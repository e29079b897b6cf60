"""Port parity of the ``:overlap`` epilogue (``dist/overlap.py``): the
quantized ring's two halves (``comm.dispatch.ring_start`` and
``ring_finish``) pipelined against the down GEMM one row microbatch at a
time, on gloo rank processes on the CPU (``repro_torch.launch.mesh``;
one spawned group per TP degree, 2 and 4).

* The ring with two rings in flight at once (both posted, then finished
  in order) against the synchronous ring on the same partials, int8 and
  int4, at a width that pads both wires (90): bit-equal, from the dense
  partials and from a ``WirePayload``; ``comm.wire_bytes`` counts the
  base spec's ``bytes_on_wire``.  ``PendingRing.in_flight`` reads true
  while a peer has not posted its part.
* The pipelined ring on the same partials against JAX's
  ``dist.overlap.pipelined_epilogue`` (an 8-device host mesh in a
  subprocess): int8 bit-equal at tp 2, else within one quantization step
  (``tests/test_torch_tp.py``: XLA divides int4's scale by a reciprocal
  and at tp 4 adds the chunks in another order).
* ``pair_forward_tp`` with ``:overlap``, tp-aware and naive plans, plain
  and ``:fused``: bit-equal to the same spec without ``:overlap`` at M 4
  and 8 (even splits: torch's CPU GEMM rows of M=2 and M=4 calls equal
  those of the whole call); at M 3 (1 + 2) bit-equal to the
  per-microbatch GEMMs followed by the synchronous ring (a one-row CPU
  GEMM sums in another order).
* JAX's own ``p.forward`` with ``:overlap`` (``tests/test_dist.py``'s
  plan and input) against the port's on the same plan: within two wire
  levels (the GEMMs sum in different orders, ``tests/test_torch_tp.py``'s
  bound), every rank the same.
* The pipelined window: mb1's GEMM runs between mb0's post and the
  return of its wait (``torch.profiler`` ranges on the CPU), and
  ``overlap.stats`` counts the site.
* Parse (``CollectiveSpec``, the reference's cases), the split rule, the
  tuner's ``:overlap`` marks (as the reference's), the CLI, a JAX
  ``--overlap-collectives`` artifact served by the port (the same ids as
  without ``:overlap``) and a port-prepared one validated and linted by
  JAX.
* ``gpu``: K1 and K3 at a microbatch pair's halves against the whole
  call, and the ``:overlap`` pair at tp=2 on the card.

JAX runs only in the reference subprocess and inside tests: the rank
processes import this module."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.comm import dispatch as comm
from repro_torch.comm.spec import CollectiveSpec, parse_collective
from repro_torch.comm.wire import WirePayload, wire_params
from repro_torch.dist import overlap
from repro_torch.launch import mesh

_ROOT = os.path.join(os.path.dirname(__file__), "..")
#: ring inputs: (M, N) partials per rank; 90 pads int4's wire at tp 2 and
#: both wires at tp 4
RING_M, RING_N = 6, 90
RING_SPECS = ("quant-int8:32", "quant-int4:32", "quant-int8", "quant-int4:12")
#: the reference's overlap cases (tests/test_dist.py); JAX runs the plain
#: two (its ``:fused`` wire kernel runs in interpret mode on the CPU)
BASES = ("quant-int8:32", "quant-int4:32", "quant-int8:32:fused",
         "quant-int4:32:fused")
JAX_BASES = BASES[:2]
PAIR_SCHEMES = ("tp-aware", "naive-actorder")

_JAX_REFERENCE = """
import sys, traceback
out = sys.argv[1]
try:
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.comm.spec import CollectiveSpec
    from repro.core import compat, reorder
    from repro.core.policy import ExecutionPolicy
    from repro.dist import overlap as joverlap
    from repro.train import checkpoint

    BASES, SPECS = {bases!r}, {specs!r}
    r = jax.random.split(jax.random.PRNGKey(0), 3)
    pp = reorder.plan_pair(
        jax.random.normal(r[0], (64, 256)) * 0.1,
        jax.random.normal(r[1], (256, 96)) * 0.1,
        scheme="tp-aware", group_size_up=32, group_size_down=32, rng=r[2])
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 64))
    checkpoint.save(out + "/pair.npz", pp)
    np.save(out + "/x.npy", np.asarray(x))
    open(out + "/plan.done", "w").close()
    ring_in = np.load(out + "/ring_in.npz")
    refs = {{}}
    for tp in (2, 4):
        devs = np.array(jax.devices()[:8]).reshape(8 // tp, tp)
        grid = Mesh(devs, ("data", "model"))
        for base in BASES:
            pol = ExecutionPolicy(collective=base + ":overlap")
            fn = jax.jit(lambda xx, p, pol=pol: p.forward(
                xx, pol, grid, activation=None))
            refs[f"pair|{{tp}}|{{base}}"] = np.asarray(fn(x, pp))

        def rings(y):
            return {{c: joverlap.pipelined_epilogue(
                y[0], axis="model", spec=CollectiveSpec.parse(c),
                gemm=lambda v: v)[None] for c in SPECS}}

        ring = compat.shard_map(
            rings, mesh=Mesh(devs.reshape(-1)[:tp], ("model",)),
            in_specs=(P("model"),),
            out_specs={{c: P("model") for c in SPECS}})
        for k, v in jax.jit(ring)(ring_in[f"ring_in|{{tp}}"]).items():
            refs[f"ring|{{tp}}|{{k}}"] = np.asarray(v)
    np.savez(out + "/refs.npz", **refs)
    open(out + "/done", "w").close()
except BaseException:
    open(out + "/failed", "w").write(traceback.format_exc())
    raise
"""

#: JAX's ``prepare --autotune-collectives --overlap-collectives`` of the
#: smoke model at tp=2, into sys.argv[1]
_JAX_PREPARE = """
import sys, traceback
out = sys.argv[1]
try:
    from repro.launch import serve
    serve.prepare(["--arch", "qwen3-4b", "--smoke", "--tp", "2",
                   "--autotune-collectives", "--overlap-collectives",
                   "--out", out])
    open(out + "/done", "w").close()
except BaseException:
    open(out + "/failed", "w").write(traceback.format_exc())
    raise
"""


def _jax_env(devices: int = 1) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                JAX_PLATFORMS="cpu")


def _await(directory: str, marker: str = "done", timeout: float = 200.0):
    """Wait for a JAX subprocess to mark ``directory`` (``marker``); raise
    with its traceback when it failed."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(os.path.join(directory, marker)):
        failed = os.path.join(directory, "failed")
        if os.path.exists(failed):
            with open(failed) as f:
                raise RuntimeError(f"the JAX subprocess failed:\n{f.read()}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {marker!r} in {directory} within "
                               f"{timeout:.0f} s")
        time.sleep(0.1)


@pytest.fixture(scope="module")
def jax_started(tmp_path_factory):
    """Two JAX subprocesses, started side by side and left running while
    the port's ranks work (they wait for the files they need): the
    8-device one plans the reference test's pair (``pair.npz``, ``x.npy``,
    then ``plan.done``) and writes its ``:overlap`` outputs and its
    pipelined rings on the ring inputs made here from a numpy seed
    (``refs.npz``); the other is JAX's ``prepare --autotune-collectives
    --overlap-collectives`` of the smoke model at tp=2.  Yields (the
    first's directory, the artifact's directory, the processes); the
    processes are ended at teardown."""
    out = str(tmp_path_factory.mktemp("overlap_reference"))
    art = str(tmp_path_factory.mktemp("jax_overlap"))
    rng = np.random.default_rng(0)
    np.savez(os.path.join(out, "ring_in.npz"), **{
        f"ring_in|{tp}": (rng.standard_normal((tp, RING_M, RING_N))
                          * 3).astype(np.float32) for tp in (2, 4)})
    script = _JAX_REFERENCE.format(bases=JAX_BASES, specs=RING_SPECS)
    procs = []
    for code, where, devices in ((script, out, 8), (_JAX_PREPARE, art, 1)):
        with open(os.path.join(where, "log.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(code), where],
                stdout=log, stderr=subprocess.STDOUT, env=_jax_env(devices)))
    yield out, art, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _finished(proc, where: str):
    proc.wait(timeout=240)
    with open(os.path.join(where, "log.txt")) as f:
        assert proc.returncode == 0, f.read()


@pytest.fixture(scope="module")
def reference(jax_started):
    """The JAX refs, the ring inputs and ``x`` in one dict."""
    out, _, procs = jax_started
    _finished(procs[0], out)
    refs = dict(np.load(os.path.join(out, "refs.npz")))
    refs.update(np.load(os.path.join(out, "ring_in.npz")))
    refs["x"] = np.load(os.path.join(out, "x.npy"))
    return out, refs


@pytest.fixture(scope="module")
def jax_overlap_artifact(jax_started):
    _, art, procs = jax_started
    _finished(procs[1], art)
    return art


# ---------------------------------------------------------------------------
# rank work (runs in the spawned rank processes)
# ---------------------------------------------------------------------------

def _pairs():
    """Port-planned pairs, tp-aware and naive, output width 90 (pads the
    wires), from numpy-seeded weights; and eight input rows."""
    from repro_torch.core import reorder

    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    w_up, w_gate, w_down = t(64, 128), t(64, 128), t(128, 90)
    bundle = reorder.quantize_pair(w_up, w_down, w_gate=w_gate,
                                   group_size_up=16, group_size_down=16,
                                   generator=torch.Generator().manual_seed(5))
    return ({s: reorder.layout_pair(bundle, s) for s in PAIR_SCHEMES},
            t(8, 64))


def _policy(scheme, coll):
    from repro_torch.core.policy import ExecutionPolicy

    return ExecutionPolicy(scheme=scheme, backend="torch", collective=coll)


def _ring_cases(ctx, ys) -> dict:
    """Every ring spec on this rank's partials: the synchronous ring and
    the ``:overlap`` spec's from the dense partials and from a
    WirePayload, their counted bytes; two started rings in flight at once
    (from ``y`` and ``2 y``; from the payload and ``y``), finished in the
    order posted; and the pipelined ring (an identity GEMM)."""
    y = torch.from_numpy(ys[ctx.rank])
    out = {}
    for short in RING_SPECS:
        spec = CollectiveSpec.parse(short)
        runs = {}
        for name, sp in (("sync", spec),
                         ("overlap", spec.with_(overlap=True))):
            comm.wire_bytes.reset()
            runs[name] = comm.apply(y, ctx.group, sp).numpy()
            runs[name + "_bytes"] = comm.wire_bytes.total
        n_pad, _, bs = wire_params(RING_N, ctx.tp, spec.bits,
                                   spec.block_size)
        from repro_torch.kernels.dequant_matmul import quantize_wire

        wp = WirePayload(*quantize_wire(y, n_pad=n_pad, wire_block=bs,
                                        wire_bits=spec.bits),
                         n=RING_N, tp=ctx.tp, bits=spec.bits, block=bs,
                         out_dtype=torch.float32)
        runs["wire_sync"] = comm.apply_wire(wp, ctx.group, spec).numpy()
        runs["wire_overlap"] = comm.apply_wire(
            wp, ctx.group, spec.with_(overlap=True)).numpy()
        runs["sync2"] = comm.apply(2 * y, ctx.group, spec).numpy()
        for name, starts in (
                ("in_flight", (lambda: comm.ring_start(y, ctx.group, spec),
                               lambda: comm.ring_start(2 * y, ctx.group,
                                                       spec))),
                ("wire_in_flight", (
                    lambda: comm.ring_start_wire(wp, ctx.group, spec),
                    lambda: comm.ring_start(y, ctx.group, spec)))):
            pending = [start() for start in starts]
            runs[name] = [comm.ring_finish(p).numpy() for p in pending]
        runs["pipelined"] = overlap.pipelined_epilogue(
            y, ctx.group, spec, gemm=lambda v: v).numpy()
        out[short] = runs
    return out


def _pair_cases(ctx) -> dict:
    """``:overlap`` pair forwards against the same spec without it, at M 4
    and 8, and at M 3 against the per-microbatch GEMMs and the
    synchronous ring."""
    from repro_torch.core import reorder, schemes

    plans, x = _pairs()
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # naive plans cannot fuse
        for scheme, pp in plans.items():
            local = reorder.shard_pair(pp, ctx.tp)[ctx.rank]
            for base in BASES:
                for m in (4, 8):
                    out[(scheme, base, m)] = tuple(
                        local.forward(x[:m], _policy(scheme, c), ctx.group,
                                      activation="silu",
                                      pair_path="layers.mlp").numpy()
                        for c in (base, base + ":overlap"))
                if "fused" in base:
                    continue
                pol = _policy(scheme, base)
                y1 = schemes.column_step(x[:3], local, pol, "silu")
                per_mb = torch.cat([comm.apply(
                    schemes.qmatmul(rows, local.down, pol), ctx.group,
                    CollectiveSpec.parse(base)) for rows in (y1[:1], y1[1:])])
                got = local.forward(x[:3], _policy(scheme, base + ":overlap"),
                                    ctx.group, activation="silu",
                                    pair_path="layers.mlp")
                out[(scheme, base, 3)] = (per_mb.numpy(), got.numpy())
    return out


def _window(ctx) -> tuple:
    """The tp-aware ``quant-int8:32:overlap`` pair at M 8 under the CPU
    profiler: the events' (name, start, end) on the host timeline, and
    ``overlap.stats`` (sites, in flight) of that forward."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import reorder

    plans, x = _pairs()
    local = reorder.shard_pair(plans["tp-aware"], ctx.tp)[ctx.rank]
    pol = _policy("tp-aware", "quant-int8:32:overlap")
    overlap.stats.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        local.forward(x, pol, ctx.group, activation="silu",
                      pair_path="layers.mlp")
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()]
    return ev, (overlap.stats.sites, overlap.stats.in_flight)


def _witness(ctx) -> tuple:
    """One ring whose second rank posts its part 0.5 s after the first:
    ``in_flight()`` right after the post and after ``ring_finish``, and
    the result against the synchronous ring."""
    spec = CollectiveSpec.parse("quant-int8:32")
    y = torch.arange(64, dtype=torch.float32).reshape(4, 16) * (ctx.rank + 1)
    if ctx.rank == 1:
        time.sleep(0.5)
    pend = comm.ring_start(y, ctx.group, spec)
    posted = pend.in_flight()
    got = comm.ring_finish(pend)
    return posted, pend.in_flight(), torch.equal(
        got, comm.apply(y, ctx.group, spec))


def _served_ids(ctx, path) -> tuple:
    """The artifact at ``path`` served on this rank: the greedy ids of
    ``serve --mesh``'s lockstep batch (4 prompts of 16 tokens from seed
    0, M 2 + 2), and the plan's collective."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.plan.artifact import DeploymentArtifact
    from repro_torch.runtime.sampling import SamplingConfig
    from repro_torch.runtime.serve import make_engine

    man = DeploymentArtifact.load_manifest(path)
    cfg = get_smoke_config(man["arch_id"]).with_quant(**man["quant"])
    pol = DeploymentArtifact(manifest=man).policy(backend="auto",
                                                  device=ctx.device)
    eng = make_engine(cfg, device=ctx.device, max_seq=24, group=ctx.group,
                      policy=pol, artifact=path)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    ids = eng.generate(None, torch.from_numpy(tokens), [16] * 4,
                       max_new_tokens=6,
                       scfg=SamplingConfig(temperature=0.0))
    return ids.tolist(), pol.collective.shorthand()


def _strip_overlap(src: str, dst: str) -> str:
    """A copy of the artifact at ``src`` whose plan names no ``:overlap``
    (the rank files are the same: the flag changes only how the ring
    runs)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("log.txt"))
    path = os.path.join(dst, "manifest.json")
    with open(path) as f:
        text = f.read()
    assert ":overlap" in text
    with open(path, "w") as f:
        f.write(text.replace(":overlap", ""))
    return dst


def _rank_work(ctx, ref_dir, art_dir, scratch):
    """Every case of this file on one rank: first what needs no JAX
    output, then, once the JAX subprocesses have written them, the
    forwards of JAX's plan and (tp 2) JAX's artifact and a copy of it
    whose plan names no ``:overlap``, served."""
    from repro_torch import interop
    from repro_torch.core import reorder

    ring_in = np.load(os.path.join(ref_dir, "ring_in.npz"))
    out = {"ring": _ring_cases(ctx, ring_in[f"ring_in|{ctx.tp}"]),
           "pair": _pair_cases(ctx)}
    if ctx.tp == 2:
        out["window"] = _window(ctx)
        out["witness"] = _witness(ctx)
    _await(ref_dir, "plan.done")
    pp = interop.load_tree(os.path.join(ref_dir, "pair.npz"), device="cpu")
    local = reorder.shard_pair(pp, ctx.tp)[ctx.rank]
    x = torch.from_numpy(np.load(os.path.join(ref_dir, "x.npy")))
    for base in JAX_BASES:
        out[("jax", base)] = local.forward(
            x, _policy("tp-aware", base + ":overlap"), ctx.group,
            activation=None, pair_path="layers.mlp").numpy()
    if ctx.tp == 2:
        _await(art_dir)
        plain = _strip_overlap(art_dir, os.path.join(scratch,
                                                     f"plain{ctx.rank}"))
        out["served"] = {k: _served_ids(ctx, path) for k, path in
                         (("overlap", art_dir), ("plain", plain))}
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_started, tmp_path_factory):
    """tp -> every rank's results and the JAX refs, each tp launched once
    while the JAX subprocesses run."""
    ref_dir, art_dir, _ = jax_started
    scratch = str(tmp_path_factory.mktemp("ranks"))
    runs = {}

    def get(tp):
        if tp not in runs:
            results = mesh.run(_rank_work, tp, ref_dir, art_dir, scratch,
                               device_type="cpu", timeout=240)
            runs[tp] = results
        return runs[tp]

    return get


@pytest.fixture(params=[4, 2], ids=["tp4", "tp2"])
def ranks(request, rank_runs):
    """(tp, the JAX refs, every rank's results); the ranks run before the
    refs are awaited, beside the JAX subprocesses."""
    results = rank_runs(request.param)
    return request.param, request.getfixturevalue("reference")[1], results


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_overlapped_ring_bit_equal_to_sync_ring(ranks):
    """Bit for bit on the same partials, also with a second ring in flight
    across the first's finish; the same counted bytes, equal to the base
    spec's ``bytes_on_wire`` (and the ``:overlap`` spec's)."""
    tp, _, results = ranks
    for r in results:
        for short, run in r["ring"].items():
            np.testing.assert_array_equal(run["overlap"], run["sync"])
            first, second = run["in_flight"]
            np.testing.assert_array_equal(first, run["sync"])
            np.testing.assert_array_equal(second, run["sync2"])
            spec = CollectiveSpec.parse(short)
            want = spec.bytes_on_wire((RING_M, RING_N), tp)
            assert run["overlap_bytes"] == run["sync_bytes"] == want, short
            assert spec.with_(overlap=True).bytes_on_wire(
                (RING_M, RING_N), tp) == want


def test_overlapped_wire_ring_bit_equal_to_apply_wire(ranks):
    """From the same ``WirePayload`` (the CPU's plain ``quantize_wire``):
    bit for bit, and equal to the ring from the dense partials."""
    _, _, results = ranks
    for r in results:
        for short, run in r["ring"].items():
            np.testing.assert_array_equal(run["wire_overlap"],
                                          run["wire_sync"])
            np.testing.assert_array_equal(run["wire_overlap"], run["sync"])
            wire, dense = run["wire_in_flight"]
            np.testing.assert_array_equal(wire, run["wire_sync"])
            np.testing.assert_array_equal(dense, run["sync"])


def _largest_step(ref, spec):
    """The largest quantization step a block of ``ref`` can have on the
    wire (``tests/test_torch_tp.py``)."""
    if "int8" in spec:
        return np.abs(ref).max() / 127
    return (max(ref.max(), 0.0) - min(ref.min(), 0.0)) / 15


def test_pipelined_ring_matches_jax(ranks):
    """The pipelined ring (identity GEMM, rows split 3 + 3) on the same
    partials as JAX's ``pipelined_epilogue``: int8 bit-equal at tp 2,
    else within one quantization step of the wire; equal to the
    synchronous ring."""
    tp, refs, results = ranks
    for rank, r in enumerate(results):
        for short in RING_SPECS:
            got = r["ring"][short]["pipelined"]
            np.testing.assert_array_equal(got, r["ring"][short]["sync"])
            ref = refs[f"ring|{tp}|{short}"][rank]
            if tp == 2 and "int8" in short:
                np.testing.assert_array_equal(got, ref)
            else:
                gap = np.abs(got - ref).max()
                assert gap <= _largest_step(ref, short), (short, gap)


# ---------------------------------------------------------------------------
# the pipelined pair
# ---------------------------------------------------------------------------

def test_pipelined_pair_bit_equal_to_sync_pair(ranks):
    """tp-aware and naive plans, plain and ``:fused`` (naive falls back to
    the plain ring), at M 4 and 8: bit for bit, every rank the same."""
    _, _, results = ranks
    for scheme in PAIR_SCHEMES:
        for base in BASES:
            for m in (4, 8):
                for r in results:
                    sync, ov = r["pair"][(scheme, base, m)]
                    np.testing.assert_array_equal(ov, sync)
                    np.testing.assert_array_equal(
                        ov, results[0]["pair"][(scheme, base, m)][1])


def test_pipelined_pair_odd_batch_is_per_microbatch_gemms(ranks):
    """At M 3 the split is 1 + 2: bit-equal to the two microbatches'
    GEMMs, each closed by the synchronous ring."""
    _, _, results = ranks
    for scheme in PAIR_SCHEMES:
        for base in BASES[:2]:
            for r in results:
                want, got = r["pair"][(scheme, base, 3)]
                np.testing.assert_array_equal(got, want)


def test_overlap_pair_matches_jax(ranks):
    """JAX's ``p.forward`` with ``:overlap`` on its own plan (the reference
    test's) against the port's on that plan: within two wire levels (the
    GEMMs sum in different orders), every rank the same."""
    tp, refs, results = ranks
    for base in JAX_BASES:
        ref = refs[f"pair|{tp}|{base}"]
        levels = 127 if "int8" in base else 15
        for r in results:
            got = r[("jax", base)]
            np.testing.assert_array_equal(got, results[0][("jax", base)])
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= 2 / levels, (tp, base, rel)


def test_pipelined_window_spans_the_second_gemm(rank_runs):
    """On the host timeline (CPU profiler): each microbatch's ring window
    runs from its post to the return of its wait; mb0's window holds
    mb1's down GEMM, and mb1's window holds no GEMM (nothing is left to
    hide behind it); ``overlap.stats`` counts the one pipelined site."""
    results = rank_runs(2)
    for r in results:
        ev, (sites, in_flight) = r["window"]
        assert sites == 1 and in_flight in (0, 1)

        def one(name):
            (hit,) = [e for e in ev if e[0] == name]
            return hit

        post0, wait0 = one("overlap.post mb0"), one("overlap.wait mb0")
        post1, wait1 = one("overlap.post mb1"), one("overlap.wait mb1")
        gemms = [e for e in ev if e[0] in ("aten::mm", "aten::matmul")]
        assert any(post0[1] <= s and e <= wait0[2] for _, s, e in gemms)
        assert not any(post1[1] <= s and e <= wait1[2]
                       for _, s, e in gemms)
        assert post0[2] <= post1[1] <= wait0[1]


def test_in_flight_witness(rank_runs):
    """``PendingRing.in_flight`` is true on the rank whose peer has not
    posted yet, false once the ring is finished; the started ring's
    result is the synchronous one's."""
    results = rank_runs(2)
    assert results[0]["witness"][0] is True
    for posted, after, equal in (r["witness"] for r in results):
        assert after is False and equal is True


def test_split_rows_follows_the_kernel_loop():
    """The reference's split (the largest leading dim at half), kept only
    where both halves take the whole call's loop (as K1's: a large-M loop
    from a threshold of rows, 256 here)."""
    def k1(m):
        return m >= 256

    assert overlap.split_rows((4,)) == (0, 2)
    assert overlap.split_rows((3,)) == (0, 1)
    assert overlap.split_rows((1,)) is None
    assert overlap.split_rows(()) is None
    assert overlap.split_rows((2, 5)) == (1, 2)
    assert overlap.split_rows((4,), k1) == (0, 2)
    assert overlap.split_rows((300,), k1) is None        # 150 + 150
    assert overlap.split_rows((300,)) == (0, 150)
    assert overlap.split_rows((600,), k1) == (0, 300)
    assert overlap.split_rows((2, 300), k1) == (1, 150)  # 300 rows each
    assert overlap.split_rows((2, 255), k1) is None      # 254 + 256 rows


def test_tp1_epilogue_is_the_gemm():
    y = torch.randn(4, 10)
    spec = CollectiveSpec.parse("quant-int8:overlap")
    assert overlap.pipelined_epilogue(y, None, spec, gemm=lambda v: v) is y
    assert comm.apply(y, None, spec) is y


# ---------------------------------------------------------------------------
# parse, tuner, CLI, artifacts
# ---------------------------------------------------------------------------

def test_overlap_flag_parses_as_jax():
    """The reference's cases (``tests/test_dist.py``): round trips, both
    flag orders printing ``:fused`` first, refused on non-quantized
    collectives and when repeated."""
    from repro.comm.spec import CollectiveSpec as JaxSpec

    for short in ("quant-int8:32:overlap", "quant-int4:32:fused:overlap",
                  "quant-int4:32:overlap:fused", "quant-int8:overlap",
                  "quant-int4:overlap"):
        spec, jspec = CollectiveSpec.parse(short), JaxSpec.parse(short)
        assert spec.shorthand() == jspec.shorthand()
        assert (spec.fused, spec.overlap, spec.block_size) == \
            (jspec.fused, jspec.overlap, jspec.block_size)
        assert CollectiveSpec.parse(spec.shorthand()) == spec
    assert CollectiveSpec.parse(
        "quant-int4:32:overlap:fused").shorthand() == \
        "quant-int4:32:fused:overlap"
    with pytest.raises(ValueError, match="only applies to quant"):
        CollectiveSpec(name="psum", overlap=True)
    with pytest.raises(ValueError, match="repeat"):
        CollectiveSpec.parse("quant-int8:32:overlap:overlap")
    plan = parse_collective("per-layer:*.mlp=quant-int8:64:overlap,*=psum")
    assert plan.resolve("layers.mlp").overlap
    assert not plan.resolve("layers.attn").overlap


def _smoke_cfg():
    from repro_torch.configs import get_smoke_config

    return get_smoke_config("qwen3-4b").with_quant(
        mode="mlp", scheme="tp-aware", backend="torch", collective="psum")


def test_tuner_marks_overlap_like_jax(jax_overlap_artifact):
    """``prepare(autotune=True, tune_overlap=True)`` at smoke tp=2: the
    reference test's checks (every quantized entry ``:overlap``, the
    default psum, ``overlap`` true in the report of each quantized pair
    site), the same sites marked as the reference's prepare, and
    ``validate`` passes; without ``tune_overlap`` nothing is marked."""
    from repro_torch.comm.spec import CollectivePlan
    from repro_torch.plan import compiler
    from repro_torch.plan.artifact import DeploymentArtifact

    cfg = _smoke_cfg()
    art = compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True,
                           tune_overlap=True, extra_manifest={"smoke": True})
    plan = art.manifest["collective_plan"]
    quant = [s for _, s in plan["entries"] if s.startswith("quant")]
    assert quant and all(s.endswith(":overlap") for s in quant), plan
    assert plan["default"] == "psum"
    for site in art.manifest["collective_tuner"]:
        if site["chosen"].startswith("quant") and site["kind"] == "pair":
            assert site["overlap"] is True
            assert site["eligibility"]["fusable"] is True
    pol = art.policy()
    assert isinstance(pol.collective, CollectivePlan)
    art.validate(cfg=cfg, policy=pol, tp=2)
    jplan = DeploymentArtifact.load_manifest(
        jax_overlap_artifact)["collective_plan"]

    def marked(p):
        return [path for path, s in p["entries"] if s.endswith(":overlap")]

    assert marked(plan) == marked(jplan) == ["layers.mlp"]
    plain = compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True)
    assert ":overlap" not in json.dumps(plain.manifest)


def test_prepare_overlap_needs_autotune(tmp_path):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["prepare", "--smoke", "--tp", "2", "--device", "cpu",
                    "--overlap-collectives", "--out", str(tmp_path)])
    assert e.value.code == 2


def test_port_serves_jax_overlap_artifact(rank_runs):
    """A JAX-prepared ``--overlap-collectives`` artifact (smoke, tp=2)
    served by the port over gloo, the lockstep batch of ``serve --mesh``
    (4 rows: M 2 + 2): its plan names ``:overlap``, and the greedy ids
    equal the same artifact's without ``:overlap``, on both ranks."""
    results = rank_runs(2)
    for r in results:
        (ids, coll), (want, plain) = r["served"]["overlap"], \
            r["served"]["plain"]
        assert ":overlap" in coll and ":overlap" not in plain
        assert coll.replace(":overlap", "") == plain
        assert len(ids) == 4 and ids == want
        assert ids == results[0]["served"]["overlap"][0]


def test_jax_validates_and_lints_port_overlap_artifact(tmp_path):
    """The port's ``prepare --autotune-collectives --overlap-collectives``
    artifact loads and validates in JAX and lints clean
    (``manifest_lint``, MF003 included: the overlap mark only on
    quantized pair sites)."""
    from repro.analysis.manifest_lint import lint_artifact
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import DeploymentArtifact as JaxArtifact

    from repro_torch.launch import serve

    path = serve.main(["prepare", "--smoke", "--tp", "2", "--device", "cpu",
                       "--autotune-collectives", "--overlap-collectives",
                       "--out", str(tmp_path / "port")])
    ref = JaxArtifact.load(path)
    assert ":overlap" in ref.manifest["policy"]["collective"]
    cfg = jax_smoke_config("qwen3-4b").with_quant(**ref.manifest["quant"])
    assert ref.validate(cfg=cfg, policy=ref.policy(), tp=2) is ref
    findings = lint_artifact(path)
    assert [f for f in findings if f.severity == "error"] == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_pair_rank(ctx):
    """The pairs on the card at tp=2 (gloo via host), the cuda backend:
    each base and its ``:overlap`` at M 4 and 8."""
    from repro_torch.core import reorder
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.train.checkpoint import map_tensors

    plans, x = _pairs()
    pp = map_tensors(reorder.shard_pair(plans["tp-aware"], ctx.tp)[ctx.rank],
                     lambda _, t: t.to(ctx.device))
    x = x.to(ctx.device)
    out = {}
    for base in BASES:
        for m in (4, 8):
            out[(base, m)] = tuple(pp.forward(
                x[:m], ExecutionPolicy(backend="cuda", collective=c),
                ctx.group, activation="silu",
                pair_path="layers.mlp").cpu().numpy()
                for c in (base, base + ":overlap"))
    return out


@pytest.mark.gpu
def test_cuda_overlap_pair_bit_equal_at_tp2():
    """On the card at tp=2 (two rank processes, gloo via host), the cuda
    backend (K1; K3 for ``:fused``): the ``:overlap`` pair bit-equal to
    the synchronous one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    results = mesh.run(_cuda_pair_rank, 2, device_type="cuda", timeout=300)
    for r in results:
        for key, (sync, ov) in r.items():
            np.testing.assert_array_equal(ov, sync, err_msg=str(key))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["decode", "straddle", "large"])
def test_cuda_halves_bit_equal_to_whole(rows):
    """K1 and K3 (int8 and int4 wires) on a microbatch pair's halves
    against the whole call's rows, where the split rule splits (M 4 on
    the decode loop, 2 t + 88 on the large-M loop, which K1 takes from
    t = ``tensor_core_min_m()`` rows); at M t + 44 (whole on the large-M
    loop, halves on the decode loop) it does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import dequant_matmul as tdk
    from repro_torch.kernels import dispatch as kdispatch

    t = tdk.tensor_core_min_m()
    m = {"decode": 4, "straddle": t + 44, "large": 2 * t + 88}[rows]
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(4864, 2560, device="cuda", generator=gen)
    ql = quantize(w, 76, generator=gen).ordered
    x = torch.randn(m, 4864, device="cuda", generator=gen)
    pol = ExecutionPolicy(backend="cuda")
    split = overlap.split_rows((m,), kdispatch.main_loop(ql, pol, x.device))
    if rows == "straddle":
        assert split is None
        return
    _, m0 = split
    whole = kdispatch.qmatmul(x, ql, pol)
    halves = torch.cat([kdispatch.qmatmul(x[:m0], ql, pol),
                        kdispatch.qmatmul(x[m0:], ql, pol)])
    assert torch.equal(halves, whole)
    for short in ("quant-int8:128", "quant-int4:32"):
        spec = CollectiveSpec.parse(short)
        wp = kdispatch.qmatmul_wire(x, ql, pol, spec=spec, tp=2)
        parts = [kdispatch.qmatmul_wire(rows, ql, pol, spec=spec, tp=2)
                 for rows in (x[:m0], x[m0:])]
        for f in ("payload", "scales", "zeros"):
            a = getattr(wp, f)
            if a is not None:
                assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                                   a), (short, f)
