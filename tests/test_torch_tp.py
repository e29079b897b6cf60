"""Port parity of tensor parallelism: the port's ranks are gloo processes
on the CPU (``repro_torch.launch.mesh``), the reference's are an 8-device
host mesh in a subprocess, as ``tests/test_tp.py`` runs them.

* The pair at tp 2 and 4, all three schemes, every strategy, against
  JAX ``pair_forward_tp`` on the same plan (carried across through
  ``checkpoint.save``).  Unquantized strategies within rel 1e-4 of
  max|ref| (``tests/test_tp.py``'s bound); the quantized rings within two
  levels of the reference's wire (one per ring phase), since the two
  GEMMs sum in different orders.
* The quantized rings fed the same per-rank partials: int8 bit-equal at
  tp 2; int4 at tp 2, and both at tp 4, within one quantization step.
  Under jit XLA rewrites the int4 quantizer's division by the constant 15
  as a multiplication by its reciprocal, so the reference's scale can
  differ from the port's in its last bit (the port divides, as the
  reference's quantizer does run eagerly, ``tests/test_torch_comm.py``);
  at tp 4 XLA also adds the four dequantized chunks in another order than
  ranks 0..3.
* ``:fused`` against the plain ring on the same pair: bit-identical, with
  equal counted wire bytes, which equal ``bytes_on_wire``.
* psum, cast and psum_scatter routed as for tensors on the card under
  gloo (gloo only carries the payloads, the sums run in rank order where
  the tensors live) against gloo's own reductions.
* The smoke model at tp 2 under psum against the single-device JAX
  forward (within 2e-2 of max|logit|, ``tests/test_tp.py``'s bound; the
  JAX model-level TP is ROADMAP caveat a, so single-device is the
  reference), with greedy ids equal on every rank and to JAX's, and
  sampled scheduler output equal on every rank.

JAX runs only in the reference subprocess: the rank processes import
this module, so it imports nothing of JAX at module level.
"""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch.comm import dispatch as comm
from repro_torch.comm.spec import CollectiveSpec
from repro_torch.launch import mesh

_ROOT = os.path.join(os.path.dirname(__file__), "..")
SCHEMES = ("naive-actorder", "exllama", "tp-aware")
STRATEGIES = ("psum", "psum_scatter", "cast", "none", "quant-int8",
              "quant-int4")
FUSED = ("quant-int8:fused", "quant-int4:fused")
#: ring-fed cases: partial widths (90 pads the int8 wire at tp 4 and the
#: int4 wire at both), and specs (blocks of 24 and 12: the int4 block of
#: 10 at width 80 straddles packed words)
RING_WIDTHS = (128, 90)
RING_SPECS = ("quant-int8", "quant-int8:24", "quant-int4", "quant-int4:12")
M = 16
SMOKE_TOKENS = 12

_JAX_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import dispatch as jcomm
from repro.comm.spec import CollectiveSpec
from repro.configs import get_smoke_config
from repro.core import compat, reorder
from repro.core.policy import ExecutionPolicy
from repro.models.common import REPLICATED
from repro.runtime.serve import make_engine
from repro.train import checkpoint

out, M = sys.argv[1], int(sys.argv[2])
SCHEMES, STRATEGIES = {schemes!r}, {strategies!r}
RING_WIDTHS, RING_SPECS = {widths!r}, {specs!r}
rng = np.random.default_rng(0)
w_up, w_gate = rng.standard_normal((2, 128, 256)).astype(np.float32)
w_down = rng.standard_normal((256, 128)).astype(np.float32)
x = rng.standard_normal((M, 128)).astype(np.float32)
bundle = reorder.quantize_pair(
    jnp.asarray(w_up), jnp.asarray(w_down), w_gate=jnp.asarray(w_gate),
    group_size_up=32, group_size_down=32, rng=jax.random.PRNGKey(0))
pps = {{s: reorder.layout_pair(bundle, s) for s in SCHEMES}}
checkpoint.save(out + "/plans.npz", pps)
refs = {{"x": x}}
for s in SCHEMES:
    refs["single|" + s] = np.asarray(pps[s].forward(x, activation="silu"))
for tp in (2, 4):
    devs = np.array(jax.devices()[:tp])
    grid = Mesh(devs.reshape(1, tp), ("data", "model"))

    def pairs(x, pps):
        return {{s + "|" + c: pps[s].forward(
            x, ExecutionPolicy(scheme=s, collective=c), grid,
            activation="silu") for s in SCHEMES for c in STRATEGIES}}

    with grid:
        for k, v in jax.jit(pairs)(x, pps).items():
            refs[f"pair|{{tp}}|{{k}}"] = np.asarray(v)

    ring_inputs = {{n: (rng.standard_normal((tp, M, n)) * 3).astype(
        np.float32) for n in RING_WIDTHS}}

    def rings(ys):
        return {{f"{{n}}|{{c}}": jcomm.apply(ys[n][0], "model",
                                          CollectiveSpec.parse(c))[None]
                for n in RING_WIDTHS for c in RING_SPECS}}

    ring = compat.shard_map(rings, mesh=Mesh(devs, ("model",)),
                            in_specs=({{n: P("model") for n in RING_WIDTHS}},),
                            out_specs={{f"{{n}}|{{c}}": P("model")
                                       for n in RING_WIDTHS
                                       for c in RING_SPECS}})
    for k, v in jax.jit(ring)(ring_inputs).items():
        refs[f"ring|{{tp}}|{{k}}"] = np.asarray(v)
    for n, y in ring_inputs.items():
        refs[f"ring_in|{{tp}}|{{n}}"] = y

jeng = make_engine(get_smoke_config("qwen3-4b"), jax.random.PRNGKey(0),
                   max_seq=24)
checkpoint.save(out + "/smoke.npz", jeng.params)
vocab = jeng.model.cfg.vocab_size
toks = rng.integers(0, vocab, (2, {smoke_tokens})).astype(np.int32)
refs["smoke_tokens"] = toks
refs["smoke_logits"] = np.asarray(jeng.model.forward(
    jeng.params, {{"tokens": jnp.asarray(toks)}}, REPLICATED))
prompts = rng.integers(0, vocab, (4, 8)).astype(np.int32)
plen = np.array([8, 5, 7, 6], np.int32)
refs["smoke_prompts"], refs["smoke_plen"] = prompts, plen
refs["smoke_ids"] = np.asarray(jeng.generate(
    jax.random.PRNGKey(0), {{"tokens": jnp.asarray(prompts)}},
    jnp.asarray(plen), max_new_tokens=8))
np.savez(out + "/refs.npz", **refs)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX plans and outputs, written by an 8-device subprocess."""
    out = str(tmp_path_factory.mktemp("tp_reference"))
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    script = _JAX_REFERENCE.format(schemes=SCHEMES, strategies=STRATEGIES,
                                   widths=RING_WIDTHS, specs=RING_SPECS,
                                   smoke_tokens=SMOKE_TOKENS)
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(script), out,
                        str(M)], capture_output=True, text=True, env=env,
                       timeout=180)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    return out, dict(np.load(os.path.join(out, "refs.npz")))


# ---------------------------------------------------------------------------
# rank work (runs in the spawned rank processes)
# ---------------------------------------------------------------------------

def _padded_pair():
    """A port-planned tp-aware pair whose output width, 90, pads both
    wires: the same plan on every rank (seeded generator)."""
    from repro_torch.core import reorder

    gen = torch.Generator().manual_seed(5)
    w_up, w_gate = (torch.randn(64, 128, generator=gen) for _ in range(2))
    w_down = torch.randn(128, 90, generator=gen)
    bundle = reorder.quantize_pair(w_up, w_down, w_gate=w_gate,
                                   group_size_up=16, group_size_down=16,
                                   generator=gen)
    x = torch.randn(M, 64, generator=gen)
    return reorder.layout_pair(bundle, "tp-aware"), x


def _forward(local, x, ctx, scheme, coll):
    """One pair forward; (output, wire bytes counted, warnings raised)."""
    from repro_torch.core.policy import ExecutionPolicy

    pol = ExecutionPolicy(scheme=scheme, backend="torch", collective=coll)
    comm.wire_bytes.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y = local.forward(x, pol, ctx.group, activation="silu",
                          pair_path="layers.mlp")
    return y.numpy(), comm.wire_bytes.total, len(caught)


def _through_host(ctx, refs):
    """The reducing collectives on the ring inputs, routed as they are for
    tensors on the card under gloo; on the CPU the host copies are
    no-ops, so this runs that path's gathers and sums.  Returns, per
    spec, gloo's own reduction, the routed one, and each one's counted
    bytes."""
    y = torch.from_numpy(refs[f"ring_in|{ctx.tp}|128"][ctx.rank])
    out = {}
    for spec in ("psum", "cast", "psum_scatter"):
        runs = []
        for via_host in (False, True):
            saved = comm._via_host
            if via_host:
                comm._via_host = lambda t, group: True
            try:
                comm.wire_bytes.reset()
                got = comm.apply(y, ctx.group, CollectiveSpec.parse(spec))
                runs.append((got.numpy(), comm.wire_bytes.total))
            finally:
                comm._via_host = saved
        out[spec] = runs
    return out


def _smoke(ctx, ref_dir):
    """The smoke model on this rank: forward logits, greedy ids, and a
    sampled scheduler run."""
    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.plan import compiler
    from repro_torch.runtime.sampling import SamplingConfig
    from repro_torch.runtime.scheduler import Request, Scheduler
    from repro_torch.runtime.serve import Engine

    refs = np.load(os.path.join(ref_dir, "refs.npz"))
    cfg = get_smoke_config("qwen3-4b")
    params = interop.load_params(os.path.join(ref_dir, "smoke.npz"),
                                 device="cpu")
    trees, shards = compiler.shard_params(cfg, params, ctx.tp)
    eng = Engine(model=build_model(cfg), params=trees[ctx.rank],
                 device=torch.device("cpu"), max_seq=24, group=ctx.group)
    out = {"leaf_shards": shards,
           "cache_heads": eng.init_cache(1)["k"].shape[3],
           "mesh": eng.policy.mesh.shorthand()}
    try:
        Engine(model=eng.model, params=eng.params, device=eng.device,
               policy=eng.policy.with_(mesh="dp1xtp4"), group=ctx.group)
    except ValueError as e:
        out["mesh_refused"] = str(e)
    toks = torch.from_numpy(refs["smoke_tokens"]).long()
    out["logits"] = eng.prefill_logits(toks).numpy()
    out["ids"] = eng.generate(
        None, torch.from_numpy(refs["smoke_prompts"]).long(),
        torch.from_numpy(refs["smoke_plen"]), max_new_tokens=8).numpy()
    rng = np.random.default_rng(9)
    sched = Scheduler(eng, max_batch=2, prompt_budget=8,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=3)
    for i, n in enumerate((5, 7, 4)):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=5))
    out["sampled"] = {rid: r.output for rid, r in sched.run().items()}
    return out


def _rank_work(ctx, ref_dir):
    """Every TP case of this test file on one rank."""
    from repro_torch import interop
    from repro_torch.core import reorder

    refs = np.load(os.path.join(ref_dir, "refs.npz"))
    x = torch.from_numpy(refs["x"])
    plans = interop.load_tree(os.path.join(ref_dir, "plans.npz"),
                              device="cpu")
    out = {}
    for scheme in SCHEMES:
        local = reorder.shard_pair(plans[scheme], ctx.tp)[ctx.rank]
        for coll in STRATEGIES + FUSED:
            out[("pair", scheme, coll)] = _forward(local, x, ctx, scheme,
                                                   coll)
    pp, xp = _padded_pair()
    local = reorder.shard_pair(pp, ctx.tp)[ctx.rank]
    for coll in ("quant-int8", "quant-int8:12", "quant-int4",
                 "quant-int4:12"):
        out[("padded", coll)] = _forward(local, xp, ctx, "tp-aware", coll)
        out[("padded", coll + ":fused")] = _forward(
            local, xp, ctx, "tp-aware", coll + ":fused")
    for n in RING_WIDTHS:
        y = torch.from_numpy(refs[f"ring_in|{ctx.tp}|{n}"][ctx.rank])
        for spec in RING_SPECS:
            out[("ring", n, spec)] = comm.apply(
                y, ctx.group, CollectiveSpec.parse(spec)).numpy()
    out["host"] = _through_host(ctx, refs)
    if ctx.tp == 2:
        out["smoke"] = _smoke(ctx, ref_dir)
    return out


def _fail_on_rank_one(ctx):
    if ctx.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return ctx.rank


@pytest.fixture(scope="module")
def rank_runs(reference):
    """tp -> every rank's results, each tp launched once."""
    ref_dir, refs = reference
    runs = {}

    def get(tp):
        if tp not in runs:
            runs[tp] = (tp, refs, mesh.run(_rank_work, tp, ref_dir,
                                           device_type="cpu", timeout=180))
        return runs[tp]

    return get


@pytest.fixture(params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, rank_runs):
    return rank_runs(request.param)


@pytest.fixture
def tp2(rank_runs):
    return rank_runs(2)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _port_output(results, key, spec):
    """The port's output as JAX's shard_map assembles it: the ranks'
    shards concatenated for a scattering strategy, else rank 0's."""
    if comm.scatters_output(CollectiveSpec.parse(spec)):
        return np.concatenate([r[key][0] for r in results], axis=-1)
    return results[0][key][0]


def test_pair_unquantized_strategies_match_jax(ranks):
    tp, refs, results = ranks
    for scheme in SCHEMES:
        for coll in ("psum", "psum_scatter", "cast", "none"):
            got = _port_output(results, ("pair", scheme, coll), coll)
            ref = refs[f"pair|{tp}|{scheme}|{coll}"]
            assert got.shape == ref.shape
            # cast: a bf16 all-reduce, summed in another order by gloo
            tol = 1e-2 if coll == "cast" else 1e-4
            assert _rel(got, ref) < tol, (tp, scheme, coll, _rel(got, ref))
        if tp == 2:
            single = refs[f"single|{scheme}"]
            got = _port_output(results, ("pair", scheme, "psum"), "psum")
            assert _rel(got, single) < 1e-4


def test_pair_quantized_rings_match_jax(ranks):
    """Within two wire levels of the reference's result (the two GEMMs sum
    in different orders, so each ring phase may round one value to the
    neighbouring level), and every rank holds the same result."""
    tp, refs, results = ranks
    for scheme in SCHEMES:
        for coll, levels in (("quant-int8", 127), ("quant-int4", 15)):
            ref = refs[f"pair|{tp}|{scheme}|{coll}"]
            for r in results:
                got = r[("pair", scheme, coll)][0]
                np.testing.assert_array_equal(
                    got, results[0][("pair", scheme, coll)][0])
            assert _rel(got, ref) <= 2 / levels, (tp, scheme, coll)


def test_fused_ring_bit_identical_to_plain_ring(ranks):
    """``:fused`` (the down GEMM emits ring phase 1's payload) against the
    plain ring on the same pair: bit-identical, equal wire bytes.  The
    naive layout has no wire kernel: it runs the plain ring and warns,
    once per (site, reason)."""
    tp, _, results = ranks
    for r in results:
        for scheme in SCHEMES:
            for coll in FUSED:
                fused = r[("pair", scheme, coll)]
                plain = r[("pair", scheme, coll.removesuffix(":fused"))]
                np.testing.assert_array_equal(fused[0], plain[0])
                assert fused[1] == plain[1]
            warned = sum(r[("pair", scheme, coll)][2] for coll in FUSED)
            assert warned == (1 if scheme == "naive-actorder" else 0)
        for coll in ("quant-int8", "quant-int8:12", "quant-int4",
                     "quant-int4:12"):
            fused, plain = r[("padded", coll + ":fused")], r[("padded",
                                                               coll)]
            np.testing.assert_array_equal(fused[0], plain[0])
            assert fused[1] == plain[1]
            assert fused[0].shape == (M, 90)


def test_counted_wire_bytes_equal_bytes_on_wire(ranks):
    """The transport's byte counter against the analytic ring model, for
    the schemes whose only collective is the epilogue (exllama adds its
    Algorithm-2 gather of Y1: (tp - 1) shards of M x 256/tp floats)."""
    tp, _, results = ranks
    for r in results:
        for coll in STRATEGIES + FUSED:
            spec = CollectiveSpec.parse(coll)
            want = spec.bytes_on_wire((M, 128), tp)
            for scheme in ("naive-actorder", "tp-aware"):
                assert r[("pair", scheme, coll)][1] == want, (scheme, coll)
            gather = (tp - 1) * M * (256 // tp) * 4
            assert r[("pair", "exllama", coll)][1] == want + gather
        for coll in ("quant-int8:12", "quant-int4:12"):
            spec = CollectiveSpec.parse(coll)
            assert r[("padded", coll)][1] == spec.bytes_on_wire((M, 90), tp)


def _largest_step(ref, spec):
    """The largest quantization step a block of ``ref`` can have on the
    wire: max|v| / 127 for int8, (max(vmax, 0) - min(vmin, 0)) / 15 for
    int4."""
    if "int8" in spec:
        return np.abs(ref).max() / 127
    return (max(ref.max(), 0.0) - min(ref.min(), 0.0)) / 15


def test_rings_fed_same_partials_match_jax(ranks):
    """The same per-rank partials through the port's ring and the
    reference's jitted one: int8 bit-equal at tp 2, else within one
    quantization step (see the module note for why)."""
    tp, refs, results = ranks
    for n in RING_WIDTHS:
        for spec in RING_SPECS:
            ref = refs[f"ring|{tp}|{n}|{spec}"]
            got = np.stack([r[("ring", n, spec)] for r in results])
            assert got.shape == ref.shape
            if tp == 2 and "int8" in spec:
                np.testing.assert_array_equal(got, ref)
            else:
                gap = np.abs(got - ref).max()
                step = _largest_step(ref, spec)
                assert gap <= step, (n, spec, gap, step,
                                     int((got != ref).sum()), got.size)


def test_host_transport_sums_match_gloo(ranks):
    """psum, cast and psum_scatter with gloo only carrying the payloads (an
    all-gather or an all-to-all, then the sum in rank order) against
    gloo's own all-reduce and reduce-scatter: bit-equal at tp 2 (one
    addition each), within the sum-order rounding of the wire dtype at
    tp 4; the same counted bytes."""
    tp, _, results = ranks
    for r in results:
        for spec, ((gloo, gloo_bytes), (host, host_bytes)) in r[
                "host"].items():
            assert host.shape == gloo.shape and host.dtype == gloo.dtype
            assert host_bytes == gloo_bytes, spec
            if tp == 2:
                np.testing.assert_array_equal(host, gloo, err_msg=spec)
            else:
                eps = 2.0 ** -8 if spec == "cast" else 2.0 ** -23
                assert _rel(host, gloo) <= 4 * eps, (spec, _rel(host, gloo))


def test_smoke_model_tp2_matches_single_device_jax(tp2):
    _, refs, results = tp2
    ref = refs["smoke_logits"]
    for r in results:
        got = r["smoke"]["logits"]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
        np.testing.assert_array_equal(r["smoke"]["ids"], refs["smoke_ids"])
        assert r["smoke"]["cache_heads"] == 1       # 2 KV heads over 2
    shards = results[0]["smoke"]["leaf_shards"]
    assert shards["embed||embedding"] == 0 and shards["embed||lm_head"] == 1
    assert shards["layers||0||attn||wo"] == 0
    assert shards["layers||0||mlp||down||qweight"] == 0
    assert shards["layers||0||mlp||p1_up"] is None


def test_ranks_agree(tp2):
    """Every rank samples the same tokens: the logits are gathered whole on
    each rank and each rank seeds its generators alike."""
    _, _, results = tp2
    first = results[0]["smoke"]
    for r in results[1:]:
        assert r["smoke"]["sampled"] == first["sampled"]
        np.testing.assert_array_equal(r["smoke"]["logits"], first["logits"])
    assert all(len(v) == 5 for v in first["sampled"].values())


def test_engine_mesh_is_the_groups(tp2):
    """A rank's derived policy plans the group's degree, and an engine whose
    policy plans another raises."""
    _, _, results = tp2
    for r in results:
        assert r["smoke"]["mesh"] == "dp1xtp2"
        assert "plans tp=4, but 2 rank(s) run it" in r["smoke"]["mesh_refused"]


def test_sharded_dim_that_does_not_split_raises():
    """The TP forward sums every sharded leaf's partials over the ranks, so
    a leaf whose sharded dim does not divide tp raises instead of staying
    whole: the raw MLP of a model whose d_ff does not split, and a
    planned pair (as ``shard_pair`` raises)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import reorder
    from repro_torch.models import common
    from repro_torch.models.registry import build_model
    from repro_torch.plan import compiler

    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              d_ff=513).with_quant(mode="none")
    with pytest.raises(ValueError,
                       match=r"'mlp\|\|w_up'.*does not split over tp=2"):
        build_model(cfg).init(0, device="cpu", tp=2, rank=0)
    gen = torch.Generator().manual_seed(0)
    bundle = reorder.quantize_pair(
        torch.randn(32, 40, generator=gen), torch.randn(40, 32, generator=gen),
        group_size_up=8, group_size_down=8, generator=gen)
    pp = reorder.layout_pair(bundle, "tp-aware")      # n1 = 40
    with pytest.raises(ValueError, match=r"'down\|\|qweight'.*over tp=2"):
        compiler.stage_shard(pp, common.mlp_specs(pp), 2, 0)
    with pytest.raises(ValueError, match="packing factor"):
        reorder.shard_pair(pp, 2)
    got = compiler.stage_shard(pp, common.mlp_specs(pp), 5, 1)
    want = reorder.shard_pair(pp, 5)[1]
    for name in ("up", "down"):
        for leaf in ("qweight", "scales", "zeros"):
            assert torch.equal(getattr(getattr(got, name), leaf),
                               getattr(getattr(want, name), leaf))
    assert torch.equal(got.p2, want.p2)


def test_shard_pair_leaves_bit_equal_to_jax(reference):
    """Every leaf of the port's ``shard_pair`` against the reference's on
    the same plan, at tp 2 and 4."""
    import jax  # noqa: F401  (the reference's plan reader needs it)

    from repro.core import reorder as jreorder
    from repro.train import checkpoint
    from repro_torch import interop
    from repro_torch.core import reorder

    ref_dir, _ = reference
    path = os.path.join(ref_dir, "plans.npz")
    jplans = checkpoint.load(path)
    plans = interop.load_tree(path, device="cpu")
    for scheme in SCHEMES:
        for tp in (2, 4):
            for jl, tl in zip(jreorder.shard_pair(jplans[scheme], tp),
                              reorder.shard_pair(plans[scheme], tp)):
                flat = checkpoint.flatten_keys({"p": jl})
                for key, leaf in flat.items():
                    node = tl
                    for part in key.split("||")[1:]:
                        node = getattr(node, part)
                    ref = np.asarray(leaf)
                    if ref.dtype == np.uint32:
                        ref = ref.view(np.int32)
                    np.testing.assert_array_equal(node.numpy(), ref,
                                                  err_msg=(scheme, tp, key))


def test_mesh_backend_rule_and_failing_rank():
    assert mesh.backend_for(2, "cpu") == "gloo"
    assert mesh.transport(2, "cpu") == "gloo, 2 ranks on the CPU"
    if torch.cuda.device_count() < 2:
        assert mesh.transport(2, "cuda") == "gloo via host, 2 ranks on 1 card"
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        mesh.run(_fail_on_rank_one, 2, device_type="cpu", timeout=120)
