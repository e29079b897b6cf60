"""The MoE family over gloo ranks on the CPU, at smoke size: within-expert
tensor parallelism (tp=2) and expert parallelism over the data axis
(``dp2xtp1``), against the reference's single-device forward (ROADMAP
caveat a: the reference's own EP tests do not run under jax 0.9.0).

* tp=2 (the reference's ``tests/test_moe_ep.py``): the within-expert
  epilogue resolves ``layers.moe.experts`` from the plan; ``none`` falls
  back to ``psum``, bit-equal to the ``psum`` plan; ``quant-int8:32``
  applies (0 < err < 5e-2 of max|logit|); one collective closes each
  MoE layer's stacked experts; the ``psum`` logits within 5e-3 of the
  JAX forward's.
* ``dp2xtp1``: each process keeps half of every layer's experts and its
  rows' tokens travel by all-to-all; with ``capacity_factor=64`` (no
  drop on either side) each data rank's logits are within 5e-3 of the
  JAX forward's rows, and the lockstep greedy ids equal the one-process
  engine's over the whole batch.

* ``dp2xtp2`` through the serve CLI's grid (``--mesh``), expert and
  tensor parallelism at once from a tp=2 artifact: each process holds
  half the experts of its TP slice, and the lockstep greedy ids equal
  ``dp1xtp2``'s row for row.

JAX is imported inside the fixture that runs it: the gloo rank processes
import this module."""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.comm import dispatch as comm
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.dist.topology import MeshPlan
from repro_torch.launch import mesh
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.runtime.serve import Engine

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
REL_TOL = 5e-3
CPU = torch.device("cpu")
MAX_SEQ = 24
#: the within-expert plans: (name, collective)
PLANS = (("psum", "psum"),
         ("none", "per-layer:*.experts=none,*=psum"),
         ("int8", "per-layer:*.experts=quant-int8:32,*=psum"))


def _cfg(arch: str, capacity_factor: float = 1.25):
    return get_smoke_config(arch).with_(capacity_factor=capacity_factor)


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests: the smoke models' ops
    are tiny, so one thread runs them as fast alone, and it does not
    spin against the other test processes of a parallel run (as the
    spawned ranks of ``launch/mesh.py`` do on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per arch: JAX's smoke params (a checkpoint) and its single-device
    forward logits of one (4, 16) batch, at the default capacity and at
    ``capacity_factor=64``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.common import REPLICATED
    from repro.models.registry import build_model as jax_build_model
    from repro.train import checkpoint as jax_checkpoint

    out = {}
    for arch in ARCHS:
        cfg = jax_smoke_config(arch)
        model = jax_build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks)}
        out[arch] = {
            "ckpt": jax_checkpoint.save(
                str(tmp_path_factory.mktemp("ckpt") / "p.npz"), params),
            "tokens": toks,
            "logits": np.asarray(model.forward(params, batch, REPLICATED)),
            "logits64": np.asarray(jax_build_model(
                cfg.with_(capacity_factor=64.0)).forward(
                    params, batch, REPLICATED))}
    return out


def _count_expert_collectives(calls: list):
    """Record the spec of every collective over stacked expert partials
    (3-dim: (E, C, d)) in ``calls``."""
    real = moe.comm.apply

    def apply(y, group, spec, policy=None):
        if y.dim() == 3:
            calls.append(spec.shorthand())
        return real(y, group, spec, policy)

    moe.comm.apply = apply


def _tp_rank(ctx, ref: dict) -> dict:
    """One rank at tp=2: each arch's forward under each within-expert
    plan, and how many stacked collectives each forward closed."""
    calls: list = []
    _count_expert_collectives(calls)
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = interop.load_params(ref[arch]["ckpt"], device=CPU)
        trees, _ = compiler.shard_params(cfg, params, ctx.tp)
        tokens = torch.from_numpy(ref[arch]["tokens"]).long()
        for name, coll in PLANS[:1 if arch == "arctic-480b" else None]:
            policy = ExecutionPolicy.from_config(cfg, device=CPU).with_(
                collective=coll, mesh=MeshPlan(tp=ctx.tp))
            eng = Engine(model=build_model(cfg), params=trees[ctx.rank],
                         device=CPU, max_seq=MAX_SEQ, group=ctx.group,
                         policy=policy)
            calls.clear()
            out[arch, name] = (eng.prefill_logits(tokens).numpy(),
                               list(calls))
    return out


def _ep_rank(ctx, ref: dict) -> dict:
    """One process of ``dp2xtp1``: its data rank's rows of each arch's
    batch through half of the experts, at ``capacity_factor=64``; then
    the lockstep greedy ids of its rows (default capacity)."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 3, 2) \
        + 100 * ctx.dp_rank
    comm.wire_bytes.reset()
    y = comm.all_to_all(x, ctx.data_group, split_axis=0, concat_axis=1)
    out = {"a2a": (x, y, comm.wire_bytes.total, comm.all_to_all(
        y, ctx.data_group, split_axis=1, concat_axis=0))}
    rows = slice(2 * ctx.dp_rank, 2 * ctx.dp_rank + 2)
    for arch in ARCHS:
        model = build_model(_cfg(arch, 64.0))
        params = interop.load_params(ref[arch]["ckpt"], device=CPU)
        mine = model.keep_experts(params, ctx.dp, ctx.dp_rank)
        eng = Engine(model=model, params=mine, device=CPU, max_seq=MAX_SEQ,
                     ep_group=ctx.data_group)
        tokens = torch.from_numpy(ref[arch]["tokens"][rows]).long()
        out[arch] = {
            "experts": mine["layers"][0]["moe"]["experts"].up.qweight.shape[0],
            "logits": eng.prefill_logits(tokens).numpy(),
            "ids": Engine(model=build_model(_cfg(arch)), params=mine,
                          device=CPU, max_seq=MAX_SEQ,
                          ep_group=ctx.data_group).generate(
                None, tokens[:, :6], [6, 6], max_new_tokens=6).numpy()}
    return out


@pytest.fixture(scope="module")
def tp_ranks(reference):
    return mesh.run(_tp_rank, 2, reference, device_type="cpu", timeout=240)


@pytest.fixture(scope="module")
def ep_ranks(reference):
    return mesh.run(_ep_rank, 1, reference, device_type="cpu", dp=2,
                    timeout=240)


@pytest.mark.parametrize("arch", ARCHS)
def test_within_expert_tp2_matches_single_device_jax(reference, tp_ranks,
                                                     arch):
    """psum at tp=2 against the reference's single-device forward; the
    ranks agree bit for bit; one collective per MoE layer a forward."""
    layers = get_smoke_config(arch).num_layers
    for r in tp_ranks:
        logits, calls = r[arch, "psum"]
        assert _rel_gap(logits, reference[arch]["logits"]) <= REL_TOL
        assert calls == ["psum"] * layers
    np.testing.assert_array_equal(tp_ranks[0][arch, "psum"][0],
                                  tp_ranks[1][arch, "psum"][0])


def test_within_expert_collective_resolves_from_plan(tp_ranks):
    """``none`` falls back to psum, bit-equal to the psum plan; a
    quantized full-output strategy applies, with a bounded error."""
    arch, layers = ARCHS[0], get_smoke_config(ARCHS[0]).num_layers
    for r in tp_ranks:
        psum = r[arch, "psum"][0]
        none, calls = r[arch, "none"]
        np.testing.assert_array_equal(none, psum)
        assert calls == ["psum"] * layers
        q, calls = r[arch, "int8"]
        assert calls == ["quant-int8:32"] * layers
        err = np.abs(q - psum).max() / np.abs(psum).max()
        assert 0 < err < 5e-2, err


def test_all_to_all_is_the_references_tiled_shuffle(ep_ranks):
    """``comm.all_to_all`` over the data group: ``(E, cap, d)`` ->
    ``(E/D, D*cap, d)``, rank r holding every rank's slice r of dim 0
    joined along dim 1 in rank order (``jax.lax.all_to_all(tiled=True)``);
    back again is the identity; its wire bytes are an all-to-all's."""
    xs = [r["a2a"][0] for r in ep_ranks]
    for r, res in enumerate(ep_ranks):
        x, y, nbytes, back = res["a2a"]
        want = torch.cat([xi[2 * r:2 * r + 2] for xi in xs], dim=1)
        assert torch.equal(y, want)
        assert torch.equal(back, x)
        assert nbytes == x.numel() * 4 / 2


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_dp2_matches_single_device_jax(reference, ep_ranks, arch):
    """Each process holds half of every layer's experts; its rows'
    logits within 5e-3 of the reference's forward with no token dropped
    (capacity factor 64 on both sides)."""
    e = get_smoke_config(arch).num_experts
    for dp_rank, r in enumerate(ep_ranks):
        assert r[arch]["experts"] == e // 2
        want = reference[arch]["logits64"][2 * dp_rank:2 * dp_rank + 2]
        assert _rel_gap(r[arch]["logits"], want) <= REL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_dp2_greedy_ids_equal_one_process(reference, ep_ranks, arch):
    """The two data ranks' lockstep greedy ids are the one-process
    engine's over the whole batch (capacity 4 per expert at 2 and 4
    decode rows: no drop either way)."""
    cfg = _cfg(arch)
    params = interop.load_params(reference[arch]["ckpt"], device=CPU)
    eng = Engine(model=build_model(cfg), params=params, device=CPU,
                 max_seq=MAX_SEQ)
    tokens = torch.from_numpy(reference[arch]["tokens"]).long()
    want = eng.generate(None, tokens[:, :6], [6] * 4,
                        max_new_tokens=6).numpy()
    got = np.concatenate([r[arch]["ids"] for r in ep_ranks])
    np.testing.assert_array_equal(got, want)


def test_dp2xtp2_serves_the_dp1xtp2_ids(tmp_path, capsys):
    """``serve --artifact DIR --mesh dp2xtp2 --temperature 0`` against
    ``--mesh dp1xtp2`` on arctic's tp=2 smoke artifact (its dense MLP at
    tp=2 too): the same ids row for row, and every process of the
    dp2xtp2 grid keeps half of its rank file's expert bytes."""
    import argparse

    from repro_torch.dist.topology import MeshPlan
    from repro_torch.launch import serve

    path = compiler.prepare(_cfg("arctic-480b"), tp=2, seed=0, device=CPU,
                            extra_manifest={"smoke": True}).save(
                                str(tmp_path / "art"))
    rows = {}
    for grid in ("dp1xtp2", "dp2xtp2"):
        args = argparse.Namespace(
            artifact=path, mesh=MeshPlan.parse(grid), tp=2, backend="auto",
            max_new=4, prompt_budget=16, max_batch=4, temperature=0.0,
            seed=0, kv_page_size=None, kv_bits=None)
        rows[grid] = serve._run_mesh(args, CPU)
    out = capsys.readouterr().out
    assert rows["dp2xtp2"] == rows["dp1xtp2"]
    resident = [ln.split("resident_expert_bytes=")[1].split("/")
                for ln in out.splitlines() if "resident_expert_bytes" in ln]
    assert len(resident) == 4
    assert all(2 * int(a) == int(b) for a, b in resident)
