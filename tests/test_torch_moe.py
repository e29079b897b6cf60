"""Port parity of the MoE family (qwen3-moe-235b-a22b, arctic-480b) at
smoke size, on the CPU: JAX params carried across through
``checkpoint.save`` -> ``repro_torch.interop`` (the experts' ``(L, E,
...)`` stack split into per-layer ``(E, ...)`` leaves), then the port's
forward, decode and greedy ids against the reference's, for the tp-aware
plan and the naive act-order one.

* Configs, full and smoke, equal the reference's field for field and by
  ``config_hash``; the experts' group sizes are the reference's.
* Logits within 5e-3 of max|logit| (``tests/test_torch_model.py``'s
  bound); decode is held against the reference's decode, never its
  forward (ROADMAP caveat b).
* The dispatch (router ``idx``, the ``(E, cap, d)`` buffer, the ``keep``
  mask) and the combine equal the reference's ``_dispatch_local`` in a
  case with drops (8 tokens, top-2 over 4 experts: capacity 5).
* fp pages give the dense step's logits bit for bit; the scheduler's
  batched greedy ids equal solo ``Engine.generate`` runs.
* ``prepare`` plans one expert at a time and equals ``Model.init``; a
  JAX-prepared artifact is served by the port, and the port's manifest
  lists the reference's pairs and leaf shards.
* The serve CLI at smoke size for each arch.
* ``gpu``: K1 and K4 at the four full-width expert shapes (skip without
  a card).  Within-expert TP and expert parallelism over gloo ranks:
  ``tests/test_torch_moe_dist.py``.

JAX is imported inside the tests and fixtures that run it."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.reorder import PlannedPair
from repro_torch.kernels import dequant_matmul as tdk
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
SCHEMES = ("tp-aware", "naive-actorder")
REL_TOL = 5e-3
CPU = torch.device("cpu")
MAX_SEQ = 24
GREEDY = SamplingConfig(temperature=0.0)


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
def carried(tmp_path_factory):
    """(arch, scheme) -> (JAX engine, port engine) over the same params,
    each built once."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.runtime.serve import make_engine as jax_make_engine
    from repro.train import checkpoint as jax_checkpoint

    made = {}

    def get(arch, scheme="tp-aware"):
        if (arch, scheme) not in made:
            jeng = jax_make_engine(
                jax_smoke_config(arch).with_quant(scheme=scheme),
                jax.random.PRNGKey(0), max_seq=MAX_SEQ)
            path = jax_checkpoint.save(
                str(tmp_path_factory.mktemp("ckpt") / "p.npz"), jeng.params)
            teng = Engine(
                model=build_model(get_smoke_config(arch).with_quant(
                    scheme=scheme)),
                params=interop.load_params(path, device=CPU), device=CPU,
                max_seq=MAX_SEQ)
            made[arch, scheme] = (jeng, teng)
        return made[arch, scheme]

    return get


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan.artifact import config_hash as jax_hash

    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert part.config_hash(port) == jax_hash(ref)
    model = build_model(get_config(arch))
    assert model.module is moe and model.supports_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_group_sizes_and_k_steps_are_the_references(arch):
    """The full-width experts' group sizes (down: qwen3-moe 96, arctic
    76) and each expert GEMM's K step, whole and at the tp=2 down shard,
    as the reference picks them."""
    from repro.configs import get_config as jax_config
    from repro.kernels.dequant_matmul import pick_block_k as jax_block_k
    from repro.plan import compiler as jax_compiler

    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.moe_dff
    w_up, w_down = (types.SimpleNamespace(shape=s) for s in ((d, ff),
                                                              (ff, d)))
    gs_up, gs_down = compiler._pair_group_sizes(cfg, w_up, w_down)
    assert (gs_up, gs_down) == jax_compiler._pair_group_sizes(
        jax_config(arch), w_up, w_down)
    assert gs_down == {"qwen3-moe-235b-a22b": 96, "arctic-480b": 76}[arch]
    for k, gs in ((d, gs_up), (ff, gs_down), (ff // 2, gs_down)):
        assert tdk.pick_block_k(k, gs) == jax_block_k(k, gs), (k, gs)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_carried_leaves_bit_equal(carried, arch, scheme):
    """Every JAX leaf, the experts' ``(L, E, ...)`` stack included, is
    the port's per-layer leaves stacked again, bit for bit."""
    from repro.train import checkpoint as jax_checkpoint

    jeng, teng = carried(arch, scheme)
    experts = teng.params["layers"][0]["moe"]["experts"]
    assert isinstance(experts, PlannedPair) and experts.scheme == scheme
    assert experts.up.qweight.shape[0] == teng.model.cfg.num_experts
    assert ("dense_mlp" in teng.params["layers"][0]["moe"]) == (
        arch == "arctic-480b")
    have = checkpoint.flatten_keys(interop.to_reference_layout(teng.params))
    want = jax_checkpoint.flatten_keys(jeng.params)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        ref = np.asarray(leaf)
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        got = have[key].numpy()
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


# ---------------------------------------------------------------------------
# the two archs against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(carried, arch, scheme):
    import jax.numpy as jnp
    from repro.models.common import REPLICATED

    jeng, teng = carried(arch, scheme)
    toks = np.random.default_rng(2).integers(
        0, teng.model.cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jeng.model.forward(jeng.params,
                                        {"tokens": jnp.asarray(toks)},
                                        REPLICATED))
    got = teng.model.forward(teng.params,
                             {"tokens": torch.from_numpy(toks).long()},
                             teng.policy).numpy()
    assert got.shape == ref.shape
    assert _rel_gap(got, ref) <= REL_TOL


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_greedy_ids_match_jax(carried, arch, scheme):
    """Lockstep steps, then steps on unequal per-slot positions (the path
    the CUDA graph captures), against the reference's jitted step; then
    greedy generation's ids."""
    import jax
    import jax.numpy as jnp

    jeng, teng = carried(arch, scheme)
    b, steps = 3, 6
    vocab = teng.model.cfg.vocab_size
    toks = np.random.default_rng(1).integers(
        0, vocab, (b, steps)).astype(np.int32)
    for offsets in (np.zeros(b, np.int32), np.array([0, 3, 9], np.int32)):
        jcache, tcache = jeng.init_cache(b), teng.init_cache(b)
        for t in range(steps):
            pos = offsets + t
            ref, jcache = jeng._decode(jeng.params, jcache,
                                       jnp.asarray(toks[:, t]),
                                       jnp.asarray(pos))
            got, tcache = teng.decode(tcache,
                                      torch.from_numpy(toks[:, t]).long(),
                                      torch.from_numpy(pos).long())
            assert _rel_gap(got.numpy(), np.asarray(ref)) <= REL_TOL, (
                offsets, t)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, vocab, (4, 6)).astype(np.int32)
    plen = np.array([6, 4, 5, 3], np.int32)
    ref = np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                   {"tokens": jnp.asarray(prompts)},
                                   jnp.asarray(plen), max_new_tokens=6))
    got = teng.generate(None, torch.from_numpy(prompts).long(),
                        torch.from_numpy(plen), max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, ref)


def test_dispatch_and_combine_equal_the_references_with_drops(carried):
    """8 tokens, top-2 over 4 experts: capacity 5 holds 10 of the 16
    slots at most, so slots are dropped.  The router's choice, the
    ``(E, cap, d)`` buffer and the combine equal the reference's
    ``_dispatch_local``; ``keep`` is the reference's cumsum rule."""
    import jax.numpy as jnp
    from repro.models import moe as jax_moe

    _, teng = carried("qwen3-moe-235b-a22b")
    cfg = teng.model.cfg
    router = teng.params["layers"][0]["moe"]["router"]
    rng = np.random.default_rng(5)
    # tokens near one another pick the same experts and overflow them
    xt = (rng.standard_normal(cfg.d_model) * 4
          + rng.standard_normal((8, cfg.d_model)) * 0.5).astype(np.float32)
    cap = moe._capacity(cfg, 8)
    assert cap == 5
    jbuf, jcombine, (_, jidx) = jax_moe._dispatch_local(
        cfg, jnp.asarray(xt), jnp.asarray(router.numpy()), cap)
    buf, routing, _ = moe.dispatch(cfg, torch.from_numpy(xt), router, cap)
    idx, gate, pos, keep = routing
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    flat = np.asarray(jidx).reshape(-1)
    want_pos = np.array([(flat[:i] == e).sum() for i, e in enumerate(flat)])
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_pos < cap)
    assert not keep.all(), "the case must drop slots"
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    out = rng.standard_normal((cfg.num_experts, cap, cfg.d_model)).astype(
        np.float32)
    np.testing.assert_allclose(
        moe.combine(torch.from_numpy(out), routing, torch.float32).numpy(),
        np.asarray(jcombine(jnp.asarray(out))), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the serving stack over the family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_bit_identical_to_dense(arch):
    """fp pages of 5 (not dividing max_seq 12) give the dense step's
    logits bit for bit over every step of two slots on unequal clocks."""
    from repro_torch.cache.manager import PagedCacheManager
    from repro_torch.cache.spec import PageSpec

    cfg, batch, max_seq, ps = get_smoke_config(arch), 2, 12, 5
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    policy = ExecutionPolicy.from_config(cfg, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (max_seq, batch)))
    mgr = PagedCacheManager(PageSpec(page_size=ps), max_batch=batch,
                            max_seq=max_seq)
    dense = model.init_cache(batch, max_seq, device=CPU)
    pool = model.init_paged_cache(mgr.pool_pages, ps, device=CPU)
    for i in range(batch):
        mgr.admit(i, toks[:1, i].numpy(), max_seq)
    with torch.inference_mode():
        for t in range(max_seq - 3):
            pos = torch.tensor([t, t + 3])
            for i in range(batch):
                mgr.ensure(i, int(pos[i]))
            table = torch.from_numpy(mgr.table())
            ld, _ = model.decode_step(params, dense, toks[t], pos, policy)
            lp, _ = model.decode_step(params, pool, toks[t], pos, policy,
                                      pages=table, kv_len=max_seq)
            np.testing.assert_array_equal(lp.numpy(), ld.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_batch_equals_solo(arch):
    """The scheduler steps the family at token granularity on per-slot
    positions; every request's greedy ids equal a solo
    ``Engine.generate`` of it."""
    eng = make_engine(get_smoke_config(arch), 0, device=CPU, max_seq=MAX_SEQ)
    assert eng.supports_continuous
    rng = np.random.default_rng(4)
    prompts = {i: rng.integers(1, eng.model.cfg.vocab_size,
                               size=n).astype(np.int32)
               for i, n in enumerate((6, 3, 8))}
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=GREEDY)
    for rid, p in prompts.items():
        sched.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
    done = sched.run()
    for rid, p in prompts.items():
        ref = eng.generate(None, torch.from_numpy(p)[None], [p.size],
                           max_new_tokens=5, scfg=GREEDY)[0]
        assert done[rid].output == ref.tolist(), rid


# ---------------------------------------------------------------------------
# the plan: expert-at-a-time init, the artifact
# ---------------------------------------------------------------------------

def test_prepare_is_model_init_one_expert_at_a_time(monkeypatch):
    """``prepare``'s rank r equals ``Model.init(0, tp=2, rank=r)`` bit for
    bit, and its experts are staged one at a time (no stage ever sees two
    experts' raw weights); the manifest records the experts stacked
    ``[L, E]`` at ``layers.moe.experts`` and the dense MLP ``[L]``."""
    cfg = get_smoke_config("arctic-480b")
    staged = []
    real = compiler.compile_params

    def spy(cfg_, node, **kw):
        if isinstance(node, dict) and "w_up" in node:
            staged.append(tuple(node["w_up"].shape))
        return real(cfg_, node, **kw)

    monkeypatch.setattr(compiler, "compile_params", spy)
    art = compiler.prepare(cfg, tp=2, seed=0, device=CPU)
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_dff
    assert staged == [(d, ff)] * (e * cfg.num_layers)
    pairs = {m["path"]: m["stacked"] for m in art.manifest["pairs"]}
    assert pairs == {moe.EXPERTS_PATH: [cfg.num_layers, e],
                     moe.DENSE_MLP_PATH: [cfg.num_layers]}
    for r in (0, 1):
        want = checkpoint.flatten_keys(
            build_model(cfg).init(0, device=CPU, tp=2, rank=r))
        have = checkpoint.flatten_keys(art.rank_tree(r))
        assert sorted(have) == sorted(want)
        for key, t in want.items():
            assert torch.equal(have[key], t), key
    up = art.rank_tree(0)["layers"][0]["moe"]["experts"].up
    assert tuple(up.qweight.shape) == (e, d // 8, ff // 2)


def test_init_keeps_only_its_data_ranks_experts(monkeypatch):
    """``Model.init(ep=2, ep_rank=1)`` stages every expert (the plan
    stream runs as in the whole init) but keeps only data rank 1's half:
    bit for bit ``keep_experts`` of the whole init, here at TP rank 1 of
    2."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    model = build_model(cfg)
    staged = []
    real = compiler.compile_params

    def spy(cfg_, node, **kw):
        if isinstance(node, dict) and "w_up" in node:
            staged.append(tuple(node["w_up"].shape))
        return real(cfg_, node, **kw)

    monkeypatch.setattr(compiler, "compile_params", spy)
    have = checkpoint.flatten_keys(model.init(0, device=CPU, tp=2, rank=1,
                                              ep=2, ep_rank=1))
    monkeypatch.setattr(compiler, "compile_params", real)
    assert len(staged) == cfg.num_experts * cfg.num_layers
    whole = model.init(0, device=CPU, tp=2, rank=1)
    want = checkpoint.flatten_keys(model.keep_experts(whole, 2, 1))
    assert sorted(have) == sorted(want)
    for key, t in want.items():
        assert torch.equal(have[key], t), key


def _jax_prepare(arch: str, tp: int, out: str) -> str:
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.plan import compiler as jax_compiler

    cfg = jax_smoke_config(arch)
    policy = JaxPolicy.from_config(cfg).with_(mesh=JaxMeshPlan(dp=1, tp=tp))
    return jax_compiler.prepare(cfg, tp=tp, seed=0, policy=policy,
                                extra_manifest={"smoke": True}).save(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_artifact_served_by_the_port(arch, tmp_path):
    """A JAX-prepared smoke artifact: the port loads it (the experts'
    stack split per layer), validates it and serves it, logits within
    5e-3 of the JAX engine's on the same files and greedy ids equal; the
    port's own ``prepare`` lists the same pairs and, at tp 1 and 2, the
    same leaf shards."""
    import jax
    import jax.numpy as jnp
    from repro.runtime.serve import make_engine as jax_make_engine

    jdir = _jax_prepare(arch, 1, str(tmp_path / "jax1"))
    cfg = get_smoke_config(arch)
    teng = make_engine(cfg, device=CPU, max_seq=MAX_SEQ, artifact=jdir)
    from repro.configs import get_smoke_config as jax_smoke_config
    jeng = jax_make_engine(jax_smoke_config(arch), max_seq=MAX_SEQ,
                           artifact=jdir)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    got = teng.prefill_logits(torch.from_numpy(toks).long()).numpy()
    ref = np.asarray(jeng.model.forward(
        jeng.params, {"tokens": jnp.asarray(toks)}, jeng.ctx))
    assert _rel_gap(got, ref) <= REL_TOL
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        teng.generate(None, torch.from_numpy(prompts).long(), [6, 6],
                      max_new_tokens=6).numpy(),
        np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                 {"tokens": jnp.asarray(prompts)},
                                 jnp.asarray([6, 6]), max_new_tokens=6)))
    for tp in (1, 2):
        ref_man = (DeploymentArtifact.load_manifest(jdir) if tp == 1 else
                   DeploymentArtifact.load_manifest(
                       _jax_prepare(arch, 2, str(tmp_path / "jax2"))))
        port = compiler.prepare(cfg, tp=tp, seed=0, device=CPU)
        key = lambda m: m["path"]  # noqa: E731
        assert sorted(port.manifest["pairs"], key=key) == sorted(
            ref_man["pairs"], key=key)
        assert port.manifest["leaf_shards"] == ref_man["leaf_shards"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_arch_at_smoke_size(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ARCH --smoke --device
    cpu --requests 2 --max-new 4`` (its ``main``, in this process)."""
    from repro_torch.launch import serve

    outputs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(outputs) == [0, 1]
    assert all(len(o) == 4 for o in outputs.values())
    assert "[scheme=tp-aware backend=torch collective=psum" in out
    assert arch in serve.serve_parser().format_help()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_kernels_at_the_expert_shapes(arch):
    """K1 and K4 at the arch's full-width expert shapes (up/gate and
    down) at M = 4 (an expert's decode capacity) and 8 (a data rank's
    share under expert parallelism at dp=2), against their plain
    versions on the card within 1e-5 of max|ref| + 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import quantization as tqz
    from repro_torch.kernels import ops

    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.moe_dff
    w_up, w_down = (types.SimpleNamespace(shape=s) for s in ((d, ff),
                                                              (ff, d)))
    gs_up, gs_down = compiler._pair_group_sizes(cfg, w_up, w_down)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for k, n, gs in ((d, ff, gs_up), (ff, d, gs_down)):
        q = tqz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                         generator=gen)
        for m in (4, 8):
            x = torch.randn(m, k, generator=gen, device="cuda")
            for ql, plain in (
                    (q.ordered, lambda ql: tdk.dequant_matmul_ordered_torch(
                        x, ql.qweight, ql.scales, ql.zeros, group_size=gs)),
                    (q.naive, lambda ql: tdk.dequant_matmul_gidx_torch(
                        x, ql.qweight, ql.scales, ql.zeros, ql.g_idx))):
                y, ref = ops.dequant_matmul(x, ql), plain(ql)
                err = (y - ref).abs().max().item()
                assert err <= 1e-5 * ref.abs().max().item() + 1e-4, (
                    k, n, m, err)
