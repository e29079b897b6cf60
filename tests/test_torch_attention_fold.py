"""The attention V->O fold in the port (``core/attention_fold.py``; its
consumption in ``models/common.py``, ``models/transformer.py`` and
``runtime/serve.py``) against the reference, on the CPU.

Inputs are made from a seed with numpy (or, for a plan's draws, taken
from the reference: its row importance and V's processing order).
Tolerances:

* ``constrained_row_order`` and ``plan_attention_vo`` leaves bit-equal
  given the reference's importance and V order;
* ``attention_vo_reference``, and ``attention_forward`` /
  ``attention_decode`` with ``vo=`` (float32 input, dense cache), within
  1e-4 of max|y| (``tests/test_attention_fold.py``'s bound), as is the
  fold against its effective dense weights;
* the smoke qwen3-4b model and engine through a fold (bfloat16 carry,
  dense and paged caches) within 5e-3 of max|logit| over 10 decode
  steps (``tests/test_torch_model.py``'s bound), greedy ids equal.  The
  reference's step is run un-jitted there: through a fold its bfloat16
  carry rounds V and the attention output to bfloat16, and under ``jit``
  XLA on the CPU drops some of those roundings (it simplifies a
  float32 -> bfloat16 -> float32 convert pair), so its jitted step
  drifts from its own un-jitted one past this bound at some steps, where
  the port agrees with the un-jitted one to float32 rounding.

The ``gpu`` tests (they skip here) hold K1 at the full-width fold's V
and O shapes against its plain version, and the captured fold step bit
for bit to ``decode_eager``: ``python -m pytest -q -m gpu
tests/test_torch_attention_fold.py``."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import attention_fold as af
from repro_torch.core import quantization as qz
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.reorder import PlannedPair
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.runtime.serve import make_engine
from repro_torch.train import checkpoint

CPU = torch.device("cpu")
VO_TOL = 1e-4
REL_TOL = 5e-3
MAX_SEQ = 24


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _to_port(pp) -> PlannedPair:
    """A reference ``PlannedPair`` as the port's (packed words as int32
    bit views)."""
    def ql(j):
        return qz.QuantizedLinear(
            qweight=_t(np.asarray(j.qweight).view(np.int32)),
            scales=_t(j.scales), zeros=_t(j.zeros), g_idx=None,
            group_size=j.group_size, kind=j.kind)

    return PlannedPair(up=ql(pp.up), gate=None, down=ql(pp.down),
                       p1_up=_t(pp.p1_up), p1_gate=None, p2=_t(pp.p2),
                       scheme=pp.scheme)


def _jax_plan(h, kv, hd, d, gs, seed):
    """(raw numpy weights, the reference's draws, its plan)."""
    import jax
    from repro.core import attention_fold as jaf

    rng = np.random.default_rng(seed)
    w_v = rng.standard_normal((d, kv * hd)).astype(np.float32)
    w_o = rng.standard_normal((h * hd, d)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    draws = {"importance_o": _t(jax.random.uniform(key, (h * hd,))),
             "proc_order_v": _t(jax.random.permutation(key, d))}
    pp = jaf.plan_attention_vo(w_v, w_o, n_heads=h, n_kv_heads=kv,
                               head_dim=hd, group_size=gs, rng=key)
    return w_v, w_o, draws, pp


def _assert_pair_equal(got: PlannedPair, ref):
    from repro.train import checkpoint as jcheckpoint

    want = {k: np.asarray(v)
            for k, v in jcheckpoint.flatten_keys(ref).items()}
    have = checkpoint.flatten_keys(got)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        arr = have[key].numpy()
        if leaf.dtype == np.uint32:
            arr = arr.view(np.uint32)
        assert arr.dtype == leaf.dtype, key
        np.testing.assert_array_equal(arr, leaf, err_msg=key)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kv,hd", [(8, 2, 32), (4, 4, 16), (8, 1, 32)])
def test_constrained_row_order_bit_equal(h, kv, hd):
    from repro.core import attention_fold as jaf

    imp = np.random.default_rng(h + kv).random(h * hd).astype(np.float32)
    order, pi = af.constrained_row_order(
        torch.from_numpy(imp), n_heads=h, n_kv_heads=kv, head_dim=hd)
    jorder, jpi = jaf.constrained_row_order(imp, n_heads=h, n_kv_heads=kv,
                                            head_dim=hd)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    assert order.dtype == torch.int32 and pi.dtype == torch.int32
    for head in range(h):                    # never leaves its block
        assert (order[head * hd:(head + 1) * hd] // hd == head).all()


@pytest.mark.parametrize("h,kv,hd,gs", [(8, 2, 32, 32), (4, 4, 16, 16),
                                        (8, 1, 32, 32), (4, 2, 32, 16),
                                        (4, 2, 16, 64)])
def test_plan_attention_vo_leaves_bit_equal(h, kv, hd, gs):
    w_v, w_o, draws, ref = _jax_plan(h, kv, hd, 64, gs, seed=h * 10 + kv)
    got = af.plan_attention_vo(torch.from_numpy(w_v), torch.from_numpy(w_o),
                               n_heads=h, n_kv_heads=kv, head_dim=hd,
                               group_size=gs, **draws)
    assert got.scheme == "tp-aware" and got.gate is None
    _assert_pair_equal(got, ref)


def test_plan_attention_vo_draws_and_refusals():
    """Without explicit draws the plan comes from the generator (the same
    seed, the same plan); a group size that crosses head blocks and a
    mismatched W_o raise as in the reference."""
    rng = np.random.default_rng(0)
    w_v = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    w_o = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=32, group_size=32)
    a = af.plan_attention_vo(w_v, w_o, generator=torch.Generator()
                             .manual_seed(3), **kw)
    b = af.plan_attention_vo(w_v, w_o, generator=torch.Generator()
                             .manual_seed(3), **kw)
    c = af.plan_attention_vo(w_v, w_o, generator=torch.Generator()
                             .manual_seed(4), **kw)
    fa, fb, fc = (checkpoint.flatten_keys(p) for p in (a, b, c))
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa["p1_up"], fc["p1_up"])
    assert not torch.equal(fa["up||qweight"], fc["up||qweight"])
    with pytest.raises(ValueError, match="tile head_dim"):
        af.plan_attention_vo(w_v, w_o, n_heads=4, n_kv_heads=2, head_dim=32,
                             group_size=48)
    with pytest.raises(ValueError, match="H\\*hd"):
        af.plan_attention_vo(w_v, w_o[:64], **kw)


@pytest.mark.parametrize("h,kv,hd", [(8, 2, 32), (4, 4, 16), (8, 1, 32)])
def test_attention_vo_reference_matches_jax(h, kv, hd):
    from repro.core import attention_fold as jaf

    d, b, s = 64, 2, 6
    _, _, _, ref = _jax_plan(h, kv, hd, d, hd, seed=h * 10 + kv)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    sc = rng.standard_normal((b, h, s, s)).astype(np.float32)
    aw = np.exp(sc) / np.exp(sc).sum(-1, keepdims=True)
    want = np.asarray(jaf.attention_vo_reference(
        x, None, aw, ref, n_heads=h, n_kv_heads=kv, head_dim=hd))
    got = af.attention_vo_reference(
        torch.from_numpy(x), None, torch.from_numpy(aw), _to_port(ref),
        n_heads=h, n_kv_heads=kv, head_dim=hd).numpy()
    assert np.abs(got - want).max() <= VO_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# the fold inside the model's attention
# ---------------------------------------------------------------------------

def _smoke_attention():
    """(cfg, numpy attention params of qwen3-4b smoke, the reference's
    fold of them, the port's copy of that fold)."""
    import jax
    from repro.core import attention_fold as jaf

    cfg = get_smoke_config("qwen3-4b")
    p = cm.attention_params(cfg, torch.Generator().manual_seed(0))
    p = {k: v.numpy() for k, v in p.items()}
    kvp, _, hp = cm.head_grid(cfg)
    gs = qz.choose_group_size(cfg.head_dim, cfg.quant.group_size)
    vo = jaf.plan_attention_vo(p["wv"], p["wo"], n_heads=hp, n_kv_heads=kvp,
                               head_dim=cfg.head_dim, group_size=gs,
                               rng=jax.random.PRNGKey(7))
    return cfg, p, vo, _to_port(vo)


def _effective_dense(vo: PlannedPair):
    """The fold's closed function as dense weights (x @ scatter_rows(W_up,
    p1), then W_down)."""
    wv = qz.dequantize(vo.up)
    back = torch.empty_like(wv)
    back[vo.p1_up.long()] = wv
    return back, qz.dequantize(vo.down)


def test_attention_with_vo_matches_jax():
    """``attention_forward`` and ``attention_decode`` (lockstep and
    per-slot positions, four steps into a dense cache) with ``vo=``
    against the reference's, and against the port's own dense attention
    on the fold's effective weights; the cache holds the folded V."""
    import jax.numpy as jnp
    from repro.models import common as jcm
    from repro.models.common import REPLICATED

    cfg, p, jvo, vo = _smoke_attention()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    policy = ExecutionPolicy()
    x = np.random.default_rng(3).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    want = np.asarray(jcm.attention_forward(cfg, p, x, REPLICATED, vo=jvo))
    got = cm.attention_forward(cfg, tp, torch.from_numpy(x), vo=vo,
                               policy=policy).numpy()
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= VO_TOL * scale
    wv, wo = _effective_dense(vo)
    eff = cm.attention_forward(cfg, dict(tp, wv=wv, wo=wo),
                               torch.from_numpy(x)).numpy()
    assert np.abs(got - eff).max() <= VO_TOL * scale

    kvp, hd = cm.head_grid(cfg)[0], cfg.head_dim
    jcache = {"k": jnp.zeros((2, 8, kvp, hd)), "v": jnp.zeros((2, 8, kvp, hd))}
    caches = {kind: {"k": torch.zeros(2, 8, kvp, hd),
                     "v": torch.zeros(2, 8, kvp, hd)}
              for kind in ("lockstep", "per-slot")}
    for t in range(4):
        xt = x[:, t:t + 1]
        want, jcache = jcm.attention_decode(cfg, p, xt, jcache, jnp.int32(t),
                                            REPLICATED, vo=jvo)
        want = np.asarray(want)
        for kind, cache in caches.items():
            pos = t if kind == "lockstep" else torch.full((2,), t)
            got, _ = cm.attention_decode(cfg, tp, torch.from_numpy(xt),
                                         cache, pos, vo=vo, policy=policy)
            assert np.abs(got.numpy() - want).max() <= VO_TOL * scale, \
                (kind, t)
    for cache in caches.values():
        np.testing.assert_allclose(cache["v"].numpy(),
                                   np.asarray(jcache["v"]), atol=1e-4)
    assert torch.equal(caches["lockstep"]["v"], caches["per-slot"]["v"])


def test_flash_forward_with_vo():
    """The flash path (its plain version on the CPU) takes the folded V:
    the einsum path's output within the float32 tolerance."""
    cfg, p, _, vo = _smoke_attention()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    policy = ExecutionPolicy()
    ein = cm.attention_forward(cfg, tp, x, vo=vo, policy=policy)
    fl = cm.attention_forward(cfg, tp, x, vo=vo, policy=policy,
                              attn_backend="flash")
    assert ein.dtype == fl.dtype == torch.bfloat16
    assert (fl.float() - ein.float()).abs().max() <= \
        1e-2 * ein.float().abs().max()


@pytest.mark.parametrize("tp", [2])
def test_rank_slices_of_the_fold_sum_to_the_whole(tp):
    """``shard_attention_vo`` keeps each rank's heads: the ranks' partial
    output projections (attention on each rank's slices of the params
    and the fold, float32 input) add up to the one-device output."""
    cfg, p, _, vo = _smoke_attention()
    tp_p = {k: torch.from_numpy(v) for k, v in p.items()}
    kvp, _, hp = cm.head_grid(cfg)
    specs = cm.attention_specs(cfg, tp_p, tp)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    policy = ExecutionPolicy()
    whole = cm.attention_forward(cfg, tp_p, x, vo=vo, policy=policy)
    shards = af.shard_attention_vo(vo, tp, n_heads=hp, n_kv_heads=kvp,
                                   head_dim=cfg.head_dim)
    total = 0
    for r, vo_r in enumerate(shards):
        p_r = {k: (v if specs[k] is None else v.chunk(tp, specs[k])[r])
               for k, v in tp_p.items()}
        total = total + cm.attention_forward(cfg, p_r, x, vo=vo_r,
                                             policy=policy)
        assert vo_r.up.n == kvp // tp * cfg.head_dim
        assert vo_r.down.k == hp // tp * cfg.head_dim
    assert (total - whole).abs().max() <= 1e-5 * whole.abs().max()
    with pytest.raises(ValueError, match="do not split"):
        af.shard_attention_vo(vo, 3, n_heads=hp, n_kv_heads=kvp,
                              head_dim=cfg.head_dim)


# ---------------------------------------------------------------------------
# the model and the engine through a fold artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fold(tmp_path_factory):
    """The reference's tp=1 fold artifact of qwen3-4b smoke (seed 0), and
    its engine."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import compiler as jcompiler
    from repro.runtime.serve import make_engine as jax_make_engine

    cfg = jax_smoke_config("qwen3-4b").with_quant(attn_tp_aware=True)
    path = jcompiler.prepare(cfg, tp=1, seed=0, extra_manifest={
        "smoke": True}).save(str(tmp_path_factory.mktemp("jfold")))
    jeng = jax_make_engine(cfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ,
                           artifact=path)
    return path, jeng


def _fold_cfg():
    return get_smoke_config("qwen3-4b").with_quant(attn_tp_aware=True)


def _jax_step(jeng, cache, tok, pos, pages=None):
    """The reference's decode step through its fold, un-jitted (see the
    module docstring)."""
    import jax
    import jax.numpy as jnp

    with jax.disable_jit():
        logits, cache = jeng.model.decode_step(
            jeng.params, cache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32),
            jeng.ctx, pages=None if pages is None else jnp.asarray(pages),
            aux=jeng.aux)
    return np.asarray(logits), cache


def test_engine_serves_jax_fold_artifact_like_jax(jax_fold):
    """The port's engine on the reference's fold artifact: the aux folds
    kept per layer, greedy ids of ``generate`` equal, and 10 decode steps
    within 5e-3 of max|logit|; the fold changes the logits."""
    import jax
    import jax.numpy as jnp

    path, jeng = jax_fold
    teng = make_engine(_fold_cfg(), device="cpu", max_seq=MAX_SEQ,
                       artifact=path)
    vos = teng.aux["attn_plans"]["layers.attn"]
    assert isinstance(vos, list) and len(vos) == teng.model.cfg.num_layers
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (4, 8)).astype(np.int32)
    plen = np.array([8, 5, 7, 6], np.int32)
    ref = np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                   {"tokens": jnp.asarray(toks)},
                                   jnp.asarray(plen), max_new_tokens=8))
    got = teng.generate(None, torch.from_numpy(toks).long(),
                        torch.from_numpy(plen), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, ref)

    plain = make_engine(_fold_cfg(), device="cpu", max_seq=MAX_SEQ)
    jcache, tcache, pcache = (jeng.init_cache(3), teng.init_cache(3),
                              plain.init_cache(3))
    for t in range(10):
        tok = rng.integers(0, 512, 3).astype(np.int32)
        want, jcache = _jax_step(jeng, jcache, tok, t)
        have, tcache = teng.decode(tcache, torch.from_numpy(tok).long(), t)
        other, pcache = plain.decode(pcache, torch.from_numpy(tok).long(), t)
        assert np.abs(have.numpy() - want).max() <= \
            REL_TOL * np.abs(want).max(), t
        np.testing.assert_array_equal(have.numpy().argmax(-1),
                                      want.argmax(-1))
        assert not torch.equal(have, other)

    toks = torch.from_numpy(rng.integers(0, 512, (2, 12)))
    with jax.disable_jit():
        want = np.asarray(jeng.model.forward(
            jeng.params, {"tokens": jnp.asarray(toks.numpy())}, jeng.ctx,
            aux=jeng.aux))
    have = teng.prefill_logits(toks).numpy()
    assert np.abs(have - want).max() <= REL_TOL * np.abs(want).max()


def test_paged_decode_with_fold_matches_jax(jax_fold):
    """Ten paged steps (page size 4, two slots on unequal clocks) through
    the fold: the reference's paged step within 5e-3 of max|logit|,
    greedy ids equal, and the port's dense step's bits."""
    from repro_torch.cache.manager import PagedCacheManager
    from repro_torch.cache.spec import PageSpec

    path, jeng = jax_fold
    teng = make_engine(_fold_cfg(), device="cpu", max_seq=16, artifact=path)
    jmodel = jeng.model
    ps, batch, max_seq = 4, 2, 16
    mgr = PagedCacheManager(PageSpec(page_size=ps), max_batch=batch,
                            max_seq=max_seq)
    for i in range(batch):
        mgr.admit(i, np.zeros(1, np.int32), max_seq - 1)
    pool = teng.model.init_paged_cache(mgr.pool_pages, ps, device=CPU)
    dense = teng.init_cache(batch)
    jpool = jmodel.init_paged_cache(batch, mgr.pool_pages, ps)
    toks = np.random.default_rng(3).integers(0, 512, (10, batch))
    for t in range(10):
        pos = np.array([t, t + 3])
        for i in range(batch):
            mgr.ensure(i, int(pos[i]))
        table = mgr.table()
        got, _ = teng.decode_eager(pool, torch.from_numpy(toks[t]),
                                   torch.from_numpy(pos),
                                   pages=torch.from_numpy(table))
        dgot, _ = teng.decode_eager(dense, torch.from_numpy(toks[t]),
                                    torch.from_numpy(pos))
        assert torch.equal(got, dgot), t
        want, jpool = _jax_step(jeng, jpool, toks[t], pos, table)
        assert np.abs(got.numpy() - want).max() <= \
            REL_TOL * np.abs(want).max(), t
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))


def test_model_takes_stacked_or_per_layer_folds(jax_fold):
    """``Model.forward`` runs the aux tree as the artifact holds it
    (stacked) and as the engine keeps it (per layer) to the same bits;
    a fold of the wrong depth raises."""
    from repro_torch.plan.artifact import DeploymentArtifact

    path, _ = jax_fold
    art = DeploymentArtifact.load(path, device="cpu")
    model = build_model(_fold_cfg())
    params = art.params()
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, 512, (2, 6)))}
    policy = ExecutionPolicy()
    stacked = model.forward(params, batch, policy, aux=art.aux)
    teng = make_engine(_fold_cfg(), device="cpu", artifact=path)
    per_layer = model.forward(params, batch, policy, aux=teng.aux)
    assert torch.equal(stacked, per_layer)
    assert not torch.equal(stacked, model.forward(params, batch, policy))
    short = {"attn_plans": {"layers.attn": teng.aux["attn_plans"][
        "layers.attn"][:1]}}
    with pytest.raises(ValueError, match="1 layers"):
        model.forward(params, batch, policy, aux=short)
    assert model.supports_attn_vo and model.attn_vo_path == "layers.attn"


def test_port_fold_stage_plans_every_layer():
    """``stage_fold_attention`` plans each layer's attention over the
    padded head grid, stacked as the reference's aux; the same seed gives
    the same folds, and a config without ``attn_tp_aware`` none."""
    cfg = _fold_cfg()
    raw = build_model(cfg).init_raw(0, device="cpu")
    plans = compiler.stage_fold_attention(cfg, raw,
                                          compiler.fold_generator(0))
    again = compiler.stage_fold_attention(cfg, raw,
                                          compiler.fold_generator(0))
    assert list(plans) == ["layers.attn"]
    pp = plans["layers.attn"]
    kvp, _, hp = cm.head_grid(cfg)
    assert tuple(pp.up.qweight.shape) == (cfg.num_layers, cfg.d_model // 8,
                                          kvp * cfg.head_dim)
    assert tuple(pp.down.qweight.shape) == (cfg.num_layers,
                                            hp * cfg.head_dim // 8,
                                            cfg.d_model)
    fa, fb = (checkpoint.flatten_keys(p["layers.attn"])
              for p in (plans, again))
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert compiler.stage_fold_attention(
        get_smoke_config("qwen3-4b"), raw, compiler.fold_generator(0)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _fold_shapes(cfg) -> list:
    """(name, K, N, group size) of the fold's V and O GEMMs at ``cfg``."""
    kvp, _, hp = cm.head_grid(cfg)
    hd = cfg.head_dim
    gs = qz.choose_group_size(hd, cfg.quant.group_size)
    return [("V", cfg.d_model, kvp * hd,
             qz.choose_group_size(cfg.d_model, gs)),
            ("O", hp * hd, cfg.d_model, qz.choose_group_size(hd, gs))]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 2048])
def test_k1_at_the_fold_shapes_matches_plain_version(m):
    """K1 at full-width qwen3-4b's fold shapes (V: K 2560, N 1024; O:
    K 4096, N 2560; groups of 128) against its plain version, float32,
    within 1e-5 of max|ref| (its decode loop at M 4, its tensor-core loop
    at M 2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import dequant_matmul as tdk
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    assert [s[1:] for s in _fold_shapes(get_config("qwen3-4b"))] == [
        (2560, 1024, 128), (4096, 2560, 128)]
    for _, k, n, gs in _fold_shapes(get_config("qwen3-4b")):
        w = torch.randn(k, n, generator=gen, device="cuda")
        ql = qz.quantize(w, gs, generator=gen).ordered
        x = torch.randn(m, k, generator=gen, device="cuda")
        launches = tdk.dequant_matmul_ordered.launches
        y = ops.dequant_matmul(x, ql)
        torch.cuda.synchronize()
        assert tdk.dequant_matmul_ordered.launches == launches + 1
        ref = tdk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=gs)
        err = (y - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item() + 1e-4, (k, n, m, err)


@pytest.mark.gpu
def test_captured_fold_step_equals_eager_step(tmp_path):
    """A fold artifact prepared and served on the card: each captured
    step gives ``decode_eager``'s logits and cache bit for bit, and a step
    launches K1 for the MLP and for V and O (5 a layer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import dequant_matmul as tdk

    cfg = _fold_cfg()
    path = compiler.prepare(cfg, tp=1, seed=0, extra_manifest={
        "smoke": True}).save(str(tmp_path / "fold"))
    eng = make_engine(cfg, device="cuda", max_seq=MAX_SEQ, artifact=path)
    assert eng.policy.backend == "cuda"
    graph_cache, eager_cache = eng.init_cache(3), eng.init_cache(3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (8, 3))).cuda()
    for t, tok in enumerate(toks):
        pos = torch.tensor([t, t + 1, t + 2], device="cuda")
        before = tdk.dequant_matmul_ordered.launches
        got, _ = eng.decode(graph_cache, tok, pos)
        if t:
            assert tdk.dequant_matmul_ordered.launches - before == \
                5 * cfg.num_layers
        want, _ = eng.decode_eager(eager_cache, tok, pos)
        assert torch.equal(got, want), t
        for name in ("k", "v"):
            assert torch.equal(graph_cache[name], eager_cache[name]), t
    assert eng.captures == 1
