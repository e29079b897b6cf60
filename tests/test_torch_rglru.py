"""Port parity of the hybrid family (recurrentgemma-2b) at smoke size, on
the CPU: JAX params carried across through ``checkpoint.save`` ->
``repro_torch.interop`` (the ``super`` and ``extra`` stacks split into
lists), then the port's blocks, forward, decode and greedy ids against
the reference's, and the serving stack over the family.

* The depth: the default smoke config's 2 layers (no superblock: a
  ``super`` stack of length 0, so no attention, and 2 extra layers), 5
  (one superblock and 2 extra), and 3 (one superblock, ``extra`` None)
  with a local window of 8 under 20 decode steps, so the K/V ring
  wraps.
* ``_causal_conv``, ``_rg_lru`` (the decode step and the sequence) and
  the rec block on the same float32 inputs within 1e-5 of max|.|.
* The forward within 5e-3 of max|.|, and 10 decode steps (20 with the
  window of 8), lockstep and on per-slot positions, each from the
  reference's state, in bf16 and in float32 activations; greedy ids
  equal.  Decode is held against the reference's decode only (ROADMAP
  caveat b).
* ``pages=`` is ignored, ``init_paged_cache`` refused, ``reset_slot``
  zeroes one lane of every leaf (the K/V ring's too) in place, and the
  continuous scheduler with slot reuse gives each request its solo
  ``Engine.generate`` ids (and at one slot its logits bit for bit).
* The flash forward (``attn_backend="flash"``, the window of 8) at head
  dim 256 and 64 against the reference's flash forward within 5e-3 of
  max|logit|, and against the einsum one.
* A JAX-prepared tp=1 artifact served by the port, bit-equal to the
  in-memory plan; the port's manifest lists the reference's pair sites
  (stacked ``[0]`` at 2 layers) and leaf shards; ``quantize_model``
  replaces every pair; the serve CLI in memory and from its own
  ``prepare``, at ``--tp 2`` and from a tp=2 ``prepare`` on a
  ``dp2xtp2`` grid (``tests/test_torch_recurrent_tp.py`` holds tp=2 to
  JAX); naive-actorder against tp-aware ids.
* The merged ``LAYER_STACKS`` map: ``super`` shared with the vision
  model at one depth; a prefix at two depths raises."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core.reorder import PlannedPair
from repro_torch.models import rglru, vision_llama
from repro_torch.models.registry import build_model, layer_stacks
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

ARCH = "recurrentgemma-2b"
REL_TOL = 5e-3
BLOCK_TOL = 1e-5
CPU = torch.device("cpu")
MAX_SEQ = 24
GREEDY = SamplingConfig(temperature=0.0)
WRAP = {"num_layers": 3, "local_window": 8}


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np(a) -> np.ndarray:
    import jax.numpy as jnp

    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests: the smoke models' ops
    are tiny, so one thread runs them as fast alone, and it does not
    spin against the other test processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    from repro.configs import get_smoke_config as jax_smoke_config

    return (jax_smoke_config(ARCH).with_(**over),
            get_smoke_config(ARCH).with_(**over))


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(config overrides) -> (JAX engine, port engine) over the same
    params, each built once."""
    import jax
    from repro.models.registry import build_model as jax_build_model
    from repro.runtime.serve import Engine as JaxEngine
    from repro.train import checkpoint as jax_checkpoint

    made = {}

    def get(**over):
        key = tuple(sorted(over.items()))
        if key not in made:
            jcfg, cfg = _cfgs(**over)
            jm = jax_build_model(jcfg)
            jeng = JaxEngine(model=jm,
                             params=jax.jit(jm.init)(jax.random.PRNGKey(0)),
                             max_seq=MAX_SEQ)
            path = jax_checkpoint.save(
                str(tmp_path_factory.mktemp("ckpt") / "p.npz"), jeng.params)
            teng = Engine(model=build_model(cfg),
                          params=interop.load_params(path, device=CPU),
                          device=CPU, max_seq=MAX_SEQ)
            made[key] = (jeng, teng)
        return made[key]

    return get


# ---------------------------------------------------------------------------
# the layer stacks and the params
# ---------------------------------------------------------------------------

def test_layer_stacks_share_super_at_one_depth(monkeypatch):
    """``super`` is stacked by the vision model and by recurrentgemma, one
    dim deep in both; a family stacking a shared prefix at another depth
    raises."""
    from repro_torch.models import registry

    stacks = layer_stacks()
    assert stacks["super"] == 1 and stacks["super.self"] == 2
    assert stacks["extra"] == 1 and stacks["layers"] == 1
    assert rglru.LAYER_STACKS == {"super": 1, "extra": 1}
    assert vision_llama.LAYER_STACKS["super"] == 1
    other = types.SimpleNamespace(__name__="other", LAYER_STACKS={"super": 2})
    monkeypatch.setitem(registry._FAMILY_MODULES, "other", other)
    with pytest.raises(ValueError, match="'super' is 1 dims deep"):
        layer_stacks()


@pytest.mark.parametrize("over", [{"num_layers": 2}, {"num_layers": 5}, WRAP],
                         ids=["2L", "5L", "3L-window8"])
def test_carried_leaves_bit_equal(carried, over):
    """Every JAX leaf is the port's per-layer leaves stacked again; at 2
    layers the ``super`` stack of length 0 is carried as it is (its
    leaves ``(0, ...)``), at 3 ``extra`` is None."""
    from repro.train import checkpoint as jax_checkpoint

    jeng, teng = carried(**over)
    layers = over["num_layers"]
    ns, nx = layers // 3, layers % 3
    sup, extra = teng.params["super"], teng.params["extra"]
    if ns:
        assert isinstance(sup, list) and len(sup) == ns
    else:
        assert isinstance(sup, dict) and rglru.blocks(sup) == []
        assert sup["rec1"]["mlp"].up.qweight.shape[0] == 0
    assert (extra is None) == (nx == 0)
    assert len(rglru.blocks(extra)) == nx
    have = checkpoint.flatten_keys(interop.to_reference_layout(teng.params))
    want = jax_checkpoint.flatten_keys(jeng.params)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        ref = np.asarray(leaf)
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        got = have[key].numpy()
        assert got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


# ---------------------------------------------------------------------------
# the blocks against JAX, on the same float32 inputs
# ---------------------------------------------------------------------------

def test_conv_and_rg_lru_match_jax():
    """``_causal_conv`` from zeros and from a state, and ``_rg_lru``'s
    decode step and its sequence (from zeros and from a state), within
    1e-5 of max|.|."""
    import jax.numpy as jnp
    from repro.models import rglru as jax_rglru

    rng = np.random.default_rng(0)
    b, s, w, cw = 3, 6, 32, 4
    h = rng.standard_normal((b, s, w)).astype(np.float32)
    conv_w = rng.standard_normal((cw, w)).astype(np.float32)
    state = rng.standard_normal((b, cw - 1, w)).astype(np.float32)
    for st in (None, state):
        ref, ref_st = jax_rglru._causal_conv(
            jnp.asarray(h), jnp.asarray(conv_w),
            None if st is None else jnp.asarray(st))
        got, got_st = rglru._causal_conv(
            torch.from_numpy(h), torch.from_numpy(conv_w),
            None if st is None else torch.from_numpy(st))
        assert _rel_gap(got.numpy(), _np(ref)) <= BLOCK_TOL
        np.testing.assert_array_equal(got_st.numpy(), _np(ref_st))
    r, i = (rng.standard_normal((b, s, w)).astype(np.float32)
            for _ in range(2))
    lam = np.linspace(0.9, 5.0, w).astype(np.float32)
    lru = rng.standard_normal((b, w)).astype(np.float32)
    for sl in (slice(0, 1), slice(0, s)):
        for st in (None, lru):
            args = [x[:, sl] for x in (h, r, i)] + [lam]
            ref, ref_st = jax_rglru._rg_lru(
                *map(jnp.asarray, args),
                None if st is None else jnp.asarray(st))
            got, got_st = rglru._rg_lru(
                *map(torch.from_numpy, args),
                None if st is None else torch.from_numpy(st))
            assert got.shape == ref.shape
            assert _rel_gap(got.numpy(), _np(ref)) <= BLOCK_TOL, sl
            assert _rel_gap(got_st.numpy(), _np(ref_st)) <= BLOCK_TOL, sl


@pytest.mark.parametrize("seq,with_state", [(1, True), (5, False)])
def test_rec_block_matches_jax(carried, seq, with_state):
    """The rec block of the first extra layer on the same float32 input:
    one decode step from a state, and a sequence from zeros; output and
    new state within 1e-5 of max|.|."""
    import jax
    import jax.numpy as jnp
    from repro.models import rglru as jax_rglru

    jeng, teng = carried(num_layers=5)
    cfg = teng.model.cfg
    ref_p = jax.tree_util.tree_map(lambda a: a[0], jeng.params["extra"])
    got_p = teng.params["extra"][0]
    rng = np.random.default_rng(1)
    w = cfg.lru_width
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((2, cfg.conv_width - 1, w)).astype(
        np.float32), "lru": rng.standard_normal((2, w)).astype(np.float32)}
    ref, ref_st = jax_rglru.rec_block_forward(
        jeng.model.cfg, ref_p["rec"], jnp.asarray(x), jeng.ctx,
        {k: jnp.asarray(v) for k, v in st.items()} if with_state else None)
    got, got_st = rglru.rec_block_forward(
        cfg, got_p["rec"], torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()} if with_state
        else None)
    assert _rel_gap(got.numpy(), _np(ref)) <= BLOCK_TOL
    for key in ("conv", "lru"):
        assert got_st[key].dtype == torch.float32
        assert _rel_gap(got_st[key].numpy(), _np(ref_st[key])) <= BLOCK_TOL


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [{"num_layers": 2}, {"num_layers": 5}, WRAP],
                         ids=["2L", "5L", "3L-window8"])
def test_forward_matches_jax(carried, over):
    """The forward (12 tokens: past the window of 8) in the config's bf16
    and in float32 activations, against the reference's compiled
    forward, within 5e-3 of max|logit|."""
    import jax.numpy as jnp
    from repro.models import rglru as jax_rglru

    jeng, teng = carried(**over)
    cfg = teng.model.cfg
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    for dtype in ("bfloat16", "float32"):
        ref = np.asarray(jax_rglru.forward(
            jeng.model.cfg.with_(dtype=dtype), jeng.params,
            {"tokens": jnp.asarray(toks)}, jeng.ctx))
        got = rglru.forward(cfg.with_(dtype=dtype), teng.params,
                            {"tokens": torch.from_numpy(toks).long()},
                            teng.policy).numpy()
        assert got.shape == ref.shape
        assert _rel_gap(got, ref) <= REL_TOL, dtype


def _held_decode(jeng, teng, toks, offsets, dtype):
    """Step both models over ``toks`` (B, steps) at ``offsets + t`` in
    ``dtype`` activations, each step from the reference's state (copied
    into the port's cache first), the reference's step compiled.  Yields
    (port, JAX) logits and every new state leaf of both."""
    import jax
    import jax.numpy as jnp
    from repro.train import checkpoint as jax_checkpoint

    jcfg = jeng.model.cfg.with_(dtype=dtype)
    jmod = jeng.model.module
    jstep = jax.jit(lambda p, c, tok, pos: jmod.decode_step(
        jcfg, p, c, tok, pos, jeng.ctx))
    eng = dataclasses.replace(
        teng, model=build_model(teng.model.cfg.with_(dtype=dtype)))
    b = toks.shape[0]
    jcache = jeng.model.init_cache(b, MAX_SEQ)
    tcache = eng.init_cache(b)
    for t in range(toks.shape[1]):
        flat = jax_checkpoint.flatten_keys(jcache)
        for key, leaf in checkpoint.flatten_keys(tcache).items():
            leaf.copy_(torch.from_numpy(_np(flat[key])))
        pos = offsets + t
        ref, jcache = jstep(jeng.params, jcache, jnp.asarray(toks[:, t]),
                            jnp.asarray(pos))
        got, tcache = eng.decode(tcache, torch.from_numpy(toks[:, t]).long(),
                                 torch.from_numpy(pos).long())
        flat = jax_checkpoint.flatten_keys(jcache)
        yield got.numpy(), np.asarray(ref), {
            k: (v.float().numpy(), _np(flat[k]))
            for k, v in checkpoint.flatten_keys(tcache).items()}


@pytest.mark.parametrize("over,steps", [({"num_layers": 2}, 10),
                                        ({"num_layers": 5}, 10),
                                        (WRAP, 20)],
                         ids=["2L", "5L", "3L-window8"])
def test_decode_and_greedy_ids_match_jax(carried, over, steps):
    """``steps`` lockstep steps, then as many on unequal per-slot
    positions, in the config's bf16 and in float32 activations, each
    from the reference's state: logits and every state leaf (the K/V
    ring included; with a window of 8 over 20 steps it wraps) within
    5e-3 of max|.|; then ``Engine.generate``'s greedy ids against the
    reference's."""
    import jax
    import jax.numpy as jnp

    jeng, teng = carried(**over)
    cfg = teng.model.cfg
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, steps)).astype(np.int32)
    runs = [(dtype, offsets) for dtype in ("bfloat16", "float32")
            for offsets in (np.zeros(3, np.int32),
                            np.array([0, 2, 3], np.int32))]
    for dtype, offsets in runs:
        for t, (got, ref, states) in enumerate(_held_decode(
                jeng, teng, toks, offsets, dtype)):
            assert _rel_gap(got, ref) <= REL_TOL, (dtype, offsets, t)
            for key, (g, r) in states.items():
                if g.size:
                    assert _rel_gap(g, r) <= REL_TOL, (dtype, offsets, t, key)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    plen = np.array([6, 4], np.int32)
    ref = np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                   {"tokens": jnp.asarray(prompts)},
                                   jnp.asarray(plen), max_new_tokens=6,
                                   scfg=GREEDY))
    got = teng.generate(None, torch.from_numpy(prompts).long(), plen,
                        max_new_tokens=6, scfg=GREEDY).numpy()
    np.testing.assert_array_equal(got, ref)


def test_forward_matches_the_decode_replay():
    """The forward of 12 tokens (5 layers, a window of 8: the ring wraps)
    against the same tokens replayed through the decode step, in float32
    activations and a float32 state, within 2e-2 of max|logit| (the
    reference's bound,
    ``tests/test_models_smoke.py``); ``chip_smoke.py`` holds the same at
    full depth.  (In bf16 the cache's rounding of K and V, which the
    reference's decode makes and its forward does not, moves the logits
    further.)"""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", num_layers=5,
                                       local_window=8)
    eng = make_engine(cfg, 0, device=CPU, max_seq=MAX_SEQ)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 12)))
    full = eng.prefill_logits(toks)
    cache = eng.model.init_cache(2, MAX_SEQ, dtype=torch.float32, device=CPU)
    steps = []
    for t in range(12):
        logits, cache = eng.decode(cache, toks[:, t], t)
        steps.append(logits)
    assert _rel_gap(torch.stack(steps, 1).numpy(), full.numpy()) < 2e-2


# ---------------------------------------------------------------------------
# serving: pages, the lane reset, the scheduler, flash
# ---------------------------------------------------------------------------

def test_pages_ignored_and_paged_cache_refused(carried):
    """The decode step ignores a page table; ``init_paged_cache`` raises;
    a paged policy keeps the dense state."""
    from repro_torch.cache.spec import PageSpec

    _, teng = carried(num_layers=5)
    toks = torch.tensor([3, 7])
    c1, c2 = teng.init_cache(2), teng.init_cache(2)
    with torch.inference_mode():
        for t in range(3):
            a, _ = teng.model.decode_step(teng.params, c1, toks + t,
                                          torch.tensor([t, t]), teng.policy)
            b, _ = teng.model.decode_step(
                teng.params, c2, toks + t, torch.tensor([t, t]), teng.policy,
                pages=torch.zeros((2, 4), dtype=torch.int64), kv_len=MAX_SEQ)
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no paged cache"):
        teng.model.init_paged_cache(8, 4, device=CPU)
    paged = dataclasses.replace(
        teng, policy=teng.policy.with_(kv=PageSpec(page_size=4)))
    assert not paged.uses_page_table


def test_reset_slot_zeroes_one_lane_in_place(carried):
    """``Engine.reset_slot`` zeroes lane ``slot`` of every leaf (conv, LRU
    and the K/V ring of every stack), leaves the other lanes, and keeps
    every leaf's address."""
    _, teng = carried(num_layers=5)
    cache = teng.init_cache(3)
    assert sorted(cache) == ["attn", "extra", "rec1", "rec2"]
    assert cache["rec1"]["conv"].dtype == torch.float32
    assert cache["attn"]["k"].dtype == torch.bfloat16
    with torch.inference_mode():
        for t in range(3):
            teng.decode(cache, torch.tensor([5, 6, 7]) + t, t)
    before = {k: (v.clone(), v.data_ptr())
              for k, v in checkpoint.flatten_keys(cache).items()}
    assert len(before) == 8
    assert all(v[:, 1].abs().sum() > 0 for v, _ in before.values())
    assert teng.reset_slot(cache, 1) is cache
    for key, leaf in checkpoint.flatten_keys(cache).items():
        old, ptr = before[key]
        assert leaf.data_ptr() == ptr, key
        assert not leaf[:, 1].any(), key
        assert torch.equal(leaf[:, [0, 2]], old[:, [0, 2]]), key


def _solo_rows(eng, prompt, max_new):
    rows = []
    step = eng.decode

    def decode(cache, tokens, pos, pages=None):
        logits, cache = step(cache, tokens, pos, pages)
        rows.append(logits[0])
        return logits, cache

    eng.decode = decode
    try:
        ids = eng.generate(None,
                           torch.from_numpy(prompt.astype(np.int64))[None],
                           [prompt.size], max_new_tokens=max_new,
                           scfg=GREEDY)[0]
    finally:
        del eng.decode
    return ids.tolist(), torch.stack(rows[prompt.size - 1:])


def _scheduler_matches_solo(eng, max_batch: int):
    """Four requests at ``max_batch`` slots with unequal
    ``max_new_tokens``: each request's ids equal its solo
    ``Engine.generate``'s, and at one slot its logits rows bit for bit
    (the CPU's plain GEMMs give a row other last bits at another row
    count)."""
    cfg = eng.model.cfg
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 6, 4, 7)]
    new = (2, 8, 3, 4)
    sched = Scheduler(eng, max_batch=max_batch, prompt_budget=8,
                      scfg=GREEDY)
    rows: dict = {}
    step = eng.decode

    def decode(cache, tokens, pos, pages=None):
        logits, cache = step(cache, tokens, pos, pages)
        for i, s in enumerate(sched._slots):
            if s is not None and s.fed + 1 >= s.req.prompt.size:
                rows.setdefault(s.req.rid, []).append(logits[i])
        return logits, cache

    for i, (p, mn) in enumerate(zip(prompts, new)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
    eng.decode = decode
    try:
        done = sched.run()
    finally:
        del eng.decode
    assert any(step > 0 for step, _ in sched.admissions)
    for i, (p, mn) in enumerate(zip(prompts, new)):
        ids, solo = _solo_rows(eng, p, mn)
        assert done[i].output == ids, i
        if max_batch == 1:
            assert torch.equal(torch.stack(rows[i]), solo), i


@pytest.mark.parametrize("over,max_batch", [({"num_layers": 5}, 1),
                                            ({"num_layers": 5}, 2),
                                            (WRAP, 2)],
                         ids=["5L-1slot", "5L-2slots", "3L-window8-2slots"])
def test_scheduler_slot_reuse_bit_identical_to_solo(carried, over,
                                                    max_batch):
    """The continuous scheduler over the recurrent state and the K/V
    ring: a re-admitted lane is reset, so every request's ids (and at one
    slot its logits) are its solo run's; without the reset a reused
    lane's request differs."""
    _, teng = carried(**over)
    assert teng.supports_continuous
    _scheduler_matches_solo(teng, max_batch)
    if max_batch == 1:
        reset = teng.reset_slot
        teng.reset_slot = lambda cache, slot: cache
        try:
            with pytest.raises(AssertionError):
                _scheduler_matches_solo(teng, max_batch)
        finally:
            teng.reset_slot = reset


def test_step_and_the_serving_loop_accept_the_family(carried):
    """``Scheduler.step()`` steps the family at token granularity and the
    HTTP front end's ``EngineLoop`` takes its scheduler."""
    from repro_torch.serving.loop import EngineLoop

    _, teng = carried(num_layers=5)
    sched = Scheduler(teng, max_batch=2, prompt_budget=8, scfg=GREEDY)
    sched.submit(Request(rid=0, prompt=np.arange(1, 4, dtype=np.int32),
                         max_new_tokens=2))
    events = []
    while sched.has_work:
        events += sched.step()
    assert [e.final for e in events] == [False, True]
    EngineLoop(Scheduler(teng, max_batch=2))


@pytest.mark.parametrize("over", [dict(WRAP, head_dim=256),
                                  dict(WRAP, head_dim=64)],
                         ids=["3L-window8-d256", "3L-window8-d64"])
def test_flash_forward_matches_jax_flash_forward(carried, over):
    """The forward with ``attn_backend="flash"`` at the config's head dim
    256 (MQA) and at 64, 12 tokens past the window of 8, in bf16 and
    float32 activations, against the reference's flash forward (its Pallas
    kernel in interpret mode) within 5e-3 of max|logit|, as the einsum
    forward is held; the flash forward also equals the port's einsum one
    within that bound."""
    import jax.numpy as jnp
    from repro.models import rglru as jax_rglru

    jeng, teng = carried(**over)
    cfg = teng.model.cfg
    jctx = dataclasses.replace(jeng.ctx, attn_backend="flash")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    for dtype in ("bfloat16", "float32"):
        ref = np.asarray(jax_rglru.forward(
            jeng.model.cfg.with_(dtype=dtype), jeng.params,
            {"tokens": jnp.asarray(toks)}, jctx))
        batch = {"tokens": torch.from_numpy(toks).long()}
        got = rglru.forward(cfg.with_(dtype=dtype), teng.params, batch,
                            teng.policy, attn_backend="flash").numpy()
        assert got.shape == ref.shape
        assert _rel_gap(got, ref) <= REL_TOL, dtype
        xla = rglru.forward(cfg.with_(dtype=dtype), teng.params, batch,
                            teng.policy).numpy()
        assert _rel_gap(got, xla) <= REL_TOL, dtype


# ---------------------------------------------------------------------------
# the plan: the JAX artifact, the manifest, quantize_model, the CLI
# ---------------------------------------------------------------------------

def _jax_plan(jcfg, tmp_path):
    """The reference's tp=1 artifact of its raw init from seed 0 (compiled
    under ``jit``, a fraction of its eager time) through its
    ``compile_plan``, and ``compile_params`` of the same raw tree and
    plan stream (what its ``Model.init`` serves): (artifact, the in-memory
    plan saved as a checkpoint)."""
    import jax
    from repro.models.registry import build_model as jax_build_model
    from repro.plan import compiler as jax_compiler
    from repro.train import checkpoint as jax_checkpoint

    key = jax.random.PRNGKey(0)
    raw = jax.jit(jax_build_model(jcfg).init_raw)(key)
    rng = jax.random.fold_in(key, jax_compiler.PLAN_RNG_STREAM)
    art = jax_compiler.compile_plan(jcfg, raw, tp=1, rng=rng, seed=0)
    path = jax_checkpoint.save(str(tmp_path / "plan.npz"),
                               jax_compiler.compile_params(jcfg, raw,
                                                           rng=rng))
    return art, path


def test_jax_artifact_served_by_the_port(tmp_path):
    """A JAX-prepared tp=1 artifact of the default smoke config (2 layers:
    the ``super`` stack of length 0, and 2 extra layers, so every pair
    site): the port loads and serves it, its params and logits bit-equal
    to the in-memory plan (the reference's plan of the same raw tree,
    carried across); the port's own prepare lists the reference's pair
    sites, stacked shapes (``super``'s ``[0]``) and leaf shards, and its
    saved files load back bit-equal."""
    layers = 2
    jcfg, cfg = _cfgs(num_layers=layers)
    jart, path = _jax_plan(jcfg, tmp_path)
    jdir = jart.save(str(tmp_path / "jax"))
    teng = Engine(model=build_model(cfg), device=CPU, max_seq=MAX_SEQ,
                  params=interop.load_params(path, device=CPU))
    served = make_engine(cfg, device=CPU, max_seq=MAX_SEQ, artifact=jdir)
    have = checkpoint.flatten_keys(served.params)
    want = checkpoint.flatten_keys(teng.params)
    assert sorted(have) == sorted(want)
    assert all(torch.equal(have[k], t) for k, t in want.items())
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 5)))
    c1, c2 = served.init_cache(2), teng.init_cache(2)
    for t in range(5):
        a, _ = served.decode(c1, toks[:, t], t)
        b, _ = teng.decode(c2, toks[:, t], t)
        assert torch.equal(a, b), t
    port = compiler.prepare(cfg, tp=1, seed=0, device=CPU)
    key = lambda m: m["path"]  # noqa: E731
    pairs = port.manifest["pairs"]
    assert sorted(pairs, key=key) == sorted(jart.manifest["pairs"], key=key)
    ns, nx = layers // 3, layers % 3
    assert {m["path"]: m["stacked"] for m in pairs} == {
        "super.rec1.mlp": [ns], "super.rec2.mlp": [ns],
        "super.attn.mlp": [ns], "extra.mlp": [nx]}
    assert port.manifest["leaf_shards"] == jart.manifest["leaf_shards"]
    back = part.DeploymentArtifact.load(port.save(str(tmp_path / "port")),
                                        device=CPU)
    flat = checkpoint.flatten_keys(back.rank_tree(0))
    assert all(torch.equal(flat[k], t) for k, t in checkpoint.flatten_keys(
        port.rank_tree(0)).items())


def test_quantize_model_replaces_every_pair():
    """``quant/gptq.quantize_model`` on the raw params replaces every MLP
    pair, at 2 layers those of the ``super`` stack of length 0 too (a
    pair of ``(0, ...)`` leaves), at 3 and 5 each superblock's three and
    each extra layer's."""
    from repro_torch.quant.gptq import quantize_model

    for layers in (2, 3, 5):
        cfg = get_smoke_config(ARCH).with_(num_layers=layers).with_quant(
            mode="none")
        raw = build_model(cfg).init_raw(0, device=CPU)
        q = quantize_model(cfg.with_quant(mode="mlp"), raw)
        found = []

        def walk(node):
            if isinstance(node, PlannedPair):
                found.append(node)
            elif isinstance(node, dict):
                assert not compiler._is_mlp_dict(node)
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)

        walk(q)
        ns, nx = layers // 3, layers % 3
        assert len(found) == 3 * max(ns, 1) + nx, layers
        assert all(pp.scheme == "tp-aware" and pp.gate is not None
                   for pp in found)


def test_cli_in_memory_from_its_artifact_and_at_tp2(tmp_path, capsys):
    """``--arch recurrentgemma-2b --smoke --device cpu``: served by the
    continuous scheduler; ``prepare`` then ``--artifact`` gives the same
    ids, and so does ``--tp 2`` (two gloo ranks); ``--mesh dp1xtp2``
    gives ``--mesh dp1xtp1``'s lockstep rows, and so does ``prepare --tp
    2`` then ``--artifact`` on a ``--mesh dp2xtp2`` grid."""
    from repro_torch.launch import serve

    base = ["--device", "cpu", "--requests", "3", "--max-new", "4"]
    want = serve.main(["--arch", ARCH, "--smoke"] + base)
    assert sorted(want) == [0, 1, 2]
    out = str(tmp_path / "art")
    serve.main(["prepare", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--out", out])
    assert serve.main(["--artifact", out] + base) == want
    assert "decode step: eager (cpu)" in capsys.readouterr().out
    assert serve.main(["--arch", ARCH, "--smoke", "--tp", "2"] + base) == want
    assert "decode step: eager (tp=2 over gloo)" in capsys.readouterr().out
    lock = ["--device", "cpu", "--temperature", "0", "--max-new", "4"]
    rows = serve.main(["--arch", ARCH, "--smoke", "--mesh", "dp1xtp1"] + lock)
    assert serve.main(["--arch", ARCH, "--smoke", "--mesh", "dp1xtp2"]
                      + lock) == rows
    tp2 = str(tmp_path / "tp2")
    serve.main(["prepare", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--tp", "2", "--out", tp2])
    assert serve.main(["--artifact", tp2, "--mesh", "dp2xtp2"] + lock) == rows
    assert "mesh=dp2xtp2 process=3/4 resident_artifact_bytes=" in \
        capsys.readouterr().out


def test_naive_actorder_gives_the_tp_aware_ids():
    """The naive act-order plan and the tp-aware plan of the same seed:
    greedy ids equal."""
    cfg = get_smoke_config(ARCH).with_(num_layers=5)
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6)))
    ids = [make_engine(cfg.with_quant(scheme=s), 0, device=CPU,
                       max_seq=MAX_SEQ).generate(None, prompts, [6, 5],
                                                 max_new_tokens=6,
                                                 scfg=GREEDY)
           for s in ("tp-aware", "naive-actorder")]
    assert torch.equal(ids[0], ids[1])
