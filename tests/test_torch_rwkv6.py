"""Port parity of the ssm family (rwkv6-3b) at smoke size, on the CPU: JAX
params carried across through ``checkpoint.save`` ->
``repro_torch.interop`` (the ``layers`` stack split into a list), then
the port's blocks, forward, decode and greedy ids against the
reference's, and the serving stack over the family.

* Configs, full and smoke, equal the reference's field for field and by
  ``config_hash``; ``ARCH_IDS`` is the reference's, in its order.
* ddlerp, ``_wkv_step``, the time-mix and the channel-mix on the same
  float32 inputs within 1e-5 of max|.|.  The reference's ``mu`` params
  are weakly typed (``jnp.full``): the port's mixes follow that in bf16.
* The forward within 5e-3 of max|.| (bf16 and float32 activations), and
  10 decode steps (lockstep and per-slot positions) each from the
  reference's state, against the reference's un-jitted step (under
  ``jit`` XLA drops some bf16 roundings); greedy ids equal.  Decode is
  held against the reference's decode only (ROADMAP caveat b).
* ``pages=`` is ignored, ``init_paged_cache`` refused, ``reset_slot``
  zeroes one lane of every leaf in place, and the continuous scheduler
  with slot reuse gives each request its solo ``Engine.generate`` ids
  and logits bit for bit (the port's ``tests/test_runtime.py``
  recurrent test).
* A JAX-prepared tp=1 artifact served by the port, bit-equal to the
  in-memory plan; the port's manifest lists the reference's pair sites
  and leaf shards; ``quantize_model`` replaces every pair; the serve CLI
  in memory and from its own ``prepare``, at ``--tp 2`` and from a tp=2
  ``prepare`` (``tests/test_torch_recurrent_tp.py`` holds tp=2 to JAX);
  naive-actorder against tp-aware ids."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.reorder import PlannedPair
from repro_torch.models import rwkv6
from repro_torch.models.registry import build_model
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

ARCH = "rwkv6-3b"
REL_TOL = 5e-3
BLOCK_TOL = 1e-5
CPU = torch.device("cpu")
MAX_SEQ = 24
GREEDY = SamplingConfig(temperature=0.0)


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests: the smoke models' ops
    are tiny, so one thread runs them as fast alone, and it does not
    spin against the other test processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """scheme -> (JAX engine, port engine) over the same params, each
    built once."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.runtime.serve import Engine as JaxEngine
    from repro.train import checkpoint as jax_checkpoint

    made = {}

    def get(scheme="tp-aware"):
        if scheme not in made:
            jm = jax_build_model(
                jax_smoke_config(ARCH).with_quant(scheme=scheme))
            jeng = JaxEngine(model=jm,
                             params=jax.jit(jm.init)(jax.random.PRNGKey(0)),
                             max_seq=MAX_SEQ)
            path = jax_checkpoint.save(
                str(tmp_path_factory.mktemp("ckpt") / "p.npz"), jeng.params)
            teng = Engine(
                model=build_model(get_smoke_config(ARCH).with_quant(
                    scheme=scheme)),
                params=interop.load_params(path, device=CPU), device=CPU,
                max_seq=MAX_SEQ)
            made[scheme] = (jeng, teng)
        return made[scheme]

    return get


def _layer0(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _np(a) -> np.ndarray:
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_equal_the_references():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan.artifact import config_hash as jax_hash

    assert list(ARCH_IDS) == list(JAX_ARCH_IDS)
    for arch in ("rwkv6-3b", "recurrentgemma-2b"):
        for port, ref in ((get_config(arch), jax_config(arch)),
                          (get_smoke_config(arch), jax_smoke_config(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert part.config_hash(port) == jax_hash(ref)
    model = build_model(get_config(ARCH))
    assert model.module is rwkv6 and not model.supports_paged
    assert rwkv6.LAYER_STACKS == {"layers": 1}


def test_carried_leaves_bit_equal(carried):
    """Every JAX leaf is the port's per-layer leaves stacked again."""
    from repro.train import checkpoint as jax_checkpoint

    jeng, teng = carried()
    assert len(teng.params["layers"]) == teng.model.cfg.num_layers
    assert isinstance(teng.params["layers"][0]["cm"]["pair"], PlannedPair)
    have = checkpoint.flatten_keys(interop.to_reference_layout(teng.params))
    want = jax_checkpoint.flatten_keys(jeng.params)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        ref = np.asarray(leaf)
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        np.testing.assert_array_equal(have[key].numpy(), ref, err_msg=key)


# ---------------------------------------------------------------------------
# the blocks against JAX, on the same float32 inputs
# ---------------------------------------------------------------------------

def _block_inputs(cfg, b: int = 3, s: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32),
            (0.1 * rng.standard_normal((b, d // hd, hd, hd))).astype(
                np.float32))


def test_ddlerp_and_wkv_step_match_jax(carried):
    """ddlerp's five mixes and one wkv step (every row, every head) on the
    same float32 inputs within 1e-5 of max|.|."""
    import jax
    import jax.numpy as jnp
    from repro.models import rwkv6 as jax_rwkv6

    jeng, teng = carried()
    cfg = teng.model.cfg
    ref_p = _layer0(jeng.params["layers"])["tm"]
    got_p = teng.params["layers"][0]["tm"]
    x, prev, wkv = _block_inputs(cfg)
    xx = np.concatenate([prev[:, None], x[:, :-1]], axis=1)
    ref = jax_rwkv6._ddlerp(ref_p, jnp.asarray(x), jnp.asarray(xx))
    got = rwkv6._ddlerp(got_p, torch.from_numpy(x), torch.from_numpy(xx))
    assert sorted(got) == sorted(ref)
    for name in rwkv6.MIX_NAMES:
        assert _rel_gap(got[name].numpy(), _np(ref[name])) <= BLOCK_TOL, name
    rng = np.random.default_rng(1)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    r, k, w = (rng.standard_normal((3, h, hd)).astype(np.float32)
               for _ in range(3))
    v = rng.standard_normal((3, h, hd)).astype(np.float32)
    w = np.exp(-np.exp(w)).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    step = jax.vmap(jax_rwkv6._wkv_step, in_axes=(0, (0, 0, 0, 0, None)))
    ref_s, ref_o = step(jnp.asarray(wkv),
                        tuple(map(jnp.asarray, (r, k, v, w, u))))
    got_s, got_o = rwkv6._wkv_step(torch.from_numpy(wkv), tuple(
        map(torch.from_numpy, (r, k, v, w, u))))
    assert _rel_gap(got_s.numpy(), _np(ref_s)) <= BLOCK_TOL
    assert _rel_gap(got_o.numpy(), _np(ref_o)) <= BLOCK_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_jax(carried, with_state):
    """The time-mix (sequence of 5, from zeros or from a state) and the
    channel-mix on the same float32 inputs within 1e-5 of max|.|, and
    their new states."""
    import jax.numpy as jnp
    from repro.models import rwkv6 as jax_rwkv6

    jeng, teng = carried()
    cfg = teng.model.cfg
    lref, lgot = _layer0(jeng.params["layers"]), teng.params["layers"][0]
    x, prev, wkv = _block_inputs(cfg, seed=2)
    jstate = ({"shift": jnp.asarray(prev), "wkv": jnp.asarray(wkv)}
              if with_state else None)
    tstate = ({"shift": torch.from_numpy(prev), "wkv": torch.from_numpy(wkv)}
              if with_state else None)
    ref, ref_st = jax_rwkv6.time_mix_forward(jeng.model.cfg, lref["tm"],
                                             jnp.asarray(x), jeng.ctx,
                                             state=jstate)
    got, got_st = rwkv6.time_mix_forward(cfg, lgot["tm"],
                                         torch.from_numpy(x), tstate)
    assert _rel_gap(got.numpy(), _np(ref)) <= BLOCK_TOL
    assert _rel_gap(got_st["wkv"].numpy(), _np(ref_st["wkv"])) <= BLOCK_TOL
    np.testing.assert_array_equal(got_st["shift"].numpy(),
                                  _np(ref_st["shift"]))
    ref, ref_st = jax_rwkv6.channel_mix_forward(
        jeng.model.cfg, lref["cm"], jnp.asarray(x), jeng.ctx,
        state=jnp.asarray(prev) if with_state else None)
    got, got_st = rwkv6.channel_mix_forward(
        cfg, lgot["cm"], torch.from_numpy(x), teng.policy,
        torch.from_numpy(prev) if with_state else None)
    assert _rel_gap(got.numpy(), _np(ref)) <= BLOCK_TOL
    np.testing.assert_array_equal(got_st.numpy(), _np(ref_st))


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["tp-aware", "naive-actorder"])
def test_forward_matches_jax(carried, scheme):
    """The forward in the config's bf16 activations against the
    reference's un-jitted forward (its layer scan compiled drops bf16
    roundings of the carry, which moves this model's logits past the
    bound), and in float32 activations against the compiled one, within
    5e-3 of max|logit|."""
    import jax
    import jax.numpy as jnp
    from repro.models import rwkv6 as jax_rwkv6

    jeng, teng = carried(scheme)
    cfg = teng.model.cfg
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    for dtype in ("bfloat16", "float32"):
        with jax.disable_jit(dtype == "bfloat16"):
            ref = np.asarray(jax_rwkv6.forward(
                jeng.model.cfg.with_(dtype=dtype), jeng.params,
                {"tokens": jnp.asarray(toks)}, jeng.ctx))
        got = rwkv6.forward(cfg.with_(dtype=dtype), teng.params,
                            {"tokens": torch.from_numpy(toks).long()},
                            teng.policy).numpy()
        assert got.shape == ref.shape
        assert _rel_gap(got, ref) <= REL_TOL, dtype


def _held_decode(jeng, teng, toks, offsets):
    """Step both models over ``toks`` (B, steps) at ``offsets + t``, each
    step from the reference's state (copied into the port's cache first),
    the reference's step un-jitted.  Yields (port, JAX) logits and new
    states."""
    import jax
    import jax.numpy as jnp
    from repro.train import checkpoint as jax_checkpoint

    jmod = jeng.model.module
    b = toks.shape[0]
    jcache = jeng.model.init_cache(b, MAX_SEQ)
    tcache = teng.init_cache(b)
    for t in range(toks.shape[1]):
        flat = jax_checkpoint.flatten_keys(jcache)
        for key, leaf in checkpoint.flatten_keys(tcache).items():
            leaf.copy_(torch.from_numpy(np.array(_np(flat[key]))))
        pos = offsets + t
        with jax.disable_jit():
            ref, jcache = jmod.decode_step(
                jeng.model.cfg, jeng.params, jcache,
                jnp.asarray(toks[:, t]), jnp.asarray(pos), jeng.ctx)
        got, tcache = teng.decode(tcache, torch.from_numpy(toks[:, t]).long(),
                                  torch.from_numpy(pos).long())
        flat = jax_checkpoint.flatten_keys(jcache)
        yield got.numpy(), np.asarray(ref), {
            k: (v.float().numpy(), _np(flat[k]))
            for k, v in checkpoint.flatten_keys(tcache).items()}


def test_decode_and_greedy_ids_match_jax(carried):
    """10 lockstep steps, then 10 on unequal per-slot positions, each from
    the reference's state: logits and every state leaf within 5e-3 of
    max|.|; then ``Engine.generate``'s greedy ids against the
    reference's."""
    import jax
    import jax.numpy as jnp

    jeng, teng = carried()
    cfg = teng.model.cfg
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    for offsets in (np.zeros(3, np.int32), np.array([0, 3, 9], np.int32)):
        for t, (got, ref, states) in enumerate(_held_decode(
                jeng, teng, toks, offsets)):
            assert _rel_gap(got, ref) <= REL_TOL, (offsets, t)
            for key, (g, r) in states.items():
                assert _rel_gap(g, r) <= REL_TOL, (offsets, t, key)
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
    """The forward of 12 tokens (2 layers) against the same tokens
    replayed through the decode step, in float32 activations and a
    float32 state, within 2e-2 of max|logit| (the reference's bound,
    ``tests/test_models_smoke.py``); ``chip_smoke.py`` holds the same at
    full depth.  (In bf16 the cache's rounding of K and V, which the
    reference's decode makes and its forward does not, moves the logits
    further.)"""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", **{})
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
# serving: pages, the lane reset, the scheduler
# ---------------------------------------------------------------------------

def test_pages_ignored_and_paged_cache_refused(carried):
    """The decode step ignores a page table; ``init_paged_cache`` raises;
    a paged policy keeps the dense state (``uses_page_table`` False) and
    the scheduler serves it."""
    from repro_torch.cache.spec import PageSpec

    _, teng = carried()
    cfg = teng.model.cfg
    toks = torch.tensor([3, 7])
    c1, c2 = teng.init_cache(2), teng.init_cache(2)
    with torch.inference_mode():
        for t in range(3):
            a, _ = teng.model.decode_step(teng.params, c1, toks + t, t,
                                          teng.policy)
            b, _ = teng.model.decode_step(
                teng.params, c2, toks + t, torch.tensor([t, t]), teng.policy,
                pages=torch.zeros((2, 4), dtype=torch.int64), kv_len=MAX_SEQ)
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no paged cache"):
        teng.model.init_paged_cache(8, 4, device=CPU)
    paged = dataclasses.replace(
        teng, policy=teng.policy.with_(kv=PageSpec(page_size=4)))
    assert paged.policy.kv.paged and not paged.uses_page_table
    sched = Scheduler(paged, max_batch=2, prompt_budget=8, scfg=GREEDY)
    sched.submit(Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                         max_new_tokens=3))
    assert len(sched.run()[0].output) == 3 and sched.manager is None


def test_reset_slot_zeroes_one_lane_in_place(carried):
    """``Engine.reset_slot`` zeroes lane ``slot`` (dim 1) of every leaf,
    leaves the other lanes, and keeps every leaf's address."""
    _, teng = carried()
    cache = teng.init_cache(3)
    with torch.inference_mode():
        for t in range(3):
            teng.decode(cache, torch.tensor([5, 6, 7]) + t, t)
    before = {k: (v.clone(), v.data_ptr())
              for k, v in checkpoint.flatten_keys(cache).items()}
    assert all(v[:, 1].abs().sum() > 0 for v, _ in before.values())
    out = teng.reset_slot(cache, 1)
    assert out is cache
    for key, leaf in checkpoint.flatten_keys(cache).items():
        old, ptr = before[key]
        assert leaf.data_ptr() == ptr, key
        assert not leaf[:, 1].any(), key
        assert torch.equal(leaf[:, [0, 2]], old[:, [0, 2]]), key


def _solo_rows(eng, prompt, max_new):
    """``prompt`` alone through ``Engine.generate``: its greedy ids and the
    logits row of every step that emits."""
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


def scheduler_matches_solo(eng, max_batch: int, sizes=(5, 6, 4, 7),
                           new=(2, 8, 3, 4)):
    """Requests at ``max_batch`` slots with unequal ``max_new_tokens`` (so
    later ones enter lanes earlier ones used): each request's ids equal
    its solo ``Engine.generate``'s, and at one slot every emitted logits
    row bit-equal too (the CPU's plain GEMMs give a row other last bits
    at another row count; on the card the kernels' rows do not, and
    ``chip_smoke.py`` holds the logits of 4 slots bit-equal).  Returns
    the admissions."""
    cfg = eng.model.cfg
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in sizes]
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
    admitted = dict((rid, step) for step, rid in sched.admissions)
    assert any(step > 0 for step in admitted.values())
    for i, (p, mn) in enumerate(zip(prompts, new)):
        ids, solo = _solo_rows(eng, p, mn)
        assert done[i].output == ids, i
        if max_batch == 1:
            assert torch.equal(torch.stack(rows[i]), solo), i
    return sched.admissions


@pytest.mark.parametrize("max_batch", [1, 2])
def test_scheduler_slot_reuse_bit_identical_to_solo(carried, max_batch):
    """The continuous scheduler over the recurrent state: a re-admitted
    lane is reset, so every request's ids (and at one slot its logits)
    are its solo run's; without the reset (the lane left dirty) a reused
    lane's request differs."""
    _, teng = carried()
    assert teng.supports_continuous
    admissions = scheduler_matches_solo(teng, max_batch)
    assert [rid for _, rid in admissions] == [0, 1, 2, 3]
    reset = teng.reset_slot
    teng.reset_slot = lambda cache, slot: cache
    try:
        with pytest.raises(AssertionError):
            scheduler_matches_solo(teng, max_batch)
    finally:
        teng.reset_slot = reset


# ---------------------------------------------------------------------------
# the plan: the JAX artifact, the manifest, quantize_model, the CLI
# ---------------------------------------------------------------------------

def test_jax_artifact_served_by_the_port(tmp_path):
    """A JAX-prepared tp=1 smoke artifact (the reference's
    ``compile_plan`` of its raw init from seed 0, compiled under ``jit``):
    the port loads and serves it, its params and logits bit-equal to the
    in-memory plan (the reference's ``compile_params`` of the same raw
    tree and plan stream, what its ``Model.init`` serves, carried
    across); the port's own prepare lists the reference's pair sites and
    leaf shards."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.plan import compiler as jax_compiler
    from repro.train import checkpoint as jax_checkpoint

    jcfg = jax_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    raw = jax.jit(jax_build_model(jcfg).init_raw)(key)
    rng = jax.random.fold_in(key, jax_compiler.PLAN_RNG_STREAM)
    jart = jax_compiler.compile_plan(jcfg, raw, tp=1, rng=rng, seed=0,
                                     extra_manifest={"smoke": True})
    jdir = jart.save(str(tmp_path / "jax"))
    cfg = get_smoke_config(ARCH)
    path = jax_checkpoint.save(str(tmp_path / "p.npz"),
                               jax_compiler.compile_params(jcfg, raw,
                                                           rng=rng))
    teng = Engine(model=build_model(cfg), device=CPU, max_seq=MAX_SEQ,
                  params=interop.load_params(path, device=CPU))
    served = make_engine(cfg, device=CPU, max_seq=MAX_SEQ, artifact=jdir)
    have = checkpoint.flatten_keys(served.params)
    want = checkpoint.flatten_keys(teng.params)
    assert sorted(have) == sorted(want)
    assert all(torch.equal(have[k], t) for k, t in want.items())
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 6)))
    c1, c2 = served.init_cache(2), teng.init_cache(2)
    for t in range(6):
        a, _ = served.decode(c1, toks[:, t], t)
        b, _ = teng.decode(c2, toks[:, t], t)
        assert torch.equal(a, b), t
    ref = jart.manifest
    port = compiler.prepare(cfg, tp=1, seed=0, device=CPU).manifest
    key = lambda m: m["path"]  # noqa: E731
    assert sorted(port["pairs"], key=key) == sorted(ref["pairs"], key=key)
    assert [m["path"] for m in port["pairs"]] == [rwkv6.MLP_PATH]
    assert port["pairs"][0]["stacked"] == [cfg.num_layers]
    assert port["leaf_shards"] == ref["leaf_shards"]


def test_quantize_model_replaces_every_pair():
    """``quant/gptq.quantize_model`` on the raw params replaces each
    layer's channel-mix pair and leaves no raw MLP dict."""
    from repro_torch.quant.gptq import quantize_model

    cfg = get_smoke_config(ARCH).with_quant(mode="none")
    raw = build_model(cfg).init_raw(0, device=CPU)
    q = quantize_model(cfg.with_quant(mode="mlp", scheme="tp-aware"), raw)
    pairs = [lp["cm"]["pair"] for lp in q["layers"]]
    assert len(pairs) == cfg.num_layers
    for pp in pairs:
        assert isinstance(pp, PlannedPair) and pp.scheme == "tp-aware"
        assert pp.up.qweight.dtype == torch.int32 and pp.gate is None
    assert not any(compiler._is_mlp_dict(n) for lp in q["layers"]
                   for n in lp["cm"].values())


def test_cli_in_memory_from_its_artifact_and_at_tp2(tmp_path, capsys):
    """``--arch rwkv6-3b --smoke --device cpu``: served by the continuous
    scheduler; ``prepare`` then ``--artifact`` gives the same ids; so do
    ``--tp 2`` (two gloo ranks), and ``prepare --tp 2`` then
    ``--artifact`` (each rank reading its own file); ``--mesh dp1xtp2``
    gives ``--mesh dp1xtp1``'s lockstep rows."""
    from repro_torch.launch import serve

    base = ["--device", "cpu", "--requests", "3", "--max-new", "4"]
    want = serve.main(["--arch", ARCH, "--smoke"] + base)
    assert sorted(want) == [0, 1, 2]
    assert all(len(o) == 4 for o in want.values())
    out = str(tmp_path / "art")
    serve.main(["prepare", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--out", out])
    assert serve.main(["--artifact", out] + base) == want
    assert f"artifact={out}]" in capsys.readouterr().out
    assert serve.main(["--arch", ARCH, "--smoke", "--tp", "2"] + base) == want
    assert "decode step: eager (tp=2 over gloo)" in capsys.readouterr().out
    tp2 = str(tmp_path / "tp2")
    serve.main(["prepare", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--tp", "2", "--out", tp2])
    assert serve.main(["--artifact", tp2] + base) == want
    printed = capsys.readouterr().out
    assert "rank 0: resident_artifact_bytes=" in printed
    assert "ranks=[1]" in printed
    lock = ["--arch", ARCH, "--smoke", "--device", "cpu", "--temperature",
            "0", "--max-new", "4"]
    assert serve.main(lock + ["--mesh", "dp1xtp2"]) == serve.main(
        lock + ["--mesh", "dp1xtp1"])


def test_naive_actorder_gives_the_tp_aware_ids():
    """The naive act-order plan (g_idx layout) and the tp-aware plan of
    the same seed: greedy ids equal."""
    cfg = get_smoke_config(ARCH)
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6)))
    ids = [make_engine(cfg.with_quant(scheme=s), 0, device=CPU,
                       max_seq=MAX_SEQ).generate(None, prompts, [6, 5],
                                                 max_new_tokens=6,
                                                 scfg=GREEDY)
           for s in ("tp-aware", "naive-actorder")]
    assert torch.equal(ids[0], ids[1])
    assert ExecutionPolicy.from_config(
        cfg.with_quant(scheme="naive-actorder"), device=CPU).scheme == \
        "naive-actorder"
