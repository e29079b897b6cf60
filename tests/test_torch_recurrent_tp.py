"""Tensor parallelism of the recurrent families on the CPU: rwkv6-3b at
its smoke size and recurrentgemma-2b at 5 layers (one superblock, so
its local attention runs, with its one KV head cut over the ranks, and
two extra RG-LRU layers), at tp=2 on gloo rank processes.

* The port's tp=2 ``param_specs`` are the reference's manifest
  ``leaf_shards``, leaf by leaf (rwkv6's r/k/v/g by columns and w_o by
  rows, the decay, bonus and norm scale whole; recurrentgemma's
  ``w_x``, ``w_gate`` and ``conv_w`` by columns, ``lam`` split,
  ``w_rgate``, ``w_igate`` and ``w_out`` by rows, ``wk`` and ``wv`` by
  columns within the one KV head); its prepare writes the reference's
  manifest, and its rank r is ``Model.init(0, tp=2, rank=r)``.
* A JAX-prepared tp=2 artifact of each loads bit-equal, and the ranks
  serve it, each reading only its own file.
* The ranks' forward (bf16 and float32 activations) and each of
  ``STEPS`` decode steps from the reference's state (each rank's slice
  of it) within 5e-3 of max|logit| of the single-device JAX model
  (rwkv6's bf16 forward and decode un-jitted, as in
  ``tests/test_torch_rwkv6.py``; ROADMAP caveat a: the reference's own
  model-level TP is not the yardstick); greedy ids equal the port's
  tp=1 ids; the continuous scheduler with slot reuse gives every
  request its solo ids at tp=2.
* Each decode step's state, leaf by leaf, is within 5e-3 of max|.| of
  the rank's slice of the reference's next state.
* rwkv6's 4 smoke heads do not split over 3 ranks: ``Model.init`` and
  ``init_cache`` raise naming the count.  A KV head cut over the ranks
  is refused where the query heads of a rank would span two KV heads,
  and for the audio and vision families, whose cross K/V caches hold a
  rank's whole heads.

JAX is imported inside the fixtures and tests that run it: the gloo rank
processes import this module."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

#: each arch's smoke config overrides: recurrentgemma's default 2 layers
#: have no superblock, hence no attention
ARCHS = {"rwkv6-3b": {}, "recurrentgemma-2b": {"num_layers": 5}}
TP = 2
REL_TOL = 5e-3
CPU = torch.device("cpu")
MAX_SEQ = 24
STEPS = 6
GREEDY = SamplingConfig(temperature=0.0)


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cfg(arch: str):
    return get_smoke_config(arch).with_(**ARCHS[arch])


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


def _reference(arch: str, tmp_path_factory) -> dict:
    """The single-device JAX model of ``arch`` and what the ranks are held
    to: its params (carried), its forward logits, its decode steps (the
    state before each and the logits), the port's tp=1 greedy ids on the
    carried params, and a JAX tp=2 artifact of the raw init of seed 0
    (``compile_plan``, the raw init compiled under ``jit``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.models.registry import build_model as jax_build_model
    from repro.plan import compiler as jax_compiler
    from repro.runtime.serve import Engine as JaxEngine
    from repro.train import checkpoint as jax_checkpoint

    jcfg = jax_smoke_config(arch).with_(**ARCHS[arch])
    jm = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    jeng = JaxEngine(model=jm, params=jax.jit(jm.init)(key), max_seq=MAX_SEQ)
    ckpt = jax_checkpoint.save(str(tmp_path_factory.mktemp("ckpt") / "p.npz"),
                               jeng.params)
    # rwkv6's reference mu params are weakly typed: under jit XLA drops
    # its bf16 carry roundings, so its bf16 forward and decode run eagerly
    eager = jcfg.family == "ssm"
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    logits = {}
    for dtype in ("bfloat16", "float32"):
        with jax.disable_jit(eager and dtype == "bfloat16"):
            logits[dtype] = np.asarray(jm.module.forward(
                jcfg.with_(dtype=dtype), jeng.params,
                {"tokens": jnp.asarray(toks)}, jeng.ctx))
    dtoks = rng.integers(0, jcfg.vocab_size, (2, STEPS)).astype(np.int32)
    offsets = np.array([0, 3], np.int32)
    step = (lambda p, c, tok, pos: jm.module.decode_step(jcfg, p, c, tok,
                                                         pos, jeng.ctx))
    step = step if eager else jax.jit(step)
    jcache, steps = jm.init_cache(2, MAX_SEQ), []
    for t in range(STEPS):
        state = {k: _np(v)
                 for k, v in jax_checkpoint.flatten_keys(jcache).items()}
        with jax.disable_jit(eager):
            out, jcache = step(jeng.params, jcache, jnp.asarray(dtoks[:, t]),
                               jnp.asarray(offsets + t))
        steps.append((state, np.asarray(out)))
    after = {k: _np(v) for k, v in jax_checkpoint.flatten_keys(jcache).items()}
    prompts = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    plen = np.array([6, 4], np.int32)
    teng = Engine(model=build_model(_cfg(arch)),
                  params=interop.load_params(ckpt, device=CPU), device=CPU,
                  max_seq=MAX_SEQ)
    ids = teng.generate(None, torch.from_numpy(prompts).long(), plen,
                        max_new_tokens=6, scfg=GREEDY).numpy()
    raw = jax.jit(jm.init_raw)(key)
    policy = JaxPolicy.from_config(jcfg).with_(mesh=JaxMeshPlan(dp=1, tp=TP))
    art = jax_compiler.compile_plan(
        jcfg, raw, tp=TP, policy=policy, seed=0,
        rng=jax.random.fold_in(key, jax_compiler.PLAN_RNG_STREAM))
    return {"ckpt": ckpt, "tokens": toks, "logits": logits, "dtoks": dtoks,
            "offsets": offsets, "steps": steps, "after": after,
            "prompts": prompts,
            "plen": plen, "ids": ids,
            "artifact": art.save(str(tmp_path_factory.mktemp("jax2")))}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    made = {}

    def get(arch: str) -> dict:
        if arch not in made:
            made[arch] = _reference(arch, tmp_path_factory)
        return made[arch]

    return get


def _rank_slice(a: np.ndarray, shape: tuple, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole state leaf ``a``: along the dim
    where its leaf (``shape``) is smaller (rwkv6's heads, the RG-LRU
    channels), or the whole leaf (the shift rows, the whole KV head)."""
    for d, (n, m) in enumerate(zip(a.shape, shape)):
        if n != m:
            return np.take(a, np.arange(rank * m, (rank + 1) * m), axis=d)
    return a


def _slot_reuse(eng) -> dict:
    """Four greedy requests of unequal ``max_new_tokens`` at 2 slots (so
    later ones enter lanes earlier ones used, which ``reset_slot``
    zeroes), and each alone through ``Engine.generate``."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.model.cfg.vocab_size, size=n).astype(
        np.int32) for n in (5, 6, 4, 7)]
    new = (2, 8, 3, 4)
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=GREEDY)
    for i, (p, mn) in enumerate(zip(prompts, new)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
    done = sched.run()
    solo = {i: eng.generate(None, torch.from_numpy(p.astype(np.int64))[None],
                            [p.size], max_new_tokens=mn,
                            scfg=GREEDY)[0].tolist()
            for i, (p, mn) in enumerate(zip(prompts, new))}
    return {"batched": {i: r.output for i, r in done.items()}, "solo": solo,
            "admissions": sched.admissions}


def _rank(ctx, arch: str, ref: dict) -> dict:
    """One rank at tp=2: its slices of the carried params; the forward in
    both activation dtypes, the decode steps from the reference's state,
    the greedy ids, slot reuse, and the JAX artifact served."""
    cfg = _cfg(arch)
    params = interop.load_params(ref["ckpt"], device="cpu")
    trees, _ = compiler.shard_params(cfg, params, ctx.tp)
    eng = Engine(model=build_model(cfg), params=trees[ctx.rank], device=CPU,
                 max_seq=MAX_SEQ, group=ctx.group)
    toks = torch.from_numpy(ref["tokens"]).long()
    out = {"logits": {
        dtype: dataclasses.replace(
            eng, model=build_model(cfg.with_(dtype=dtype))).prefill_logits(
                toks).numpy() for dtype in ref["logits"]}}
    cache, steps, states = eng.init_cache(2), [], []
    for t, (state, _) in enumerate(ref["steps"]):
        for key, leaf in checkpoint.flatten_keys(cache).items():
            leaf.copy_(torch.from_numpy(_rank_slice(
                state[key], tuple(leaf.shape), ctx.rank)))
        logits, cache = eng.decode(
            cache, torch.from_numpy(ref["dtoks"][:, t]).long(),
            torch.from_numpy(ref["offsets"] + t).long())
        steps.append(logits.numpy())
        # copies: the cache's float32 leaves are written in place
        states.append({k: v.to(torch.float32, copy=True).numpy()
                       for k, v in checkpoint.flatten_keys(cache).items()})
    out["steps"], out["states"] = steps, states
    out["cache_shapes"] = {k: tuple(v.shape) for k, v in
                           checkpoint.flatten_keys(cache).items()}
    prompts = torch.from_numpy(ref["prompts"]).long()
    out["ids"] = eng.generate(None, prompts, ref["plen"], max_new_tokens=6,
                              scfg=GREEDY).numpy()
    out["reuse"] = _slot_reuse(eng)
    served = make_engine(cfg, device=CPU, max_seq=MAX_SEQ,
                         artifact=ref["artifact"], group=ctx.group)
    st = served.load_stats
    out["artifact"] = {
        "ranks": list(st.ranks), "loaded": st.file_bytes_loaded,
        "total": st.file_bytes_total,
        "ids": served.generate(None, prompts, ref["plen"], max_new_tokens=6,
                               scfg=GREEDY).numpy()}
    return out


@pytest.fixture(scope="module")
def ranks(refs):
    """arch -> the two ranks' results (one ``mesh.run`` per arch)."""
    made = {}

    def get(arch: str) -> list:
        if arch not in made:
            ref = {k: v for k, v in refs(arch).items()
                   if k not in ("ids", "after")}
            made[arch] = mesh.run(_rank, TP, arch, ref, device_type="cpu",
                                  timeout=300)
        return made[arch]

    return get


#: the leaves each family's split turns on, with the dim of the
#: reference's stacked tree each is split along
NAMED_SHARDS = {
    "rwkv6-3b": {"layers||tm||w_r": 2, "layers||tm||w_k": 2,
                 "layers||tm||w_v": 2, "layers||tm||w_g": 2,
                 "layers||tm||w_o": 1, "layers||tm||decay_base": None,
                 "layers||tm||decay_w2": None, "layers||tm||bonus_u": None,
                 "layers||tm||ln_scale": None, "layers||tm||mu": None,
                 "layers||cm||w_r": None},
    "recurrentgemma-2b": {
        "super||attn||attn||wk": 2, "super||attn||attn||wv": 2,
        "super||attn||attn||wq": 2, "super||attn||attn||wo": 1,
        "extra||rec||lam": 1, "extra||rec||conv_w": 2,
        "extra||rec||w_rgate": 1, "extra||rec||w_igate": 1,
        "super||rec1||rec||w_x": 2, "super||rec2||rec||w_out": 1}}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_are_the_references_leaf_shards(refs, arch):
    """The port's tp=2 split (its prepare's ``leaf_shards``, from
    ``param_specs``), leaf by leaf, is the reference's manifest's; the
    port's prepare writes the reference's manifest (pairs in any order)
    and its rank r is ``Model.init(0, tp=2, rank=r)`` bit for bit."""
    want = DeploymentArtifact.load_manifest(refs(arch)["artifact"])
    for key, dim in NAMED_SHARDS[arch].items():
        assert want["leaf_shards"][key] == dim, key
    cfg = _cfg(arch)
    art = compiler.prepare(cfg, tp=TP, seed=0, device="cpu")
    have = art.manifest
    assert have["leaf_shards"] == want["leaf_shards"]
    path = lambda m: m["path"]  # noqa: E731
    assert sorted(have["pairs"], key=path) == sorted(want["pairs"], key=path)
    assert {k: v for k, v in have.items() if k != "pairs"} == {
        k: v for k, v in want.items() if k != "pairs"}
    model = build_model(cfg)
    for r in range(TP):
        mine = checkpoint.flatten_keys(model.init(0, device="cpu", tp=TP,
                                                  rank=r))
        got = checkpoint.flatten_keys(art.rank_tree(r))
        assert list(got) == list(mine)
        assert all(torch.equal(got[k], mine[k]) for k in mine)
    if arch == "recurrentgemma-2b":
        # the one KV head's 64 columns, 32 on each rank
        attn = art.rank_tree(1)["super"][0]["attn"]["attn"]
        assert tuple(attn["wk"].shape) == tuple(attn["wv"].shape) == (256, 32)
        assert tuple(attn["wq"].shape) == (256, 128)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_jax_tp2_artifact_loads_bit_equal(refs, arch):
    """A JAX-prepared tp=2 artifact: the port's loader reads each rank's
    tree bit-equal to the reference's own, and it validates against the
    port's config and split at tp=2."""
    from repro.plan import DeploymentArtifact as JaxArtifact
    from repro.train import checkpoint as jax_checkpoint

    path = refs(arch)["artifact"]
    ref = JaxArtifact.load(path)
    art = DeploymentArtifact.load(path, device="cpu")
    assert art.manifest == ref.manifest
    art.validate(cfg=_cfg(arch), policy=art.policy(), tp=TP)
    for r in range(TP):
        want = jax_checkpoint.flatten_keys(ref.rank_tree(r))
        have = checkpoint.flatten_keys(
            interop.to_reference_layout(art.rank_tree(r)))
        assert sorted(have) == sorted(want)
        for key, leaf in want.items():
            leaf = np.asarray(leaf)
            t = have[key].numpy()
            if leaf.dtype == np.uint32:
                t = t.view(np.uint32)
            assert t.dtype == leaf.dtype, key
            np.testing.assert_array_equal(t, leaf, err_msg=key)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp2_ranks_match_single_device_jax(refs, ranks, arch):
    """Each rank's forward logits (bf16 and float32 activations) and each
    decode step from the reference's state within 5e-3 of max|logit| of
    the single-device JAX model, the two ranks' logits equal (the head's
    gathered logits); the state each step leaves, leaf by leaf, within
    5e-3 of max|.| of the rank's slice of the reference's next state
    (rwkv6's decayed wkv state, the conv and LRU state after the gates'
    reduce-scatter, the K/V ring); greedy ids equal the port's tp=1 ids;
    each rank's state its share: rwkv6's heads, the RG-LRU channels, the
    whole KV head."""
    ref = refs(arch)
    res = ranks(arch)
    cfg = _cfg(arch)
    for rank, r in enumerate(res):
        for dtype, want in ref["logits"].items():
            assert r["logits"][dtype].shape == want.shape
            assert _rel_gap(r["logits"][dtype], want) <= REL_TOL, dtype
        for t, (got, (_, want)) in enumerate(zip(r["steps"], ref["steps"],
                                                 strict=True)):
            assert _rel_gap(got, want) <= REL_TOL, t
        nexts = [state for state, _ in ref["steps"][1:]] + [ref["after"]]
        for t, (got, want) in enumerate(zip(r["states"], nexts,
                                            strict=True)):
            for key, leaf in got.items():
                whole = _rank_slice(want[key], leaf.shape, rank)
                assert _rel_gap(leaf, whole) <= REL_TOL, (t, key)
        np.testing.assert_array_equal(r["ids"], ref["ids"])
    np.testing.assert_array_equal(res[0]["logits"]["bfloat16"],
                                  res[1]["logits"]["bfloat16"])
    shapes = res[0]["cache_shapes"]
    if arch == "rwkv6-3b":
        h = cfg.d_model // cfg.rwkv_head_dim
        assert shapes["wkv"] == (cfg.num_layers, 2, h // TP, 64, 64)
        assert shapes["tm_shift"] == (cfg.num_layers, 2, cfg.d_model)
    else:
        w = cfg.lru_width // TP
        assert shapes["rec1||conv"] == (1, 2, cfg.conv_width - 1, w)
        assert shapes["extra||lru"] == (2, 2, w)
        assert shapes["attn||k"] == (1, 2, MAX_SEQ, 1, cfg.head_dim)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp2_slot_reuse_and_the_artifact_served(refs, ranks, arch):
    """At tp=2 the continuous scheduler, with requests entering used lanes
    (each rank resetting its own leaves), gives every request its solo
    ids; the JAX artifact served at tp=2, each rank reading only its own
    file, gives the ids of one device serving the reassembled plan."""
    res = ranks(arch)
    for r, out in enumerate(res):
        reuse = out["reuse"]
        assert any(step > 0 for step, _ in reuse["admissions"])
        assert reuse["batched"] == reuse["solo"]
        assert reuse == res[0]["reuse"]
        art = out["artifact"]
        assert art["ranks"] == [r] and art["loaded"] < art["total"]
    path = refs(arch)["artifact"]
    one = Engine(model=build_model(_cfg(arch)),
                 params=DeploymentArtifact.load(path, device="cpu").params(),
                 device=CPU, max_seq=MAX_SEQ)
    want = one.generate(None, torch.from_numpy(refs(arch)["prompts"]).long(),
                        refs(arch)["plen"], max_new_tokens=6,
                        scfg=GREEDY).numpy()
    for out in res:
        np.testing.assert_array_equal(out["artifact"]["ids"], want)


def test_rwkv6_heads_that_do_not_split_raise():
    """rwkv6's 4 smoke heads over 3 ranks would cut a head: the split,
    ``Model.init`` and ``init_cache`` raise naming the count."""
    cfg = get_smoke_config("rwkv6-3b")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="4 time-mix heads do not split "
                                         "over tp=3"):
        model.init(0, device="cpu", tp=3, rank=0)
    with pytest.raises(ValueError, match="4 time-mix heads"):
        model.init_cache(2, MAX_SEQ, device="cpu", tp=3)


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_cut_kv_heads_refused_for_the_cross_attention_families(arch):
    """The audio and vision smoke models' 2 KV heads over 4 ranks would
    be cut: their cross K/V caches hold whole heads, so the split
    raises (at 2 ranks the heads split whole, as before)."""
    model = build_model(get_smoke_config(arch))
    with pytest.raises(ValueError, match="2 KV heads do not split over "
                                         "tp=4 ranks"):
        model.init(0, device="cpu", tp=4, rank=0)
    assert model.param_specs(model.init(0, device="cpu", tp=2, rank=0), 2)


def test_cut_kv_heads_whose_rank_spans_two_heads_raise():
    """6 query heads over 2 KV heads at tp=3: rank 1's two query heads
    would pair with both KV heads, the second cut, which the grouped
    attention cannot serve; tp=2 and tp=6 (heads whole, or each rank's
    within one KV head) pass."""
    from repro_torch.models import common as cm

    cfg = get_smoke_config("qwen3-4b").with_(n_heads=6, n_kv_heads=2,
                                             head_dim=16)
    p = dict.fromkeys(("wq", "wk", "wv", "wo"))
    with pytest.raises(ValueError, match="2 KV heads over tp=3 ranks"):
        cm.attention_specs(cfg, p, 3)
    for tp in (2, 6):
        assert cm.attention_specs(cfg, p, tp)["wk"] == 1
