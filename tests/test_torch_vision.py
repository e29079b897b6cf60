"""Port parity of the vision family (llama-3.2-vision-90b) at smoke size,
on the CPU: JAX params carried across through ``checkpoint.save`` ->
``repro_torch.interop`` (``super`` split into a list of superblocks and
the ``(n_super, n_self)`` stack of ``super.self`` into lists of self
layers), then the port's cross K/V, forward, decode and greedy ids
against the reference's, for the tp-aware plan and the naive act-order
one.

The cross layers' gates start at 0 (tanh(0) = 0: the cross-attention and
the cross MLP then add nothing), so every comparison here runs with both
gates at 0.5, in the JAX tree and the port's alike.  The smoke config is
one superblock of one self layer, which cannot show a two-level stack
transposed; the model is also held at ``smoke_reduce(cfg,
num_layers=6, cross_attn_every=3)``: two superblocks of two self layers
and one cross layer each.

* The configs equal the reference's field for field and by
  ``config_hash``.
* Forward, decode steps (10, lockstep and per-slot positions) and greedy
  ids within 5e-3 of max|.| (``tests/test_torch_model.py``'s bound), ids
  equal; decode is held against the reference's decode only (ROADMAP
  caveat b), each step on the reference's cache.  At six layers a bf16
  rounding of a carry that the two frameworks round apart moves this
  random model's logits by up to ~1% of max|logit|: there each layer is
  held on the reference's input carries in bf16, and the whole forward
  and the decode steps in float32 activations.
* fp pages give the dense self-attention step bit for bit; the flash
  forward is the einsum one's.
* The scheduler batch-drains the family (``run()`` equals
  ``Engine.generate`` on the same rows with zero patches); ``step()``,
  ``EngineLoop`` and the CLI's ``--http`` refuse it; the serve CLI runs
  in-process and from its own ``prepare``'s artifact.
* A JAX-prepared artifact with the V->O fold (``super.self.attn`` at two
  stacked dims, the waived ``super.cross.xattn``) is served by the port;
  the port's manifest lists the reference's pairs and leaf shards.
* tp=2 over gloo ranks: each self and cross layer on the tp=1 engine's
  input carries, and the decode logits and greedy ids, against tp=1.

JAX is imported inside the tests and fixtures that run it: the gloo rank
processes import this module."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config, smoke_reduce
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import derive_seed, new_generator
from repro_torch.launch import mesh
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models import vision_llama as vl
from repro_torch.models.registry import build_model
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime import scheduler as sched_mod
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

ARCH = "llama-3.2-vision-90b"
SCHEMES = ("tp-aware", "naive-actorder")
REL_TOL = 5e-3
CPU = torch.device("cpu")
MAX_SEQ = 24
GATE = 0.5
GREEDY = SamplingConfig(temperature=0.0)


def _cfg(size: str):
    """The smoke config, or the six-layer one (2 superblocks of 2 self
    layers and a cross layer)."""
    if size == "smoke":
        return get_smoke_config(ARCH)
    return smoke_reduce(get_config(ARCH), num_layers=6, cross_attn_every=3)


def _jax_cfg(size: str):
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import smoke_reduce as jax_smoke_reduce

    if size == "smoke":
        return jax_smoke_config(ARCH)
    return jax_smoke_reduce(jax_config(ARCH), num_layers=6,
                            cross_attn_every=3)


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _patches(cfg, b: int, seed: int) -> np.ndarray:
    """Random patch embeddings (B, vision_tokens, d), bf16-exact float32."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def _torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype (bf16 stays bf16)."""
    import jax.numpy as jnp

    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _open_gates(params) -> dict:
    """The port's params with every cross layer's gates at ``GATE``."""
    sup = [dict(sp, cross=dict(sp["cross"],
                               gate_attn=torch.full((), GATE),
                               gate_mlp=torch.full((), GATE)))
           for sp in params["super"]]
    return dict(params, super=sup)


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
    """(size, scheme) -> (JAX engine, port engine) over the same params,
    the gates at ``GATE`` in both, each built once."""
    import jax
    import jax.numpy as jnp
    from repro.models.registry import build_model as jax_build_model
    from repro.runtime.serve import Engine as JaxEngine
    from repro.train import checkpoint as jax_checkpoint

    made = {}

    def get(size="smoke", scheme="tp-aware"):
        if (size, scheme) not in made:
            # the reference's init and plan compile under one jit (a
            # quarter of their eager time); both sides run these params
            jm = jax_build_model(_jax_cfg(size).with_quant(scheme=scheme))
            jeng = JaxEngine(model=jm,
                             params=jax.jit(jm.init)(jax.random.PRNGKey(0)),
                             max_seq=MAX_SEQ)
            sup = jeng.params["super"]
            cross = dict(sup["cross"],
                         gate_attn=jnp.full_like(sup["cross"]["gate_attn"],
                                                 GATE),
                         gate_mlp=jnp.full_like(sup["cross"]["gate_mlp"],
                                                GATE))
            jeng.params = dict(jeng.params, super=dict(sup, cross=cross))
            path = jax_checkpoint.save(
                str(tmp_path_factory.mktemp("ckpt") / "p.npz"), jeng.params)
            teng = Engine(model=build_model(_cfg(size).with_quant(
                scheme=scheme)), params=interop.load_params(path, device=CPU),
                device=CPU, max_seq=MAX_SEQ)
            made[size, scheme] = (jeng, teng)
        return made[size, scheme]

    return get


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_equal_the_references():
    from repro.configs import get_config as jax_config
    from repro.plan.artifact import config_hash as jax_hash

    for port, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (_cfg("smoke"), _jax_cfg("smoke")),
                      (_cfg("six"), _jax_cfg("six"))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert part.config_hash(port) == jax_hash(ref)
    model = build_model(get_config(ARCH))
    assert model.module is vl and model.has_cross
    assert model.attn_vo_path == "super.self.attn"
    assert set(model.attn_vo_waived) == {"super.cross.xattn"}
    assert model.module.LAYER_STACKS == {"super": 1, "super.self": 2}
    assert vl._n_super(get_config(ARCH)) == (20, 4)
    assert vl._n_super(_cfg("six")) == (2, 2)


@pytest.mark.parametrize("size,scheme", [("smoke", "tp-aware"),
                                         ("smoke", "naive-actorder"),
                                         ("six", "tp-aware")])
def test_carried_leaves_bit_equal(carried, size, scheme):
    """Every JAX leaf (``super.self``'s ``(n_super, n_self, ...)`` stack
    included) is the port's per-layer leaves stacked again, bit for bit;
    the port holds self layer (s, j) where the reference holds
    ``[s, j]``."""
    from repro.train import checkpoint as jax_checkpoint

    jeng, teng = carried(size, scheme)
    ns, nself = vl._n_super(teng.model.cfg)
    sup = teng.params["super"]
    assert len(sup) == ns and all(len(sp["self"]) == nself for sp in sup)
    assert float(sup[-1]["cross"]["gate_attn"]) == GATE
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
    wq = np.asarray(jeng.params["super"]["self"]["attn"]["wq"])
    for s in range(ns):
        for j in range(nself):
            np.testing.assert_array_equal(
                sup[s]["self"][j]["attn"]["wq"].numpy(), wq[s, j])


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------

def _batch(cfg, b: int, s: int, seed: int):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return toks, _patches(cfg, b, seed + 100)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_forward_matches_jax(carried, scheme):
    import jax.numpy as jnp
    from repro.models.common import REPLICATED

    jeng, teng = carried("smoke", scheme)
    toks, patches = _batch(teng.model.cfg, 2, 12, 2)
    ref = np.asarray(jeng.model.forward(
        jeng.params, {"tokens": jnp.asarray(toks),
                      "patches": jnp.asarray(patches, jnp.bfloat16)},
        REPLICATED))
    got = teng.prefill_logits({"tokens": torch.from_numpy(toks).long(),
                               "patches": _bf16(patches)}).numpy()
    assert got.shape == ref.shape
    assert _rel_gap(got, ref) <= REL_TOL


def test_six_layers_match_jax_layer_by_layer(carried):
    """Each of the six layers (self layers through
    ``transformer.layer_forward``, the gated cross layers) on the
    reference's bf16 input carry within 5e-3 of its output; then the
    whole forward in float32 activations within 5e-3."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jax_tfm
    from repro.models import vision_llama as jax_vl
    from repro.models import common as jax_cm
    from repro.models.common import REPLICATED

    jeng, teng = carried("six")
    cfg, jcfg = teng.model.cfg, jeng.model.cfg
    toks, patches = _batch(cfg, 2, 10, 3)
    jp = jnp.asarray(patches, jnp.bfloat16)
    self_fwd = jax_tfm._layer(jcfg, REPLICATED, None,
                              mlp_path="super.self.mlp")
    cross_fwd = jax_vl._cross_layer_fwd(jcfg, REPLICATED)
    x = jax_cm.embed_tokens(jcfg, jeng.params["embed"], jnp.asarray(toks),
                            REPLICATED)
    sup = jeng.params["super"]
    ns, nself = vl._n_super(cfg)
    for s in range(ns):
        for j in range(nself):
            lp = jax.tree.map(lambda a: a[s, j], sup["self"])
            y = self_fwd(x, lp, None)
            got = tfm.layer_forward(cfg, teng.params["super"][s]["self"][j],
                                    _torch(x), teng.policy,
                                    path=vl.SELF_MLP_PATH)
            assert _rel_gap(got.numpy(), np.asarray(y)) <= REL_TOL, (s, j)
            x = y.astype(x.dtype)
        cp = jax.tree.map(lambda a: a[s], sup["cross"])
        y = cross_fwd(x, cp, jp)
        got = vl.cross_layer_forward(cfg, teng.params["super"][s]["cross"],
                                     _torch(x), _bf16(patches), teng.policy)
        assert _rel_gap(got.numpy(), np.asarray(y)) <= REL_TOL, s
        x = y.astype(x.dtype)
    ref = np.asarray(jax_vl.forward(
        jcfg.with_(dtype="float32"), jeng.params,
        {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)},
        REPLICATED))
    got = vl.forward(cfg.with_(dtype="float32"), teng.params,
                     {"tokens": torch.from_numpy(toks).long(),
                      "patches": torch.from_numpy(patches)},
                     teng.policy).numpy()
    assert _rel_gap(got, ref) <= REL_TOL


def _jax_cross(jeng, patches: np.ndarray):
    import jax.numpy as jnp
    from repro.models import vision_llama as jax_vl

    ks, vs = jax_vl.precompute_cross(jeng.model.cfg, jeng.params,
                                     jnp.asarray(patches, jnp.bfloat16),
                                     jeng.ctx)
    return ks.astype(jnp.bfloat16), vs.astype(jnp.bfloat16)


def test_precompute_cross_matches_jax(carried):
    """Each superblock's cross K/V, written into the cache in place,
    within 5e-3 of the reference's (both bf16)."""
    import jax.numpy as jnp

    jeng, teng = carried("six")
    cfg = teng.model.cfg
    patches = _patches(cfg, 2, 5)
    cache = teng.init_cache(2)
    k, v = vl.precompute_cross(cfg, teng.params, _bf16(patches), cache)
    assert k.data_ptr() == cache["cross_k"].data_ptr()
    assert tuple(k.shape) == (2, 2, cfg.vision_tokens,
                              cm.head_grid(cfg)[0], cfg.head_dim)
    for t, r in zip((k, v), _jax_cross(jeng, patches)):
        assert _rel_gap(t.float().numpy(),
                        np.asarray(r.astype(jnp.float32))) <= REL_TOL


def _caches(jeng, teng, patches, b: int, max_seq: int = MAX_SEQ):
    ks, vs = _jax_cross(jeng, patches)
    jcache = dict(jeng.model.init_cache(b, max_seq), cross_k=ks, cross_v=vs)
    tcache = teng.model.init_cache(b, max_seq, device=CPU)
    tcache["cross_k"].copy_(_torch(ks))
    tcache["cross_v"].copy_(_torch(vs))
    return jcache, tcache


def _decode_pair(jeng, teng, patches, offsets, toks, jstep=None):
    """Step both engines over ``toks`` (B, steps) at positions ``offsets +
    t``, each step from the same caches (the reference's cross K/V, and
    before every step its self cache copied into the port's); yields each
    step's (port, JAX) logits and self caches after it."""
    import jax.numpy as jnp

    jstep = jstep or jeng._decode
    jcache, tcache = _caches(jeng, teng, patches, toks.shape[0])
    for t in range(toks.shape[1]):
        for name in ("k", "v"):
            tcache["self"][name].copy_(_torch(jcache["self"][name]))
        pos = offsets + t
        ref, jcache = jstep(jeng.params, jcache, jnp.asarray(toks[:, t]),
                            jnp.asarray(pos))
        got, tcache = teng.decode(tcache, torch.from_numpy(toks[:, t]).long(),
                                  torch.from_numpy(pos).long())
        yield (got.numpy(), np.asarray(ref),
               torch.cat([tcache["self"][n] for n in "kv"]).float().numpy(),
               np.concatenate([np.asarray(jcache["self"][n].astype(
                   jnp.float32)) for n in "kv"]))


def _greedy_pair(jeng, teng, patches, prompts, plen, n: int):
    """Greedy ids of both engines from the same cross K/V: the prompts
    replayed through the decode step, then ``n - 1`` steps."""
    import jax.numpy as jnp

    jcache, tcache = _caches(jeng, teng, patches, prompts.shape[0])
    jlast = tlast = 0
    for t in range(prompts.shape[1]):
        ref, jcache = jeng._decode(jeng.params, jcache,
                                   jnp.asarray(prompts[:, t]), t)
        got, tcache = teng.decode(tcache,
                                  torch.from_numpy(prompts[:, t]).long(), t)
        sel = plen[:, None] == t + 1
        jlast = np.where(sel, np.asarray(ref), jlast)
        tlast = np.where(sel, got.numpy(), tlast)
    jids, tids = [jlast.argmax(-1)], [tlast.argmax(-1)]
    pos = int(plen.max())
    for i in range(n - 1):
        ref, jcache = jeng._decode(jeng.params, jcache,
                                   jnp.asarray(jids[-1].astype(np.int32)),
                                   pos + i)
        got, tcache = teng.decode(tcache, torch.from_numpy(tids[-1]).long(),
                                  pos + i)
        jids.append(np.asarray(ref).argmax(-1))
        tids.append(got.numpy().argmax(-1))
    return np.stack(tids, 1), np.stack(jids, 1)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_and_greedy_ids_match_jax(carried, scheme):
    """10 lockstep steps, then 10 on unequal per-slot positions (the path
    the CUDA graph captures), against the reference's jitted step on the
    same caches; then greedy ids from the same cross K/V."""
    jeng, teng = carried("smoke", scheme)
    cfg = teng.model.cfg
    b = 3
    toks, patches = _batch(cfg, b, 10, 1)
    for offsets in (np.zeros(b, np.int32), np.array([0, 3, 9], np.int32)):
        for t, (got, ref, kv, jkv) in enumerate(_decode_pair(
                jeng, teng, patches, offsets, toks)):
            assert _rel_gap(got, ref) <= REL_TOL, (offsets, t)
            assert _rel_gap(kv, jkv) <= REL_TOL, (offsets, t)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 6)).astype(np.int32)
    got, ref = _greedy_pair(jeng, teng, _patches(cfg, 4, 14), prompts,
                            np.array([6, 4, 5, 3], np.int32), 6)
    np.testing.assert_array_equal(got, ref)


def test_six_layer_decode_matches_jax(carried):
    """The six-layer model's decode steps (float32 activations; the cache
    and the cross K/V bf16), lockstep and per-slot, on the reference's
    caches: every superblock's self cache at ``[s, j]``."""
    import jax
    from repro.models import vision_llama as jax_vl

    jeng, teng = carried("six")
    cfg = teng.model.cfg
    jcfg32 = jeng.model.cfg.with_(dtype="float32")
    jstep = jax.jit(lambda p, c, tok, pos: jax_vl.decode_step(
        jcfg32, p, c, tok, pos, jeng.ctx))
    t32 = Engine(model=build_model(cfg.with_(dtype="float32")),
                 params=teng.params, device=CPU, max_seq=MAX_SEQ)
    toks, patches = _batch(cfg, 3, 10, 6)
    for offsets in (np.zeros(3, np.int32), np.array([0, 3, 9], np.int32)):
        for t, (got, ref, kv, jkv) in enumerate(_decode_pair(
                jeng, t32, patches, offsets, toks, jstep=jstep)):
            assert _rel_gap(got, ref) <= REL_TOL, (offsets, t)
            assert _rel_gap(kv, jkv) <= REL_TOL, (offsets, t)


# ---------------------------------------------------------------------------
# the serving stack over the family
# ---------------------------------------------------------------------------

def test_paged_decode_bit_identical_to_dense():
    """fp pages of 5 (not dividing max_seq 12) give the dense step's
    logits bit for bit over every step of two slots on unequal clocks,
    at six layers ((2, 2) pool lead dims), gates open."""
    from repro_torch.cache.manager import PagedCacheManager
    from repro_torch.cache.spec import PageSpec

    cfg, batch, max_seq, ps = _cfg("six"), 2, 12, 5
    model = build_model(cfg)
    params = _open_gates(model.init(0, device=CPU))
    policy = ExecutionPolicy.from_config(cfg, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (max_seq, batch)))
    mgr = PagedCacheManager(PageSpec(page_size=ps), max_batch=batch,
                            max_seq=max_seq)
    dense = model.init_cache(batch, max_seq, device=CPU)
    pool = model.init_paged_cache(mgr.pool_pages, ps, device=CPU,
                                  batch=batch)
    assert tuple(pool["self"]["k"].shape[:2]) == (2, 2)
    patches = {"patches": _bf16(_patches(cfg, batch, 16))}
    with torch.inference_mode():
        for cache in (dense, pool):
            model.prefill_cross(params, patches, cache, policy)
        for i in range(batch):
            mgr.admit(i, toks[:1, i].numpy(), max_seq)
        for t in range(max_seq - 3):
            pos = torch.tensor([t, t + 3])
            for i in range(batch):
                mgr.ensure(i, int(pos[i]))
            table = torch.from_numpy(mgr.table())
            ld, _ = model.decode_step(params, dense, toks[t], pos, policy)
            lp, _ = model.decode_step(params, pool, toks[t], pos, policy,
                                      pages=table, kv_len=max_seq)
            np.testing.assert_array_equal(lp.numpy(), ld.numpy())


def test_flash_forward_is_the_einsum_forward():
    """``attn_backend="flash"`` runs the self layers through the flash
    wrapper (on the CPU its plain version) and leaves cross-attention on
    the einsum path: within 5e-3 of the einsum forward."""
    cfg = _cfg("six")
    eng = make_engine(cfg, 0, device=CPU, max_seq=MAX_SEQ)
    eng.params = _open_gates(eng.params)
    toks, patches = _batch(cfg, 2, 16, 9)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "patches": _bf16(patches)}
    xla = eng.prefill_logits(batch).numpy()
    flash = dataclasses.replace(eng, attn_backend="flash").prefill_logits(
        batch).numpy()
    assert _rel_gap(flash, xla) <= REL_TOL


def _drained_by_generate(eng, prompts: dict, max_new: dict, max_batch: int,
                         budget: int, scfg, seed: int) -> dict:
    """Each batch of ``max_batch`` requests, padded to ``budget``, through
    ``Engine.generate`` beside zero patches, sampled from the batch's
    generator: what batch-drain mode must give."""
    cfg = eng.model.cfg
    rids, out = sorted(prompts), {}
    for k, i0 in enumerate(range(0, len(rids), max_batch)):
        batch = rids[i0:i0 + max_batch]
        toks = np.zeros((len(batch), budget), np.int64)
        for row, rid in enumerate(batch):
            toks[row, :prompts[rid].size] = prompts[rid]
        gen = new_generator(derive_seed(seed, sched_mod.DRAIN_STREAM, k))
        ids = eng.generate(
            gen, {"tokens": torch.from_numpy(toks),
                  "patches": torch.zeros((len(batch), cfg.vision_tokens,
                                          cfg.d_model),
                                         dtype=torch.bfloat16)},
            [prompts[rid].size for rid in batch],
            max_new_tokens=max(max_new[rid] for rid in batch), scfg=scfg)
        for row, rid in enumerate(batch):
            out[rid] = ids[row, :max_new[rid]].tolist()
    return out


@pytest.mark.parametrize("scfg", [GREEDY, SamplingConfig(temperature=0.8,
                                                          top_k=40)],
                         ids=["greedy", "seeded"])
def test_batch_drain_run_equals_generate(scfg):
    """Five requests at max_batch 2: three batches through
    ``Engine.generate``; ``step()`` and ``EngineLoop`` refuse the
    family."""
    from repro_torch.serving.loop import EngineLoop

    eng = make_engine(_cfg("smoke"), 0, device=CPU, max_seq=MAX_SEQ)
    eng.params = _open_gates(eng.params)
    assert not eng.supports_continuous
    rng = np.random.default_rng(4)
    prompts = {i: rng.integers(1, eng.model.cfg.vocab_size,
                               size=n).astype(np.int32)
               for i, n in enumerate((6, 3, 8, 2, 5))}
    max_new = {0: 5, 1: 3, 2: 4, 3: 6, 4: 2}
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=scfg, seed=3)
    for rid, p in prompts.items():
        sched.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new[rid]))
    done = sched.run()
    assert {rid: r.output for rid, r in done.items()} == _drained_by_generate(
        eng, prompts, max_new, 2, 8, scfg, 3)
    with pytest.raises(RuntimeError, match="batch-drain only"):
        Scheduler(eng).step()
    with pytest.raises(ValueError, match="batch-drain scheduling"):
        EngineLoop(Scheduler(eng))


def test_cli_serves_in_process_refuses_http_and_serves_its_artifact(
        tmp_path, capsys):
    """``python -m repro_torch.launch.serve --arch llama-3.2-vision-90b
    --smoke --device cpu --requests 2 --max-new 4`` (its ``main``, in
    this process) serves through batch-drain mode; ``--http`` exits 1
    naming the refusal; ``prepare`` then ``--artifact`` give the same
    ids."""
    from repro_torch.launch import serve

    base = ["--device", "cpu", "--requests", "2", "--max-new", "4"]
    outputs = serve.main(["--arch", ARCH, "--smoke"] + base)
    assert sorted(outputs) == [0, 1]
    assert all(len(o) == 4 for o in outputs.values())
    assert "[scheme=tp-aware backend=torch collective=psum" in (
        capsys.readouterr().out)
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--http",
                    "127.0.0.1:0"])
    assert "batch-drain" in str(e.value.code)
    out = str(tmp_path / "art")
    serve.main(["prepare", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--out", out])
    assert serve.main(["--artifact", out] + base) == outputs


# ---------------------------------------------------------------------------
# the plan: the JAX artifact, the fold, the manifest
# ---------------------------------------------------------------------------

def _jax_prepare(tp: int, out: str) -> str:
    """The reference's prepare of the six-layer fold plan from seed 0 (its
    raw init under one jit, as ``carried`` runs it; the stages as
    ``compiler.prepare`` runs them)."""
    import jax
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.models.registry import build_model as jax_build_model
    from repro.plan import compiler as jax_compiler

    cfg = _jax_cfg("six").with_quant(attn_tp_aware=True)
    policy = JaxPolicy.from_config(cfg).with_(mesh=JaxMeshPlan(dp=1, tp=tp))
    key = jax.random.PRNGKey(0)
    raw = jax.jit(jax_build_model(cfg).init_raw)(key)
    return jax_compiler.compile_plan(
        cfg, raw, tp=tp, policy=policy, seed=0,
        rng=jax.random.fold_in(key, jax_compiler.PLAN_RNG_STREAM)).save(out)


def test_jax_fold_artifact_served_by_the_port(tmp_path):
    """A JAX-prepared six-layer tp=2 artifact with the V->O fold: the port
    loads it (``super`` and ``super.self`` split per rank file),
    validates it (the waived cross folds are accepted), reassembles the
    plan and serves it on one device, keeping the self layers' folds as
    (2, 2) nested lists and leaving the cross folds unused: the forward
    (gates opened in both; float32 activations, as the fold casts V and
    O to them) within 5e-3 of the reference's on the same plan.  The
    port's own prepare lists the same pairs (``super.self.mlp`` stacked
    ``[2, 2]``), the same leaf shards and the same folds, the self folds
    stacked ``(2, 2, ...)``."""
    import jax.numpy as jnp
    from repro.models import vision_llama as jax_vl
    from repro.models.common import REPLICATED
    from repro.plan import DeploymentArtifact as JaxArtifact

    jdir = _jax_prepare(2, str(tmp_path / "jax2"))
    cfg = _cfg("six").with_quant(attn_tp_aware=True)
    art = DeploymentArtifact.load(jdir, device=CPU)
    art.validate(cfg=cfg, policy=art.policy(), tp=2)
    teng = Engine(model=build_model(cfg), params=_open_gates(art.params()),
                  device=CPU, max_seq=MAX_SEQ, aux=art.aux)
    folds = teng.aux["attn_plans"]
    assert sorted(folds) == ["super.self.attn"]
    assert [len(f) for f in folds["super.self.attn"]] == [2, 2]
    jart = JaxArtifact.load(jdir)
    jparams = jart.params()
    sup = jparams["super"]
    cross = dict(sup["cross"], gate_attn=jnp.full((2,), GATE),
                 gate_mlp=jnp.full((2,), GATE))
    jparams = dict(jparams, super=dict(sup, cross=cross))
    toks, patches = _batch(cfg, 2, 10, 8)
    ref = np.asarray(jax_vl.forward(
        _jax_cfg("six").with_(dtype="float32"), jparams,
        {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)},
        REPLICATED, aux=jart.aux))
    got = teng.model.module.forward(
        cfg.with_(dtype="float32"), teng.params,
        {"tokens": torch.from_numpy(toks).long(),
         "patches": torch.from_numpy(patches)}, teng.policy,
        aux=teng.aux).numpy()
    assert _rel_gap(got, ref) <= REL_TOL
    port = compiler.prepare(cfg, tp=2, seed=0, device=CPU)
    key = lambda m: m["path"]  # noqa: E731
    assert sorted(port.manifest["pairs"], key=key) == sorted(
        art.manifest["pairs"], key=key)
    assert port.manifest["leaf_shards"] == art.manifest["leaf_shards"]
    plans, ref_plans = port.aux["attn_plans"], art.aux["attn_plans"]
    assert list(plans) == ["super.self.attn", "super.cross.xattn"]
    assert sorted(plans) == sorted(ref_plans)
    for path, pp in plans.items():
        assert pp.up.qweight.shape == ref_plans[path].up.qweight.shape
    assert tuple(plans["super.self.attn"].up.qweight.shape[:2]) == (2, 2)
    pairs = {m["path"]: m["stacked"] for m in port.manifest["pairs"]}
    assert pairs == {"super.self.mlp": [2, 2], "super.cross.mlp": [2]}
    assert port.manifest["leaf_shards"]["super||self||attn||wq"] == 3
    assert port.manifest["leaf_shards"]["super||cross||xattn||wo"] == 1


def test_prepare_is_model_init_and_round_trips(tmp_path):
    """``prepare``'s rank r equals ``Model.init(0, tp=2, rank=r)`` bit for
    bit at six layers; saved and loaded (every rank, or rank r's file
    alone), its trees come back as nested lists; ``params()``
    reassembles the whole plan."""
    cfg = _cfg("six")
    art = compiler.prepare(cfg, tp=2, seed=0, device=CPU)
    path = art.save(str(tmp_path / "art"))
    back = DeploymentArtifact.load(path, device=CPU)
    for r in (0, 1):
        want = checkpoint.flatten_keys(build_model(cfg).init(
            0, device=CPU, tp=2, rank=r))
        own = DeploymentArtifact.load_rank(path, r, device=CPU)
        assert own.load_stats.ranks == (r,)
        for tree in (art.rank_tree(r), back.rank_tree(r), own.rank_tree(r)):
            have = checkpoint.flatten_keys(tree)
            assert sorted(have) == sorted(want)
            assert all(torch.equal(have[k], t) for k, t in want.items())
    whole = checkpoint.flatten_keys(build_model(cfg).init(0, device=CPU))
    have = checkpoint.flatten_keys(back.params())
    assert sorted(have) == sorted(whole)
    assert all(torch.equal(have[k], t) for k, t in whole.items())


# ---------------------------------------------------------------------------
# tensor parallelism over gloo ranks
# ---------------------------------------------------------------------------

def _layer_outputs(cfg, params, policy, toks, patches, carries=None,
                   group=None):
    """Every self and cross layer's output (before its cast) on the input
    carries ``carries`` (default: this model's own), and those carries."""
    x = cm.embed_tokens(cfg, params["embed"], toks, group=group)
    own, outs, i = [], [], 0
    for sp in params["super"]:
        for lp in sp["self"] + [None]:
            xin = x if carries is None else carries[i]
            own.append(xin)
            y = (tfm.layer_forward(cfg, lp, xin, policy, group=group,
                                   path=vl.SELF_MLP_PATH) if lp is not None
                 else vl.cross_layer_forward(cfg, sp["cross"], xin, patches,
                                             policy, group=group))
            outs.append(y)
            x = y.to(x.dtype)
            i += 1
    return outs, own


def _run(eng, toks, patches, steps, prompts, group=None):
    with torch.inference_mode():
        cache = eng.init_cache(2)
        eng.model.prefill_cross(eng.params, {"patches": patches}, cache,
                                eng.policy, group=group)
        logits = []
        for t in range(steps.shape[1]):
            out, cache = eng.decode(cache, steps[:, t], t)
            logits.append(out.numpy())
        ids = eng.generate(None, {"tokens": prompts, "patches": patches},
                           [5, 3], max_new_tokens=5).numpy()
    return logits, ids, tuple(cache["cross_k"].shape)


def _tp_inputs(cfg):
    rng = np.random.default_rng(31)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 8))),
            "steps": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (2, 6))),
            "prompts": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 5))),
            "patches": _bf16(_patches(cfg, 2, 32))}


def _tp_rank(ctx, carries):
    cfg = _cfg("six")
    inp = _tp_inputs(cfg)
    eng = make_engine(cfg, 0, device=CPU, max_seq=MAX_SEQ, group=ctx.group)
    eng.params = _open_gates(eng.params)
    with torch.inference_mode():
        outs, _ = _layer_outputs(cfg, eng.params, eng.policy, inp["tokens"],
                                 inp["patches"], carries, ctx.group)
    logits, ids, cross = _run(eng, inp["tokens"], inp["patches"],
                              inp["steps"], inp["prompts"], ctx.group)
    return {"layers": [y.numpy() for y in outs], "steps": logits,
            "ids": ids, "cross_k": cross}


def test_tp2_over_gloo_matches_tp1_layer_by_layer():
    """At tp=2, six layers, gates open: each self and cross layer on the
    tp=1 engine's input carries within 1e-4 of max|.| of its tp=1
    output; the decode logits over 6 steps within 5e-3, greedy ids
    equal; each rank's cross K/V hold its KV heads."""
    cfg = _cfg("six")
    inp = _tp_inputs(cfg)
    one = make_engine(cfg, 0, device=CPU, max_seq=MAX_SEQ)
    one.params = _open_gates(one.params)
    with torch.inference_mode():
        refs, carries = _layer_outputs(cfg, one.params, one.policy,
                                       inp["tokens"], inp["patches"])
    logits, ids, _ = _run(one, inp["tokens"], inp["patches"], inp["steps"],
                          inp["prompts"])
    ranks = mesh.run(_tp_rank, 2, carries, device_type="cpu", timeout=180)
    kvh = cm.head_grid(cfg)[0]
    for r in ranks:
        assert r["cross_k"] == (2, 2, cfg.vision_tokens, kvh // 2,
                                cfg.head_dim)
        assert len(r["layers"]) == cfg.num_layers
        for i, (got, ref) in enumerate(zip(r["layers"], refs)):
            assert _rel_gap(got, ref.numpy()) <= 1e-4, i
        for t, (got, ref) in enumerate(zip(r["steps"], logits)):
            assert _rel_gap(got, ref) <= REL_TOL, t
        np.testing.assert_array_equal(r["ids"], ids)
