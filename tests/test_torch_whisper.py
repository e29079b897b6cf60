"""Port parity of the audio family (whisper-large-v3) at smoke size, on the
CPU: JAX params carried across through ``checkpoint.save`` ->
``repro_torch.interop`` (the ``enc_layers`` and ``dec_layers`` stacks
split into per-layer lists), then the port's encoder, cross K/V, forward,
decode and greedy ids against the reference's, for the tp-aware plan and
the naive act-order one.

* Configs, full and smoke, equal the reference's field for field and by
  ``config_hash``; ``ARCH_IDS`` keeps the reference's order.
* ``_sinusoid`` equals the reference's table within 1e-6.
* ``encode``, ``precompute_cross``, the forward and the decode step (10
  steps, lockstep and per-slot positions) within 5e-3 of max|.|
  (``tests/test_torch_model.py``'s bound), greedy ids equal; decode is
  held against the reference's decode only (ROADMAP caveat b).
  Positions past ``max_target_positions - 1`` clamp as the reference's.
* fp pages give the dense self-attention step bit for bit.
* The scheduler batch-drains the family: ``run()`` equals
  ``Engine.generate`` on the same padded rows with zero frames; ``step()``,
  ``EngineLoop`` and the CLI's ``--http`` refuse it.  The serve CLI runs
  in-process, and from its own ``prepare``'s artifact.
* A JAX-prepared artifact with the V->O fold is served by the port; the
  port's manifest lists the reference's pairs and leaf shards, and its
  aux the reference's folds (the consumed decoder fold and the waived
  encoder and cross folds).
* tp=2 over gloo ranks: each encoder and decoder layer on the tp=1
  engine's input carries, and the decode logits and greedy ids, against
  tp=1.

JAX is imported inside the tests and fixtures that run it: the gloo rank
processes import this module."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import derive_seed, new_generator
from repro_torch.launch import mesh
from repro_torch.models import common as cm
from repro_torch.models import whisper
from repro_torch.models.registry import build_model
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime import scheduler as sched_mod
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

ARCH = "whisper-large-v3"
SCHEMES = ("tp-aware", "naive-actorder")
REL_TOL = 5e-3
CPU = torch.device("cpu")
MAX_SEQ = 24
GREEDY = SamplingConfig(temperature=0.0)


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    """Random frame embeddings (B, enc_seq, d), bf16-exact float32."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


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
            # the reference's init and plan compile under one jit (a
            # fraction of their eager time); both sides run these params
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


# ---------------------------------------------------------------------------
# configs, tables and params
# ---------------------------------------------------------------------------

def test_configs_equal_the_references():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan.artifact import config_hash as jax_hash

    assert list(ARCH_IDS) == [a for a in JAX_ARCH_IDS if a in ARCH_IDS]
    assert ARCH in ARCH_IDS and "llama-3.2-vision-90b" in ARCH_IDS
    for port, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert part.config_hash(port) == jax_hash(ref)
    model = build_model(get_config(ARCH))
    assert model.module is whisper and model.has_cross
    assert model.attn_vo_path == "dec_layers.attn"
    assert set(model.attn_vo_waived) == {"enc_layers.attn",
                                         "dec_layers.xattn"}
    assert model.module.LAYER_STACKS == {"enc_layers": 1, "dec_layers": 1}


@pytest.mark.parametrize("seq,d", [(1500, 1280), (448, 1280), (32, 256)])
def test_sinusoid_equals_the_references(seq, d):
    from repro.models import whisper as jax_whisper

    ref = np.asarray(jax_whisper._sinusoid(seq, d))
    got = whisper._sinusoid(seq, d).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_carried_leaves_bit_equal(carried, scheme):
    """Every JAX leaf is the port's per-layer leaves stacked again (the
    encoder's and the decoder's stacks), bit for bit."""
    from repro.train import checkpoint as jax_checkpoint

    jeng, teng = carried(scheme)
    cfg = teng.model.cfg
    assert len(teng.params["enc_layers"]) == cfg.encoder_layers
    assert len(teng.params["dec_layers"]) == cfg.num_layers
    assert teng.params["dec_layers"][0]["mlp"].scheme == scheme
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
# the model against JAX
# ---------------------------------------------------------------------------

def _jax_cross(jeng, frames: np.ndarray):
    """The reference's encoder states and cross K/V (bf16, as its prefill
    casts them into the cache) of ``frames``."""
    import jax.numpy as jnp
    from repro.models import whisper as jax_whisper

    cfg = jeng.model.cfg
    enc = jax_whisper.encode(cfg, jeng.params,
                             jnp.asarray(frames, jnp.bfloat16), jeng.ctx)
    ks, vs = jax_whisper.precompute_cross(cfg, jeng.params, enc, jeng.ctx)
    return enc, ks.astype(jnp.bfloat16), vs.astype(jnp.bfloat16)


def _torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype (bf16 stays bf16)."""
    import jax.numpy as jnp

    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_and_precompute_cross_match_jax(carried, scheme):
    """The encoder's states within 5e-3 of the reference's, and the cross
    K/V of the same states, written into the cache in place, within 5e-3
    of the reference's (both bf16)."""
    import jax.numpy as jnp

    jeng, teng = carried(scheme)
    cfg = teng.model.cfg
    frames = _frames(cfg, 2, 11)
    enc, ks, vs = _jax_cross(jeng, frames)
    got = whisper.encode(cfg, teng.params, _bf16(frames), teng.policy)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(enc.astype(jnp.float32))
    assert _rel_gap(got.float().numpy(), ref) <= REL_TOL
    cache = teng.init_cache(2)
    k, v = whisper.precompute_cross(cfg, teng.params, _torch(enc), cache)
    assert k.data_ptr() == cache["cross_k"].data_ptr()
    assert v.data_ptr() == cache["cross_v"].data_ptr()
    for t, r in ((k, ks), (v, vs)):
        assert t.dtype == torch.bfloat16
        assert _rel_gap(t.float().numpy(),
                        np.asarray(r.astype(jnp.float32))) <= REL_TOL


@pytest.mark.parametrize("scheme", SCHEMES)
def test_forward_matches_jax(carried, scheme):
    """The decoder's forward over the reference's encoder states within
    5e-3 of the reference's forward; and the whole forward, encoder
    included, in float32 activations (frames and carries).  In bf16 a
    few one-ulp roundings of the encoder's carry that differ between the
    two (each layer agrees within 1e-6 on the same input) move this
    random model's logits by up to 1.5% of max|logit|, so the whole bf16
    forward is held stage by stage: the encoder in
    ``test_encode_and_precompute_cross_match_jax``, the decoder here."""
    import jax.numpy as jnp
    from repro.models import whisper as jax_whisper
    from repro.models.common import REPLICATED

    jeng, teng = carried(scheme)
    cfg = teng.model.cfg
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    frames = _frames(cfg, 2, 12)
    ref = np.asarray(jeng.model.forward(
        jeng.params, {"tokens": jnp.asarray(toks),
                      "frames": jnp.asarray(frames, jnp.bfloat16)},
        REPLICATED))
    enc, _, _ = _jax_cross(jeng, frames)
    got = whisper.decoder_forward(cfg, teng.params,
                                  torch.from_numpy(toks).long(), _torch(enc),
                                  teng.policy).numpy()
    assert got.shape == ref.shape
    assert _rel_gap(got, ref) <= REL_TOL
    jcfg32 = jeng.model.cfg.with_(dtype="float32")
    ref = np.asarray(jax_whisper.forward(
        jcfg32, jeng.params, {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)}, REPLICATED))
    got = whisper.forward(cfg.with_(dtype="float32"), teng.params,
                          {"tokens": torch.from_numpy(toks).long(),
                           "frames": torch.from_numpy(frames)},
                          teng.policy).numpy()
    assert _rel_gap(got, ref) <= REL_TOL


def _caches(jeng, teng, frames, b: int, max_seq: int = MAX_SEQ):
    """A JAX cache and a port cache of ``b`` rows over the same cross K/V
    (the reference's, of ``frames``)."""
    _, ks, vs = _jax_cross(jeng, frames)
    jcache = dict(jeng.model.init_cache(b, max_seq), cross_k=ks, cross_v=vs)
    tcache = teng.model.init_cache(b, max_seq, device=CPU)
    tcache["cross_k"].copy_(_torch(ks))
    tcache["cross_v"].copy_(_torch(vs))
    return jcache, tcache


def _decode_pair(jeng, teng, frames, offsets, toks, max_seq=MAX_SEQ,
                 jstep=None):
    """Step both engines over ``toks`` (B, steps) at positions ``offsets +
    t``, each step from the same caches: the reference's cross K/V, and
    before every step its self-attention cache copied into the port's.
    Yields each step's (port, JAX) logits and (port, JAX) self caches
    after it.  (Free-running, one bf16 rounding of a layer's carry that
    the two round apart (its float32 value agreeing within 1e-6) moves
    this random model's next logits by up to ~1% of max|logit|: a step is
    held on the reference's inputs.)  ``jstep``: the reference's step
    (default: the engine's jitted one)."""
    import jax.numpy as jnp

    jstep = jstep or jeng._decode
    jcache, tcache = _caches(jeng, teng, frames, toks.shape[0], max_seq)
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


def _greedy_pair(jeng, teng, frames, prompts, plen, n: int):
    """Greedy ids of both engines from the same cross K/V: the prompts
    replayed through the decode step (the engines' prefill), then ``n - 1``
    steps from ``max(plen)``."""
    import jax.numpy as jnp

    jcache, tcache = _caches(jeng, teng, frames, prompts.shape[0])
    keep = plen[:, None]
    jlast = tlast = None
    for t in range(prompts.shape[1]):
        ref, jcache = jeng._decode(jeng.params, jcache,
                                   jnp.asarray(prompts[:, t]), t)
        got, tcache = teng.decode(tcache,
                                  torch.from_numpy(prompts[:, t]).long(), t)
        sel = keep == t + 1
        jlast = np.where(sel, np.asarray(ref), 0 if jlast is None else jlast)
        tlast = np.where(sel, got.numpy(), 0 if tlast is None else tlast)
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
    the CUDA graph captures), against the reference's jitted step over
    the same cross K/V; then greedy ids from the same cross K/V, and
    ``Engine.generate``'s against the reference's (frames in)."""
    jeng, teng = carried(scheme)
    cfg = teng.model.cfg
    b, steps = 3, 10
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, steps)).astype(np.int32)
    frames = _frames(cfg, b, 13)
    for offsets in (np.zeros(b, np.int32), np.array([0, 3, 9], np.int32)):
        for t, (got, ref, kv, jkv) in enumerate(_decode_pair(
                jeng, teng, frames, offsets, toks)):
            assert _rel_gap(got, ref) <= REL_TOL, (offsets, t)
            assert _rel_gap(kv, jkv) <= REL_TOL, (offsets, t)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    plen = np.array([6, 4, 5, 3], np.int32)
    got, ref = _greedy_pair(jeng, teng, _frames(cfg, 4, 14), prompts, plen,
                            6)
    np.testing.assert_array_equal(got, ref)


def test_positions_past_the_last_clamp_as_the_references(carried):
    """The decoder's positions end at ``max_target_positions`` (128 at
    smoke size, 448 at full): steps at 120-140 clamp at 127 as the
    reference's do, within 5e-3 of its logits; at full width the
    embedding of a position past 447 is row 447's, and the int and the
    per-slot forms give the same bits."""
    jeng, teng = carried()
    cfg = teng.model.cfg
    assert cfg.max_target_positions == 128
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    offsets = np.array([120, 129], np.int32)
    for t, (got, ref, _, _) in enumerate(_decode_pair(
            jeng, teng, _frames(cfg, 2, 15), offsets, toks, max_seq=160)):
        assert _rel_gap(got, ref) <= REL_TOL, t
    full = get_config(ARCH)
    x = torch.zeros((3, 1, full.d_model), dtype=torch.bfloat16)
    table = whisper._sinusoid(448, full.d_model).to(torch.bfloat16)
    per_slot = whisper._positions(full, torch.tensor([447, 500, 3]), x)
    assert torch.equal(per_slot[:, 0], table[[447, 447, 3]])
    for p in (3, 447, 1000):
        assert torch.equal(whisper._positions(full, p, x)[0, 0],
                           table[min(p, 447)])


# ---------------------------------------------------------------------------
# the serving stack over the family
# ---------------------------------------------------------------------------

def test_paged_decode_bit_identical_to_dense():
    """fp pages of 5 (not dividing max_seq 12) give the dense step's
    logits bit for bit over every step of two slots on unequal clocks,
    both over the same cross K/V."""
    from repro_torch.cache.manager import PagedCacheManager
    from repro_torch.cache.spec import PageSpec

    cfg, batch, max_seq, ps = get_smoke_config(ARCH), 2, 12, 5
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    policy = ExecutionPolicy.from_config(cfg, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (max_seq, batch)))
    mgr = PagedCacheManager(PageSpec(page_size=ps), max_batch=batch,
                            max_seq=max_seq)
    dense = model.init_cache(batch, max_seq, device=CPU)
    pool = model.init_paged_cache(mgr.pool_pages, ps, device=CPU,
                                  batch=batch)
    frames = {"frames": _bf16(_frames(cfg, batch, 16))}
    with torch.inference_mode():
        for cache in (dense, pool):
            model.prefill_cross(params, frames, cache, policy)
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


def _prompts(cfg, sizes, seed=4) -> dict:
    rng = np.random.default_rng(seed)
    return {i: rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for i, n in enumerate(sizes)}


def _drained_by_generate(eng, prompts: dict, max_new: dict, max_batch: int,
                         budget: int, scfg, seed: int) -> dict:
    """What batch-drain mode must give: each batch of ``max_batch``
    requests, padded to ``budget``, through ``Engine.generate`` beside
    zero frames, sampled from the batch's generator."""
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
                  "frames": torch.zeros((len(batch), cfg.encoder_seq,
                                         cfg.d_model), dtype=torch.bfloat16)},
            [prompts[rid].size for rid in batch],
            max_new_tokens=max(max_new[rid] for rid in batch), scfg=scfg)
        for row, rid in enumerate(batch):
            out[rid] = ids[row, :max_new[rid]].tolist()
    return out


@pytest.mark.parametrize("scfg", [GREEDY, SamplingConfig(temperature=0.8,
                                                          top_k=40)],
                         ids=["greedy", "seeded"])
def test_batch_drain_run_equals_generate(scfg):
    """Three requests at max_batch 2: two batches through
    ``Engine.generate``, each row's own ``max_new_tokens`` of the ids;
    ``step()`` and ``EngineLoop`` refuse the family."""
    from repro_torch.serving.loop import EngineLoop

    eng = make_engine(get_smoke_config(ARCH), 0, device=CPU, max_seq=MAX_SEQ)
    assert not eng.supports_continuous
    prompts = _prompts(eng.model.cfg, (6, 3, 8))
    max_new = {0: 5, 1: 3, 2: 4}
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=scfg, seed=7)
    for rid, p in prompts.items():
        sched.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new[rid]))
    done = sched.run()
    want = _drained_by_generate(eng, prompts, max_new, 2, 8, scfg, 7)
    assert {rid: r.output for rid, r in done.items()} == want
    assert all(r.done for r in done.values())
    with pytest.raises(RuntimeError, match="batch-drain only"):
        Scheduler(eng).step()
    with pytest.raises(ValueError, match="batch-drain scheduling"):
        EngineLoop(Scheduler(eng))


def test_cli_serves_in_process_and_refuses_http(capsys):
    """``python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke
    --device cpu --requests 2 --max-new 4`` (its ``main``, in this
    process) serves through the scheduler's batch-drain mode; with
    ``--http`` it exits 1 naming the refusal."""
    from repro_torch.launch import serve

    outputs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(outputs) == [0, 1]
    assert all(len(o) == 4 for o in outputs.values())
    assert "[scheme=tp-aware backend=torch collective=psum" in out
    assert ARCH in serve.serve_parser().format_help()
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--http",
                    "127.0.0.1:0"])
    assert "batch-drain" in str(e.value.code)


def test_cli_prepare_and_artifact_serve_the_in_memory_ids(tmp_path, capsys):
    """``prepare --arch whisper-large-v3 --smoke`` then ``--artifact DIR``:
    the requests' ids of the in-memory serve."""
    from repro_torch.launch import serve

    base = ["--device", "cpu", "--requests", "2", "--max-new", "4"]
    want = serve.main(["--arch", ARCH, "--smoke"] + base)
    out = str(tmp_path / "art")
    serve.main(["prepare", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--out", out])
    assert serve.main(["--artifact", out] + base) == want
    assert f"artifact={out}]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the plan: the JAX artifact, the fold, the manifest
# ---------------------------------------------------------------------------

def _jax_prepare(tp: int, out: str, fold: bool = True) -> str:
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.plan import compiler as jax_compiler

    cfg = jax_smoke_config(ARCH).with_quant(attn_tp_aware=fold)
    policy = JaxPolicy.from_config(cfg).with_(mesh=JaxMeshPlan(dp=1, tp=tp))
    return jax_compiler.prepare(cfg, tp=tp, seed=0, policy=policy,
                                extra_manifest={"smoke": True}).save(out)


def test_jax_fold_artifact_served_by_the_port(tmp_path):
    """A JAX-prepared smoke artifact with the V->O fold: the port loads it
    (its stacks split per layer), validates it (the waived folds in its
    aux are accepted, and left unused), serves it through the decoder's
    fold: the forward and the decode steps (float32 activations; the fold
    casts V and O to the activations' dtype, and in bf16 the roundings
    that differ between the two move this random model's logits by ~1%)
    within 5e-3 of the JAX engine's on the same files, and the bf16
    greedy ids equal.  The port's own prepare lists the same pairs, the
    same leaf shards at tp 1 and 2, and the same folds in its aux."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import whisper as jax_whisper
    from repro.runtime.serve import make_engine as jax_make_engine

    jdir = _jax_prepare(1, str(tmp_path / "jax1"))
    cfg = get_smoke_config(ARCH).with_quant(attn_tp_aware=True)
    teng = make_engine(cfg, device=CPU, max_seq=MAX_SEQ, artifact=jdir)
    assert sorted(teng.aux["attn_plans"]) == ["dec_layers.attn"]
    assert len(teng.aux["attn_plans"]["dec_layers.attn"]) == cfg.num_layers
    jeng = jax_make_engine(jax_smoke_config(ARCH).with_quant(
        attn_tp_aware=True), max_seq=MAX_SEQ, artifact=jdir)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    frames = _frames(cfg, 2, 17)
    # the forward in float32 activations: the fold casts V to the
    # input's dtype, and in bf16 the roundings that differ between the
    # two move this random model's logits by ~1.5% (see
    # test_forward_matches_jax); the bf16 steps are held below
    ref = np.asarray(jax_whisper.forward(
        jeng.model.cfg.with_(dtype="float32"), jeng.params,
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        jeng.ctx, aux=jeng.aux))
    got = whisper.forward(cfg.with_(dtype="float32"), teng.params,
                          {"tokens": torch.from_numpy(toks).long(),
                           "frames": torch.from_numpy(frames)}, teng.policy,
                          aux=teng.aux).numpy()
    assert _rel_gap(got, ref) <= REL_TOL
    # the decode steps through the fold in float32 activations too (the
    # cache and the cross K/V stay bf16)
    jcfg32 = jeng.model.cfg.with_(dtype="float32")
    jstep = jax.jit(lambda p, c, tok, pos: jax_whisper.decode_step(
        jcfg32, p, c, tok, pos, jeng.ctx, aux=jeng.aux))
    t32 = Engine(model=build_model(cfg.with_(dtype="float32")),
                 params=teng.params, device=CPU, max_seq=MAX_SEQ,
                 aux=teng.aux)
    for t, (got, ref, kv, jkv) in enumerate(_decode_pair(
            jeng, t32, frames, np.array([0, 4], np.int32), toks,
            jstep=jstep)):
        assert _rel_gap(got, ref) <= REL_TOL, t
        assert _rel_gap(kv, jkv) <= REL_TOL, t
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    got, ref = _greedy_pair(jeng, teng, frames, prompts,
                            np.array([6, 6], np.int32), 6)
    np.testing.assert_array_equal(got, ref)
    # the engine's own prefill (frames in) serves the same plan
    ids = teng.generate(None, {"tokens": torch.from_numpy(prompts).long(),
                               "frames": _bf16(frames)}, [6, 6],
                        max_new_tokens=6)
    assert ids.shape == (2, 6)
    key = lambda m: m["path"]  # noqa: E731
    for tp in (1, 2):
        ref_dir = jdir if tp == 1 else _jax_prepare(2, str(tmp_path / "jax2"))
        ref_art = DeploymentArtifact.load(ref_dir, device=CPU)
        port = compiler.prepare(cfg, tp=tp, seed=0, device=CPU)
        assert sorted(port.manifest["pairs"], key=key) == sorted(
            ref_art.manifest["pairs"], key=key)
        assert port.manifest["leaf_shards"] == ref_art.manifest["leaf_shards"]
        plans, ref_plans = (a.aux["attn_plans"] for a in (port, ref_art))
        assert list(plans) == ["enc_layers.attn", "dec_layers.attn",
                               "dec_layers.xattn"]
        assert sorted(plans) == sorted(ref_plans)
        for path, pp in plans.items():
            assert pp.up.qweight.shape == ref_plans[path].up.qweight.shape
    pairs = {m["path"]: m["stacked"] for m in port.manifest["pairs"]}
    assert pairs == {"enc_layers.mlp": [cfg.encoder_layers],
                     "dec_layers.mlp": [cfg.num_layers]}


def test_prepare_is_model_init_and_round_trips(tmp_path):
    """``prepare``'s rank r equals ``Model.init(0, tp=2, rank=r)`` bit for
    bit; saved and loaded (every rank, or rank r's file alone), its trees
    come back in the port's layout."""
    cfg = get_smoke_config(ARCH)
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
    assert back.manifest["leaf_shards"]["dec_layers||xattn||wo"] == 1
    assert back.manifest["leaf_shards"]["enc_layers||attn||wq"] == 2


# ---------------------------------------------------------------------------
# tensor parallelism over gloo ranks
# ---------------------------------------------------------------------------

def _tp_inputs(cfg):
    rng = np.random.default_rng(21)
    return {"frames": _frames(cfg, 2, 22),
            "tokens": rng.integers(0, cfg.vocab_size, (2, 8)),
            "prompts": rng.integers(0, cfg.vocab_size, (2, 5)),
            "steps": rng.integers(0, cfg.vocab_size, (2, 6))}


def _layer_outputs(cfg, params, policy, inp, carries=None, group=None):
    """Every encoder and decoder layer's output (before its cast) on the
    input carries ``carries`` (default: this model's own), and those
    carries."""
    frames = _bf16(inp["frames"])
    x = frames + whisper._sinusoid(frames.shape[1], cfg.d_model).to(
        frames.dtype)
    own, outs = [], []
    for i, lp in enumerate(params["enc_layers"]):
        xin = x if carries is None else carries[i]
        own.append(xin)
        y = whisper.enc_layer_forward(cfg, lp, xin, policy, group=group)
        outs.append(y)
        x = y.to(x.dtype)
    enc = cm.apply_norm(cfg, params["enc_norm"], x)
    n = len(params["enc_layers"])
    toks = torch.from_numpy(inp["tokens"]).long()
    x = cm.embed_tokens(cfg, params["embed"], toks, group=group)
    x = x + whisper._sinusoid(toks.shape[1], cfg.d_model).to(x.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        xin = x if carries is None else carries[n + i]
        encin = enc if carries is None else carries[-1]
        own.append(xin)
        y = whisper.dec_layer_forward(cfg, lp, xin, encin, policy,
                                      group=group)
        outs.append(y)
        x = y.to(x.dtype)
    return outs, own + [enc]


def _tp_rank(ctx, inp, carries):
    cfg = get_smoke_config(ARCH)
    eng = make_engine(cfg, 0, device=CPU, max_seq=MAX_SEQ, group=ctx.group)
    with torch.inference_mode():
        outs, _ = _layer_outputs(cfg, eng.params, eng.policy, inp, carries,
                                 ctx.group)
        frames = _bf16(inp["frames"])
        cache = eng.init_cache(2)
        eng.model.prefill_cross(eng.params, {"frames": frames}, cache,
                                eng.policy, group=ctx.group)
        steps = []
        for t in range(inp["steps"].shape[1]):
            logits, cache = eng.decode(
                cache, torch.from_numpy(inp["steps"][:, t]).long(), t)
            steps.append(logits.numpy())
        ids = eng.generate(None, {"tokens": torch.from_numpy(
            inp["prompts"]).long(), "frames": frames}, [5, 3],
            max_new_tokens=5).numpy()
    return {"layers": [y.numpy() for y in outs], "steps": steps, "ids": ids,
            "cross_k": tuple(cache["cross_k"].shape)}


def test_tp2_over_gloo_matches_tp1_layer_by_layer():
    """At tp=2 (2 of 4 heads, half of each MLP pair per rank) each
    encoder and decoder layer, on the tp=1 engine's input carries, is
    within 1e-4 of max|.| of its tp=1 output; the decode logits over 6
    steps within 5e-3, greedy ids equal, and each rank's cross K/V hold
    its KV heads."""
    cfg = get_smoke_config(ARCH)
    inp = _tp_inputs(cfg)
    one = make_engine(cfg, 0, device=CPU, max_seq=MAX_SEQ)
    with torch.inference_mode():
        refs, carries = _layer_outputs(cfg, one.params, one.policy, inp)
        cache = one.init_cache(2)
        one.model.prefill_cross(one.params, {"frames": _bf16(inp["frames"])},
                                cache, one.policy)
        steps = []
        for t in range(inp["steps"].shape[1]):
            logits, cache = one.decode(
                cache, torch.from_numpy(inp["steps"][:, t]).long(), t)
            steps.append(logits.numpy())
        ids = one.generate(None, {"tokens": torch.from_numpy(
            inp["prompts"]).long(), "frames": _bf16(inp["frames"])}, [5, 3],
            max_new_tokens=5).numpy()
    ranks = mesh.run(_tp_rank, 2, inp, carries, device_type="cpu",
                     timeout=180)
    kvh = cm.head_grid(cfg)[0]
    for r in ranks:
        assert r["cross_k"] == (cfg.num_layers, 2, cfg.encoder_seq, kvh // 2,
                                cfg.head_dim)
        assert len(r["layers"]) == cfg.encoder_layers + cfg.num_layers
        for i, (got, ref) in enumerate(zip(r["layers"], refs)):
            assert _rel_gap(got, ref.numpy()) <= 1e-4, i
        for t, (got, ref) in enumerate(zip(r["steps"], steps)):
            assert _rel_gap(got, ref) <= REL_TOL, t
        np.testing.assert_array_equal(r["ids"], ids)
