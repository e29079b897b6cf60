"""The port's paged KV cache (``repro_torch.cache``) and the scheduler's
paged mode, against the reference's on the CPU.

* ``PageSpec``, the allocator, the prefix keys and a scripted
  ``PagedCacheManager`` run equal the reference's (tables, ``fed0`` and
  ``stats()`` at each step, prefix hits, LRU resurrection and eviction);
* the page codec is bit-equal to the reference's on the same rows, and
  a page round trip stays within ``(max - min) / (2 * qmax)``;
* fp paged decode is bit-equal to dense decode at page sizes 1, 16 and 5
  with ``max_seq`` 15 (the gather returns the dense capacity's columns);
* the port's paged decode holds the reference's paged decode on the same
  params and table within 5e-3 of max|logit| (fp, int8, int4);
* the scheduler's paged serve gives a solo ``Engine.generate``'s greedy
  ids, shares prefix pages, queues on pool exhaustion and releases its
  cache; the CLI serves paged at tp 1 and 2;
* the policy and the artifact carry the layout.

JAX is imported inside the tests that run it, so the ``gpu`` tests run on
a machine without JAX (``python -m pytest -q -m gpu
tests/test_torch_cache.py``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.cache import (OutOfPages, PageAllocator, PagedCacheManager,
                               PageSpec, chain_keys)
from repro_torch.cache import paged as paged_pool
from repro_torch.cache.prefix import PrefixStore
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.kernels import dequant_matmul as dk
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.runtime import sampling
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine

CPU = torch.device("cpu")
GREEDY = sampling.SamplingConfig(temperature=0.0)
REL_TOL = 5e-3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# PageSpec and the policy
# ---------------------------------------------------------------------------

SPECS = [None, "dense", "paged:16", "paged:8:int4", "paged:64:int8",
         "paged:1", "paged", "paged:x", "paged:8:int3", "paged:8:fp8",
         "dense:8", "rows", "paged:0", "paged:4:int", "paged:4:8"]


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


@pytest.mark.parametrize("value", SPECS)
def test_page_spec_parse_equals_jax(value):
    """Each string parses to the reference's spec (fields, shorthand,
    ``pages_for``) or is refused by both."""
    from repro.cache import PageSpec as JaxPageSpec

    try:
        want = JaxPageSpec.parse(value)
    except ValueError:
        with pytest.raises(ValueError):
            PageSpec.parse(value)
        return
    got = PageSpec.parse(value)
    assert (got.page_size, got.bits) == (want.page_size, want.bits)
    assert got.shorthand() == want.shorthand()
    assert PageSpec.parse(got.shorthand()) == got
    if got.paged:
        assert [got.pages_for(t) for t in range(40)] == \
            [want.pages_for(t) for t in range(40)]


def test_page_spec_refuses_bits_without_pages():
    with pytest.raises(ValueError):
        PageSpec(bits=8)
    with pytest.raises(ValueError):
        PageSpec(page_size=0)
    assert PageSpec(page_size=5).pages_for(11) == 3


@pytest.mark.parametrize("page_size,bits,want", [
    (None, None, "dense"), (4, None, "paged:4"), (4, 8, "paged:4:int8"),
    (16, 4, "paged:16:int4")])
def test_policy_from_config_builds_the_page_spec(page_size, bits, want):
    """``from_config`` builds a ``PageSpec``, as the reference does (it
    once built the string ``"paged:4:None"`` for fp pages)."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.policy import ExecutionPolicy as JaxPolicy

    kw = dict(mode="mlp", kv_page_size=page_size, kv_bits=bits)
    pol = ExecutionPolicy.from_config(
        get_smoke_config("qwen3-4b").with_quant(**kw), device=CPU)
    assert pol.kv == PageSpec(page_size=page_size, bits=bits)
    assert pol.kv.shorthand() == want == JaxPolicy.from_config(
        jax_smoke_config("qwen3-4b").with_quant(**kw)).kv.shorthand()
    assert ExecutionPolicy(kv=want).kv == pol.kv


def test_artifact_manifest_carries_the_layout():
    """The manifest's ``kv`` is the layout's shorthand and ``policy()``
    carries it back; ``validate`` ignores it (runtime-only)."""
    cfg = get_smoke_config("qwen3-4b").with_quant(mode="mlp")
    policy = ExecutionPolicy.from_config(cfg, device=CPU).with_(
        kv="paged:8:int4")
    art = compiler.prepare(cfg, tp=1, seed=0, policy=policy, device=CPU)
    assert art.manifest["policy"]["kv"] == "paged:8:int4"
    assert art.policy(backend="auto", device=CPU).kv == PageSpec(8, 4)
    art.validate(cfg=cfg, policy=policy.with_(kv="dense"), tp=1)


# ---------------------------------------------------------------------------
# allocator, prefix keys, manager: the reference's, copied
# ---------------------------------------------------------------------------

def test_allocator_refcounts_reservations_and_lru():
    a = PageAllocator(4)
    pids = [a.alloc() for _ in range(4)]
    assert len(set(pids)) == 4 and a.free_pages == 0
    with pytest.raises(OutOfPages):
        a.alloc()
    a.retain(pids[0])
    a.release(pids[0])
    assert a.refcount(pids[0]) == 1
    a.release(pids[0])
    assert a.refcount(pids[0]) == 0 and a.free_pages == 1
    b = PageAllocator(4)
    b.reserve(3)
    assert b.available() == 1 and not b.can_reserve(2)
    with pytest.raises(OutOfPages):
        b.reserve(2)
    evicted = []
    c = PageAllocator(3, evict_cb=evicted.append)
    p0, p1, _ = (c.alloc() for _ in range(3))
    c.release(p0, keep_cached=True)
    c.release(p1, keep_cached=True)
    c.retain(p1)
    assert c.alloc() == p0 and evicted == [p0] and c.evictions == 1


def test_chain_keys_and_prefix_store_equal_jax():
    from repro.cache import chain_keys as jax_chain_keys

    toks = np.random.default_rng(0).integers(0, 1000, 37).astype(np.int32)
    for ps in (1, 4, 5, 16, 64):
        assert chain_keys(toks, ps) == jax_chain_keys(toks, ps)
    store = PrefixStore()
    store.register(7, b"key")
    assert store.lookup(b"key") is None
    store.mark_complete(7)
    store.register(8, b"key")
    assert store.lookup(b"key") == 7


def _manager_script(rng):
    """Admit / run / release operations that exercise concurrent
    identical prompts, prefix hits from the LRU, and eviction under
    pressure (page size 4, 8 pages, 3 slots)."""
    a = rng.integers(1, 500, 10)
    b = rng.integers(1, 500, 16)
    c = rng.integers(1, 500, 12)
    return [("admit", 0, a, 3), ("admit", 1, a, 3), ("run", 0, 0, 12),
            ("release", 0), ("admit", 2, a, 2), ("run", 1, 0, 12),
            ("release", 1), ("run", 2, 8, 11), ("release", 2),
            ("admit", 0, b, 1), ("admit", 1, c, 5), ("run", 0, 0, 16),
            ("run", 1, 0, 16), ("release", 0), ("release", 1),
            ("admit", 2, b, 2), ("run", 2, 12, 17), ("release", 2)]


def _apply(mgr, op):
    kind, slot = op[0], op[1]
    if kind == "admit":
        return mgr.admit(slot, op[2], op[3])
    if kind == "run":
        for pos in range(op[2], op[3]):
            mgr.ensure(slot, pos)
            mgr.advance(slot, pos + 1)
        return None
    return mgr.release(slot)


def test_manager_script_equals_jax():
    """One scripted sequence through both managers: each step's return
    (``fed0``), table and ``stats()`` are equal."""
    from repro.cache import PageSpec as JaxPageSpec
    from repro.cache import PagedCacheManager as JaxManager

    port = PagedCacheManager(PageSpec(page_size=4), max_batch=3,
                             max_seq=20, n_pages=8)
    ref = JaxManager(JaxPageSpec(page_size=4), max_batch=3, max_seq=20,
                     n_pages=8)
    for mgr in (port, ref):
        mgr.page_bytes, mgr.page_bytes_fp = 64, 128
    for i, op in enumerate(_manager_script(np.random.default_rng(4))):
        assert _apply(port, op) == _apply(ref, op), (i, op[:2])
        np.testing.assert_array_equal(port.table(), ref.table(),
                                      err_msg=str(i))
        assert port.stats() == ref.stats(), (i, op[:2])
    st = port.stats()
    assert st["prefix"]["hits"] >= 4 and st["pages"]["evictions"] >= 1
    assert st["pages"]["live"] == 0 and port.pool_pages == 9


# ---------------------------------------------------------------------------
# the page codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,qmax", [(8, paged_pool.INT8_QMAX),
                                       (4, paged_pool.INT4_QMAX)])
def test_page_codec_bit_equal_to_jax(bits, qmax):
    """``_quantize_rows`` (codes, scale, zero) and ``_pack_last`` give the
    reference's bits on the same seeded rows (int4 words as int32)."""
    import jax.numpy as jnp
    from repro.cache import paged as jax_paged

    x = np.random.default_rng(bits).normal(size=(3, 5, 2, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.25                      # an all-equal row: scale 1
    codes, scale, zero = paged_pool._quantize_rows(torch.from_numpy(x), qmax)
    jc, js, jz = jax_paged._quantize_rows(jnp.asarray(x), qmax)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(zero.numpy(), np.asarray(jz))
    if bits == 4:
        packed = paged_pool._pack_last(codes)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jax_paged._pack_last(jc)).view(
                np.int32))
        assert torch.equal(paged_pool._unpack_last(packed), codes)


@pytest.mark.parametrize("bits,qmax", [(8, paged_pool.INT8_QMAX),
                                       (4, paged_pool.INT4_QMAX)])
def test_quantized_page_round_trip_error_bound(bits, qmax):
    """scatter -> gather through an intN pool dequantizes every stored
    (token, head) row within ``(max - min) / (2 * qmax)``."""
    pool = paged_pool.init_pool((), 6, 4, 2, 16, bits=bits)
    assert paged_pool.pool_bits(pool) == bits
    rng = np.random.default_rng(0)
    b = 3
    pages = torch.arange(b * 2, dtype=torch.int32).reshape(b, 2)
    stored = []
    for t in range(8):
        k, v = (torch.from_numpy(rng.normal(size=(b, 2, 16)).astype(
            np.float32)) for _ in range(2))
        paged_pool.scatter_token(pool, k, v, pages, torch.full((b,), t))
        stored.append((k, v))
    gk, gv = paged_pool.gather(pool, pages, 8)
    for t, (k, v) in enumerate(stored):
        for got, ref in ((gk[:, t], k), (gv[:, t], v)):
            bound = (ref.amax(-1) - ref.amin(-1)) / (2 * qmax) + 1e-6
            assert ((got - ref).abs().amax(-1) <= bound).all(), (bits, t)


def test_pool_bytes_and_int4_head_dim():
    raw, i8, i4 = (paged_pool.init_pool((3,), 4, 8, 2, 16, bits=bits)
                   for bits in (None, 8, 4))
    (b_raw, fp_raw), (b8, fp8), (b4, fp4) = (
        paged_pool.pool_page_bytes(p, 4) for p in (raw, i8, i4))
    assert b_raw == fp_raw == fp8 == fp4 and b4 < b8 < b_raw
    with pytest.raises(ValueError, match="head_dim"):
        paged_pool.init_pool((), 2, 4, 2, 12, bits=4)


# ---------------------------------------------------------------------------
# paged decode == dense decode, bit for bit
# ---------------------------------------------------------------------------

def _paired_decode(arch, page_size, max_seq=15, batch=2):
    """Dense and paged decode side by side over ``max_seq`` steps; the
    last step's logits of each."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    policy = ExecutionPolicy.from_config(cfg, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (max_seq, batch)))
    mgr = PagedCacheManager(PageSpec(page_size=page_size), max_batch=batch,
                            max_seq=max_seq)
    dense = model.init_cache(batch, max_seq, device=CPU)
    pool = model.init_paged_cache(mgr.pool_pages, page_size, device=CPU)
    for i in range(batch):
        mgr.admit(i, toks[:1, i].numpy(), max_seq)
    with torch.inference_mode():
        for t in range(max_seq):
            pos = torch.full((batch,), t)
            for i in range(batch):
                mgr.ensure(i, t)
            table = torch.from_numpy(mgr.table())
            ld, _ = model.decode_step(params, dense, toks[t], pos, policy)
            lp, _ = model.decode_step(params, pool, toks[t], pos, policy,
                                      pages=table, kv_len=max_seq)
    return ld, lp


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-3-8b"])
@pytest.mark.parametrize("page_size", [1, 16, 5])
def test_paged_decode_bit_identical_to_dense(arch, page_size):
    """fp pages give the dense step's logits bit for bit, at page size 1,
    16 (more than ``max_seq`` 15: the table's columns overrun the dense
    capacity, which the gather does not read) and a non-dividing 5."""
    ld, lp = _paired_decode(arch, page_size)
    np.testing.assert_array_equal(lp.numpy(), ld.numpy())


# ---------------------------------------------------------------------------
# the port's paged decode against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX model and params, port model and params): one smoke plan."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.runtime.serve import make_engine as jax_make_engine
    from repro.train import checkpoint

    jeng = jax_make_engine(jax_smoke_config("qwen3-4b"),
                           jax.random.PRNGKey(0), max_seq=16)
    path = checkpoint.save(str(tmp_path_factory.mktemp("ckpt") / "p.npz"),
                           jeng.params)
    model = build_model(get_smoke_config("qwen3-4b"))
    return jeng, model, interop.load_params(path, device=CPU)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_paged_decode_matches_jax(carried, bits):
    """Ten paged steps of two slots on unequal clocks through the same
    table: the port's logits within 5e-3 of max|logit| of the
    reference's (``tests/test_torch_model.py``'s bound), greedy ids
    equal."""
    import jax
    import jax.numpy as jnp
    from repro.models.common import REPLICATED

    jeng, model, params = carried
    jmodel = jeng.model
    policy = ExecutionPolicy.from_config(model.cfg, device=CPU)
    ps, batch, max_seq, steps = 4, 2, 16, 10
    mgr = PagedCacheManager(PageSpec(page_size=ps, bits=bits),
                            max_batch=batch, max_seq=max_seq)
    for i in range(batch):
        mgr.admit(i, np.zeros(1, np.int32), max_seq - 1)
    pool = model.init_paged_cache(mgr.pool_pages, ps, bits=bits,
                                  device=CPU)
    jpool = jmodel.init_paged_cache(batch, mgr.pool_pages, ps, bits=bits)
    jstep = jax.jit(lambda p, c, t, pos, pg: jmodel.decode_step(
        p, c, t, pos, REPLICATED, pages=pg))
    toks = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (steps, batch))
    for t in range(steps):
        pos = np.array([t, t + 3])
        for i in range(batch):
            mgr.ensure(i, int(pos[i]))
        table = mgr.table()
        with torch.inference_mode():
            got, _ = model.decode_step(
                params, pool, torch.from_numpy(toks[t]), torch.from_numpy(
                    pos), policy, pages=torch.from_numpy(table),
                kv_len=max_seq)
        want, jpool = jstep(jeng.params, jpool, jnp.asarray(toks[t]),
                            jnp.asarray(pos, jnp.int32), jnp.asarray(table))
        want = np.asarray(want)
        gap = np.abs(got.numpy() - want).max()
        assert gap <= REL_TOL * np.abs(want).max(), (bits, t, gap)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))


# ---------------------------------------------------------------------------
# the scheduler's paged mode
# ---------------------------------------------------------------------------

def _paged_engine(page_size=4, bits=None, max_seq=24):
    cfg = get_smoke_config("qwen3-4b").with_quant(
        mode="mlp", kv_page_size=page_size, kv_bits=bits)
    return make_engine(cfg, 0, device=CPU, max_seq=max_seq)


@pytest.fixture(scope="module")
def paged_engine():
    return _paged_engine()


def test_scheduler_paged_equals_solo_and_shares_prefix(paged_engine):
    """The reference's waves: wave 1's identical prompts both replay
    (their pages are incomplete); wave 2 resurrects the retired pages
    from the LRU, one request the whole prompt, one only the first page,
    and their staggered lengths leave an idle lane stepping beside a
    live one (the scratch page).  Every request's greedy ids equal a solo
    ``Engine.generate``."""
    eng = paged_engine
    assert eng.uses_page_table and eng.supports_continuous
    vocab = eng.model.cfg.vocab_size
    rng = np.random.default_rng(3)
    base = rng.integers(1, vocab, size=8).astype(np.int32)
    prompts = {0: base.copy(), 1: base.copy(),
               2: np.concatenate([base[:4], rng.integers(
                   1, vocab, 3).astype(np.int32)]),
               3: base.copy()}
    max_new = {0: 5, 1: 5, 2: 6, 3: 3}
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=GREEDY)
    for wave in ((0, 1), (2, 3)):
        for rid in wave:
            sched.submit(Request(rid=rid, prompt=prompts[rid],
                                 max_new_tokens=max_new[rid]))
        done = sched.run()
    for rid, p in prompts.items():
        ref = eng.generate(None, torch.from_numpy(p)[None], [p.size],
                           max_new_tokens=max_new[rid], scfg=GREEDY)[0]
        assert done[rid].output == ref.tolist(), rid
    st = sched.cache_stats()
    assert st["spec"] == "paged:4" and st["prefix"]["hits"] >= 3
    assert st["bytes"]["saved_prefix"] > 0
    assert st["pages"]["live"] == 0 and st["per_request_pages"] == {}


def test_scheduler_paged_quantized_pages_save_bytes():
    eng = _paged_engine(bits=8)
    rng = np.random.default_rng(0)
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=GREEDY)
    for i in range(2):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, eng.model.cfg.vocab_size, 6).astype(np.int32),
            max_new_tokens=4))
    done = sched.run()
    assert all(len(r.output) == 4 for r in done.values())
    st = sched.cache_stats()
    assert st["spec"] == "paged:4:int8"
    assert st["bytes"]["saved_quantized"] > 0
    assert st["bytes"]["per_page"] < st["bytes"]["dense_equiv"] // (
        sched.manager.pmax * sched.max_batch)


def test_scheduler_pool_exhaustion_queues_not_fails(paged_engine):
    """A pool with room for one worst-case request admits two one at a
    time (the second waits, FIFO) and both finish; a request the pool can
    never hold is refused at submit."""
    eng = paged_engine
    pmax = PageSpec(page_size=4).pages_for(24)
    sched = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=GREEDY,
                      n_pages=pmax)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, eng.model.cfg.vocab_size, 8).astype(np.int32),
        max_new_tokens=16) for i in range(2)]
    sched.submit(reqs[0])
    sched.step()
    assert sched.live_slots == 1 and not sched.can_admit(reqs[1])
    sched.submit(reqs[1])
    sched.step()
    assert sched.live_slots == 1
    done = sched.run()
    assert sorted(done) == [0, 1]
    assert all(len(r.output) == 16 for r in done.values())
    tiny = Scheduler(eng, max_batch=2, prompt_budget=8, scfg=GREEDY,
                     n_pages=2)
    with pytest.raises(ValueError, match="never be admitted"):
        tiny.submit(Request(rid=9, prompt=np.zeros(8, np.int32),
                            max_new_tokens=4))


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_release_cache_lifetime(paged):
    """The cache frees once traffic drains and is built again by the next
    request, dense and paged."""
    eng = (_paged_engine(max_seq=16) if paged else
           make_engine(get_smoke_config("qwen3-4b"), 0, device=CPU,
                       max_seq=16))
    sched = Scheduler(eng, max_batch=2, prompt_budget=4, scfg=GREEDY)
    assert not sched.release_cache()
    sched.submit(Request(rid=0, prompt=np.asarray([1, 2, 3], np.int32),
                         max_new_tokens=2))
    sched.step()
    assert sched.cache_stats()["allocated"] and not sched.release_cache()
    first = sched.run()[0].output
    assert sched.release_cache()
    st = sched.cache_stats()
    assert not st["allocated"]
    if paged:
        assert st["pages"]["live"] == 0 and st["pages"]["cached"] == 0
    else:
        assert "bytes" not in st
    sched.submit(Request(rid=1, prompt=np.asarray([1, 2, 3], np.int32),
                         max_new_tokens=2))
    assert sched.run()[1].output == first
    assert sched.cache_stats()["builds"] == 2


def test_paged_step_refuses_window_and_lockstep(paged_engine):
    eng = paged_engine
    pool = eng.init_paged_cache(7)
    table = torch.zeros((1, 6), dtype=torch.int32)
    tok = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="per-slot"):
        eng.decode_eager(pool, tok, 0, table)
    windowed = Engine(model=eng.model, params=eng.params, device=CPU,
                      max_seq=24, window=8, policy=eng.policy)
    with pytest.raises(ValueError, match="window"):
        windowed.decode_eager(pool, tok, torch.zeros(1, dtype=torch.int64),
                              table)


def test_paged_step_requires_kv_len(paged_engine):
    """A paged step names the columns it gathers (the dense capacity);
    there is no ``Pmax * ps`` default."""
    eng = paged_engine
    pool = eng.init_paged_cache(7)
    table = torch.zeros((1, 6), dtype=torch.int32)
    tok = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="kv_len"):
        eng.model.decode_step(eng.params, pool, tok,
                              torch.zeros(1, dtype=torch.int64), eng.policy,
                              pages=table)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(args):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _ids(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith("req ")]


def test_cli_paged_ids_equal_dense_at_tp1_and_tp2():
    """``--kv-page-size 4`` gives the dense serve's seeded ids at one rank
    and at two gloo ranks; the banner names the layout."""
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--max-new",
            "4"]
    dense = _run(base)
    paged = _run(base + ["--kv-page-size", "4"])
    tp2 = _run(base + ["--kv-page-size", "4", "--tp", "2", "--collective",
                       "quant-int8:fused"])
    assert "kv=dense" in dense and "kv=paged:4 " in paged
    assert "kv=paged:4 mesh=dp1xtp2" in tp2
    assert len(_ids(dense)) == 3
    assert _ids(paged) == _ids(dense) == _ids(tp2)


def test_cli_http_at_tp2_names_the_item():
    """``--tp 2 --http`` serves (``tests/test_torch_serving_tp.py``); a
    grid of tp=2 replicas (``--mesh dp2xtp2``) still refuses ``--http``
    and names the item."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--mesh", "dp2xtp2", "--http", "127.0.0.1:0"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 1 and "item 9" in proc.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card_paged():
    """(dense engine, paged:4 engine) over the same smoke params."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dense = make_engine(get_smoke_config("qwen3-4b"), 0, device="cuda",
                        max_seq=24)
    paged = Engine(model=dense.model, params=dense.params, device="cuda",
                   max_seq=24, policy=dense.policy.with_(kv="paged:4"))
    return dense, paged


def _card_steps(eng, cache, steps, b, table=None, eager=False):
    """``steps`` per-slot steps on unequal clocks; each step's logits."""
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, eng.model.cfg.vocab_size, (steps, b))).cuda()
    step = eng.decode_eager if eager else eng.decode
    out = []
    for t in range(steps):
        pos = t + 3 * torch.arange(b, device="cuda")
        out.append(step(cache, toks[t], pos, table)[0]
                   if table is not None else step(cache, toks[t], pos)[0])
    return out


def _card_table(b, max_seq=24, ps=4):
    mgr = PagedCacheManager(PageSpec(page_size=ps), max_batch=b,
                            max_seq=max_seq)
    for i in range(b):
        mgr.admit(i, np.zeros(1, np.int32), max_seq - 1)
        mgr.ensure(i, max_seq - 1)
    return mgr, torch.from_numpy(mgr.table()).cuda()


@pytest.mark.gpu
def test_captured_paged_step_equals_eager_and_dense(card_paged):
    """The captured paged step gives the eager paged step's logits and
    pool bit for bit, and the captured dense step's logits (fp pages),
    over 12 steps of 3 slots; each replay launches K1 3 times a layer."""
    dense, paged = card_paged
    b, steps = 3, 12
    mgr, table = _card_table(b)
    pools = [paged.init_paged_cache(mgr.pool_pages) for _ in range(2)]
    got = _card_steps(paged, pools[0], steps, b, table)
    want = _card_steps(paged, pools[1], steps, b, table, eager=True)
    ref = _card_steps(dense, dense.init_cache(b), steps, b)
    for t in range(steps):
        assert torch.equal(got[t], want[t]), t
        assert torch.equal(got[t], ref[t]), t
    for name in pools[0]:
        assert torch.equal(pools[0][name], pools[1][name]), name
    assert paged.captures == 1 and paged.graphs[b].pages is not None
    assert paged.graphs[b].launches[0] == 3 * paged.model.cfg.num_layers
    assert dk.dequant_matmul_ordered.launches > 0


@pytest.mark.gpu
def test_release_cache_recaptures(card_paged):
    """``release_cache`` drops the captured step with the pool; the next
    serve builds a pool, captures again and gives the same ids."""
    _, paged = card_paged
    sched = Scheduler(paged, max_batch=2, prompt_budget=8, scfg=GREEDY)
    prompt = np.arange(1, 7, dtype=np.int32)
    outs = []
    for rid in range(2):
        sched.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        outs.append(sched.run()[rid].output)
        assert sched.release_cache() and paged.graphs == {}
    assert outs[0] == outs[1] and paged.captures == 2
