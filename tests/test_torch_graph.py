"""The engine's captured decode step (``Engine.decode``), the port's
counterpart of the reference's jitted step.

On the CPU ``decode`` is the eager step.  The graph always runs the
per-slot path of ``attention_decode`` (positions in a (B,) tensor on the
card), so these tests hold that path bit for bit to the lockstep ``int``
path that ``prefill`` and ``generate`` take eagerly.  The ``gpu`` tests
hold the captured step bit for bit to ``decode_eager``; they skip without
a card (``python -m pytest -q -m gpu tests/test_torch_graph.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import dequant_matmul as dk
from repro_torch.kernels import ops
from repro_torch.runtime.serve import make_engine

B, STEPS, MAX_SEQ = 3, 20, 24


def _tokens(vocab: int, b: int, steps: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (steps, b)))


def _assert_same_cache(a: dict, b: dict, what: str):
    for name in ("k", "v"):
        assert torch.equal(a[name], b[name]), f"{what}: cache {name} differs"


@pytest.mark.parametrize("window", [None, 8])
def test_per_slot_step_equals_lockstep_step(window):
    """The per-slot path (a (B,) position tensor) gives the lockstep int
    path's logits and cache bit for bit, with and without a sliding
    window; with window 8, steps 8..19 write past the ring's wrap."""
    eng = make_engine(get_smoke_config("qwen3-4b"), 0, device="cpu",
                      max_seq=MAX_SEQ, window=window)
    lock, slot = eng.init_cache(B), eng.init_cache(B)
    for t, tok in enumerate(_tokens(eng.model.cfg.vocab_size, B, STEPS)):
        want, _ = eng.decode_eager(lock, tok, t)
        got, _ = eng.decode_eager(slot, tok, torch.full((B,), t))
        assert torch.equal(got, want), t
        _assert_same_cache(slot, lock, f"step {t}")


def test_cpu_decode_is_the_eager_step():
    """On the CPU ``decode`` is ``decode_eager``: the same bits, no graph,
    and logits that later steps do not overwrite."""
    eng = make_engine(get_smoke_config("qwen3-4b"), 0, device="cpu",
                      max_seq=MAX_SEQ)
    a, b = eng.init_cache(B), eng.init_cache(B)
    toks = _tokens(eng.model.cfg.vocab_size, B, 4, seed=1)
    kept = []
    for t, tok in enumerate(toks):
        got, _ = eng.decode(a, tok, torch.full((B,), t))
        want, _ = eng.decode_eager(b, tok, torch.full((B,), t))
        assert torch.equal(got, want), t
        kept.append((got, got.clone()))
    _assert_same_cache(a, b, "decode vs decode_eager")
    assert eng.graphs == {} and eng.captures == 0
    assert eng.decode_mode == "eager (cpu)"
    assert len({got.data_ptr() for got, _ in kept}) == len(kept)
    assert all(torch.equal(got, copy) for got, copy in kept)


def test_launch_counts_add_per_counter():
    """``add_launch_counts`` adds a replay's counts to each counter, in
    ``COUNTERS`` order, and takes them back with the negated counts."""
    before = ops.launch_counts()
    delta = tuple(range(1, len(ops.COUNTERS) + 1))
    try:
        ops.add_launch_counts(delta)
        assert ops.launch_counts() == tuple(
            a + d for a, d in zip(before, delta))
        assert dk.dequant_matmul_ordered.launches == before[0] + 1
        assert dk.dequant_matmul_ordered.tensor_core_launches == \
            before[1] + 2
    finally:
        ops.add_launch_counts(-d for d in delta)
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = make_engine(get_smoke_config("qwen3-4b"), 0, device="cuda",
                      max_seq=MAX_SEQ)
    assert eng.policy.backend == "cuda"
    return eng


def _positions(kind: str, t: int, b: int):
    """Lockstep: the int ``t``; per-slot: unequal clocks t, t+3, t+6..."""
    if kind == "lockstep":
        return t
    return t + 3 * torch.arange(b, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kind", ["lockstep", "per-slot"])
def test_captured_step_equals_eager_step(card_engine, b, kind):
    """Every step of the graph gives ``decode_eager``'s logits and cache
    bit for bit, at two batch sizes, on lockstep and on unequal per-slot
    positions; the first call captures, the others replay."""
    eng = card_engine
    graph_cache, eager_cache = eng.init_cache(b), eng.init_cache(b)
    toks = _tokens(eng.model.cfg.vocab_size, b, 12, seed=2).cuda()
    for t, tok in enumerate(toks):
        pos = _positions(kind, t, b)
        got, _ = eng.decode(graph_cache, tok, pos)
        want, _ = eng.decode_eager(eager_cache, tok, pos)
        assert torch.equal(got, want), t
        _assert_same_cache(graph_cache, eager_cache, f"step {t}")
    assert eng.captures == 1 and set(eng.graphs) == {b}
    assert eng.decode_mode == "CUDA graph, 1 captures"


@pytest.mark.gpu
def test_new_cache_recaptures(card_engine):
    """A cache at other addresses recaptures; its own cache replays."""
    eng = card_engine
    tok = torch.arange(B, device="cuda")
    first, second = eng.init_cache(B), eng.init_cache(B)
    eng.decode(first, tok, 0)
    eng.decode(first, tok, 1)
    assert eng.captures == 1
    eng.decode(second, tok, 0)
    assert eng.captures == 2
    eng.decode(second, tok, 1)
    assert eng.captures == 2
    eng.decode(eng.init_cache(B + 1), torch.arange(B + 1, device="cuda"), 0)
    assert eng.captures == 3 and set(eng.graphs) == {B, B + 1}


@pytest.mark.gpu
def test_replay_adds_one_capture_of_launches(card_engine):
    """A capturing call counts its eager step's launches only; each
    replay adds what the capture counted: 3 K1 launches a layer."""
    eng = card_engine
    cache = eng.init_cache(B)
    tok = torch.arange(B, device="cuda")
    per_step = 3 * eng.model.cfg.num_layers
    c0 = dk.dequant_matmul_ordered.launches
    eng.decode(cache, tok, 0)                       # eager step + capture
    assert dk.dequant_matmul_ordered.launches - c0 == per_step
    step = eng.graphs[B]
    assert step.launches[0] == per_step
    for t in (1, 2):
        before = ops.launch_counts()
        eng.decode(cache, tok, t)
        assert ops.launch_counts() == tuple(
            a + n for a, n in zip(before, step.launches))


@pytest.mark.gpu
def test_replay_does_not_sync(card_engine):
    """A replay, with its input copies and its logits' copy, makes no call
    that waits for the card."""
    eng = card_engine
    cache = eng.init_cache(B)
    tok = torch.arange(B, device="cuda")
    eng.decode(cache, tok, 0)
    pos = torch.full((B,), 1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = eng.decode(cache, tok, pos)
        eng.decode(cache, tok, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
