"""Decode rows independent of the batch size (``models/common.row_stable``),
on the CPU.

A library GEMM picks its kernel by the row count, so on the card a
request's logits depended on how many requests were batched with it;
``row_stable`` runs every row count up to ``ROW_STABLE_MAX`` in blocks
of exactly ``row_block()`` rows (``ROW_BLOCK``, or an engine's
``row_block``).  Here: rows at M 1..8 bit-equal to the same rows of one
call at the fixed row count, at blocks of 4 and 8, through the helper
and through its callers on the decode path (``matmul``, the head, the
norm, decode attention); an engine steps in its own block; and a full
forward's long row count keeps its plain product.
``tools/row_stability.py`` shows the library's M dependence on the card
and the helper's rows there."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import common as cm

CPU = torch.device("cpu")


def _rows(m: int, *shape, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((m,) + shape, generator=gen)


@pytest.mark.parametrize("m", range(1, 9))
def test_row_stable_rows_equal_one_call_at_the_fixed_count(m):
    """Rows of an M-row call (one block, several, a ragged last one) are
    the bits of the same rows in one call at ``ROW_BLOCK`` rows."""
    w = _rows(64, 96, seed=1)
    x = _rows(cm.ROW_BLOCK * 2, 64)
    fixed = torch.cat([x[i:i + cm.ROW_BLOCK] @ w
                       for i in range(0, x.shape[0], cm.ROW_BLOCK)])
    got = cm.row_stable(lambda t: t @ w, x[:m])
    assert got.shape == (m, 96)
    assert torch.equal(got, fixed[:m])


@pytest.mark.parametrize("m", range(1, 9))
def test_row_blocks_sets_the_fixed_count(m):
    """Within ``row_blocks(8)`` rows of an M-row call are the bits of the
    same rows in one call at 8 rows; the block is restored after."""
    w = _rows(64, 96, seed=1)
    x = _rows(8, 64)
    with cm.row_blocks(8):
        assert cm.row_block() == 8
        got = cm.row_stable(lambda t: t @ w, x[:m])
    assert cm.row_block() == cm.ROW_BLOCK
    assert torch.equal(got, (x @ w)[:m])


def test_engine_steps_in_its_row_block(monkeypatch):
    """An engine's decode and forward run every ``row_stable`` op in
    blocks of its ``row_block`` (the serve CLI's ``--max-batch``)."""
    from repro_torch.runtime.serve import make_engine

    cfg = get_smoke_config("qwen3-4b")
    eng = make_engine(cfg, device=CPU, max_seq=8, row_block=8)
    seen = []
    real = cm.row_stable

    def spy(fn, *xs):
        seen.append(cm.row_block())
        return real(fn, *xs)

    monkeypatch.setattr(cm, "row_stable", spy)
    tokens = torch.tensor([3, 5, 7])
    eng.decode(eng.init_cache(3), tokens, 0)
    eng.prefill_logits(tokens[:, None])
    assert seen and set(seen) == {8}


def test_matmul_head_norm_and_attention_rows_do_not_depend_on_the_batch():
    """``matmul`` (the projections and the MoE router), ``lm_head``, the
    norm (its reduction) and the decode attention give each row the bits
    it has alone."""
    cfg = get_smoke_config("qwen3-4b")
    d, hd = cfg.d_model, cfg.head_dim
    gen = torch.Generator().manual_seed(2)
    head = {"lm_head": torch.randn(d, cfg.vocab_size, generator=gen)}
    w = torch.randn(d, 128, generator=gen)
    x = torch.randn(6, 1, d, generator=gen).bfloat16()
    q = torch.randn(6, 1, 4, hd, generator=gen)
    kv = torch.randn(2, 6, 9, 2, hd, generator=gen).bfloat16()
    mask = torch.arange(9)[None, None, :] <= torch.arange(6)[:, None, None]
    for fn in (lambda r: cm.matmul(x[r], w),
               lambda r: cm.lm_head(cfg, head, x[r]),
               lambda r: cm.apply_norm(cfg, {"scale": head["lm_head"][:, 0]},
                                       x[r].float() * 3),
               lambda r: cm.row_stable(cm._sdpa_decode, q[r], kv[0][r],
                                       kv[1][r], mask[r])):
        batch = fn(slice(0, 6))
        for i in range(6):
            assert torch.equal(batch[i:i + 1], fn(slice(i, i + 1))), i


def test_decode_attention_grouped_equals_repeated_heads():
    """The grouped GQA product of the decode step against the repeated-
    head form of the forward (``_sdpa``) within float32 rounding."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(3, 1, 8, 16, generator=gen)
    k, v = torch.randn(2, 3, 7, 2, 16, generator=gen)
    mask = torch.rand(3, 1, 7, generator=gen) > 0.3
    mask[..., 0] = True
    np.testing.assert_allclose(cm._sdpa_decode(q, k, v, mask).numpy(),
                               cm._sdpa(q, k, v, mask).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_long_row_counts_keep_the_plain_product():
    """Past ``ROW_STABLE_MAX`` rows (a full forward) the product is one
    plain call."""
    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return t * 2

    x = _rows(cm.ROW_STABLE_MAX + 1, 3)
    assert torch.equal(cm.row_stable(fn, x), x * 2)
    assert calls == [cm.ROW_STABLE_MAX + 1]
    calls.clear()
    cm.row_stable(fn, x[:cm.row_block() + 1])
    assert calls == [cm.row_block(), cm.row_block()]
