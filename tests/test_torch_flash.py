"""Port parity of the flash-attention kernel (K2): ``ops.flash_attention``
on the CPU against the JAX Pallas kernel in interpret mode, at the shapes
of ``tests/test_kernels.py`` (causal, non-causal, windowed, uneven JAX
blocks), in float32 (rtol/atol 1e-5, the reference's own) and bfloat16
(2e-2).  On the card, the CUDA kernel against its plain version (``gpu``
marker; skips without a card).

JAX is imported inside the parity tests only, so the ``gpu`` tests also
run on a machine that has the card but no JAX:
``python -m pytest -q -m gpu tests/test_torch_flash.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref

#: (b, h, s, d, causal, window, JAX block_q, JAX block_k)
SWEEP = [
    (1, 2, 128, 32, True, None, 64, 64),
    (2, 2, 256, 64, True, None, 128, 128),
    (1, 1, 128, 32, False, None, 64, 64),
    (1, 2, 256, 32, True, 64, 64, 64),
    (1, 2, 128, 32, True, None, 128, 32),   # uneven q/k blocks
]


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("b,h,s,d,causal,window,bq,bk", SWEEP)
def test_flash_matches_jax_kernel(b, h, s, d, causal, window, bq, bk):
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    q, k, v = _qkv(b * s + d, (b, h, s, d))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=bq, block_k=bk))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the oracle is the twin of the reference's
    want_ref = np.asarray(jref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    got_ref = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_dtypes_match_jax_kernel(dtype):
    """Computed in float32 whatever the input type, written in q's type
    (bf16: one ulp of the output, 2e-2, as the reference's test)."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    q, k, v = _qkv(0, (1, 2, 128, 32))
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, block_q=64,
                                           block_k=64)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_flash_refuses_empty_window():
    q = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="window must be >= 1"):
        ops.flash_attention(q, q, q, window=0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half an ulp to the magnitude
    bits and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, eq, split):
    """``einsum(eq, a, b)`` with TF32 operands, as the kernel's mma.sync
    takes them: split 3xTF32 (small*big + big*small + big*big, the
    products exact in float32) or one TF32 product."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, ab, bb)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (torch.einsum(eq, asm, bb) + torch.einsum(eq, ab, bsm)
            + torch.einsum(eq, ab, bb))


def _tf32_attention(q, k, v, *, split):
    s, d = q.shape[2], q.shape[3]
    sc = _tf32_product(q, k, "bhsd,bhtd->bhst", split) * d ** -0.5
    mask = tfa.attention_mask(s, k.shape[2], causal=True, window=None)
    p = torch.softmax(sc.masked_fill(~mask, tfa.NEG_INF), dim=-1)
    return _tf32_product(p, v, "bhst,bhtd->bhsd", split)


def test_3xtf32_split_holds_the_float32_tolerance():
    """The numeric design of the CUDA kernel, on the CPU: both products
    with 3xTF32 operands stay within the float32 check limit
    (1e-5 * max|ref| + 1e-5) of the plain version; a single TF32 product
    does not, which is why the kernel splits float32 operands."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, (1, 2, 256, 128)))
    want = tfa.flash_attention_torch(q, k, v, causal=True)
    limit = 1e-5 * want.abs().max().item() + 1e-5
    err3 = (_tf32_attention(q, k, v, split=True) - want).abs().max().item()
    err1 = (_tf32_attention(q, k, v, split=False) - want).abs().max().item()
    assert err3 <= limit, (err3, limit)
    assert err1 > 4 * limit, (err1, limit)


#: (b, h, s, t, d, causal, window) of the card's test: the reference's
#: sweep, ragged S = T, windows inside and across a 64-key tile, S != T,
#: every head dim at S 2048, and 8 heads of the full-width forward
CUDA_CASES = [(b, h, s, s, d, causal, window)
              for b, h, s, d, causal, window, _, _ in SWEEP] + [
    (1, 3, 100, 100, 64, True, None),       # ragged S = T
    (2, 2, 77, 77, 128, False, None),
    (1, 2, 200, 200, 32, True, 48),
    (1, 2, 100, 100, 128, True, None),      # S not a multiple of 16 or 64
    (1, 2, 1000, 1000, 128, True, None),
    (1, 2, 300, 300, 128, True, 16),        # windows below, across a tile
    (1, 2, 300, 300, 64, True, 48),
    (1, 2, 300, 300, 128, True, 80),
    (1, 2, 300, 300, 128, False, 80),
    (1, 2, 100, 300, 128, False, None),     # S != T
    (2, 2, 300, 70, 64, False, None),
    (1, 2, 2048, 2048, 32, True, None),     # every head dim at S 2048
    (1, 2, 2048, 2048, 64, True, None),
    (1, 8, 2048, 2048, 128, True, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-3)])
def test_cuda_flash_kernel_matches_plain_version(dtype, tol):
    """K2 against its plain version on the card at ``CUDA_CASES``;
    tolerance relative to max|ref| (plus 1e-5 in float32): float32 as the
    reference's own tests, bfloat16 and float16 two ulps of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, s, t, d, causal, window in CUDA_CASES:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, h, t, d, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        launches = tfa.flash_attention.launches
        y = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == launches + 1
        want = tfa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
        err = (y.float() - want.float()).abs().max().item()
        limit = tol * want.float().abs().max().item() + (
            1e-5 if dtype == torch.float32 else 0.0)
        assert err <= limit, (b, h, s, t, d, causal, window, err, limit)
