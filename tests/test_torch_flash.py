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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_kernel_matches_plain_version(dtype, tol):
    """K2 against its plain version on the card, at the reference's test
    shapes, ragged S/T, and 8 heads of the full-width forward (D 128, S
    2048); tolerance relative to max|ref| (plus 1e-5 in float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [case[:6] for case in SWEEP] + [
        (1, 3, 100, 64, True, None),        # ragged S = T
        (2, 2, 77, 128, False, None),
        (1, 2, 200, 32, True, 48),
        (1, 8, 2048, 128, True, None)]
    for b, h, s, d, causal, window in shapes:
        q, k, v = (torch.randn(b, h, s, d, generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        launches = tfa.flash_attention.launches
        y = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == launches + 1
        want = tfa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
        err = (y.float() - want.float()).abs().max().item()
        limit = tol * want.float().abs().max().item() + (
            1e-5 if dtype == torch.float32 else 0.0)
        assert err <= limit, (b, h, s, d, causal, window, err)
