"""Port parity: the dequant wrappers (``repro_torch.kernels.ops``) on the
CPU against the JAX Pallas kernels in interpret mode, at the shapes of
``tests/test_kernels.py`` plus the full-width down projection's group size
76 (groups straddle packed words): the ordered dequant-GEMM (K1), the
``g_idx`` dequant-GEMM of the naive layout (K4) and the dequantize kernel
(K5).  On the card, each CUDA kernel against its plain version (``gpu``
marker; skips without a card).

JAX is imported inside the parity tests only, so the ``gpu`` tests also
run on a machine that has the card but no JAX:
``python -m pytest -q -m gpu tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.kernels import dequant_matmul as tdk
from repro_torch.kernels import dispatch, ops

SHAPES = [
    (8, 128, 128, 32),
    (16, 256, 384, 64),
    (128, 512, 256, 128),
    (1, 256, 128, 64),      # decode-like M=1
    (4, 1024, 128, 128),    # deep K
    (4, 608, 128, 76),      # gs=76: a packed word straddles two groups
]

#: (torch dtype, rtol, atol): f32 as the reference's own kernel sweep;
#: bf16 rounds the output to 8 mantissa bits, whose last bit the two
#: frameworks' summation orders may set differently
DTYPES = {
    "float32": (torch.float32, 1e-5, 1e-4),
    "bfloat16": (torch.bfloat16, 2e-2, 2e-2),
}


#: the reference's g_idx kernel sweep (``tests/test_kernels.py``) plus
#: the down projection's group size 76
GIDX_SHAPES = [
    (8, 128, 128, 32),
    (16, 256, 384, 64),
    (32, 512, 256, 128),
    (4, 608, 128, 76),
]


def _quantized(seed, k, n, gs):
    import jax

    from repro.core import quantization as jqz

    r1, r2 = jax.random.split(jax.random.PRNGKey(seed))
    return jqz.quantize(jax.random.normal(r1, (k, n)), gs, rng=r2)


def _ordered(seed, k, n, gs):
    return _quantized(seed, k, n, gs).ordered


def _port(ql) -> QuantizedLinear:
    return QuantizedLinear(
        qweight=torch.from_numpy(np.array(ql.qweight).view(np.int32)),
        scales=torch.from_numpy(np.array(ql.scales)),
        zeros=torch.from_numpy(np.array(ql.zeros)),
        g_idx=(None if ql.g_idx is None
               else torch.from_numpy(np.array(ql.g_idx))),
        group_size=ql.group_size, kind=ql.kind)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n,gs", SHAPES)
def test_ops_dequant_matmul_matches_jax_kernel(m, k, n, gs, dtype):
    import jax.numpy as jnp

    from repro.kernels import dequant_matmul as jdk

    tdt, rtol, atol = DTYPES[dtype]
    ql = _ordered(m * 3 + k, k, n, gs)
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(
        np.float32)
    ref = jdk.dequant_matmul_ordered(jnp.asarray(x), ql.qweight, ql.scales,
                                     ql.zeros, group_size=gs,
                                     compute_dtype=getattr(jnp, dtype))
    got = ops.dequant_matmul(torch.from_numpy(x), _port(ql),
                             compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


def test_ops_flattens_leading_dims_and_checks_k():
    ql = _port(_ordered(7, 128, 96, 32))
    x = torch.randn(2, 3, 128, generator=torch.Generator().manual_seed(0))
    y = ops.dequant_matmul(x, ql)
    assert y.shape == (2, 3, 96)
    torch.testing.assert_close(y[1, 2], ops.dequant_matmul(x[1, 2:3], ql)[0])
    with pytest.raises(ValueError, match="K=64"):
        ops.dequant_matmul(x[..., :64], ql)


def test_pick_block_k_matches_jax():
    from repro.kernels import dequant_matmul as jdk

    for k, gs in ((1024, 128), (608, 76), (9728, 76), (2560, 128),
                  (256, 32)):
        for target in (256, 512):
            assert tdk.pick_block_k(k, gs, target) == \
                jdk.pick_block_k(k, gs, target)
    # the full-width K steps: whole groups of 76 straddle packed words
    assert tdk.pick_block_k(9728, 76) == 152
    assert tdk.pick_block_k(2560, 128) == 256


def test_cuda_backend_refuses_cpu_tensors():
    """backend='cuda' never quietly runs the plain version, for either
    layout kind."""
    res = _quantized(1, 128, 64, 32)
    for ql in (_port(res.ordered), _port(res.naive)):
        with pytest.raises(ValueError, match="needs tensors on the card"):
            dispatch.qmatmul(torch.zeros(2, 128), ql,
                             ExecutionPolicy(backend="cuda"))
    assert dispatch.backends("ordered") == ("cuda", "ref", "torch")
    assert dispatch.backends("naive") == ("cuda", "ref", "torch")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n,gs", GIDX_SHAPES)
def test_gidx_matches_jax_kernel(m, k, n, gs, dtype):
    """K4: ``ops.dequant_matmul`` on the naive layout and the kernel's
    plain version against the JAX g_idx kernel (interpret mode)."""
    import jax.numpy as jnp

    from repro.kernels import dequant_matmul as jdk

    tdt, rtol, atol = DTYPES[dtype]
    jql = _quantized(m * 5 + n, k, n, gs).naive
    x = np.random.default_rng(m + n).standard_normal((m, k)).astype(
        np.float32)
    ref = np.asarray(jdk.dequant_matmul_gidx(
        jnp.asarray(x), jql.qweight, jql.scales, jql.zeros, jql.g_idx,
        compute_dtype=getattr(jnp, dtype)), np.float32)
    ql = _port(jql)
    xt = torch.from_numpy(x)
    got = ops.dequant_matmul(xt, ql, compute_dtype=tdt)
    plain = tdk.dequant_matmul_gidx_torch(
        xt, ql.qweight, ql.scales, ql.zeros, ql.g_idx, compute_dtype=tdt)
    for y in (got, plain, ops.dequant_matmul_gidx(xt, ql,
                                                  compute_dtype=tdt)):
        assert y.dtype == tdt and y.shape == (m, n)
        np.testing.assert_allclose(y.float().numpy(), ref, rtol=rtol,
                                   atol=atol)


def test_gidx_entry_refuses_ordered_layout():
    ql = _port(_ordered(3, 128, 64, 32))
    with pytest.raises(ValueError, match="g_idx kernel got layout kind"):
        ops.dequant_matmul_gidx(torch.zeros(2, 128), ql)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,gs", [(128, 128, 32), (512, 384, 128),
                                    (608, 128, 76)])
def test_dequantize_matches_jax_kernel_bit_equal(k, n, gs, out_dtype):
    """K5: ``ops.dequantize`` of an ordered layout against the JAX
    dequantize kernel, bit for bit; a naive layout takes the plain
    dequantize, as the reference's ``ops.dequantize`` does."""
    import jax.numpy as jnp

    from repro.kernels import dequant_matmul as jdk
    from repro.kernels import ops as jops

    res = _quantized(k + n, k, n, gs)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    ref = jdk.dequantize_ordered(res.ordered.qweight, res.ordered.scales,
                                 res.ordered.zeros, group_size=gs,
                                 out_dtype=jdt)
    got = ops.dequantize(_port(res.ordered), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (k, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    ref_naive = jops.dequantize(res.naive, out_dtype=jdt)
    got_naive = ops.dequantize(_port(res.naive), out_dtype=tdt)
    np.testing.assert_array_equal(got_naive.float().numpy(),
                                  np.asarray(ref_naive, np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """The hand-written kernel against its plain version on the card;
    tolerance relative to max|ref| (float32 sums in another order, or one
    bf16 ulp of the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import quantization as tqz

    gen = torch.Generator(device="cuda").manual_seed(0)
    edges = [(5, 256, 102, 64), (33, 608, 200, 76)]   # ragged M and N
    full = [(4, 2560, 9728, 128), (4, 9728, 2560, 76)]  # qwen3-4b MLP
    for m, k, n, gs in SHAPES + edges + full:
        w = torch.randn(k, n, generator=gen, device="cuda")
        ql = tqz.quantize(w, gs, generator=gen).ordered
        x = torch.randn(m, k, generator=gen, device="cuda")
        launches = tdk.dequant_matmul_ordered.launches
        y = ops.dequant_matmul(x, ql, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert tdk.dequant_matmul_ordered.launches == launches + 1
        ref = tdk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=gs,
            compute_dtype=dtype)
        err = (y.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item() + 1e-4, \
            (m, k, n, gs, err)


def _cuda_quantized(gen, k, n, gs):
    from repro_torch.core import quantization as tqz

    w = torch.randn(k, n, generator=gen, device="cuda")
    return tqz.quantize(w, gs, generator=gen)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_gidx_kernel_matches_plain_version(dtype, tol):
    """K4 against its plain version on the card, with K1's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    edges = [(5, 256, 102, 64), (33, 608, 200, 76)]   # ragged M and N
    full = [(4, 2560, 9728, 128), (4, 9728, 2560, 76)]  # qwen3-4b MLP
    for m, k, n, gs in GIDX_SHAPES + edges + full:
        ql = _cuda_quantized(gen, k, n, gs).naive
        x = torch.randn(m, k, generator=gen, device="cuda")
        launches = tdk.dequant_matmul_gidx.launches
        y = ops.dequant_matmul(x, ql, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert tdk.dequant_matmul_gidx.launches == launches + 1
        ref = tdk.dequant_matmul_gidx_torch(
            x, ql.qweight, ql.scales, ql.zeros, ql.g_idx,
            compute_dtype=dtype)
        err = (y.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item() + 1e-4, \
            (m, k, n, gs, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dequantize_kernel_bit_equal_to_plain_version(dtype):
    """K5 against its plain version on the card: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for k, n, gs in [(128, 128, 32), (512, 384, 128), (608, 200, 76),
                     (256, 102, 64),                    # ragged N
                     (2560, 9728, 128), (9728, 2560, 76)]:
        ql = _cuda_quantized(gen, k, n, gs).ordered
        launches = tdk.dequantize_ordered.launches
        w = ops.dequantize(ql, out_dtype=dtype)
        torch.cuda.synchronize()
        assert tdk.dequantize_ordered.launches == launches + 1
        ref = tdk.dequantize_ordered_torch(
            ql.qweight, ql.scales, ql.zeros, group_size=gs, out_dtype=dtype)
        assert torch.equal(w, ref), (k, n, gs)
