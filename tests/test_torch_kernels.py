"""Port parity: the dequant-GEMM wrapper (``repro_torch.kernels.ops``) on
the CPU against the JAX Pallas kernel in interpret mode, at the shapes of
``tests/test_kernels.py`` plus the full-width down projection's group size
76 (groups straddle packed words).  On the card, the CUDA kernel against
its plain version (``gpu`` marker; skips without a card).

JAX is imported inside the parity tests only, so the ``gpu`` test also
runs on a machine that has the card but no JAX:
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


def _ordered(seed, k, n, gs):
    import jax

    from repro.core import quantization as jqz

    r1, r2 = jax.random.split(jax.random.PRNGKey(seed))
    return jqz.quantize(jax.random.normal(r1, (k, n)), gs, rng=r2).ordered


def _port(ql) -> QuantizedLinear:
    return QuantizedLinear(
        qweight=torch.from_numpy(np.array(ql.qweight).view(np.int32)),
        scales=torch.from_numpy(np.array(ql.scales)),
        zeros=torch.from_numpy(np.array(ql.zeros)),
        g_idx=None, group_size=ql.group_size, kind=ql.kind)


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
    """backend='cuda' never quietly runs the plain version."""
    ql = _port(_ordered(1, 128, 64, 32))
    with pytest.raises(ValueError, match="needs tensors on the card"):
        dispatch.qmatmul(torch.zeros(2, 128), ql,
                         ExecutionPolicy(backend="cuda"))
    assert dispatch.backends("ordered") == ("cuda", "ref", "torch")
    assert dispatch.backends("naive") == ("ref", "torch")


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
