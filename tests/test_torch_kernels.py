"""Port parity: the dequant wrappers (``repro_torch.kernels.ops``) on the
CPU against the JAX Pallas kernels in interpret mode, at the shapes of
``tests/test_kernels.py`` plus the full-width down projection's group size
76 (groups straddle packed words): the ordered dequant-GEMM (K1), the
``g_idx`` dequant-GEMM of the naive layout (K4), the dequantize kernel
(K5) and the fused dequant-GEMM + wire quantize (K3, at the shapes of
``tests/test_fused_wire.py``).  On the card, each CUDA kernel against its
plain version (``gpu`` marker; skips without a card), K1's tensor-core
loop at large M among them, and K3 bit for bit against K1 followed by the
collective's quantizer, and K4's rows bit-equal whatever the batch or
the column tile.  On the CPU, the tensor-core loop's 3xTF32 arithmetic,
emulated with bit operations, and K4's sum order (64 row slots, then a
fixed-order sum), emulated in float32, against the float32 limit.

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
    from repro_torch.comm.spec import CollectiveSpec

    with pytest.raises(ValueError, match="needs tensors on the card"):
        dispatch.qmatmul_wire(torch.zeros(2, 128), _port(res.ordered),
                              ExecutionPolicy(backend="cuda"),
                              spec=CollectiveSpec.parse("quant-int8"), tp=2)
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
    # qwen3-4b MLP at decode M, an EP data rank's 8 rows and 64 rows
    full = [(m, k, n, gs) for k, n, gs in ((2560, 9728, 128),
                                           (9728, 2560, 76))
            for m in (4, 8, 64)]
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k1_rows_do_not_depend_on_the_batch(dtype):
    """K1's sum order depends on N, K, the group size and the card, never
    on M: at the full-width shapes the rows of calls at M 4, 8, 17, 64 and
    255 (every M below the large-M loop's threshold takes the decode loop)
    are bit-equal to the same rows run one at a time (M = 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(6)
    assert tdk.tensor_core_min_m() > 255
    for k, n, gs in ((2560, 9728, 128), (9728, 2560, 76)):
        ql = _cuda_quantized(gen, k, n, gs).ordered
        args = (ql.qweight, ql.scales, ql.zeros)
        x = torch.randn(255, k, generator=gen, device="cuda")
        solo = torch.cat([tdk.dequant_matmul_ordered(
            x[i:i + 1], *args, group_size=gs, compute_dtype=dtype)
            for i in range(255)])
        for m in (4, 8, 17, 64, 255):
            assert torch.equal(tdk.dequant_matmul_ordered(
                x[:m], *args, group_size=gs, compute_dtype=dtype),
                solo[:m]), (k, n, m)


@pytest.mark.gpu
def test_cuda_decode_loop_refuses_a_group_size_it_does_not_take():
    """K1's float32 decode loop takes groups of a multiple of 4 rows, at
    least 8 (every configuration's): K1 and K3 raise on others in
    float32, and bfloat16 takes them on its own loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for k, gs in ((80, 10), (64, 4)):
        ql = _cuda_quantized(gen, k, 128, gs).ordered
        x = torch.randn(4, k, generator=gen, device="cuda")
        with pytest.raises(ValueError, match="multiple of 4 rows"):
            ops.dequant_matmul(x, ql)
        with pytest.raises(ValueError, match="multiple of 4 rows"):
            ops.dequant_matmul_wire(x, ql, tp=2, wire_bits=8, wire_block=32)
        y = ops.dequant_matmul(x, ql, compute_dtype=torch.bfloat16)
        ref = tdk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=gs,
            compute_dtype=torch.bfloat16)
        assert (y.float() - ref.float()).abs().max().item() <= \
            1e-2 * ref.float().abs().max().item(), (k, gs)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half an ulp to the magnitude
    bits and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("k,gs", [(2560, 128), (9728, 76)])
def test_3xtf32_split_holds_the_float32_tolerance(k, gs):
    """The numeric design of K1's tensor-core loop, on the CPU, at the
    full-width up/gate and down K and group sizes (M 64, N 256): x and the
    dequantized weight split 3xTF32 (small*big + big*small + big*big, the
    products exact in float32) stay within the float32 check limit
    (1e-5 * max|ref| + 1e-4) of the plain version; a single TF32 product
    lies more than 4x above it, which is why the loop splits."""
    from repro_torch.core import quantization as tqz

    gen = torch.Generator().manual_seed(k)
    rng = np.random.default_rng(gs)
    ql = tqz.quantize(torch.from_numpy(rng.standard_normal(
        (k, 256)).astype(np.float32)), gs, generator=gen).ordered
    x = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    want = tdk.dequant_matmul_ordered_torch(x, ql.qweight, ql.scales,
                                            ql.zeros, group_size=gs)
    limit = 1e-5 * want.abs().max().item() + 1e-4
    w = tdk.dequantize_ordered_torch(ql.qweight, ql.scales, ql.zeros,
                                     group_size=gs)
    xb, wb = _tf32(x), _tf32(w)
    xs, wsm = _tf32(x - xb), _tf32(w - wb)
    err3 = (xs @ wb + xb @ wsm + xb @ wb - want).abs().max().item()
    err1 = (xb @ wb - want).abs().max().item()
    assert err3 <= limit, (err3, limit)
    assert err1 > 4 * limit, (err1, limit)


def _split_of(n: int, k: int, bk: int, sms: int = 132) -> tuple:
    """K1's K split (``choose_split`` in the kernel's header) on a card of
    ``sms`` SMs: (K steps of bk a split, splits)."""
    nsteps = k // bk
    splits = min(max(-(-4 * sms // -(-n // 128)), 1), nsteps)
    per = -(-nsteps // splits)
    return per, -(-nsteps // per)


def _round_to_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _decode_loop_in_kernel_order(x, qweight, scales, zeros, gs,
                                 big_only=False):
    """The float32 decode loop's arithmetic, emulated: x in two TF32 parts
    (big, then the remainder's TF32 rounding), each product with the exact
    integer q - z exact; per K split of a 132-SM card, per 128-k stage,
    each of the two 64-k chunks of a stage (a warp's) summed one 8-k step
    at a time per group it touches, into a zeroed sum per x part that the
    tensor cores round toward zero at every step; each such sum times the
    group's scale added to the warp's float32 sum (a fused multiply-add);
    then the two warps' big parts and their small parts added in order,
    then the splits in order.  ``big_only``: x's big part alone."""
    k, n = qweight.shape[0] * 8, qweight.shape[1]
    qz = (qz_unpack(qweight).double()
          - zeros.double().repeat_interleave(gs, 0))
    sk = scales.double()
    x = x.float()
    xb = _tf32(x)
    xs = torch.zeros_like(x) if big_only else _tf32(x - xb)
    xb, xs = xb.double(), xs.double()
    m = x.shape[0]
    bk = tdk.pick_block_k(k, gs)
    per, splits = _split_of(n, k, bk)
    y = torch.zeros(m, n, dtype=torch.float32)
    for z in range(splits):
        kb = z * per * bk
        ke = min(kb + per * bk, k)
        warps = [[torch.zeros(m, n, dtype=torch.float32) for _ in range(2)]
                 for _ in range(2)]              # [wk][big, small]
        for k0 in range(kb, ke, 128):
            for wk in range(2):
                kc = k0 + 64 * wk
                if kc >= ke:
                    continue
                for g in range(kc // gs, (min(kc + 64, ke) - 1) // gs + 1):
                    parts = [torch.zeros(m, n, dtype=torch.float32)
                             for _ in range(2)]
                    for ks in range(kc, min(kc + 64, ke), 8):
                        lo, hi = max(ks, g * gs), min(ks + 8, (g + 1) * gs)
                        if lo >= hi:
                            continue
                        for p, xp in enumerate((xb, xs)):
                            parts[p] = _round_to_zero(
                                parts[p].double() + xp[:, lo:hi]
                                @ qz[lo:hi])
                    for p in range(2):
                        warps[wk][p] = (warps[wk][p].double()
                                        + sk[g] * parts[p].double()).float()
        ysplit = torch.zeros(m, n, dtype=torch.float32)
        for p in range(2):
            for wk in range(2):
                ysplit = ysplit + warps[wk][p]
        y = y + ysplit
    return y


def qz_unpack(qweight: torch.Tensor) -> torch.Tensor:
    from repro_torch.core import quantization as tqz

    return tqz.unpack_int4(qweight)


#: the full-width qwen3-4b up/gate and down projections (K, gs) at M 8,
#: N 256
FULL_TF32 = [(8, 2560, 256, 128), (8, 9728, 256, 76)]


@pytest.mark.parametrize("m,k,n,gs", SHAPES + FULL_TF32)
def test_decode_loop_tf32_form_holds_the_float32_tolerance(m, k, n, gs):
    """The numeric design of K1's float32 decode loop, emulated on the CPU
    in the kernel's order: x in two TF32 parts times the exact integer
    q - z, each group's sum (per 8-k step into a zeroed sum per x part,
    truncated as the tensor cores accumulate) times its scale.  Within
    the float32 limit the kernel is held to (1e-5 * max|ref| + 1e-4) of
    the JAX kernel (interpret mode) at the reference's shapes, and of the
    plain version at the full-width up/gate and down projections (gs 76:
    groups straddle packed words and chunks); x's big part alone lies
    more than 4x above the limit there, which is why x is split."""
    if (m, k, n, gs) in FULL_TF32:
        from repro_torch.core import quantization as tqz

        rng = np.random.default_rng(k + gs)
        ql = tqz.quantize(torch.from_numpy(rng.standard_normal(
            (k, n)).astype(np.float32)), gs,
            generator=torch.Generator().manual_seed(k)).ordered
        xt = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        ref = tdk.dequant_matmul_ordered_torch(
            xt, ql.qweight, ql.scales, ql.zeros, group_size=gs).numpy()
    else:
        import jax.numpy as jnp

        from repro.kernels import dequant_matmul as jdk

        jql = _ordered(m * 3 + k, k, n, gs)
        x = np.random.default_rng(m + k).standard_normal((m, k)).astype(
            np.float32)
        ref = np.asarray(jdk.dequant_matmul_ordered(
            jnp.asarray(x), jql.qweight, jql.scales, jql.zeros,
            group_size=gs, compute_dtype=jnp.float32), np.float32)
        ql = _port(jql)
        xt = torch.from_numpy(x)
    limit = 1e-5 * np.abs(ref).max() + 1e-4
    got = _decode_loop_in_kernel_order(xt, ql.qweight, ql.scales, ql.zeros,
                                       gs)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = np.abs(got.numpy() - ref).max()
    assert err <= limit, (err, limit)
    if (m, k, n, gs) in FULL_TF32:
        big = _decode_loop_in_kernel_order(xt, ql.qweight, ql.scales,
                                           ql.zeros, gs, big_only=True)
        err1 = np.abs(big.numpy() - ref).max()
        assert err1 > 4 * limit, (err1, limit)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_large_m_matches_plain_version(dtype, tol):
    """K1 at and above the tensor-core loop's threshold against its plain
    version, with the decode loop's tolerance: the full-width MLP shapes
    at M 2048 (blocks of 128 rows for up/gate, of 160 for down), ragged M
    (the threshold - 1, + 1, 2047), ragged N (102, 200; 2501, odd, in
    blocks of 160 rows) at gs 76 and 64, a K step past K (K 152), groups
    smaller than a K step (gs 8).  float32 calls at M >= the threshold
    take the tensor-core loop, and only those; bfloat16 stays on the
    decode loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(4)
    t = tdk.tensor_core_min_m()
    cases = [(2048, 2560, 9728, 128), (2048, 9728, 2560, 76),
             (t - 1, 608, 200, 76), (t, 608, 200, 76), (t + 1, 608, 200, 76),
             (2047, 256, 102, 64), (t + 1, 256, 102, 64),
             (t + 3, 152, 200, 76), (t + 5, 64, 128, 8),
             (2047, 152, 2501, 76)]
    for m, k, n, gs in cases:
        ql = _cuda_quantized(gen, k, n, gs).ordered
        x = torch.randn(m, k, generator=gen, device="cuda")
        launches = tdk.dequant_matmul_ordered.launches
        tc = tdk.dequant_matmul_ordered.tensor_core_launches
        y = ops.dequant_matmul(x, ql, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert tdk.dequant_matmul_ordered.launches == launches + 1
        assert tdk.dequant_matmul_ordered.tensor_core_launches == tc + int(
            dtype == torch.float32 and m >= t), (m, dtype)
        ref = tdk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=gs,
            compute_dtype=dtype)
        assert y.shape == ref.shape and torch.isfinite(y.float()).all()
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
    """K4 against its plain version on the card, with K1's tolerance: the
    reference's shapes, ragged M and N (102, 200: not a multiple of the
    16- or 32-column tiles; 130: not of 4), G 304 (K 9728, gs 32: the
    largest table a block stages), the full-width qwen3-4b MLP shapes at
    M 1, 4, 5, 17 and 33 (both tile heights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    edges = [(5, 256, 102, 64), (33, 608, 200, 76), (4, 608, 130, 76),
             (4, 9728, 2560, 32), (17, 9728, 200, 32)]
    full = [(m, k, n, gs) for k, n, gs in ((2560, 9728, 128), (9728, 2560, 76))
            for m in (1, 4, 5, 17, 33)]
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
def test_cuda_gidx_rows_do_not_depend_on_the_batch(dtype):
    """K4's sum order depends on K alone: at the full-width shapes the rows
    of an M = 4 call (4-row tiles) and of an M = 17 call (16-row tiles)
    are bit-equal to the same rows run at M = 1, and the 16- and 32-column
    tiles give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for k, n, gs in ((2560, 9728, 128), (9728, 2560, 76)):
        ql = _cuda_quantized(gen, k, n, gs).naive
        args = (ql.qweight, ql.scales, ql.zeros, ql.g_idx)
        x = torch.randn(17, k, generator=gen, device="cuda")
        solo = torch.cat([tdk.dequant_matmul_gidx(
            x[i:i + 1], *args, compute_dtype=dtype) for i in range(17)])
        assert torch.equal(tdk.dequant_matmul_gidx(
            x[:4], *args, compute_dtype=dtype), solo[:4]), (k, n)
        assert torch.equal(tdk.dequant_matmul_gidx(
            x, *args, compute_dtype=dtype), solo), (k, n)
        for block_n in (16, 32):
            assert torch.equal(tdk.dequant_matmul_gidx(
                x[:4], *args, compute_dtype=dtype, block_n=block_n),
                solo[:4]), (k, n, block_n)


def _gidx_in_kernel_order(x, qweight, scales, zeros, g_idx, slots=64,
                          group=8):
    """K4's float32 sum order, emulated: the packed rows dealt to ``slots``
    row slots (slot s owns rows r = s mod slots), each slot summing its
    rows in increasing k, one fused multiply-add at a time (the product
    is exact in float64, then the sum rounds to float32); then the slot
    sums added in groups of ``group`` consecutive slots, each in slot
    order, and the group sums in order."""
    w = tdk._gather_dequant(qweight, scales, zeros, g_idx.long(),
                            torch.float32).double()
    x = x.double()
    m, n = x.shape[0], w.shape[1]
    rows = w.shape[0] // 8
    acc = torch.zeros(slots, m, n, dtype=torch.float32)
    for r0 in range(0, rows, slots):
        nr = min(slots, rows - r0)
        for i in range(8):
            ks = torch.arange(r0, r0 + nr) * 8 + i
            prod = x[:, ks].T[:, :, None] * w[ks][:, None, :]
            acc[:nr] = (acc[:nr].double() + prod).float()
    sums = []
    for g in range(slots // group):
        s = acc[g * group]
        for j in range(1, group):
            s = s + acc[g * group + j]
        sums.append(s)
    y = sums[0]
    for s in sums[1:]:
        y = y + s
    return y


FULL_DOWN = (4, 9728, 2560, 76)


@pytest.mark.parametrize("m,k,n,gs", GIDX_SHAPES + [FULL_DOWN])
def test_gidx_kernel_sum_order_holds_the_float32_tolerance(m, k, n, gs):
    """The CUDA K4's sum order, emulated on the CPU, within the float32
    limit the kernel is held to on the card (1e-5 of max|ref| + 1e-4, as
    ``test_cuda_gidx_kernel_matches_plain_version``): of the JAX g_idx
    kernel (interpret mode) at the reference's shapes, and of the plain
    version at the full-width down projection (M 4, K 9728, N 2560,
    gs 76), where each of the 64 slots sums 19 packed rows."""
    if (m, k, n, gs) == FULL_DOWN:
        from repro_torch.core import quantization as tqz

        rng = np.random.default_rng(7)
        ql = tqz.quantize(torch.from_numpy(rng.standard_normal(
            (k, n)).astype(np.float32)), gs,
            generator=torch.Generator().manual_seed(7)).naive
        xt = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        ref = tdk.dequant_matmul_gidx_torch(
            xt, ql.qweight, ql.scales, ql.zeros, ql.g_idx).numpy()
    else:
        import jax.numpy as jnp

        from repro.kernels import dequant_matmul as jdk

        jql = _quantized(m * 5 + n, k, n, gs).naive
        x = np.random.default_rng(m + n).standard_normal((m, k)).astype(
            np.float32)
        ref = np.asarray(jdk.dequant_matmul_gidx(
            jnp.asarray(x), jql.qweight, jql.scales, jql.zeros, jql.g_idx,
            compute_dtype=jnp.float32), np.float32)
        ql = _port(jql)
        xt = torch.from_numpy(x)
    got = _gidx_in_kernel_order(xt, ql.qweight, ql.scales, ql.zeros,
                                ql.g_idx)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() + 1e-4, err


def test_gidx_wrapper_refuses_a_column_tile_it_has_not():
    """``block_n`` is 0 (the kernel's pick), 16 or 32, also on the CPU."""
    ql = _port(_quantized(3, 128, 64, 32).naive)
    x = torch.zeros(2, 128)
    args = (ql.qweight, ql.scales, ql.zeros, ql.g_idx)
    assert tdk.dequant_matmul_gidx(x, *args, block_n=32).shape == (2, 64)
    with pytest.raises(ValueError, match="block_n must be 0, 16 or 32"):
        tdk.dequant_matmul_gidx(x, *args, block_n=8)


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


#: (k, n, gs, tp, bits, preferred block): ``tests/test_fused_wire.py``'s
#: four, gs 76 with padded wire widths (N 90 and 100; the int4 wire ends
#: in all-zero blocks), int4 blocks of 10 (a packed word holds values of
#: two quant blocks), and the edges of K3's epilogue units: blocks of 86
#: over n_pad 258 (blocks straddle 128-column tiles, and the padded
#: columns 256-257 lie in a tile with no GEMM blocks), and int4 blocks of
#: 48 across three tiles
WIRE_SHAPES = [
    (128, 96, 32, 4, 8, 32),
    (64, 128, 8, 8, 8, 128),
    (128, 96, 32, 2, 4, 32),
    (256, 256, 64, 2, 4, 16),
    (608, 90, 76, 4, 8, 128),
    (608, 100, 76, 4, 4, 12),
    (608, 80, 76, 2, 4, 12),
    (128, 256, 32, 3, 8, 128),
    (128, 384, 32, 2, 4, 48),
]
#: the tp=2 down shard of full-width qwen3-4b, int8 and int4 wires
WIRE_RANK = [(4864, 2560, 76, 2, 8, 128), (4864, 2560, 76, 2, 4, 32)]


def _dequantized_wire(p, s, z, bits, bs):
    """The values a wire tuple carries, in float32 (numpy in, numpy out)."""
    from repro_torch.comm import dispatch as comm

    p, s = torch.from_numpy(p), torch.from_numpy(s)
    if bits == 8:
        return comm._blockwise_dequantize(p, s, bs).numpy()
    return comm._blockwise_dequantize_int4(comm._unpack4_last(p), s,
                                           torch.from_numpy(z), bs).numpy()


@pytest.mark.parametrize("k,n,gs,tp,bits,blk", WIRE_SHAPES)
def test_wire_plain_version_within_a_level_of_jax_kernel(k, n, gs, tp, bits,
                                                         blk):
    """K3's plain version (``ops.dequant_matmul_wire`` on the CPU) against
    the JAX Pallas wire kernel in interpret mode.  The two GEMMs sum in
    different orders, so a value near a rounding boundary may land one
    quantization level away: every carried value is within one level (its
    block's scale) of the reference's, the payload shapes and types are
    the reference's, and padded columns carry exact zeros."""
    from repro.comm.wire import wire_params
    from repro.kernels import ops as jops

    jql = _ordered(k + n + tp, k, n, gs)
    x = np.random.default_rng(k + bits).standard_normal((16, k)).astype(
        np.float32)
    jp, js, jz = (None if t is None else np.array(t) for t in
                  jops.dequant_matmul_wire(x, jql, tp=tp, wire_bits=bits,
                                           wire_block=blk))
    p, s, z = ops.dequant_matmul_wire(torch.from_numpy(x), _port(jql),
                                      tp=tp, wire_bits=bits, wire_block=blk)
    n_pad, _, bs = wire_params(n, tp, bits, blk)
    if bits == 4:
        jp = jp.view(np.int32)
        assert z.shape == jz.shape and z.dtype == torch.float16
    else:
        assert z is None and jz is None
    assert p.shape == jp.shape and p.numpy().dtype == jp.dtype
    assert s.shape == js.shape == (16, n_pad // bs)
    got = _dequantized_wire(p.numpy(), s.numpy(),
                            None if z is None else z.numpy(), bits, bs)
    ref = _dequantized_wire(jp, js, jz, bits, bs)
    step = np.repeat(np.maximum(s.numpy(), js).astype(np.float32), bs,
                     axis=-1)
    assert (np.abs(got - ref) <= 1.001 * step).all()
    assert (got[:, n:] == 0).all()
    np.testing.assert_allclose(s.numpy().astype(np.float32), js, rtol=2e-3)


def test_wire_wrapper_flattens_lead_dims_and_counts_nothing_on_cpu():
    """Leading dims flatten and come back; on the CPU the wrapper runs the
    plain version and launches nothing."""
    jql = _ordered(7, 64, 64, 32)
    ql = _port(jql)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 3, 64)).astype(np.float32))
    launches = tdk.dequant_matmul_wire_ordered.launches
    p, s, z = ops.dequant_matmul_wire(x, ql, tp=2, wire_bits=8, wire_block=32)
    assert tdk.dequant_matmul_wire_ordered.launches == launches
    assert p.shape == (2, 3, 64) and p.dtype == torch.int8
    assert s.shape == (2, 3, 2) and s.dtype == torch.float16 and z is None
    p2, s2, _ = ops.dequant_matmul_wire(x.reshape(6, 64), ql, tp=2,
                                        wire_bits=8, wire_block=32)
    assert torch.equal(p.reshape(6, 64), p2)
    assert torch.equal(s.reshape(6, 2), s2)
    with pytest.raises(ValueError, match="ordered layout"):
        ops.dequant_matmul_wire(x, _port(_quantized(7, 64, 64, 32).naive),
                                tp=2, wire_bits=8, wire_block=32)


def test_wire_support_gates_and_qmatmul_wire_runs_plain_off_cuda():
    """``wire_support`` admits a quantized ring at tp > 1 on the ordered
    layout only; the wire form is no ``qmatmul`` backend; off backend
    ``cuda``, ``qmatmul_wire`` runs K3's plain version."""
    from repro_torch.comm.spec import CollectiveSpec

    ql = _port(_ordered(3, 64, 64, 32))
    with pytest.raises(ValueError, match="no kernel registered"):
        dispatch.qmatmul(torch.zeros(2, 64), ql,
                         ExecutionPolicy(backend="cuda-fused"))
    q8 = CollectiveSpec.parse("quant-int8:fused")
    assert dispatch.wire_support(ql, q8, 2) == (True, "")
    assert not dispatch.wire_support(ql, q8, 1)[0]
    assert not dispatch.wire_support(ql, CollectiveSpec.parse("psum"), 2)[0]
    naive = _port(_quantized(3, 64, 64, 32).naive)
    ok, why = dispatch.wire_support(naive, q8, 2)
    assert not ok and "naive" in why
    x = torch.ones(3, 64)
    launches = tdk.dequant_matmul_wire_ordered.launches
    wp = dispatch.qmatmul_wire(x, ql, ExecutionPolicy(backend="torch"),
                               spec=q8, tp=2)
    assert (wp.n, wp.tp, wp.bits, wp.block, wp.n_pad) == (64, 2, 8, 32, 64)
    want = ops.dequant_matmul_wire(x, ql, tp=2, wire_bits=8, wire_block=128,
                                   plain=True)
    assert torch.equal(wp.payload, want[0]) and torch.equal(wp.scales,
                                                            want[1])
    assert tdk.dequant_matmul_wire_ordered.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wire_kernel_bit_equal_to_k1_and_quantizer(dtype):
    """K3 on the card: bit-equal to K1 followed by the collective's own
    quantizer (payload, scales, zeros), and within one quantization level
    of its plain version, whose ``torch.matmul`` sums in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.comm.wire import wire_params

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(m, k, n, gs, tp, bits, blk)
             for (k, n, gs, tp, bits, blk) in WIRE_SHAPES for m in (1, 4, 64)]
    cases += [(4,) + shape for shape in WIRE_RANK]
    if dtype == torch.float32:
        # above the tensor-core loop's threshold, where K1 takes it
        m_tc = tdk.tensor_core_min_m() + 3
        cases += [(m_tc,) + shape for shape in WIRE_RANK]
        cases += [(m_tc, k, n, gs, tp, bits, blk)
                  for (k, n, gs, tp, bits, blk) in WIRE_SHAPES[4:]]
    for m, k, n, gs, tp, bits, blk in cases:
        ql = _cuda_quantized(gen, k, n, gs).ordered
        x = torch.randn(m, k, generator=gen, device="cuda")
        n_pad, _, bs = wire_params(n, tp, bits, blk)
        launches = tdk.dequant_matmul_wire_ordered.launches
        got = ops.dequant_matmul_wire(x, ql, tp=tp, wire_bits=bits,
                                      wire_block=blk, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert tdk.dequant_matmul_wire_ordered.launches == launches + 1
        want = tdk.quantize_wire(
            ops.dequant_matmul(x, ql, compute_dtype=dtype), n_pad=n_pad,
            wire_block=bs, wire_bits=bits)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), \
                (m, k, n, gs, tp, bits, blk)
        plain = tdk.dequant_matmul_wire_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=gs, n_pad=n_pad,
            wire_block=bs, wire_bits=bits, compute_dtype=dtype)
        cpu = [None if t is None else t.cpu().numpy() for t in got]
        ref = [None if t is None else t.cpu().numpy() for t in plain]
        step = np.repeat(np.maximum(cpu[1], ref[1]).astype(np.float32), bs,
                         axis=-1)
        diff = np.abs(_dequantized_wire(*cpu, bits, bs)
                      - _dequantized_wire(*ref, bits, bs))
        assert (diff <= 1.001 * step).all(), (m, k, n, gs, tp, bits, blk)


def _wire_units(n: int, n_pad: int, bs: int, tile: int = 128) -> list:
    """K3's epilogue units as ``units_of`` in
    ``csrc/dequant_matmul_wire_ordered.cu`` forms them: runs of
    ``lcm(tile, bs) / tile`` GEMM tiles, the last run extended to
    ``n_pad``; each unit as (first tile, tiles, first column, end)."""
    from math import gcd

    per = bs // gcd(bs, tile)
    tiles_n = -(-n // tile)
    count = -(-tiles_n // per)
    return [(u * per, min(per, tiles_n - u * per), u * per * tile,
             n_pad if u == count - 1 else (u + 1) * per * tile)
            for u in range(count)]


@pytest.mark.parametrize("k,n,gs,tp,bits,blk",
                         WIRE_SHAPES + WIRE_RANK + [(64, 128, 32, 3, 4, 16)])
def test_wire_epilogue_units_quantize_like_the_collective(k, n, gs, tp, bits,
                                                          blk):
    """K3's epilogue as the kernel orders it, on the CPU: the units tile
    ``[0, n_pad)``, each holds at least one GEMM tile (so its last block
    exists), and every quant block and int4 word lies in exactly one unit;
    each unit quantized alone, with each block's max and min combined over
    the unit's 128-column chunks and the quantizer's operations one at a
    time, gives ``quantize_wire``'s payload, scales and zeros bit for bit.
    The last shape (N 128 at tp 3, int4: n_pad 144, blocks of 16) has
    padded blocks in a tile of their own, which the last unit takes."""
    from repro_torch.comm import dispatch as comm
    from repro_torch.comm.wire import wire_params

    n_pad, _, bs = wire_params(n, tp, bits, blk)
    units = _wire_units(n, n_pad, bs)
    rng = np.random.default_rng(k + n + bits)
    y = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32))
    y[1, : min(n, 3 * bs)] = 0.0                # all-zero blocks
    y[2] = -y[2].abs()                          # blocks with max v < 0
    p_want, s_want, z_want = tdk.quantize_wire(y, n_pad=n_pad, wire_block=bs,
                                               wire_bits=bits)
    vals = torch.nn.functional.pad(y, (0, n_pad - n))
    owner = torch.zeros(n_pad, dtype=torch.int32)
    q = torch.zeros(5, n_pad)
    scales, zeros = torch.zeros(5, n_pad // bs), torch.zeros(5, n_pad // bs)
    fifteen, top = torch.tensor(15.0), torch.tensor(127.0)
    assert units[0][2] == 0 and units[-1][3] == n_pad
    for (t0, tiles, c0, c1), nxt in zip(units, units[1:] + [None]):
        assert tiles >= 1 and c0 < n and c0 % bs == 0 and c1 % bs == 0
        assert nxt is None or nxt[2] == c1 == t0 * 128 + tiles * 128
        if bits == 4:
            assert c0 % 8 == 0 and c1 % 8 == 0
        owner[c0:c1] += 1
        b0, nb = c0 // bs, (c1 - c0) // bs
        hi, lo = torch.zeros(5, nb), torch.zeros(5, nb)
        for cs in range(c0, c1, 128):
            ce = min(cs + 128, c1)
            for b in range(cs // bs, (ce - 1) // bs + 1):
                part = vals[:, max(cs, b * bs):min(ce, (b + 1) * bs)]
                i = b - b0
                if bits == 8:
                    hi[:, i] = torch.maximum(hi[:, i], part.abs().amax(-1))
                else:
                    hi[:, i] = torch.maximum(hi[:, i], part.amax(-1))
                    lo[:, i] = torch.minimum(lo[:, i], part.amin(-1))
        if bits == 8:
            s = torch.clamp(hi / top, min=torch.finfo(torch.float32).tiny)
            z = torch.zeros_like(s)
        else:
            s = (hi - lo) / fifteen
            s = torch.where(s <= 0, torch.ones_like(s), s)
            z = torch.clamp(torch.round(-lo / s), 0, 15)
        cols = torch.arange(c0, c1) // bs - b0
        qv = torch.round(vals[:, c0:c1] / s[:, cols] + z[:, cols])
        q[:, c0:c1] = torch.clamp(qv, -127, 127) if bits == 8 else \
            torch.clamp(qv, 0, 15)
        scales[:, b0:b0 + nb], zeros[:, b0:b0 + nb] = s, z
    assert (owner == 1).all()
    assert torch.equal(scales.to(torch.float16), s_want)
    if bits == 8:
        assert z_want is None and torch.equal(q.to(torch.int8), p_want)
    else:
        assert torch.equal(zeros.to(torch.float16), z_want)
        assert torch.equal(comm._pack4_last(q.to(torch.int32)), p_want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wire_kernel_one_launch_and_repeats_bit_equal(dtype):
    """A K3 call on the card is one device kernel (``torch.profiler``), in
    the decode loop and, for float32 above the threshold, the tensor-core
    loop; and its counters reset: the same call twice, and once more after
    a call of another shape, gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util
    import pathlib

    from repro_torch.comm.wire import wire_params

    # chip_smoke.py's count of the device kernels a call launches
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(4,) + shape for shape in WIRE_RANK + WIRE_SHAPES[-2:]]
    cases += [(64,) + shape for shape in WIRE_SHAPES[-2:]]
    if dtype == torch.float32:
        m_tc = tdk.tensor_core_min_m() + 3
        cases += [(m_tc,) + shape for shape in WIRE_RANK + WIRE_SHAPES[-2:]]
    other_ql = _cuda_quantized(gen, 64, 128, 8).ordered
    other_x = torch.randn(3, 64, generator=gen, device="cuda").to(dtype)
    for m, k, n, gs, tp, bits, blk in cases:
        ql = _cuda_quantized(gen, k, n, gs).ordered
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)

        def call():
            return ops.dequant_matmul_wire(x, ql, tp=tp, wire_bits=bits,
                                           wire_block=blk,
                                           compute_dtype=dtype)

        first, second = call(), call()
        ops.dequant_matmul_wire(other_x, other_ql, tp=3, wire_bits=4,
                                wire_block=16, compute_dtype=dtype)
        third = call()
        torch.cuda.synchronize()
        for a, b, c in zip(first, second, third):
            if a is None:
                assert b is None and c is None
                continue
            bits_of = (lambda t: t.view(torch.int16)
                       if t.dtype == torch.float16 else t)
            assert torch.equal(bits_of(a), bits_of(b)), (m, k, n, bits)
            assert torch.equal(bits_of(a), bits_of(c)), (m, k, n, bits)
        n_pad, _, bs = wire_params(n, tp, bits, blk)
        want = tdk.quantize_wire(ops.dequant_matmul(x, ql, compute_dtype=dtype),
                                 n_pad=n_pad, wire_block=bs, wire_bits=bits)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(first, want)), (m, k, n, bits)
        kernels = chip_smoke._kernel_launches(call)
        assert sum(kernels.values()) == 1, (m, k, n, bits, kernels)
        assert "WireEpilogue" in next(iter(kernels)), kernels
