// Ordered-groups int4 dequant-GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_matmul.py::dequant_matmul_ordered
//   (body _ordered_gemm_step, kernel _dequant_matmul_ordered_kernel)
// and computes the same function:
//   y[m, n] = sum_k x[m, k] * w[k, n]
//   w[k, n] = (q[k, n] - z[k/gs, n]) * s[k/gs, n]
// with q the nibble (k % 8) of the packed word qweight[k / 8, n], groups
// contiguous along K, both operands rounded to the compute type (float or
// bfloat16) before the multiply, the sum kept in float32, and y written in
// the compute type.
//
// What bounds it: in decode M is 1..32, so the kernel does ~2*M*K*N flops
// against ~K*N/2 bytes of packed weight; at M = 4 that is 16 flops per
// byte, far below the card's ridge, so its floor is the bytes it reads
// from device memory (packed weight + scales + zeros).  The float32 policy
// forbids tensor cores (no TF32), so each weight element also costs M
// CUDA-core FMAs plus its unpack and dequantize; at M = 4 that instruction
// stream, not the memory, is what this form of the kernel runs into.
//
// Design (no TMA, no wgmma yet):
//  * One thread block per (BM rows x 128 columns) output tile and K range,
//    with an in-block loop over K in steps of bk.  This replaces the TPU
//    grid's sequential K axis and its VMEM scratch accumulator: sums live
//    in float32 registers.
//  * bk is a multiple of lcm(gs, 8) dividing K, so each K step holds whole
//    quant groups: its metadata tile is exactly bk/gs rows of scales and
//    zeros, staged in shared memory once and reused for every row of x.
//  * Each K step stages the x tile, the packed weight tile and the
//    metadata tile in shared memory through a ring of cp.async stages, so
//    the loads of the next step are in flight while one step computes.
//  * Each lane owns 4 adjacent columns (one 16-byte quad of packed words,
//    so a warp reads 512 contiguous bytes of a packed row) and reuses each
//    x value it loads for all 4.  The 4 warps take interleaved packed rows
//    of the step; their partial sums are added in a fixed order at the end.
//  * When the column tiles alone cannot fill the card (the down projection
//    has 20), the K steps are split over blockIdx.z (choose_split, from
//    the device's SM count); each split writes its float32 partial tile
//    and a second kernel adds the splits in a fixed order.  The split
//    depends only on N, K and the card, never on M, so a row's result
//    does not depend on the batch it runs in.  The caller asks
//    dequant_matmul_partial_floats for the scratch this takes.
//  * The group of each row is k / gs per row, never per word: with gs = 76
//    a packed word straddles two groups.
//  * A nibble q becomes the float 2^23 + q by OR-ing it into the mantissa
//    of 2^23; subtracting 2^23 + z (exact for the integer zero-points
//    0..15 that the quantizer writes) gives q - z exactly, so w is
//    bit-equal to the reference's (q - z) * s without an int-to-float
//    conversion per element.
#include "dequant_matmul_ordered.cuh"

namespace {

// K1: the GEMM, then, when K is split, the split-add pass.
template <typename T, int BM>
cudaError_t launch(const void* x, const void* qweight, const void* scales,
                   const void* zeros, void* y, void* partial, int m, int n,
                   int k, int gs, int bk, Split split, cudaStream_t stream) {
  float* part = split.splits == 1 ? nullptr : static_cast<float*>(partial);
  cudaError_t err = launch_gemm<T, BM>(x, qweight, scales, zeros, y, part, m,
                                       n, k, gs, bk, split, stream);
  if (err != cudaSuccess || part == nullptr) return err;
  const int mn = m * n;
  add_splits_kernel<T><<<(mn + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(y), split.splits, mn);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that dequant_matmul_ordered needs in `partial` for
// this shape on the current device (0 when K is not split), or minus a
// CUDA error code.
extern "C" long long dequant_matmul_partial_floats(int m, int n, int k,
                                                   int group_size,
                                                   int block_k) {
  if (!valid_shape(m, n, k, group_size, block_k)) {
    return -static_cast<long long>(cudaErrorInvalidValue);
  }
  Split split;
  const cudaError_t err = choose_split(n, k, block_k, &split);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return split.splits == 1
             ? 0
             : static_cast<long long>(split.splits) * m * n;
}

// x (M, K) and y (M, N) in the compute type (bf16 != 0: bfloat16, else
// float32), qweight (K/8, N) 32-bit words, scales and zeros (K/gs, N)
// float32 with integer zero-points, all contiguous and 16-byte aligned.
// `partial` holds `partial_floats` floats of scratch, at least what
// dequant_matmul_partial_floats asks for.  Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int dequant_matmul_ordered(const void* x, const void* qweight,
                                      const void* scales, const void* zeros,
                                      void* y, void* partial,
                                      long long partial_floats, int m, int n,
                                      int k, int group_size, int block_k,
                                      int bf16, void* stream) {
  if (!valid_shape(m, n, k, group_size, block_k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Split split;
  const cudaError_t err = choose_split(n, k, block_k, &split);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split.splits > 1 &&
      (partial == nullptr ||
       partial_floats < static_cast<long long>(split.splits) * m * n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = block_m(m) == 4;
  if (bf16) {
    return static_cast<int>(
        small ? launch<__nv_bfloat16, 4>(x, qweight, scales, zeros, y,
                                         partial, m, n, k, group_size,
                                         block_k, split, s)
              : launch<__nv_bfloat16, 16>(x, qweight, scales, zeros, y,
                                          partial, m, n, k, group_size,
                                          block_k, split, s));
  }
  return static_cast<int>(
      small ? launch<float, 4>(x, qweight, scales, zeros, y, partial, m, n,
                               k, group_size, block_k, split, s)
            : launch<float, 16>(x, qweight, scales, zeros, y, partial, m, n,
                                k, group_size, block_k, split, s));
}

// Dynamic shared memory of one block for M rows of x.
extern "C" int dequant_matmul_smem_bytes(int m, int group_size, int block_k,
                                         int bf16) {
  const bool small = block_m(m) == 4;
  if (bf16) {
    return small ? smem_bytes<__nv_bfloat16, 4>(block_k, group_size)
                 : smem_bytes<__nv_bfloat16, 16>(block_k, group_size);
  }
  return small ? smem_bytes<float, 4>(block_k, group_size)
               : smem_bytes<float, 16>(block_k, group_size);
}

extern "C" const char* dequant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
