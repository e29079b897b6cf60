// Ordered-groups int4 dequant-GEMM with the wire quantize fused into its
// epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_matmul.py::dequant_matmul_wire_ordered
//   (bodies _dequant_matmul_wire8_kernel and _dequant_matmul_wire4_kernel,
//   tiling pick_block_wire)
// and computes the same function: K1's y = x @ W, then ring phase 1's
// blockwise quantize of y over the zero-padded wire width n_pad, per row
// and block of bs columns:
//   int8: s = max(max|v| / 127, FLT_MIN), q = clip(rint(v / s), -127, 127);
//         an int8 payload and float16 scales;
//   int4: vmax = max(max v, 0), vmin = min(min v, 0),
//         s = (vmax - vmin) / 15 (1 where s <= 0),
//         z = clip(rint(-vmin / s), 0, 15), q = clip(rint(v / s + z), 0, 15);
//         8 nibbles per 32-bit word along N (value j at bits 4j), float16
//         scales and zeros;
// where v is y rounded to the compute type and back to float32 (the
// unfused path's dtype chain) and columns N..n_pad-1 are exact zeros.
//
// The contract is bit-identity with K1 followed by the collective's own
// quantizer (repro_torch/comm/dispatch.py _blockwise_quantize[_int4]):
//  * The GEMM is K1's main loop (dequant_matmul_ordered.cuh), the one K1
//    takes for the same M and compute type: the decode loop with the
//    split K1 takes for the same (N, K), or, at large M in float32, the
//    tensor-core loop, which takes no split.  Every split writes its
//    float32 partial tile, also when K is not split, and the epilogue adds
//    the splits in K1's order (0.f + split 0 + split 1 + ...).
//  * The epilogue does the quantizer's operations one at a time, each
//    rounded: __fdiv_rn for every division (never a reciprocal), rintf
//    (round half to even), __fadd_rn for v / s + z, __float2half_rn for
//    the float16 scales and zeros.  It is built without --use_fast_math.
//
// What bounds it: the packed weight and metadata bytes the GEMM reads, as
// for K1 (7.5 MB at the tp=2 down projection, K 4864, N 2560).  Besides,
// the epilogue reads the splits' partial tiles (splits * M * N floats,
// which stay in L2 at decode batch sizes) twice and writes M * n_pad
// bytes of int8 payload, or half that for int4.
//
// Design (the simple form): the GEMM, then two small epilogue kernels.
//  1. wire_params_kernel: one warp per (row, quant block) adds the splits
//     of the block's columns, reduces max|v| (int8) or max and min (int4)
//     with warp shuffles (max and min are exact in any order), and writes
//     the float16 scale (and zero) to the wire and the float32 scale and
//     zero to scratch: the payload divides by the float32 scale, not by
//     its float16 copy.
//  2. wire_payload_kernel: one thread per int8 value or int4 word adds
//     the splits again, quantizes with its block's float32 scale (and
//     zero) and writes the payload.  A word may hold values of two quant
//     blocks (bs need not be a multiple of 8): each value uses its own
//     block's scale and zero.  The wrapper takes bs and n_pad from
//     comm/wire.wire_params, so neither a block nor a word straddles a
//     rank's chunk.
#include <cuda_fp16.h>
#include <float.h>

#include "dequant_matmul_ordered.cuh"

namespace {

constexpr int kEpiThreads = 128;
constexpr int kEpiWarps = kEpiThreads / 32;

// y[m, col] in float32 as the unfused path sees it: the splits' partial
// sums added in K1's order, rounded to the compute type and back; 0 past
// the GEMM's N columns.
template <typename T>
__device__ __forceinline__ float wire_value(const float* __restrict__ partial,
                                            int splits, int rows, int n,
                                            int m, int col) {
  if (col >= n) return 0.f;
  const size_t mn = static_cast<size_t>(rows) * n;
  const size_t i = static_cast<size_t>(m) * n + col;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[s * mn + i];
  return Num<T>::round(sum);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kEpiThreads)
wire_params_kernel(const float* __restrict__ partial, int splits, int rows,
                   int n, int n_pad, int bs, __half* __restrict__ wscales,
                   __half* __restrict__ wzeros, float* __restrict__ sz) {
  const int nb = n_pad / bs;
  const int item = blockIdx.x * kEpiWarps + threadIdx.x / 32;
  if (item >= rows * nb) return;            // the whole warp leaves
  const int lane = threadIdx.x % 32;
  const int m = item / nb, c0 = (item % nb) * bs;
  float hi = 0.f, lo = 0.f;                 // the reductions include 0
  for (int c = lane; c < bs; c += 32) {
    const float v = wire_value<T>(partial, splits, rows, n, m, c0 + c);
    if (BITS == 8) {
      hi = fmaxf(hi, fabsf(v));
    } else {
      hi = fmaxf(hi, v);
      lo = fminf(lo, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    if (BITS == 4) lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  }
  if (lane != 0) return;
  float s, z = 0.f;
  if (BITS == 8) {
    s = fmaxf(__fdiv_rn(hi, 127.f), FLT_MIN);
  } else {
    s = __fdiv_rn(__fsub_rn(hi, lo), 15.f);
    if (s <= 0.f) s = 1.f;
    z = fminf(fmaxf(rintf(__fdiv_rn(-lo, s)), 0.f), 15.f);
    wzeros[item] = __float2half_rn(z);
  }
  wscales[item] = __float2half_rn(s);
  sz[2 * item] = s;
  sz[2 * item + 1] = z;
}

template <typename T, int BITS>
__global__ void __launch_bounds__(256)
wire_payload_kernel(const float* __restrict__ partial, int splits, int rows,
                    int n, int n_pad, int bs, const float* __restrict__ sz,
                    void* __restrict__ payload) {
  constexpr int kVals = BITS == 8 ? 1 : 8;  // values per payload element
  const int per_row = n_pad / kVals;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * per_row) return;
  const int m = static_cast<int>(idx / per_row);
  const int c0 = static_cast<int>(idx % per_row) * kVals;
  const float* row_sz = sz + 2 * static_cast<size_t>(m) * (n_pad / bs);
  if (BITS == 8) {
    const float v = wire_value<T>(partial, splits, rows, n, m, c0);
    const float q = rintf(__fdiv_rn(v, row_sz[2 * (c0 / bs)]));
    static_cast<int8_t*>(payload)[idx] =
        static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  } else {
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + j;
      const float* p = row_sz + 2 * (col / bs);
      const float v = wire_value<T>(partial, splits, rows, n, m, col);
      const float q = rintf(__fadd_rn(__fdiv_rn(v, p[0]), p[1]));
      word |= static_cast<uint32_t>(fminf(fmaxf(q, 0.f), 15.f)) << (4 * j);
    }
    static_cast<uint32_t*>(payload)[idx] = word;
  }
}

struct WireShape {
  int m, n, k, gs, bk, n_pad, bs, bits;
};

bool valid_wire(const WireShape& w) {
  return valid_shape(w.m, w.n, w.k, w.gs, w.bk) && w.n_pad >= w.n &&
         w.bs > 0 && w.n_pad % w.bs == 0 &&
         (w.bits == 8 || (w.bits == 4 && w.n_pad % 8 == 0));
}

// Floats of scratch: the splits' partial tiles, then a float32 (scale,
// zero) pair per (row, quant block).
long long scratch_floats(const WireShape& w, const Split& split) {
  return static_cast<long long>(split.splits) * w.m * w.n +
         2LL * w.m * (w.n_pad / w.bs);
}

// BM = kTcLoop: the tensor-core loop (float32 only), writing its one
// partial tile to scratch.
template <typename T, int BM, int BITS>
cudaError_t launch(const void* x, const void* qweight, const void* scales,
                   const void* zeros, void* payload, void* wscales,
                   void* wzeros, float* scratch, const WireShape& w,
                   Split split, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (BM == kTcLoop) {
    err = launch_tc(x, qweight, scales, zeros, scratch, w.m, w.n, w.k, w.gs,
                    stream);
  } else {
    err = launch_gemm<T, BM>(x, qweight, scales, zeros, nullptr, scratch,
                             w.m, w.n, w.k, w.gs, w.bk, split, stream);
  }
  if (err != cudaSuccess) return err;
  float* sz = scratch + static_cast<size_t>(split.splits) * w.m * w.n;
  const int items = w.m * (w.n_pad / w.bs);
  wire_params_kernel<T, BITS>
      <<<(items + kEpiWarps - 1) / kEpiWarps, kEpiThreads, 0, stream>>>(
          scratch, split.splits, w.m, w.n, w.n_pad, w.bs,
          static_cast<__half*>(wscales), static_cast<__half*>(wzeros), sz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long work =
      static_cast<long long>(w.m) * (w.n_pad / (BITS == 8 ? 1 : 8));
  wire_payload_kernel<T, BITS>
      <<<static_cast<unsigned>((work + 255) / 256), 256, 0, stream>>>(
          scratch, split.splits, w.m, w.n, w.n_pad, w.bs, sz, payload);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_bits(const void* x, const void* qweight,
                        const void* scales, const void* zeros, void* payload,
                        void* wscales, void* wzeros, float* scratch,
                        const WireShape& w, Split split, cudaStream_t s) {
  return w.bits == 8
             ? launch<T, BM, 8>(x, qweight, scales, zeros, payload, wscales,
                                wzeros, scratch, w, split, s)
             : launch<T, BM, 4>(x, qweight, scales, zeros, payload, wscales,
                                wzeros, scratch, w, split, s);
}

}  // namespace

// Floats of scratch that dequant_matmul_wire_ordered needs for this shape
// and compute type (bf16 != 0: bfloat16) on the current device, or minus
// a CUDA error code.
extern "C" long long dequant_matmul_wire_scratch_floats(
    int m, int n, int k, int group_size, int block_k, int n_pad,
    int wire_block, int bits, int bf16) {
  const WireShape w{m, n, k, group_size, block_k, n_pad, wire_block, bits};
  if (!valid_wire(w)) return -static_cast<long long>(cudaErrorInvalidValue);
  Split split;
  const cudaError_t err = plan_split(m, n, k, group_size, block_k, bf16 != 0,
                                     &split);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return scratch_floats(w, split);
}

// x (M, K) in the compute type (bf16 != 0: bfloat16, else float32),
// qweight (K/8, N) 32-bit words, scales and zeros (K/gs, N) float32 with
// integer zero-points; payload (M, n_pad) int8 (bits 8) or (M, n_pad/8)
// 32-bit words (bits 4), wire scales and zeros (M, n_pad/wire_block)
// float16 (zeros only for bits 4); all contiguous, 16-byte aligned where
// K1 needs it.  `scratch` holds `scratch_floats` floats, at least what
// dequant_matmul_wire_scratch_floats asks for.  Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int dequant_matmul_wire_ordered(
    const void* x, const void* qweight, const void* scales,
    const void* zeros, void* payload, void* wscales, void* wzeros,
    void* scratch, long long scratch_floats_given, int m, int n, int k,
    int group_size, int block_k, int n_pad, int wire_block, int bits,
    int bf16, void* stream) {
  const WireShape w{m, n, k, group_size, block_k, n_pad, wire_block, bits};
  if (!valid_wire(w) || (bits == 4 && wzeros == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Split split;
  const cudaError_t err = plan_split(m, n, k, group_size, block_k, bf16 != 0,
                                     &split);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scratch == nullptr ||
      scratch_floats_given < scratch_floats(w, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core_path(m, group_size, bf16 != 0)) {
    return static_cast<int>(launch_bits<float, kTcLoop>(
        x, qweight, scales, zeros, payload, wscales, wzeros, sc, w, split,
        s));
  }
  const bool small = block_m(m) == 4;
  if (bf16) {
    return static_cast<int>(
        small ? launch_bits<__nv_bfloat16, 4>(x, qweight, scales, zeros,
                                              payload, wscales, wzeros, sc,
                                              w, split, s)
              : launch_bits<__nv_bfloat16, 16>(x, qweight, scales, zeros,
                                               payload, wscales, wzeros, sc,
                                               w, split, s));
  }
  return static_cast<int>(
      small ? launch_bits<float, 4>(x, qweight, scales, zeros, payload,
                                    wscales, wzeros, sc, w, split, s)
            : launch_bits<float, 16>(x, qweight, scales, zeros, payload,
                                     wscales, wzeros, sc, w, split, s));
}

extern "C" const char* dequant_matmul_wire_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
