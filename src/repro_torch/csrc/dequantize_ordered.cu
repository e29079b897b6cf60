// Ordered-groups int4 dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_matmul.py::dequantize_ordered
//   (body _dequant_kernel)
// and computes the same function:
//   out[k, n] = (q[k, n] - z[k / gs, n]) * s[k / gs, n]
// with q the nibble (k % 8) of the packed word qweight[k / 8, n], in
// float32, then rounded to the output type (float32 or bfloat16).
//
// What bounds it: bytes.  It reads half a byte of packed weight per
// element and writes 4 (float32), so the (K, N) output write is almost
// all of its traffic (about 100 MB for a full-width qwen3-4b MLP matrix);
// it does two floating-point operations per element.
//
// Design: one thread per packed word quad, i.e. 4 adjacent columns of 8
// rows: one 16-byte load of packed words, then 8 output rows of 4 columns,
// each one 16-byte store (8 bytes for bfloat16), so a warp writes 512
// contiguous bytes of an output row per store.  The metadata row k / gs
// is read through the read-only cache; each row's scales and zeros serve
// every thread of the row.  (q - z) * s uses the round-to-nearest
// intrinsics, which the compiler never contracts into a multiply-add,
// so the output is bit-equal to the reference's whatever the flags.
// CUDA C++ rather than Triton for a pass this simple keeps one build
// path for all the port's kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Store;

template <>
struct Store<float> {
  // v[0..3] to p[0..3]; p is 16-byte aligned when vec
  __device__ static void quad(float* p, const float* v, int valid, bool vec) {
    if (vec && valid >= 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
    for (int c = 0; c < valid && c < 4; ++c) p[c] = v[c];
  }
};

template <>
struct Store<__nv_bfloat16> {
  // p is 8-byte aligned when vec
  __device__ static void quad(__nv_bfloat16* p, const float* v, int valid,
                              bool vec) {
    if (vec && valid >= 4) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a);
      u.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(p) = u;
      return;
    }
    for (int c = 0; c < valid && c < 4; ++c) p[c] = __float2bfloat16_rn(v[c]);
  }
};

// The 4 32-bit values of `row` at columns col..col+3; columns >= n read
// as 0.
__device__ __forceinline__ uint4 load_quad(const uint32_t* row, int col,
                                           int n, bool vec) {
  if (vec && col + 4 <= n) {
    return __ldg(reinterpret_cast<const uint4*>(row + col));
  }
  uint32_t v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = col + c < n ? __ldg(row + col + c) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// grid: (column quads / kThreads, K / 8); blockIdx.y is the packed row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_ordered_kernel(const uint32_t* __restrict__ qweight,
                          const float* __restrict__ scales,
                          const float* __restrict__ zeros,
                          T* __restrict__ out, int N, int gs) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (col >= N) return;
  const int r = blockIdx.y;
  const bool vec = N % 4 == 0;
  const uint4 quad = load_quad(qweight + static_cast<size_t>(r) * N, col, N,
                               vec);
  const uint32_t words[4] = {quad.x, quad.y, quad.z, quad.w};
  const uint32_t* s_bits = reinterpret_cast<const uint32_t*>(scales);
  const uint32_t* z_bits = reinterpret_cast<const uint32_t*>(zeros);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = r * 8 + i;
    const size_t meta = static_cast<size_t>(k / gs) * N;
    const uint4 s = load_quad(s_bits + meta, col, N, vec);
    const uint4 z = load_quad(z_bits + meta, col, N, vec);
    const uint32_t sv[4] = {s.x, s.y, s.z, s.w};
    const uint32_t zv[4] = {z.x, z.y, z.z, z.w};
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float q = static_cast<float>((words[c] >> (4 * i)) & 0xFu);
      v[c] = __fmul_rn(__fsub_rn(q, __uint_as_float(zv[c])),
                       __uint_as_float(sv[c]));
    }
    Store<T>::quad(out + static_cast<size_t>(k) * N + col, v, N - col, vec);
  }
}

template <typename T>
cudaError_t launch(const void* qweight, const void* scales, const void* zeros,
                   void* out, int n, int k, int gs, cudaStream_t stream) {
  const int quads = (n + 3) / 4;
  const dim3 grid((quads + kThreads - 1) / kThreads, k / 8);
  dequantize_ordered_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<T*>(out), n, gs);
  return cudaGetLastError();
}

}  // namespace

// qweight (K/8, N) 32-bit words, scales and zeros (K/gs, N) float32, out
// (K, N) in the output type (bf16 != 0: bfloat16, else float32), all
// contiguous and 16-byte aligned.  Launches on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int dequantize_ordered(const void* qweight, const void* scales,
                                  const void* zeros, void* out, int n, int k,
                                  int group_size, int bf16, void* stream) {
  if (n <= 0 || k <= 0 || k % 8 || group_size <= 0 || k % group_size ||
      k / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(qweight, scales, zeros, out, n, k,
                                   group_size, s)
           : launch<float>(qweight, scales, zeros, out, n, k, group_size, s));
}

extern "C" const char* dequantize_ordered_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
