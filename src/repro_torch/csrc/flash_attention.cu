// Flash attention (online softmax, causal or windowed) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention
//   (body _flash_kernel)
// and computes the same function on q (B, H, S, D), k and v (B, H, T, D):
//   s[i, j] = (q[i] . k[j]) * D^-0.5, or -1e30 where masked
//             (causal: j > i; window w: j <= i - w)
//   out[i]  = sum_j softmax(s[i])[j] v[j]
// in float32 whatever the input type, written in q's type.  Like the
// reference it runs the online softmax over key tiles with float32 m, l
// and accumulator, skips whole key tiles above the diagonal or before the
// window, multiplies by the scale, masks with -1e30 (not -inf), and
// divides by l with l == 0 replaced by 1.  A row whose first visited tile
// is fully masked gets m = -1e30 and p = 1 on those entries, exactly as in
// the reference; the next tile with a live key wipes them with
// alpha = exp(-1e30 - m) = 0.  Keys past T (a ragged last tile) score
// -inf, so they add exactly 0; the reference refuses ragged shapes.
//
// What bounds it: operations.  At the full-width forward (B 1, H 32,
// S = T = 2048, D 128, causal) it does about 34 GFLOP against 64 MB of
// q, k, v and output, far above the card's ridge.  The float32 policy
// forbids TF32, so the floor is the CUDA-core float32 rate; the kernel
// keeps every score tile in registers and shared memory, so attention
// never writes the S x T scores to device memory.
//
// Design (simple and exact first: no TMA, no tensor cores):
//  * One block of 256 threads per (b*h, 64-query tile); blocks are issued
//    from the last query tile down, so the longest causal rows start
//    first.  The Q tile stays in shared memory; each key tile's K and V
//    (64 x D, float32) are staged there, converted from the input type.
//    At D 128 that is 98 KB a block, which needs the opt-in above 48 KB
//    and leaves room for 2 blocks per SM.
//  * Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3 in both
//    products: scores for keys tx + 16j (j < 4), and output columns in
//    D/16 owned columns.  Its rows' m, l and accumulator therefore live
//    in its registers; row max and row sum are reduced over the 16 lanes
//    of a half warp with shuffles.
//  * Q and K rows are padded to D + 4 floats, so the 8 lanes of a quarter
//    warp reading 8 key rows with 128-bit loads hit 32 distinct banks.
//    P goes through shared memory (in K's buffer, once the scores are
//    done) to be multiplied by V.
//  * expf, not __expf, and IEEE division, so float32 results stay within
//    1e-5 of the reference.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;           // query rows per block
constexpr int kBlockK = 64;           // keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kRows = kBlockQ / 16;   // query rows per thread
constexpr int kKeys = kBlockK / 16;   // keys per thread in a score tile
constexpr int kPStride = kBlockK + 4; // P row stride (floats)
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF

template <int D>
struct Dims {
  static constexpr int kStride = D + 4;            // Q and K row stride
  static constexpr int kVec = D >= 64 ? 4 : 2;     // columns per V load
  static constexpr int kGroups = D / (16 * kVec);  // V loads per key
  static constexpr int kCols = D / 16;             // output columns owned
  static constexpr int kQFloats = kBlockQ * kStride;
  static constexpr int kKFloats =
      kBlockK * kStride > kBlockQ * kPStride ? kBlockK * kStride
                                             : kBlockQ * kPStride;
  static constexpr int kVFloats = kBlockK * D;
  static constexpr int kSmemBytes = 4 * (kQFloats + kKFloats + kVFloats);
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kChunk = 4;    // elements per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static float store(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kChunk = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {           // bf16 -> f32 is a 16-bit shift
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Io<__half> {
  static constexpr int kChunk = 8;
  __device__ static void load(const __half* p, float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as
// float32 with row stride `stride`; rows past `rows` are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int row0, int rows, int tid) {
  constexpr int kChunk = Io<T>::kChunk;
  constexpr int kPerRow = D / kChunk;
  for (int i = tid; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    float v[kChunk];
    if (row0 + r < rows) {
      Io<T>::load(src + static_cast<size_t>(row0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kChunk; e += 4) {
      *reinterpret_cast<float4*>(dst + r * stride + c + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out);

template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* out) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  out[0] = a.x; out[1] = a.y;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int causal, int window, float scale) {
  using Dm = Dims<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // (64, D + 4)
  float* ks = qs + Dm::kQFloats;          // (64, D + 4), then P (64, 68)
  float* vs = ks + Dm::kKFloats;          // (64, D)
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* kb = k + static_cast<size_t>(bh) * Tk * D;
  const T* vb = v + static_cast<size_t>(bh) * Tk * D;

  // key range this query tile can see: whole tiles past its last row
  // (causal) or before its first row's window are skipped
  int k_end = Tk;
  if (causal) k_end = min(Tk, min(q0 + kBlockQ, S));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  stage<T, D>(qs, Dm::kStride, qb, q0, S, tid);

  float m[kRows], l[kRows], acc[kRows][Dm::kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Dm::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                      // last tile's P and V are read
    stage<T, D>(ks, Dm::kStride, kb, k0, Tk, tid);
    stage<T, D>(vs, D, vb, k0, Tk, tid);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[kRows][4], kv[kKeys][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        load_vec<4>(qs + (ty * kRows + i) * Dm::kStride + d, qv[i]);
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        load_vec<4>(ks + (tx + 16 * j) * Dm::kStride + d, kv[j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
        }
      }
    }

    // scale, mask, online softmax
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int iq = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int ik = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (ik >= Tk) {
          val = -INFINITY;
        } else if ((causal && ik > iq) || (window > 0 && ik <= iq - window)) {
          val = kNegInf;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < Dm::kCols; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                      // every thread is done with K
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        ps[(ty * kRows + i) * kPStride + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float p[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        load_vec<4>(ps + (ty * kRows + i) * kPStride + kk, p[i]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < Dm::kGroups; ++g) {
          float vv[Dm::kVec];
          load_vec<Dm::kVec>(
              vs + (kk + e) * D + g * 16 * Dm::kVec + tx * Dm::kVec, vv);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int c = 0; c < Dm::kVec; ++c) {
              acc[i][g * Dm::kVec + c] =
                  fmaf(p[i][e], vv[c], acc[i][g * Dm::kVec + c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int iq = q0 + ty * kRows + i;
    if (iq >= S) continue;
    const float div = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (static_cast<size_t>(bh) * S + iq) * D;
#pragma unroll
    for (int g = 0; g < Dm::kGroups; ++g) {
#pragma unroll
      for (int c = 0; c < Dm::kVec; ++c) {
        orow[g * 16 * Dm::kVec + tx * Dm::kVec + c] =
            Io<T>::store(acc[i][g * Dm::kVec + c] / div);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, int t, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Dims<D>::kSmemBytes;
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int s, int t, int d, int causal, int window,
                     float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, s, t, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, s, t, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, s, t, causal, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B*H, S, D), k and v (B*H, T, D), o (B*H, S, D), all of one type
// (dtype 0: float32, 1: bfloat16, 2: float16), contiguous and 16-byte
// aligned; D is 32, 64 or 128.  causal != 0 masks keys after the query;
// window > 0 masks keys at or before query - window (window <= 0: none).
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bh, int s, int t, int d,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
  if (bh <= 0 || s <= 0 || t <= 0 || (s + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(q, k, v, o, bh, s, t, d, causal,
                                              window, scale, st));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(
          q, k, v, o, bh, s, t, d, causal, window, scale, st));
    case 2:
      return static_cast<int>(launch_d<__half>(q, k, v, o, bh, s, t, d,
                                               causal, window, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block for head dimension d (0 if d is not
// supported).
extern "C" int flash_attention_smem_bytes(int d) {
  switch (d) {
    case 32: return Dims<32>::kSmemBytes;
    case 64: return Dims<64>::kSmemBytes;
    case 128: return Dims<128>::kSmemBytes;
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
