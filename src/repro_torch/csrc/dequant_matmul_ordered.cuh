// The ordered-groups int4 dequant-GEMM's main loop, its K split and the
// split order, shared by K1 (dequant_matmul_ordered.cu, whose note says
// how it is built up and what bounds it) and K3
// (dequant_matmul_wire_ordered.cu), so that K3's float32 sums are K1's
// bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;                    // output columns per lane
constexpr int kBlockN = 32 * kCols;         // output columns per block
constexpr int kWarps = 4;                   // warps sharing one K step
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                  // cp.async ring depth
// Thread blocks per SM the K split aims for when the column tiles alone
// cannot fill the card.
constexpr int kSplitBlocksPerSM = 4;
// Blocks per SM the register budget is cut for (80 registers a thread):
// the fastest of the caps tried (64, 80, 128 registers and none) at the
// qwen3-4b MLP shapes on an H100.
constexpr int kMinBlocks = 6;
constexpr uint32_t kMagicBits = 0x4B000000u;  // 2^23 as float bits
constexpr float kMagic = 8388608.f;           // 2^23

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  // the 8 values at p (16-byte aligned)
  __device__ static void load8(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static void load8(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {           // bf16 -> f32 is a 16-bit shift
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
};

// (q - z) * s for nibble i of `word`, rounded to the compute type;
// zm = 2^23 + z.
template <typename T>
__device__ __forceinline__ float dequant(uint32_t word, int i, float zm,
                                         float s) {
  const float qm = __uint_as_float(kMagicBits | ((word >> (4 * i)) & 0xFu));
  return Num<T>::round((qm - zm) * s);
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Byte offsets of the tiles inside one pipeline stage.
struct StageLayout {
  int w, x, s, z, bytes;
};

template <typename T, int BM>
__host__ __device__ inline StageLayout stage_layout(int bk, int gs) {
  StageLayout l;
  l.w = 0;
  l.x = align16(l.w + (bk / 8) * kBlockN * 4);
  l.s = align16(l.x + BM * bk * static_cast<int>(sizeof(T)));
  l.z = align16(l.s + (bk / gs) * kBlockN * 4);
  l.bytes = align16(l.z + (bk / gs) * kBlockN * 4);
  return l;
}

// Scales and 2^23 + zeros of group g for this lane's columns.
__device__ __forceinline__ void load_meta(const float* ss, const float* zs,
                                          int g, int lane, float* s,
                                          float* zm) {
  const float4 sv = reinterpret_cast<const float4*>(ss + g * kBlockN)[lane];
  const float4 zv = reinterpret_cast<const float4*>(zs + g * kBlockN)[lane];
  s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
  zm[0] = kMagic + zv.x; zm[1] = kMagic + zv.y;
  zm[2] = kMagic + zv.z; zm[3] = kMagic + zv.w;
}

// Copy `rows` rows of kBlockN consecutive 32-bit values (row r starts at
// src + r * stride) into dst[r * kBlockN + c].  Columns >= valid are
// zeroed.
// 16-byte copies when every row start is 16-byte aligned (vec), else 4.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* src,
                                           int rows, size_t stride, int valid,
                                           bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < rows * (kBlockN / 4); i += kThreads) {
      const int r = i / (kBlockN / 4), c = (i % (kBlockN / 4)) * 4;
      uint32_t* d = dst + r * kBlockN + c;
      if (c < valid) {
        __pipeline_memcpy_async(d, src + r * stride + c, 16);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = tid; i < rows * kBlockN; i += kThreads) {
      const int r = i / kBlockN, c = i % kBlockN;
      if (c < valid) {
        __pipeline_memcpy_async(dst + i, src + r * stride + c, 4);
      } else {
        dst[i] = 0u;
      }
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequant_matmul_ordered_kernel(const T* __restrict__ x,
                              const uint32_t* __restrict__ qweight,
                              const float* __restrict__ scales,
                              const float* __restrict__ zeros,
                              T* __restrict__ y, float* __restrict__ partial,
                              int M, int N, int K, int gs, int bk,
                              int steps_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StageLayout lay = stage_layout<T, BM>(bk, gs);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * BM;
  const int rows = bk / 8;                  // packed rows per K step
  const int groups = bk / gs;               // metadata rows per K step
  const int step0 = blockIdx.z * steps_per_split;
  const int nsteps = min(K / bk - step0, steps_per_split);
  const int valid_n = N - n0;
  const bool vec = N % 4 == 0;              // 16-byte aligned weight rows
  const int xchunks = bk * static_cast<int>(sizeof(T)) / 16;

  // Start the copies of local K step `j` into its ring slot.
  auto issue = [&](int j) {
    unsigned char* st = smem + (j % kStages) * lay.bytes;
    const int k0 = (step0 + j) * bk;
    stage_rows(reinterpret_cast<uint32_t*>(st + lay.w),
               qweight + static_cast<size_t>(k0 / 8) * N + n0, rows, N,
               valid_n, vec, tid);
    const int g0 = k0 / gs;
    stage_rows(reinterpret_cast<uint32_t*>(st + lay.s),
               reinterpret_cast<const uint32_t*>(scales) +
                   static_cast<size_t>(g0) * N + n0,
               groups, N, valid_n, vec, tid);
    stage_rows(reinterpret_cast<uint32_t*>(st + lay.z),
               reinterpret_cast<const uint32_t*>(zeros) +
                   static_cast<size_t>(g0) * N + n0,
               groups, N, valid_n, vec, tid);
    // x rows are 16-byte aligned: K is a multiple of 8, bk of 8
    unsigned char* xs = st + lay.x;
    for (int i = tid; i < BM * xchunks; i += kThreads) {
      const int m = i / xchunks, u = i % xchunks;
      if (m0 + m < M) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            x + static_cast<size_t>(m0 + m) * K + k0);
        __pipeline_memcpy_async(xs + i * 16, src + u * 16, 16);
      } else {
        *reinterpret_cast<uint4*>(xs + i * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  }

  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nsteps) issue(j);
    __pipeline_commit();
  }
  for (int j = 0; j < nsteps; ++j) {
    if (j + kStages - 1 < nsteps) issue(j + kStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();

    const unsigned char* st = smem + (j % kStages) * lay.bytes;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + lay.w);
    const T* xs = reinterpret_cast<const T*>(st + lay.x);
    const float* ss = reinterpret_cast<const float*>(st + lay.s);
    const float* zs = reinterpret_cast<const float*>(st + lay.z);
    // this warp's rows are warp, warp + kWarps, ...: follow their group
    // with a running boundary instead of a division per word
    int g = (warp * 8) / gs;
    int next = (g + 1) * gs;                // first k of the next group
    float s[kCols], zm[kCols];
    load_meta(ss, zs, g, lane, s, zm);
    for (int r = warp; r < rows; r += kWarps) {
      const uint4 quad =
          *reinterpret_cast<const uint4*>(ws + r * kBlockN + lane * kCols);
      const uint32_t words[kCols] = {quad.x, quad.y, quad.z, quad.w};
      const int kr = r * 8;                 // first k of the words
      if (kr >= next) {
        do {
          ++g;
          next += gs;
        } while (kr >= next);
        load_meta(ss, zs, g, lane, s, zm);
      }
      float w[kCols][8];
      if (kr + 8 <= next) {                 // the words lie in one group
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            w[c][i] = dequant<T>(words[c], i, zm[c], s[c]);
          }
        }
      } else {                              // they cross a group boundary
        float si[kCols], zmi[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          si[c] = s[c];
          zmi[c] = zm[c];
        }
        int gi = g, nexti = next;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (kr + i == nexti) {
            ++gi;
            nexti += gs;
            load_meta(ss, zs, gi, lane, si, zmi);
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            w[c][i] = dequant<T>(words[c], i, zmi[c], si[c]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        float xv[8];
        Num<T>::load8(xs + m * bk + kr, xv);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[m][c] = fmaf(xv[i], w[c][i], acc[m][c]);
          }
        }
      }
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);

  // Add the warps' partial sums in a fixed order.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      red[(warp * BM + m) * kBlockN + lane * kCols + c] = acc[m][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * kBlockN; i += kThreads) {
    const int m = i / kBlockN, c = i % kBlockN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float sum = 0.f;
    for (int v = 0; v < kWarps; ++v) sum += red[(v * BM + m) * kBlockN + c];
    const size_t out = static_cast<size_t>(m0 + m) * N + n0 + c;
    if (partial == nullptr) {
      y[out] = Num<T>::from_float(sum);
    } else {
      partial[blockIdx.z * static_cast<size_t>(M) * N + out] = sum;
    }
  }
}

// y = sum over the K splits' partial tiles, in split order.
template <typename T>
__global__ void add_splits_kernel(const float* __restrict__ partial,
                                  T* __restrict__ y, int splits, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    sum += partial[static_cast<size_t>(s) * mn + i];
  }
  y[i] = Num<T>::from_float(sum);
}

// Dynamic shared memory of one block: the stage ring, or the warps'
// partial sums if those need more.
template <typename T, int BM>
int smem_bytes(int bk, int gs) {
  const int ring = kStages * stage_layout<T, BM>(bk, gs).bytes;
  const int red = kWarps * BM * kBlockN * 4;
  return ring > red ? ring : red;
}

// Rows of x per block: 4 for decode batches, else 16.
inline int block_m(int m) { return m <= 4 ? 4 : 16; }

// How the K steps are split over blockIdx.z on the current device: the
// column tiles times the splits give about kSplitBlocksPerSM blocks per
// SM (the down projection alone has 20 column tiles for 132 SMs).  It
// depends on N, K and the card, never on M, so a row's float32 sum order
// does not depend on the batch it runs in.
struct Split {
  int steps_per_split, splits;
};

cudaError_t choose_split(int n, int k, int bk, Split* out) {
  static int sm_count[64] = {0};            // per device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int nsteps = k / bk;
  const int tiles = (n + kBlockN - 1) / kBlockN;
  int splits = (kSplitBlocksPerSM * sm_count[dev] + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > nsteps ? nsteps : splits);
  out->steps_per_split = (nsteps + splits - 1) / splits;
  out->splits = (nsteps + out->steps_per_split - 1) / out->steps_per_split;
  return cudaSuccess;
}

// Launch the GEMM on `stream`: each block writes its tile of y, or, when
// `partial` is given, its float32 partial tile of its K split (split z at
// partial + z * M * N), which the caller then reduces.
template <typename T, int BM>
cudaError_t launch_gemm(const void* x, const void* qweight, const void* scales,
                        const void* zeros, void* y, float* partial, int m,
                        int n, int k, int gs, int bk, Split split,
                        cudaStream_t stream) {
  const int smem = smem_bytes<T, BM>(bk, gs);
  static int opted_in = 48 * 1024;          // bytes allowed without opt-in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_ordered_kernel<T, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + BM - 1) / BM,
                  split.splits);
  dequant_matmul_ordered_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<T*>(y), partial, m, n, k, gs, bk, split.steps_per_split);
  return cudaGetLastError();
}

bool valid_shape(int m, int n, int k, int group_size, int block_k) {
  return m > 0 && n > 0 && k > 0 && group_size > 0 && block_k > 0 &&
         k % 8 == 0 && block_k % 8 == 0 && block_k % group_size == 0 &&
         k % block_k == 0;
}

}  // namespace
