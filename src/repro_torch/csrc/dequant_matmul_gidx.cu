// g_idx int4 dequant-GEMM for Hopper (sm_90a): the naive act-order layout.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_matmul.py::dequant_matmul_gidx
//   (body _dequant_matmul_gidx_kernel)
// and computes the same function:
//   y[m, n] = sum_k x[m, k] * w[k, n]
//   w[k, n] = (q[k, n] - z[g_idx[k], n]) * s[g_idx[k], n]
// with q the nibble (k % 8) of the packed word qweight[k / 8, n].  Rows
// keep their original order, so the 8 nibbles of one word belong to 8
// unrelated groups: each row gathers its scale and zero through g_idx
// (the paper's Eq. 3, the metadata reload that Algorithm 1's ordering
// removes).  w is computed in float32 and rounded to the compute type
// (float or bfloat16), as is x; the sum is kept in float32 and y written
// in the compute type.
//
// What bounds it: in decode M is 1..32, so, like the ordered kernel, its
// floor is the bytes it must read (packed weight, scales, zeros, g_idx).
// On top of the ordered kernel's work each nibble costs its own lookup of
// a scale and a zero, so the instruction stream of the unpack, the
// lookups and M CUDA-core FMAs per element (the float32 policy forbids
// TF32) is what this simple form runs into.
//
// Design (the GPU form of the reference's "whole (G, bn) metadata table
// resident" block):
//  * One thread block per (BM rows x 32 columns) output tile and range of
//    packed rows.  Each block first stages its columns' whole scale and
//    2^23 + zero table, G x 32 floats each (32 KB at G = 128), in shared
//    memory; every nibble then looks up its row's group g_idx[k] there.
//  * Eight lanes share one packed row, each owning 4 adjacent columns (one
//    16-byte quad of packed words), so a warp works on 4 packed rows and
//    a block on 16.  A 128-bit shared load is served per quarter warp,
//    and the 8 lanes of a quarter warp read one 128-byte table row, so
//    the gather has no bank conflicts.  g_idx and x are read through the
//    read-only cache; each x value serves 4 columns.
//  * When the column tiles alone cannot fill the card (the down
//    projection has 80), the packed rows are split over blockIdx.z
//    (choose_split, from the device's SM count).  Each split writes its
//    float32 partial tile and a second kernel adds the splits in a fixed
//    order.  The split depends only on N, K and the card, never on M, and
//    every sum runs in a fixed order, so a row's result does not depend
//    on the batch it runs in.
//  * A nibble q becomes the float 2^23 + q by OR-ing it into the mantissa
//    of 2^23; subtracting 2^23 + z (exact for the integer zero-points
//    0..15 that the quantizer writes) gives q - z exactly, so w is
//    bit-equal to the reference's (q - z) * s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;                      // output columns per lane
constexpr int kLanesPerRow = 8;               // lanes sharing a packed row
constexpr int kBlockN = kCols * kLanesPerRow; // output columns per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowGroups = kThreads / kLanesPerRow;  // packed rows in flight
// Thread blocks per SM the split aims for when the column tiles alone
// cannot fill the card.
constexpr int kSplitBlocksPerSM = 4;
constexpr uint32_t kMagicBits = 0x4B000000u;  // 2^23 as float bits
constexpr float kMagic = 8388608.f;           // 2^23

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  // the 8 values at p (32-byte aligned)
  __device__ static void load8(const float* p, float* out) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
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
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {           // bf16 -> f32 is a 16-bit shift
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
};

// The 4 32-bit values of `row` at columns col..col+3; columns >= n read
// as 0.  One 16-byte load when the row is 16-byte aligned (vec).
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

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_gidx_kernel(const T* __restrict__ x,
                           const uint32_t* __restrict__ qweight,
                           const float* __restrict__ scales,
                           const float* __restrict__ zeros,
                           const int* __restrict__ g_idx,
                           T* __restrict__ y, float* __restrict__ partial,
                           int M, int N, int K, int G, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);   // (G, kBlockN) scales
  float* zs = ss + G * kBlockN;                 // (G, kBlockN) 2^23 + zeros
  const int tid = threadIdx.x;
  const int grp = tid / kLanesPerRow;           // this lane's row group
  const int sub = tid % kLanesPerRow;           // its place in the group
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * BM;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(K / 8, r_begin + rows_per_split);
  const bool vec = N % 4 == 0;                  // 16-byte aligned rows

  // Stage the block's columns of the whole metadata table.
  for (int i = tid; i < G * kLanesPerRow; i += kThreads) {
    const int g = i / kLanesPerRow, c = (i % kLanesPerRow) * kCols;
    const size_t row = static_cast<size_t>(g) * N;
    const uint4 s = load_quad(reinterpret_cast<const uint32_t*>(scales) + row,
                              n0 + c, N, vec);
    const uint4 z = load_quad(reinterpret_cast<const uint32_t*>(zeros) + row,
                              n0 + c, N, vec);
    *reinterpret_cast<uint4*>(ss + g * kBlockN + c) = s;
    *reinterpret_cast<float4*>(zs + g * kBlockN + c) = make_float4(
        kMagic + __uint_as_float(z.x), kMagic + __uint_as_float(z.y),
        kMagic + __uint_as_float(z.z), kMagic + __uint_as_float(z.w));
  }
  __syncthreads();

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  }

  const int col = sub * kCols;                  // within the block's tile
  for (int r = r_begin + grp; r < r_end; r += kRowGroups) {
    const uint4 quad =
        load_quad(qweight + static_cast<size_t>(r) * N, n0 + col, N, vec);
    const uint32_t words[kCols] = {quad.x, quad.y, quad.z, quad.w};
    const int4 ga = __ldg(reinterpret_cast<const int4*>(g_idx + r * 8));
    const int4 gb = __ldg(reinterpret_cast<const int4*>(g_idx + r * 8) + 1);
    const int gi[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    float w[kCols][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 s = *reinterpret_cast<const float4*>(
          ss + gi[i] * kBlockN + col);
      const float4 zm = *reinterpret_cast<const float4*>(
          zs + gi[i] * kBlockN + col);
      const float sv[kCols] = {s.x, s.y, s.z, s.w};
      const float zv[kCols] = {zm.x, zm.y, zm.z, zm.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float qm =
            __uint_as_float(kMagicBits | ((words[c] >> (4 * i)) & 0xFu));
        w[c][i] = Num<T>::round((qm - zv[c]) * sv[c]);
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      // rows past M read row M - 1 and are never written
      const int mr = min(m0 + m, M - 1);
      float xv[8];
      Num<T>::load8(x + static_cast<size_t>(mr) * K + r * 8, xv);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[m][c] = fmaf(xv[i], w[c][i], acc[m][c]);
      }
    }
  }
  __syncthreads();                              // done with the table

  // Add the row groups' partial sums in a fixed order.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      red[(grp * BM + m) * kBlockN + col + c] = acc[m][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * kBlockN; i += kThreads) {
    const int m = i / kBlockN, c = i % kBlockN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float sum = 0.f;
    for (int v = 0; v < kRowGroups; ++v) sum += red[(v * BM + m) * kBlockN + c];
    const size_t out = static_cast<size_t>(m0 + m) * N + n0 + c;
    if (gridDim.z == 1) {
      y[out] = Num<T>::from_float(sum);
    } else {
      partial[blockIdx.z * static_cast<size_t>(M) * N + out] = sum;
    }
  }
}

// y = sum over the splits' partial tiles, in split order.
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

// Dynamic shared memory of one block: the metadata table, or the row
// groups' partial sums if those need more.
template <int BM>
int smem_bytes(int groups) {
  const int table = 2 * groups * kBlockN * 4;
  const int red = kRowGroups * BM * kBlockN * 4;
  return table > red ? table : red;
}

// Rows of x per block: 4 for decode batches, else 16.
inline int block_m(int m) { return m <= 4 ? 4 : 16; }

// How the packed rows are split over blockIdx.z on the current device:
// the column tiles times the splits give about kSplitBlocksPerSM blocks
// per SM.  It depends on N, K and the card, never on M.
struct Split {
  int rows_per_split, splits;
};

cudaError_t choose_split(int n, int k, Split* out) {
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
  const int rows = k / 8;
  const int tiles = (n + kBlockN - 1) / kBlockN;
  int splits = (kSplitBlocksPerSM * sm_count[dev] + tiles - 1) / tiles;
  // at least one packed row per row group in every split
  const int most = (rows + kRowGroups - 1) / kRowGroups;
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  out->rows_per_split = (rows + splits - 1) / splits;
  out->splits = (rows + out->rows_per_split - 1) / out->rows_per_split;
  return cudaSuccess;
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* qweight, const void* scales,
                   const void* zeros, const void* g_idx, void* y,
                   void* partial, int m, int n, int k, int groups,
                   Split split, cudaStream_t stream) {
  const int smem = smem_bytes<BM>(groups);
  static int opted_in = 48 * 1024;          // bytes allowed without opt-in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_gidx_kernel<T, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + BM - 1) / BM,
                  split.splits);
  dequant_matmul_gidx_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const int*>(g_idx), static_cast<T*>(y),
      static_cast<float*>(partial), m, n, k, groups, split.rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split.splits == 1) return err;
  const int mn = m * n;
  add_splits_kernel<T><<<(mn + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(y), split.splits,
      mn);
  return cudaGetLastError();
}

bool valid_shape(int m, int n, int k, int groups) {
  return m > 0 && n > 0 && k > 0 && k % 8 == 0 && groups > 0;
}

}  // namespace

// Floats of scratch that dequant_matmul_gidx needs in `partial` for this
// shape on the current device (0 when the rows are not split), or minus
// a CUDA error code.
extern "C" long long dequant_matmul_gidx_partial_floats(int m, int n, int k,
                                                        int groups) {
  if (!valid_shape(m, n, k, groups)) {
    return -static_cast<long long>(cudaErrorInvalidValue);
  }
  Split split;
  const cudaError_t err = choose_split(n, k, &split);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return split.splits == 1
             ? 0
             : static_cast<long long>(split.splits) * m * n;
}

// x (M, K) and y (M, N) in the compute type (bf16 != 0: bfloat16, else
// float32), qweight (K/8, N) 32-bit words, scales and zeros (groups, N)
// float32 with integer zero-points, g_idx (K,) int32 with every value in
// [0, groups); all contiguous and 16-byte aligned.  `partial` holds
// `partial_floats` floats of scratch, at least what
// dequant_matmul_gidx_partial_floats asks for.  Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int dequant_matmul_gidx(const void* x, const void* qweight,
                                   const void* scales, const void* zeros,
                                   const void* g_idx, void* y, void* partial,
                                   long long partial_floats, int m, int n,
                                   int k, int groups, int bf16,
                                   void* stream) {
  if (!valid_shape(m, n, k, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Split split;
  const cudaError_t err = choose_split(n, k, &split);
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
        small ? launch<__nv_bfloat16, 4>(x, qweight, scales, zeros, g_idx, y,
                                         partial, m, n, k, groups, split, s)
              : launch<__nv_bfloat16, 16>(x, qweight, scales, zeros, g_idx,
                                          y, partial, m, n, k, groups, split,
                                          s));
  }
  return static_cast<int>(
      small ? launch<float, 4>(x, qweight, scales, zeros, g_idx, y, partial,
                               m, n, k, groups, split, s)
            : launch<float, 16>(x, qweight, scales, zeros, g_idx, y, partial,
                                m, n, k, groups, split, s));
}

// Dynamic shared memory of one block for M rows of x and `groups` groups.
extern "C" int dequant_matmul_gidx_smem_bytes(int m, int groups) {
  return block_m(m) == 4 ? smem_bytes<4>(groups) : smem_bytes<16>(groups);
}

extern "C" const char* dequant_matmul_gidx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
