// The ordered-groups int4 dequant-GEMM's three main loops (the bfloat16
// decode loop on the CUDA cores, the float32 decode loop on the tensor
// cores, both with the K split and its split order, and the large-M
// tensor-core loop) and the rule that picks one, shared by K1
// (dequant_matmul_ordered.cu, whose note says how they are built up and
// what bounds them) and K3 (dequant_matmul_wire_ordered.cu), so that K3's
// sums are K1's bit for bit.
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
// Blocks per SM the bfloat16 decode loop's register budget is cut for (80
// registers a thread): the fastest of the caps tried (64, 80, 128
// registers and none) at the qwen3-4b MLP shapes on an H100.
constexpr int kMinBlocks = 6;
constexpr uint32_t kMagicBits = 0x4B000000u;  // 2^23 as float bits
constexpr float kMagic = 8388608.f;           // 2^23

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
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

// Every main loop ends in an epilogue hook: `epilogue(smem)` runs in every
// thread of every block once the block's tile is written, with the
// block's dynamic shared memory free for it.  K1 passes no epilogue, so
// its kernels are the code they were without the hook.  An epilogue type
// names the bfloat16 decode loop's blocks per SM for __launch_bounds__
// (Epi::kMinBlocks); register budgets do not change a sum: the code fixes
// every operation's order.
template <typename... Epilogue>
struct MinBlocks {
  static constexpr int value = kMinBlocks;
};
template <typename Epi>
struct MinBlocks<Epi> {
  static constexpr int value = Epi::kMinBlocks;
};
template <typename T, int BM, typename... Epilogue>
__global__ void __launch_bounds__(kThreads, MinBlocks<Epilogue...>::value)
dequant_matmul_ordered_kernel(const T* __restrict__ x,
                              const uint32_t* __restrict__ qweight,
                              const float* __restrict__ scales,
                              const float* __restrict__ zeros,
                              T* __restrict__ y, float* __restrict__ partial,
                              int M, int N, int K, int gs, int bk,
                              int steps_per_split, Epilogue... epilogue) {
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
  (epilogue(smem), ...);
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
// depends on N, K and the card, never on M, so within either decode loop
// a row's sum order does not depend on the batch it runs in.
struct Split {
  int steps_per_split, splits;
};

// The current device's SM count.
cudaError_t device_sm_count(int* out) {
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
  *out = sm_count[dev];
  return cudaSuccess;
}

cudaError_t choose_split(int n, int k, int bk, Split* out) {
  int sms = 0;
  const cudaError_t err = device_sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int nsteps = k / bk;
  const int tiles = (n + kBlockN - 1) / kBlockN;
  int splits = (kSplitBlocksPerSM * sms + tiles - 1) / tiles;
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

// ---------------------------------------------------------------------
// The large-M main loop: float32 on the tensor cores (mma.sync m16n8k8
// TF32, operands split 3xTF32), no K split.  The note in
// dequant_matmul_ordered.cu says why and how.

// Smallest M that takes it (float32 only): the smallest M of
// tools/k1_threshold.py's sweep from which it beats the float32 decode
// loop per qwen3-4b layer (2 x up/gate + down) at every larger M of the
// sweep on an H100.  At both full-width shapes at once it beats that loop
// at no M of the sweep (PERF.md).
constexpr int kTcMinM = 1536;
// Smallest group size it takes: a K step stages the scale and zero rows
// of every group it touches, and smaller groups overflow shared memory.
constexpr int kTcMinGroup = 4;
// The BM that K3's templates take for this loop.
constexpr int kTcLoop = 0;
constexpr int kTcBN = 128;                  // output columns per block
constexpr int kTcBK = 32;                   // K per pipeline stage
constexpr int kTcWarpsN = 4;                // warps across N ...
constexpr int kTcWarpsM = 2;                // ... and across M
constexpr int kTcThreads = 32 * kTcWarpsM * kTcWarpsN;
constexpr int kTcNTiles = kTcBN / kTcWarpsN / 8;   // n8 tiles a warp
constexpr int kTcStages = 4;                // cp.async ring depth
// Row strides in 32-bit words.  x: 16 mod 32, so the 8 lanes of a
// 16-byte read phase (rows g, g + 1, columns 4c..4c + 3) hit distinct
// banks.  Packed words: 8 mod 32, so rows 2i and 2i + 1, read together,
// sit on distinct banks.
constexpr int kTcXStride = kTcBK + 16;
constexpr int kTcWStride = kTcBN + 8;

inline bool tensor_core_path(int m, int gs, bool bf16) {
  return !bf16 && m >= kTcMinM && gs >= kTcMinGroup;
}

// Byte offsets of the tiles inside one stage of a block of bm rows: x,
// the packed words, and the scales and zeros of every group a K step can
// touch.
struct TcLayout {
  int x, w, s, z, meta_rows, bytes;
};

__host__ __device__ inline TcLayout tc_layout(int gs, int bm) {
  TcLayout l;
  l.meta_rows = (kTcBK + gs - 2) / gs + 1;
  l.x = 0;
  l.w = l.x + bm * kTcXStride * 4;
  l.s = l.w + (kTcBK / 8) * kTcWStride * 4;
  l.z = l.s + l.meta_rows * kTcBN * 4;
  l.bytes = l.z + l.meta_rows * kTcBN * 4;
  return l;
}

inline int tc_smem_bytes(int gs, int bm) {
  return kTcStages * tc_layout(gs, bm).bytes;
}

// m16 tiles a warp, MT: a block takes 32 MT rows of x.  4 (128 rows), or
// 5 where that leaves each SM fewer rows to compute: the down projection
// at M 2048 has 320 blocks of 128 rows for 132 SMs (3 waves, the last
// 42% full) but 260 of 160 rows (2 waves).  A row's sums do not depend
// on MT.
int tc_mtiles(int m, int n, int sms) {
  const long long tiles_n = (n + kTcBN - 1) / kTcBN;
  auto rows_per_sm = [&](int mt) {
    const int bm = kTcWarpsM * 16 * mt;
    const long long blocks = (m + bm - 1) / bm * tiles_n;
    return (blocks + sms - 1) / sms * bm;
  };
  return rows_per_sm(5) < rows_per_sm(4) ? 5 : 4;
}

// 16 or 4 bytes from global to shared memory; zero-filled when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// `rows` rows of kTcBN consecutive 32-bit values (row r at src + r *
// stride) into dst[r * dstride + c] by the NT threads of a block; rows >=
// vrows and columns >= vcols are zeros.  16-byte copies when every row
// start is 16-byte aligned.
template <int NT = kTcThreads>
__device__ __forceinline__ void tc_stage_rows(uint32_t* dst, int dstride,
                                              const uint32_t* src,
                                              size_t stride, int rows,
                                              int vrows, int vcols, bool vec,
                                              int tid) {
  if (vec) {
    for (int i = tid; i < rows * (kTcBN / 4); i += NT) {
      const int r = i / (kTcBN / 4), c = (i % (kTcBN / 4)) * 4;
      const bool valid = r < vrows && c < vcols;
      cp_async16(dst + r * dstride + c, valid ? src + r * stride + c : src,
                 valid);
    }
  } else {
    for (int i = tid; i < rows * kTcBN; i += NT) {
      const int r = i / kTcBN, c = i % kTcBN;
      const bool valid = r < vrows && c < vcols;
      cp_async4(dst + r * dstride + c, valid ? src + r * stride + c : src,
                valid);
    }
  }
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, each a TF32 value in a 32-bit register.  The mma reads
// only the top 19 bits of a TF32 operand and cvt.rna need not clear the
// other 13, so big's value is its bits with those cleared; v - big is
// finite whenever v is, and then cvt.rna of it is an add of half an ulp
// (0x1000) to its bits.
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(v);
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u)) + 0x1000u;
}

// c += a * b, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y[row, col], y[row, col + 1] where they exist (col is even)
__device__ __forceinline__ void tc_store2(float* y, int M, int N, int row,
                                          int col, float a, float b) {
  if (row >= M) return;
  float* p = y + static_cast<size_t>(row) * N + col;
  if (N % 2 == 0 && col + 1 < N) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (col < N) p[0] = a;
    if (col + 1 < N) p[1] = b;
  }
}

template <int MT, typename... Epilogue>
__global__ void __launch_bounds__(kTcThreads, 1)
dequant_matmul_tc_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ qweight,
                         const float* __restrict__ scales,
                         const float* __restrict__ zeros,
                         float* __restrict__ y, int M, int N, int K, int gs,
                         Epilogue... epilogue) {
  constexpr int kBM = kTcWarpsM * 16 * MT;  // rows of x per block
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout lay = tc_layout(gs, kBM);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = warp / kTcWarpsN, wn = warp % kTcWarpsN;
  const int n0 = blockIdx.x * kTcBN;
  const int m0 = blockIdx.y * kBM;
  const int groups = K / gs;
  const int nsteps = (K + kTcBK - 1) / kTcBK;
  const int valid_n = N - n0;
  const bool vec = N % 4 == 0;              // 16-byte aligned weight rows

  // Start the copies of K step `j` into its ring slot.  x rows are
  // 16-byte aligned (K is a multiple of 8), and a K step past K (a ragged
  // last step) copies zeros.
  auto issue = [&](int j) {
    unsigned char* st = smem + (j % kTcStages) * lay.bytes;
    const int k0 = j * kTcBK;
    float* xs = reinterpret_cast<float*>(st + lay.x);
    for (int i = tid; i < kBM * (kTcBK / 4); i += kTcThreads) {
      const int r = i / (kTcBK / 4), u = (i % (kTcBK / 4)) * 4;
      const bool valid = m0 + r < M && k0 + u < K;
      cp_async16(xs + r * kTcXStride + u,
                 valid ? x + static_cast<size_t>(m0 + r) * K + k0 + u : x,
                 valid);
    }
    const int w0 = k0 / 8, g0 = k0 / gs;
    tc_stage_rows(reinterpret_cast<uint32_t*>(st + lay.w), kTcWStride,
                  qweight + static_cast<size_t>(w0) * N + n0, N, kTcBK / 8,
                  K / 8 - w0, valid_n, vec, tid);
    tc_stage_rows(reinterpret_cast<uint32_t*>(st + lay.s), kTcBN,
                  reinterpret_cast<const uint32_t*>(scales) +
                      static_cast<size_t>(g0) * N + n0,
                  N, lay.meta_rows, groups - g0, valid_n, vec, tid);
    tc_stage_rows(reinterpret_cast<uint32_t*>(st + lay.z), kTcBN,
                  reinterpret_cast<const uint32_t*>(zeros) +
                      static_cast<size_t>(g0) * N + n0,
                  N, lay.meta_rows, groups - g0, valid_n, vec, tid);
  };

  float acc[MT][kTcNTiles][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kTcNTiles; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }

  for (int j = 0; j < kTcStages - 1; ++j) {
    if (j < nsteps) issue(j);
    asm volatile("cp.async.commit_group;" ::);
  }
  // The group of this lane's k = k0 + 16 kk + 4c, followed with a running
  // boundary (k only grows) instead of a division per chunk.
  int grp = 0, next = gs;
  for (int j = 0; j < nsteps; ++j) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kTcStages - 2) : "memory");
    __syncthreads();                        // step j landed; j - 1 done
    if (j + kTcStages - 1 < nsteps) issue(j + kTcStages - 1);
    asm volatile("cp.async.commit_group;" ::);

    const unsigned char* st = smem + (j % kTcStages) * lay.bytes;
    const float* xs = reinterpret_cast<const float*>(st + lay.x) +
                      (wm * MT * 16 + g) * kTcXStride + 4 * c;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + lay.w) +
                         (c >> 1) * kTcWStride + wn * kTcNTiles * 8 + g;
    const float* ss = reinterpret_cast<const float*>(st + lay.s) +
                      wn * kTcNTiles * 8 + g;
    const float* zs = reinterpret_cast<const float*>(st + lay.z) +
                      wn * kTcNTiles * 8 + g;
    const int k0 = j * kTcBK;
    const int gbase = k0 / gs;              // the stage's first group
    // Each chunk of 16 k is two k-steps.  The sum over k runs in any
    // order, so lane c takes the 4 consecutive k = kb..kb + 3 (kb = 16 kk
    // + 4c): the first k-step's k = c and c + 4 are kb and kb + 1, the
    // second's kb + 2 and kb + 3.  Its x values are one 16-byte read a
    // row, and its weights nibbles 4(c & 1)..+3 of packed row
    // 2 kk + c / 2.
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const int kb = k0 + 16 * kk + 4 * c;
      while (kb >= next) {
        ++grp;
        next += gs;
      }
      // B fragments: dequantize the lane's 4 weights of each n8 tile and
      // split them; shared by the warp's MT m16 tiles
      uint32_t bb[kTcNTiles][4], bsm[kTcNTiles][4];
      const int shift = 16 * (c & 1);
      if (kb + 3 < next) {                  // all 4 in one group
        const int r = (grp - gbase) * kTcBN;
#pragma unroll
        for (int ni = 0; ni < kTcNTiles; ++ni) {
          const uint32_t word = ws[2 * kk * kTcWStride + 8 * ni] >> shift;
          const float s = ss[r + 8 * ni];
          const float zm = kMagic + zs[r + 8 * ni];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float qm =
                __uint_as_float(kMagicBits | ((word >> (4 * e)) & 0xFu));
            split((qm - zm) * s, bb[ni][e], bsm[ni][e]);
          }
        }
      } else {                              // a group boundary inside
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int ge = grp, ne = next;
          while (kb + e >= ne) {
            ++ge;
            ne += gs;
          }
          const int r = (ge - gbase) * kTcBN;
#pragma unroll
          for (int ni = 0; ni < kTcNTiles; ++ni) {
            const uint32_t word = ws[2 * kk * kTcWStride + 8 * ni] >> shift;
            const float qm =
                __uint_as_float(kMagicBits | ((word >> (4 * e)) & 0xFu));
            split((qm - (kMagic + zs[r + 8 * ni])) * ss[r + 8 * ni],
                  bb[ni][e], bsm[ni][e]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* xr = xs + mi * 16 * kTcXStride + 16 * kk;
        const float4 r0 = *reinterpret_cast<const float4*>(xr);
        const float4 r8 = *reinterpret_cast<const float4*>(xr + 8 * kTcXStride);
        const float a0[4] = {r0.x, r0.y, r0.z, r0.w};
        const float a8[4] = {r8.x, r8.y, r8.z, r8.w};
        // The chunk's 6 mma per tile go to a zeroed fragment, which is
        // then added to the float32 sum with a rounded add: the tensor
        // cores truncate each accumulation, and over the whole of K into
        // one accumulator (whose sign stays) that bias exceeds the
        // float32 limit.  Chunk sums change sign, so their truncations do
        // not add up.
        float part[kTcNTiles][4];
#pragma unroll
        for (int ni = 0; ni < kTcNTiles; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[ni][e] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          uint32_t ab[4], as[4];
          split(a0[h], ab[0], as[0]);
          split(a8[h], ab[1], as[1]);
          split(a0[h + 1], ab[2], as[2]);
          split(a8[h + 1], ab[3], as[3]);
          // small*big, big*small, big*big: the small*small term is below
          // 2^-22 of the product
#pragma unroll
          for (int ni = 0; ni < kTcNTiles; ++ni) {
            mma(part[ni], as, bb[ni][h], bb[ni][h + 1]);
          }
#pragma unroll
          for (int ni = 0; ni < kTcNTiles; ++ni) {
            mma(part[ni], ab, bsm[ni][h], bsm[ni][h + 1]);
          }
#pragma unroll
          for (int ni = 0; ni < kTcNTiles; ++ni) {
            mma(part[ni], ab, bb[ni][h], bb[ni][h + 1]);
          }
        }
#pragma unroll
        for (int ni = 0; ni < kTcNTiles; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[ni][e];
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // C fragment: rows g and g + 8, columns 2c and 2c + 1 of each tile
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int row = m0 + wm * MT * 16 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < kTcNTiles; ++ni) {
      const int col = n0 + wn * kTcNTiles * 8 + ni * 8 + 2 * c;
      tc_store2(y, M, N, row, col, acc[mi][ni][0], acc[mi][ni][1]);
      tc_store2(y, M, N, row + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  (epilogue(smem), ...);
}

template <int MT>
cudaError_t launch_tc_mt(const void* x, const void* qweight,
                         const void* scales, const void* zeros, float* y,
                         int m, int n, int k, int gs, cudaStream_t stream) {
  constexpr int kBM = kTcWarpsM * 16 * MT;
  const int smem = tc_smem_bytes(gs, kBM);
  static int opted_in = 48 * 1024;          // bytes allowed without opt-in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_tc_kernel<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((n + kTcBN - 1) / kTcBN, (m + kBM - 1) / kBM);
  dequant_matmul_tc_kernel<MT><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros), y,
      m, n, k, gs);
  return cudaGetLastError();
}

// Launch the tensor-core GEMM on `stream`: y (M, N) float32, written
// whole by the blocks (no K split).
cudaError_t launch_tc(const void* x, const void* qweight, const void* scales,
                      const void* zeros, float* y, int m, int n, int k,
                      int gs, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = device_sm_count(&sms);
  if (err != cudaSuccess) return err;
  return tc_mtiles(m, n, sms) == 5
             ? launch_tc_mt<5>(x, qweight, scales, zeros, y, m, n, k, gs,
                               stream)
             : launch_tc_mt<4>(x, qweight, scales, zeros, y, m, n, k, gs,
                               stream);
}

// Dynamic shared memory of one block of the tensor-core loop.
cudaError_t tc_block_smem(int m, int n, int gs, int* out) {
  int sms = 0;
  const cudaError_t err = device_sm_count(&sms);
  if (err != cudaSuccess) return err;
  *out = tc_smem_bytes(gs, kTcWarpsM * 16 * tc_mtiles(m, n, sms));
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// The float32 decode loop (M < kTcMinM): the products on the tensor cores
// (mma.sync m16n8k8 TF32 with the weight on the A side, yT = WT xT), the
// weight operand the exact integer q - z, x in two TF32 parts, each
// chunk's sum scaled by its group's scale.  The note in
// dequant_matmul_ordered.cu says why and how.

constexpr int kDecRows = 32;                // packed rows a stage (256 k)
constexpr int kDecK = 8 * kDecRows;
constexpr int kDecStages = 2;               // cp.async ring depth
// The group sizes it takes: multiples of 4 (a boundary then falls at a
// k-step's start or between its nibbles 3 and 4) of at least 8 (at most
// one boundary a k-step; a stage holds the scale and zero rows of every
// group its 256 k touch).
constexpr int kDecMinGroup = 8;
// Row strides in 32-bit words: x's 4 mod 32, so the lanes' reads of one
// k-step (row g % 4, k = c) hit distinct banks for the 4 rows; the warps'
// sums 4 mod 32, so their 16-byte stores do too.
constexpr int kDecXStride = kDecK + 4;
constexpr int kDecRedStride = kBlockN + 4;

// Rows of x a block takes, in tiles of 4 (an n8 tile holds 4 rows' big
// parts and their small parts): 4 rows up to M = 4, else 8.  A row's sums
// do not depend on it.
inline int dec_tiles(int m) { return m <= 4 ? 1 : 2; }

// Byte offsets of the tiles inside one stage of a block of 4 R4 rows: the
// packed rows, x, and the scales and zeros of every group a stage's k can
// touch.
struct DecLayout {
  int w, x, s, z, meta_rows, bytes;
};

__host__ __device__ inline DecLayout dec_layout(int gs, int r4) {
  DecLayout l;
  l.meta_rows = (kDecK + gs - 2) / gs + 1;
  l.w = 0;
  l.x = l.w + kDecRows * kBlockN * 4;
  l.s = l.x + r4 * 4 * kDecXStride * 4;
  l.z = l.s + l.meta_rows * kBlockN * 4;
  l.bytes = l.z + l.meta_rows * kBlockN * 4;
  return l;
}

// Dynamic shared memory of one block: the ring, or the warps' sums if
// those need more.
inline int dec_smem_bytes(int gs, int r4) {
  const int ring = kDecStages * dec_layout(gs, r4).bytes;
  const int red = 4 * 4 * r4 * kDecRedStride * 4;
  return ring > red ? ring : red;
}

// The B operand of lane (g, c) from x: x's big TF32 part (round to
// nearest, ties away from zero, as cvt.rna.tf32.f32, here by integer
// adds on the bits) for g < 4, its small part for g >= 4, as `split`
// gives them.
__device__ __forceinline__ uint32_t x_part(float v, bool small) {
  const uint32_t big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  const uint32_t rest = __float_as_uint(v - __uint_as_float(big)) + 0x1000u;
  return small ? rest : big;
}

// The lane's B operands of k-step s of its chunk (xr at x row g % 4, k =
// c of the chunk; row tiles 4 rows apart): x at k = 8s + c in b0 and
// 8s + c + 4 in b1, their big parts (small: their small parts).
template <int R4>
__device__ __forceinline__ void load_x(const float* xr, int s, bool small,
                                       uint32_t (&b0)[R4],
                                       uint32_t (&b1)[R4]) {
#pragma unroll
  for (int t = 0; t < R4; ++t) {
    b0[t] = x_part(xr[t * 4 * kDecXStride + 8 * s], small);
    b1[t] = x_part(xr[t * 4 * kDecXStride + 8 * s + 4], small);
  }
}

// c = 0 + a * b, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// 2^(23 - 4c) + z for the lane's 8 columns (zs at its first, spans of 32
// columns): with the nibble q at bits 4c..4c + 3 of its mantissa, the
// float of exponent 2^(23 - 4c) is 2^(23 - 4c) + q, so q - z is one
// subtraction, exact for the integer zero-points the quantizer writes.
__device__ __forceinline__ void load_zero_bias(const float* zs, float bias,
                                               float (&zb)[2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float4 z = *reinterpret_cast<const float4*>(zs + 32 * u);
    zb[u][0] = z.x + bias;
    zb[u][1] = z.y + bias;
    zb[u][2] = z.z + bias;
    zb[u][3] = z.w + bias;
  }
}

// One k-step (packed row `wrow`, at the lane's first column, spans of 32)
// into the warp's 4 column tiles and R4 row tiles.  Lane (g, c) takes
// nibbles c and c + 4 of each word, as the mma's k = c and c + 4 (x's at
// k = 8r + c and 8r + c + 4 in b0, b1: the big part of row g for g < 4,
// the small part of row g - 4 for g >= 4), for columns 32u + 4g..+3: A
// rows g and g + 8 of column tile 2u + h are columns 32u + 4g + 2h and
// + 1.  kFirst: the group's first k-step, into zeroed fragments.
template <int R4, bool kFirst>
__device__ __forceinline__ void decode_step(
    float (&part)[2][2][R4][4], const uint32_t* wrow,
    const uint32_t (&b0)[R4], const uint32_t (&b1)[R4],
    const float (&zb)[2][4], uint32_t exp_c, uint32_t mask_c) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint4 q = *reinterpret_cast<const uint4*>(wrow + 32 * u);
    const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[4];
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const uint32_t w = w4[2 * h + col];
        const float z = zb[u][2 * h + col];
        const float lo = __uint_as_float(exp_c | (w & mask_c)) - z;
        const float hi = __uint_as_float(exp_c | ((w >> 16) & mask_c)) - z;
        a[col] = __float_as_uint(lo);
        a[2 + col] = __float_as_uint(hi);
      }
#pragma unroll
      for (int t = 0; t < R4; ++t) {
        if (kFirst) {
          mma0(part[u][h][t], a, b0[t], b1[t]);
        } else {
          mma(part[u][h][t], a, b0[t], b1[t]);
        }
      }
    }
  }
}

// c += a * b, m16n8k4, TF32 in, float32 accumulate
__device__ __forceinline__ void mma_k4(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Half a k-step, where a group boundary falls between its nibbles 3 and
// 4: nibble c (kHi false: the mma's k = c, x in b) or c + 4 (kHi) of
// packed row `wrow` into the warp's tiles, as decode_step does both.
template <int R4, bool kHi>
__device__ __forceinline__ void decode_half(float (&part)[2][2][R4][4],
                                            const uint32_t* wrow,
                                            const uint32_t (&b)[R4],
                                            const float (&zb)[2][4],
                                            uint32_t exp_c,
                                            uint32_t mask_c) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint4 q = *reinterpret_cast<const uint4*>(wrow + 32 * u);
    const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[2];
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const uint32_t w = kHi ? w4[2 * h + col] >> 16 : w4[2 * h + col];
        a[col] = __float_as_uint(__uint_as_float(exp_c | (w & mask_c)) -
                                 zb[u][2 * h + col]);
      }
#pragma unroll
      for (int t = 0; t < R4; ++t) mma_k4(part[u][h][t], a[0], a[1], b[t]);
    }
  }
}

template <int R4>
__device__ __forceinline__ void zero_part(float (&part)[2][2][R4][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < R4; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[u][h][t][i] = 0.f;
      }
    }
  }
}

// acc += s * part for the lane's 8 columns (ss at its first).
template <int R4>
__device__ __forceinline__ void add_scaled(float (&acc)[2][2][R4][4],
                                           const float (&part)[2][2][R4][4],
                                           const float* ss) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float4 sv = *reinterpret_cast<const float4*>(ss + 32 * u);
    const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < R4; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[u][h][t][i] =
              fmaf(s4[2 * h + i / 2], part[u][h][t][i], acc[u][h][t][i]);
        }
      }
    }
  }
}

// Blocks per SM the registers are cut for: 4 (128 a thread) for K1's 4
// rows, 3 (168) for 8 rows or with an epilogue (K3's wire quantize); at 5
// (96) K1's 4-row loop spills, and so does K3's at 4.
template <int R4, typename... Epilogue>
struct DecMinBlocks {
  static constexpr int value = R4 == 1 && sizeof...(Epilogue) == 0 ? 4 : 3;
};

// kVec: N is a multiple of 4, so the weight and metadata rows are
// 16-byte aligned.
template <int R4, bool kVec, typename... Epilogue>
__global__ void __launch_bounds__(kThreads,
                                  DecMinBlocks<R4, Epilogue...>::value)
dequant_matmul_decode_tc_kernel(const float* __restrict__ x,
                                const uint32_t* __restrict__ qweight,
                                const float* __restrict__ scales,
                                const float* __restrict__ zeros,
                                float* __restrict__ y,
                                float* __restrict__ partial, int M, int N,
                                int K, int gs, int bk, int steps_per_split,
                                Epilogue... epilogue) {
  constexpr int kBM = 4 * R4;               // rows of x per block
  extern __shared__ __align__(16) unsigned char smem[];
  const DecLayout lay = dec_layout(gs, R4);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  // warp (wn, wk): columns 64 wn..+63, packed rows 8 wk..+7 of a stage
  const int wn = warp % 2, wk = warp / 2;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * kBM;
  // the split's K range: its bk steps, the last split's up to K
  const int kb = blockIdx.z * steps_per_split * bk;
  const int ke = min(kb + steps_per_split * bk, K);
  const int nstages = (ke - kb + kDecK - 1) / kDecK;
  const int groups = K / gs;
  const int valid_n = N - n0;
  const uint32_t exp_c = (150u - 4u * c) << 23;   // the float 2^(23 - 4c)
  const uint32_t mask_c = 0xFu << (4 * c);
  const float bias_c = __uint_as_float(exp_c);

  // Start the copies of stage `j` (k = kb + 256 j..+255) into its ring
  // slot; x rows are 16-byte aligned (K is a multiple of 8), and whatever
  // lies past M, N or the split's K range is zeros.  Each thread copies
  // the 16 bytes at column (or k) 4 (tid % 32) of rows tid / 32, + 4, ...
  // of each tile; without kVec the weight and metadata rows go word by
  // word.
  const int cq = 4 * (tid % 32), rq = tid / 32;
  const bool col_ok = cq < valid_n;
  // the thread's first x and packed-row sources; a copy whose source lies
  // past the data reads nothing (src-size 0), so its address is not used
  const float* xsrc = x + static_cast<size_t>(m0 + rq) * K + kb + cq;
  const uint32_t* wsrc =
      qweight + static_cast<size_t>(kb / 8 + rq) * N + n0 + cq;
  auto issue = [&](int j) {
    unsigned char* st = smem + (j % kDecStages) * lay.bytes;
    const int k0 = kb + j * kDecK;
    const int w0 = k0 / 8, g0 = k0 / gs;
    float* xs = reinterpret_cast<float*>(st + lay.x);
#pragma unroll
    for (int r = 0; r < kBM; r += 4) {
#pragma unroll
      for (int u = 0; u < kDecK; u += 128) {
        cp_async16(xs + (r + rq) * kDecXStride + u + cq,
                   xsrc + static_cast<size_t>(r) * K + j * kDecK + u,
                   m0 + r + rq < M && k0 + u + cq < ke);
      }
    }
    uint32_t* ws = reinterpret_cast<uint32_t*>(st + lay.w);
    uint32_t* ss = reinterpret_cast<uint32_t*>(st + lay.s);
    uint32_t* zs = reinterpret_cast<uint32_t*>(st + lay.z);
    const size_t meta0 = static_cast<size_t>(g0) * N + n0;
    if constexpr (kVec) {
#pragma unroll
      for (int r = 0; r < kDecRows; r += 4) {
        cp_async16(ws + (r + rq) * kBlockN + cq,
                   wsrc + static_cast<size_t>(j * kDecRows + r) * N,
                   col_ok && w0 + r + rq < ke / 8);
      }
      for (int r = rq; r < lay.meta_rows; r += 4) {
        const bool valid = col_ok && g0 + r < groups;
        const size_t o = meta0 + static_cast<size_t>(r) * N + cq;
        cp_async16(ss + r * kBlockN + cq, scales + o, valid);
        cp_async16(zs + r * kBlockN + cq, zeros + o, valid);
      }
    } else {
      tc_stage_rows<kThreads>(ws, kBlockN,
                              qweight + static_cast<size_t>(w0) * N + n0, N,
                              kDecRows, ke / 8 - w0, valid_n, false, tid);
      tc_stage_rows<kThreads>(
          ss, kBlockN, reinterpret_cast<const uint32_t*>(scales) + meta0, N,
          lay.meta_rows, groups - g0, valid_n, false, tid);
      tc_stage_rows<kThreads>(
          zs, kBlockN, reinterpret_cast<const uint32_t*>(zeros) + meta0, N,
          lay.meta_rows, groups - g0, valid_n, false, tid);
    }
  };

  float acc[2][2][R4][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < R4; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[u][h][t][i] = 0.f;
      }
    }
  }

  for (int j = 0; j < kDecStages - 1; ++j) {
    if (j < nstages) issue(j);
    asm volatile("cp.async.commit_group;" ::);
  }
  for (int j = 0; j < nstages; ++j) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kDecStages - 2) : "memory");
    __syncthreads();                        // stage j landed; j - 1 done
    if (j + kDecStages - 1 < nstages) issue(j + kDecStages - 1);
    asm volatile("cp.async.commit_group;" ::);

    const int k0 = kb + j * kDecK;
    const unsigned char* st = smem + (j % kDecStages) * lay.bytes;
    // warp wk takes the stage's 64-k chunks wk, wk + 2, ...
#pragma unroll 1
    for (int q = wk; q < kDecK / 64; q += 2) {
      const int kc = k0 + 64 * q;
      if (kc >= ke) break;
      const uint32_t* wrow = reinterpret_cast<const uint32_t*>(st + lay.w) +
                             8 * q * kBlockN + 64 * wn + 4 * g;
      // x of row g % 4 (of each row tile) at the chunk's k = c
      const float* xr = reinterpret_cast<const float*>(st + lay.x) +
                        (g % 4) * kDecXStride + 64 * q + c;
      const bool small = g >= 4;
      const int gst = k0 / gs;                // the stage's first group
      const float* ss =
          reinterpret_cast<const float*>(st + lay.s) + 64 * wn + 4 * g;
      const float* zs =
          reinterpret_cast<const float*>(st + lay.z) + 64 * wn + 4 * g;
      // the groups the chunk's k (up to the split's end) touch
      const int glo = kc / gs, ghi = (min(kc + 64, ke) - 1) / gs;
      float part[2][2][R4][4];
      float zb[2][4];
      if (glo == ghi && kc + 64 <= ke) {      // one group, 8 whole k-steps
        const int r = (glo - gst) * kBlockN;
        load_zero_bias(zs + r, bias_c, zb);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          uint32_t b0[R4], b1[R4];
          load_x(xr, s, small, b0, b1);
          if (s == 0) {
            decode_step<R4, true>(part, wrow, b0, b1, zb, exp_c, mask_c);
          } else {
            decode_step<R4, false>(part, wrow + s * kBlockN, b0, b1, zb,
                                   exp_c, mask_c);
          }
        }
        add_scaled(acc, part, ss + r);
        continue;
      }
      // a group boundary inside the chunk (gs not a multiple of 64: at a
      // k-step's start or, gs being a multiple of 4, between its nibbles
      // 3 and 4), or the split's end: the k-steps in order, the group
      // followed with a running boundary; at a boundary the group's sum
      // is scaled into acc and the next group's starts from zero, a
      // k-step cut in two by it runs as two m16n8k4 halves
      int gg = glo, next = (glo + 1) * gs;
      load_zero_bias(zs + (gg - gst) * kBlockN, bias_c, zb);
      zero_part(part);
#pragma unroll 1
      for (int s = 0; s < 8; ++s) {
        const int ks = kc + 8 * s;
        if (ks >= ke) break;
        uint32_t b0[R4], b1[R4];
        load_x(xr, s, small, b0, b1);
        if (ks == next) {
          add_scaled(acc, part, ss + (gg - gst) * kBlockN);
          ++gg;
          next += gs;
          load_zero_bias(zs + (gg - gst) * kBlockN, bias_c, zb);
          zero_part(part);
        }
        if (ks + 4 == next) {
          decode_half<R4, false>(part, wrow + s * kBlockN, b0, zb, exp_c,
                                 mask_c);
          add_scaled(acc, part, ss + (gg - gst) * kBlockN);
          ++gg;
          next += gs;
          load_zero_bias(zs + (gg - gst) * kBlockN, bias_c, zb);
          zero_part(part);
          decode_half<R4, true>(part, wrow + s * kBlockN, b1, zb, exp_c,
                                mask_c);
        } else {
          decode_step<R4, false>(part, wrow + s * kBlockN, b0, b1, zb,
                                 exp_c, mask_c);
        }
      }
      add_scaled(acc, part, ss + (gg - gst) * kBlockN);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();                          // every warp is off the ring

  // Add the warps' sums in a fixed order.  Lane (g, c) holds, for row
  // tile t, columns 64 wn + 32u + 4g..+3 of rows 4t + 2(c % 2) and + 1:
  // their big parts' sums for c < 2, their small parts' for c >= 2.
  // y = (0 + big of wk 0 + big of wk 1) + small of wk 0 + small of wk 1.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < R4; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (2 * wk + c / 2) * kBM + 4 * t + 2 * (c % 2) + r;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        *reinterpret_cast<float4*>(red + row * kDecRedStride + 64 * wn +
                                   32 * u + 4 * g) =
            make_float4(acc[u][0][t][r], acc[u][0][t][2 + r],
                        acc[u][1][t][r], acc[u][1][t][2 + r]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    if (m0 + m >= M || n0 + col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {           // big parts, then small
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        sum += red[((2 * v + p) * kBM + m) * kDecRedStride + col];
      }
    }
    const size_t out = static_cast<size_t>(m0 + m) * N + n0 + col;
    if (partial == nullptr) {
      y[out] = sum;
    } else {
      partial[blockIdx.z * static_cast<size_t>(M) * N + out] = sum;
    }
  }
  (epilogue(smem), ...);
}

// Allow the float32 decode loop's kernel its dynamic shared memory, on
// first use.
template <int R4, bool kVec, typename... Epilogue>
cudaError_t decode_tc_opt_in(int smem) {
  static int opted_in = 48 * 1024;          // bytes allowed without opt-in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_decode_tc_kernel<R4, kVec, Epilogue...>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  return cudaSuccess;
}

// Whether a call's main loop takes its group size: the float32 decode
// loop takes multiples of 4 of at least kDecMinGroup rows, the other
// loops any.
inline bool takes_group(int m, int gs, bool bf16) {
  return bf16 || tensor_core_path(m, gs, false) ||
         (gs >= kDecMinGroup && gs % 4 == 0);
}

// The K split a shape takes: none on the tensor-core path, else
// choose_split's.
cudaError_t plan_split(int m, int n, int k, int gs, int bk, bool bf16,
                       Split* out) {
  if (tensor_core_path(m, gs, bf16)) {
    out->steps_per_split = k / bk;
    out->splits = 1;
    return cudaSuccess;
  }
  return choose_split(n, k, bk, out);
}

}  // namespace
