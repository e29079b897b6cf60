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
// window, multiplies by the scale after the product, masks with -1e30
// (not -inf), and divides by l with l == 0 replaced by 1.  A row whose
// first visited tile is fully masked gets m = -1e30 and p = 1 on those
// entries, exactly as in the reference; the next tile with a live key
// wipes them with alpha = exp(-1e30 - m) = 0.  Keys past T (a ragged last
// tile) score -inf, so they add exactly 0; the reference refuses ragged
// shapes.
//
// What bounds it: operations.  At the full-width forward (B 1, H 32,
// S = T = 2048, D 128, causal) it does about 34 GFLOP against 64 MB of
// q, k, v and output, far above the card's ridge; at recurrentgemma's
// (B 1, H 10, S = T = 2048, D 256) about 21 GFLOP against 84 MB.
//
// Both products run on the tensor cores with mma.sync m16n8k8 TF32.  The
// float32 policy holds the kernel to 1e-5 of max|ref|, and one TF32
// product (10 mantissa bits) misses that by far, so float32 operands are
// split 3xTF32: a = big + small with big = cvt.rna.tf32(a) and small =
// cvt.rna.tf32(a - big), and each k-step adds small*big, big*small and
// big*big into one float32 accumulator (CUTLASS's OpMultiplyAddFastF32
// order); the dropped small*small term is below 2^-22 of the product.
// bfloat16 and float16 values are exact in TF32, so their small parts are
// zero and those products are skipped: QK^T is one mma per step, P.V two
// (P is float32).  The floor is then 3 x 34 GFLOP at the card's dense
// TF32 rate; mma.sync reaches about 62% of that rate
// (tools/mma_tf32_probe.py), and the split's own arithmetic, done by
// every warp on every K and V element it reads, makes the kernel
// issue-bound (tools/flash_split_cost.py).
//
// Design (FA2-style ownership, cp.async double buffering; no TMA, no
// wgmma):
//  * One block of 8 warps per (b*h, 128-query tile); blocks are issued
//    from the last query tile down, so the longest causal rows start
//    first.  Warp w owns query rows 16w..16w+15 in both products: its
//    scores stay in mma accumulators, and so do its rows' m, l and
//    output accumulator.  Row max reduces over the 4 lanes of a quad with
//    shuffles; each lane keeps a partial l, summed over the quad once at
//    the end.
//  * The Q tile is copied to shared memory once; Q fragments are read
//    from there and split at every k-step (Q in registers as big and
//    small would not fit beside a D-128 accumulator).  K and V tiles of
//    64 keys are double-buffered: cp.async (16-byte, .cg) copies tile
//    t + 1 while tile t computes, one commit group per tile and one block
//    barrier per tile.  Rows past S or T are zero-filled by the copy.
//  * QK^T sums over d in any order, so the k-step pair over columns
//    16kk..16kk+15 gives lane c the 4 consecutive columns 16kk + 4c..+3
//    (k = c, c + 4 take the first two in one step, the last two in the
//    next): Q and K fragments are one 16-byte (8-byte in 16 bits) read a
//    row.
//  * P never leaves registers.  The mma's C fragment holds keys 2c, 2c+1
//    of a row in lane c of a quad, while the A fragment wants keys c and
//    c + 4.  P.V sums over keys in any order too, so its k-step takes
//    k = c as key 2c and k = c + 4 as key 2c + 1: the C registers are the
//    A registers as they stand, and V's B fragment is read from rows 2c
//    and 2c + 1.  No shuffle and no barrier for P.
//  * Row strides keep every warp-wide fragment read on distinct banks:
//    Q and K rows of D + 16 elements (16 mod 32 words in float32 for the
//    16-byte reads, 8 mod 32 in 16 bits for the 8-byte ones), V rows of
//    D + 4 floats or D + 8 16-bit elements (element [2c][g] at 8c + g
//    mod 32 words).  At D 128 float32 that is 210 KB of shared memory:
//    Q 72 KB, two stages of K and V 138 KB, one block an SM.
//  * Head dim 256 has a tiling of its own (``Dims``): at 128 queries and
//    64 keys, float32 would need 402 KB of the block's 227 KB, and a
//    warp's 16 x 256 float32 accumulator alone is 128 registers a lane.
//    A block holds 64 queries and 32-key tiles (still double-buffered:
//    201 KB in float32, 101 KB in 16 bits), and its 8 warps pair up on
//    the 4 groups of 16 query rows: both warps of a pair compute the
//    rows' whole QK^T and online softmax, the same instructions on the
//    same data, so their m, l and P agree bit for bit, and each runs P.V
//    for one half of the output's columns only (64 accumulator registers
//    a lane, as at D 128).  The pair's second QK^T makes the mma count
//    1.5 times the minimum; a pair that split QK^T over d would have to
//    add its partial scores through shared memory every tile.  The D
//    32, 64 and 128 instances are the same code with one warp a row
//    group, unchanged.
//  * A warp skips the math of a key tile above its own diagonal (causal)
//    and masks per element only in tiles that straddle one of its
//    boundaries.
//  * expf, not __expf, and IEEE division, so float32 results stay within
//    1e-5 of the reference.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 8 warps a block at every D
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF

// The tiling of head dim D in type T: D 32, 64 and 128 take 128-query
// blocks (a warp per 16 query rows) and 64-key tiles; D 256 64-query
// blocks, 32-key tiles and two warps per 16 query rows, each owning half
// of the output's columns (see the note above).
template <typename T, int D>
struct Dims {
  static constexpr int kBlockQ = D <= 128 ? 128 : 64;  // query rows a block
  static constexpr int kBlockK = D <= 128 ? 64 : 32;   // keys a tile
  static constexpr int kRowWarps = kBlockQ / 16;  // groups of 16 query rows
  static constexpr int kColSplit = kThreads / 32 / kRowWarps;  // warps each
  static constexpr int kOutCols = D / kColSplit;  // output columns a warp
  static constexpr int kKeyTiles = kBlockK / 8;   // n-tiles of S, P.V steps
  static_assert(kRowWarps * kColSplit * 32 == kThreads, "8 warps");
  // row strides (elements): Q and K are read 4 consecutive columns a lane,
  // V one column a lane from rows 2c and 2c + 1
  static constexpr int kStrideQK = D + 16;
  static constexpr int kStrideV = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kTileK = kBlockK * kStrideQK;
  static constexpr int kStage = kTileK + kBlockK * kStrideV;  // K then V
  static constexpr int kSmemBytes =
      static_cast<int>(sizeof(T)) * (kBlockQ * kStrideQK + 2 * kStage);
};

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

// 4 consecutive elements (16-byte aligned in float32, 8-byte in 16 bits)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const T* h = reinterpret_cast<const T*>(&a);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = to_float(h[e]);
}

template <typename T>
struct Out;
template <>
struct Out<float> {
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct Out<__nv_bfloat16> {
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Out<__half> {
  __device__ static void store2(__half* p, float a, float b) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// a = big + small, each a TF32 value in a 32-bit register.  The mma reads
// only the top 19 bits of a TF32 operand and cvt.rna need not clear the
// other 13, so big's value is its bits with those cleared.  a - big is
// finite whenever a is, and then cvt.rna is exactly an add of half an ulp
// (0x1000) to its bits; a non-finite a keeps big non-finite.
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(a);
  small = __float_as_uint(a - __uint_as_float(big & 0xffffe000u)) + 0x1000u;
}

// A fragment of one operand value: big, and small only where it can be
// nonzero (float32 inputs, or P)
template <bool kSplit>
__device__ __forceinline__ void frag(float a, uint32_t& big,
                                     uint32_t& small) {
  if (kSplit) {
    split(a, big, small);
  } else {
    big = __float_as_uint(a);           // exact in TF32
  }
}

// c += a * b, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows [row0, row0 + kRows) of a (rows, D) matrix into shared memory with
// row stride kStride; rows past `rows` are zero-filled.
template <typename T, int D, int kRows, int kStride>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows, int tid) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kChunks = D / kElems;     // 16-byte copies per row
  static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int j = 0; j < kRows * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * kElems;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * kStride + c,
               valid ? src + static_cast<size_t>(row0 + r) * D + c : src,
               valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int causal, int window, float scale) {
  constexpr bool kSplit = sizeof(T) == 4;
  using Dm = Dims<T, D>;
  constexpr int kBlockQ = Dm::kBlockQ, kBlockK = Dm::kBlockK;
  constexpr int kKeyTiles = Dm::kKeyTiles;
  constexpr int kSQ = Dm::kStrideQK, kSV = Dm::kStrideV;
  constexpr int kSteps = Dm::kOutCols / 8;  // n-tiles of this warp's O
  constexpr int kGroup = kSteps < 8 ? kSteps : 8;  // O n-tiles per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // (kBlockQ, kSQ)
  T* kv = qs + kBlockQ * kSQ;  // 2 stages of K (kBlockK, kSQ) and V
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rw = warp % Dm::kRowWarps;    // this warp's 16 query rows
  const int col0 = (warp / Dm::kRowWarps) * Dm::kOutCols;  // its O columns
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int r0 = q0 + 16 * rw;             // this warp's first query row
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

  load_tile<T, D, kBlockQ, kSQ>(qs, qb, q0, S, tid);
  if (t_begin < t_end) {
    load_tile<T, D, kBlockK, kSQ>(kv, kb, t_begin * kBlockK, Tk, tid);
    load_tile<T, D, kBlockK, kSV>(kv + Dm::kTileK, vb, t_begin * kBlockK,
                                  Tk, tid);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: h = 0 and 1
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  const T* qw = qs + (16 * rw + g) * kSQ + 4 * c;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    const int stage = (t - t_begin) & 1;
    cp_async_wait_all();                  // tile t (and Q) have landed
    __syncthreads();                      // for every thread; tile t-1 done
    if (t + 1 < t_end) {
      T* next = kv + (stage ^ 1) * Dm::kStage;
      load_tile<T, D, kBlockK, kSQ>(next, kb, k0 + kBlockK, Tk, tid);
      load_tile<T, D, kBlockK, kSV>(next + Dm::kTileK, vb, k0 + kBlockK,
                                    Tk, tid);
    }
    cp_async_commit();
    if (causal && k0 > r0 + 15) continue;  // above all of this warp's rows
    const T* ks = kv + stage * Dm::kStage;
    const T* vs = ks + Dm::kTileK;

    // s = Q K^T for the warp's 16 rows and the tile's keys (all D):
    // s[n] holds rows (g, g+8) x keys (8n + 2c, 8n + 2c + 1).  The sum over
    // d runs in any order, so each pair of k-steps over columns 16kk..+15
    // gives lane c the 4 consecutive columns 16kk + 4c..+3 (one vector
    // read of Q and of K): k = c and c + 4 take the first two in the
    // first step and the last two in the second.
    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      float qg[4], qg8[4], kx[kKeyTiles][4];
      load4(qw + 16 * kk, qg);
      load4(qw + 8 * kSQ + 16 * kk, qg8);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        load4(ks + (8 * n + g) * kSQ + 16 * kk + 4 * c, kx[n]);
      }
#pragma unroll
      for (int half = 0; half < 4; half += 2) {
        uint32_t ab[4], as[4] = {0u, 0u, 0u, 0u};
        frag<kSplit>(qg[half], ab[0], as[0]);
        frag<kSplit>(qg8[half], ab[1], as[1]);
        frag<kSplit>(qg[half + 1], ab[2], as[2]);
        frag<kSplit>(qg8[half + 1], ab[3], as[3]);
        uint32_t bb[kKeyTiles][2], bs[kKeyTiles][2];
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) {
          frag<kSplit>(kx[n][half], bb[n][0], bs[n][0]);
          frag<kSplit>(kx[n][half + 1], bb[n][1], bs[n][1]);
        }
        if (kSplit) {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) mma(s[n], as, bb[n]);
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) mma(s[n], ab, bs[n]);
        }
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) mma(s[n], ab, bb[n]);
      }
    }

    // scale, mask, online softmax
    const bool masked = k0 + kBlockK > Tk ||
                        (causal && k0 + kBlockK - 1 > r0) ||
                        (window > 0 && k0 <= r0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float val = s[n][e] * scale;
        if (masked) {
          const int iq = r0 + g + 8 * h;
          const int ik = k0 + 8 * n + 2 * c + (e & 1);
          if (ik >= Tk) {
            val = -INFINITY;
          } else if ((causal && ik > iq) ||
                     (window > 0 && ik <= iq - window)) {
            val = kNegInf;
          }
        }
        s[n][e] = val;
        mx[h] = fmaxf(mx[h], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);
        rs[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V; k-step j takes k = c as key 8j + 2c and k = c + 4 as key
    // 8j + 2c + 1, so P's A fragment is s[j] reordered in registers
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
      const T* vp = vs + (8 * j + 2 * c) * kSV + col0 + g;
#pragma unroll
      for (int n0 = 0; n0 < kSteps; n0 += kGroup) {
        uint32_t bb[kGroup][2], bs[kGroup][2];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          frag<kSplit>(to_float(vp[8 * (n0 + n)]), bb[n][0], bs[n][0]);
          frag<kSplit>(to_float(vp[kSV + 8 * (n0 + n)]), bb[n][1],
                       bs[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) mma(acc[n0 + n], ps, bb[n]);
        if (kSplit) {
#pragma unroll
          for (int n = 0; n < kGroup; ++n) mma(acc[n0 + n], pb, bs[n]);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) mma(acc[n0 + n], pb, bb[n]);
      }
    }
  }
  cp_async_wait_all();                    // nothing left in flight at exit

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int iq = r0 + g + 8 * h;
    if (iq >= S) continue;
    const float div = l[h] == 0.f ? 1.f : l[h];
    T* orow = o + (static_cast<size_t>(bh) * S + iq) * D + col0 + 2 * c;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      Out<T>::store2(orow + 8 * n, acc[n][2 * h] / div,
                     acc[n][2 * h + 1] / div);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, int t, int causal, int window, float scale,
                   cudaStream_t stream) {
  using Dm = Dims<T, D>;
  constexpr int smem = Dm::kSmemBytes;
  if ((s + Dm::kBlockQ - 1) / Dm::kBlockQ > 65535) {
    return cudaErrorInvalidValue;       // the grid's y limit
  }
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(bh, (s + Dm::kBlockQ - 1) / Dm::kBlockQ);
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
    case 256:
      return launch<T, 256>(q, k, v, o, bh, s, t, causal, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_bytes(int d) {
  switch (d) {
    case 32: return Dims<T, 32>::kSmemBytes;
    case 64: return Dims<T, 64>::kSmemBytes;
    case 128: return Dims<T, 128>::kSmemBytes;
    case 256: return Dims<T, 256>::kSmemBytes;
    default: return 0;
  }
}

}  // namespace

// q (B*H, S, D), k and v (B*H, T, D), o (B*H, S, D), all of one type
// (dtype 0: float32, 1: bfloat16, 2: float16), contiguous and 16-byte
// aligned; D is 32, 64, 128 or 256.  causal != 0 masks keys after the query;
// window > 0 masks keys at or before query - window (window <= 0: none).
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bh, int s, int t, int d,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
  if (bh <= 0 || s <= 0 || t <= 0) {
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

// Dynamic shared memory of one block for head dimension d and dtype (as
// above); 0 if either is not supported.
extern "C" int flash_attention_smem_bytes(int d, int dtype) {
  switch (dtype) {
    case 0: return smem_bytes<float>(d);
    case 1: return smem_bytes<__nv_bfloat16>(d);
    case 2: return smem_bytes<__half>(d);
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
