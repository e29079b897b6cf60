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
//    takes for the same M and compute type: a decode loop (float32: the
//    one on the tensor cores; bfloat16: the CUDA-core one) with the split
//    K1 takes for the same (N, K), or, at large M in float32, the large-M
//    tensor-core loop, which takes no split.  Each block writes its float32
//    partial tile as K1's split blocks do, also when K is not split, and
//    the epilogue adds the splits in the order of K1's split-add pass
//    (0.f + split 0 + split 1 + ...), then rounds to the compute type.  So
//    every y value is K1's, bit for bit.
//  * The epilogue does the quantizer's operations one at a time, each
//    rounded: __fdiv_rn for every division (never a reciprocal), rintf
//    (round half to even), __fadd_rn for v / s + z, __float2half_rn for
//    the float16 scales and zeros.  It is built without --use_fast_math.
//
// What bounds it: the packed weight and metadata bytes the GEMM reads, as
// for K1 (7.6 MB at the tp=2 down projection, K 4864, N 2560: 0.0023 ms
// at 3.35 TB/s).  At decode M the decode loops run into their
// instruction streams first (K1's note).  The epilogue adds one read of
// the splits' partial tiles from L2 (640 KB at M 4) and M * n_pad bytes
// of int8 payload (half that for int4), but mostly latency: the quantize
// of a unit starts when the last of its blocks is in.
//
// Design: one launch a call.  The epilogue runs in the tail of the GEMM's
// own blocks, through the main loops' epilogue hook, and the last block
// of each unit to arrive does the quantize (the threadfence-reduction
// idiom; no block waits on another, so nothing assumes which blocks are
// resident):
//  * Epilogue units.  A unit is the shortest run of consecutive 128-column
//    GEMM tiles that ends on a quant-block boundary (and, for int4, on a
//    packed-word boundary, which every tile end is): lcm(128, bs) / 128
//    tiles.  The last unit takes the remaining tiles and extends to n_pad,
//    over padded columns that no GEMM block computes.  At the tp=2 rank
//    shape (int8 blocks of 128, int4 of 32) a unit is one tile; blocks of
//    10, 12, 48 or 86 columns give units of several tiles, or the whole
//    row.
//  * Each block writes its partial tile; after __syncthreads() one thread
//    runs __threadfence() and adds 1 to the counter of its (row tile,
//    unit) with atomicAdd.  The block that brings the count to the unit's
//    tiles x splits is the last: that thread resets the counter, fences
//    again and tells the block through shared memory and __syncthreads().
//  * The last block reads the unit's partials with __ldcg (L2, never a
//    stale L1 line of another SM's writes), 16 splits in flight a thread
//    (or, with fewer splits, as in the tensor-core loop's one, 8 float4
//    of each split), and holds y for one 128-column chunk of all its rows
//    in shared memory where the GEMM's shared memory holds them, else of
//    as many as it holds, at least 16, at a time.  It reduces each (row,
//    quant block) over its chunks (max and min are exact in any order; a
//    warp per block where the warps cover them all, else 8 lanes), keeps
//    the float32 scale and zero in shared memory (the payload divides by
//    them, not by their float16 copies), writes the float16 scales (and
//    zeros), then the payload: from the chunk still in shared memory when
//    the unit is one chunk, else from a second read of the partials.
//    Invariant: every quant block and every int4 word is written by
//    exactly one block, the last of its unit, and only after every split
//    of every tile it covers has landed.  A word may hold values of two
//    quant blocks (bs need not be a multiple of 8): each value uses its
//    own block's scale and zero.
//  * The bfloat16 decode loop's registers: K3's instantiations are cut
//    for 4 blocks per SM (128 registers a thread;
//    WireEpilogue::kMinBlocks, which the header's hook reads), not K1's 6
//    (80): at 80 the epilogue's loads spill.  The rank shape's 320 blocks
//    still fit one wave on 132 SMs.  The float32 decode loop keeps its
//    own bounds (K1's: 4 blocks at 4 rows, 3 at 8).
//  * Counters: one int32 per (row tile, unit), in a zeroed buffer that the
//    wrapper keeps per device and stream, not in the per-call scratch.
//    The last block resets its counter to 0, so the buffer is zero again
//    after every call and no call needs a memset; calls on one stream are
//    serialized, so one buffer serves them all (and a captured graph of
//    the call needs no extra node).  After a failed launch the wrapper
//    zeroes the buffer.
//  * The wrapper takes bs and n_pad from comm/wire.wire_params, so neither
//    a quant block nor a word straddles a rank's chunk.
//
// Forms not taken (tools/k3_time.py at the rank shape, float32 unless
// named, int8 then int4 wires, one H100 80GB HBM3 at 700 W, in turns with
// this form; PERF.md).  At M 4: the earlier three launches (the GEMM, a
// scales kernel, a payload kernel, each adding the splits again),
// 0.0224-0.0229 and 0.0252-0.0257 ms; this form at K1's register cap, 8
// loads in flight, 0.0185-0.0188 and 0.0198-0.0200 ms; the splits staged
// into shared memory by cp.async instead of registers, 0.0213-0.0216 and
// 0.0196 ms; this form 0.0149-0.0154 and 0.0157-0.0158 ms.  At M 64 (the
// 16-row blocks): those blocks at K1's 80 registers 0.1638-0.1641 and
// 0.1627-0.1630 ms (bfloat16 0.1322-0.1327), where this form takes about
// 0.085 (its 128 registers also spare the 16-row main loop K1's spills).
// At M 259 (the tensor-core loop): the quantize in slabs of 16 rows with
// one load in flight, 0.5219 and 0.5069-0.5070 ms, where this form's
// slab of all rows takes about 0.497 (the three launches: 0.4961-0.4970
// and 0.5008-0.5010).  The two-launch form (the GEMM, then one epilogue
// kernel) was not timed: one launch is faster than three.
#include <cuda_fp16.h>
#include <float.h>

#include "dequant_matmul_ordered.cuh"

namespace {

static_assert(kBlockN == kTcBN, "both main loops tile N in 128 columns");

// The fewest rows of y the last block holds in shared memory at a time
// (all of a block's rows where its GEMM's shared memory holds them).
constexpr int kSlabRows = 16;
// Splits whose partial values a thread loads at once.
constexpr int kLoadsInFlight = 16;
// float4 items of y a thread loads at once where there are fewer splits.
constexpr int kItemsInFlight = 8;

struct WireShape {
  int m, n, k, gs, bk, n_pad, bs, bits;
};

__host__ __device__ inline int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The epilogue units of one row tile: GEMM tiles per unit, units, and the
// most quant blocks a unit holds.
struct Units {
  int tiles, count, max_blocks;
};

__host__ __device__ inline Units units_of(int n, int n_pad, int bs) {
  Units u;
  u.tiles = bs / gcd_int(bs, kBlockN);
  const int tiles_n = (n + kBlockN - 1) / kBlockN;
  u.count = (tiles_n + u.tiles - 1) / u.tiles;
  const int last = (n_pad - (u.count - 1) * u.tiles * kBlockN) / bs;
  const int full = u.tiles * kBlockN / bs;
  u.max_blocks = u.count > 1 && full > last ? full : last;
  return u;
}

// Bytes of the quantize's shared memory per row of y held (y for 128
// columns, then the running max and min, later the scale and zero, of
// each of the row's quant blocks), and the rows held at a time: all BM
// rows where the GEMM's shared memory (free once the tile is written)
// holds them, else as many as it holds, at least kSlabRows.
__host__ __device__ inline int slab_row_bytes(const Units& u) {
  return (kBlockN + 2 * u.max_blocks) * 4;
}

inline int slab_rows(int bm, int gemm_smem, const Units& u) {
  int rows = (gemm_smem - 16) / slab_row_bytes(u);
  rows = rows < kSlabRows ? kSlabRows : rows;
  return rows < bm ? rows : bm;
}

// The wire quantize, run through the main loops' epilogue hook by every
// thread (NT of them) of a block of BM rows.
template <typename T, int BITS, int NT, int BM>
struct WireEpilogue {
  static constexpr int kWarpsPer = NT / 32;
  // The bfloat16 decode loop's blocks per SM: 4 (128 registers a thread)
  // where K1 takes 6 (80), so that kLoadsInFlight float4 loads stay in
  // registers.  The float32 loops keep their own bounds.
  static constexpr int kMinBlocks = 4;

  const float* partial;   // splits x M x N, split z at partial + z * M * N
  void* payload;          // (M, n_pad) int8, or (M, n_pad / 8) words
  __half* wscales;        // (M, n_pad / bs)
  __half* wzeros;         // (M, n_pad / bs), int4 only
  int* counters;          // per (row tile, unit); 0 between calls
  int m, n, n_pad, bs;
  Units units;
  int slab;               // rows of y held in shared memory at a time

  // Shared memory of the quantize: y for slab x 128 columns, then the
  // running max and min (later the scale and zero) of each (row, block),
  // then the last-block flag.
  __device__ void operator()(unsigned char* smem) const {
    const int splits = static_cast<int>(gridDim.z);
    int& last = *reinterpret_cast<int*>(smem + slab * slab_row_bytes(units));
    const int unit = static_cast<int>(blockIdx.x) / units.tiles;
    const int tiles_n = (n + kBlockN - 1) / kBlockN;
    const int t0 = unit * units.tiles;
    const int t1 = min(t0 + units.tiles, tiles_n);
    __syncthreads();                        // the block's tile is written
    if (threadIdx.x == 0) {
      int* counter = counters + blockIdx.y * units.count + unit;
      __threadfence();                      // ... and visible on the card
      last = atomicAdd(counter, 1) + 1 == (t1 - t0) * splits;
      if (last) {                           // the whole unit is in
        *counter = 0;
        __threadfence();
      }
    }
    __syncthreads();
    if (!last) return;
    const int c0 = t0 * kBlockN;
    const int c1 = unit == units.count - 1 ? n_pad : t1 * kBlockN;
    const int m0 = static_cast<int>(blockIdx.y) * BM;
    const int m1 = min(m0 + BM, m);
    for (int r0 = m0; r0 < m1; r0 += slab) {
      quantize_rows(smem, r0, min(slab, m1 - r0), c0, c1);
    }
  }

  // y[r0 + r, cs + j] for r < rows, j < ce - cs into ys[r * 128 + j]:
  // the splits added in K1's order, rounded to the compute type; 0 past N.
  // The partials are read with __ldcg (L2, never a stale L1 line: other
  // SMs wrote them), kLoadsInFlight splits of a float4 at a time, or,
  // with fewer splits (the tensor-core loop has one), each split of
  // kItemsInFlight float4 at a time.  Ends with __syncthreads().
  __device__ void stage(float* ys, int r0, int rows, int cs, int ce) const {
    const int splits = static_cast<int>(gridDim.z);
    const size_t mn = static_cast<size_t>(m) * n;
    const int tid = threadIdx.x;
    if (n % 4 != 0) {                       // rows not 16-byte aligned
      for (int i = tid; i < rows * kBlockN; i += NT) {
        const int r = i / kBlockN, j = i % kBlockN;
        if (j >= ce - cs) continue;
        float v = 0.f;
        if (cs + j < n) {
          const float* p = partial + static_cast<size_t>(r0 + r) * n + cs + j;
          int s = 0;
          for (; s + kLoadsInFlight <= splits; s += kLoadsInFlight) {
            float a[kLoadsInFlight];
#pragma unroll
            for (int u = 0; u < kLoadsInFlight; ++u) {
              a[u] = __ldcg(p + (s + u) * mn);
            }
#pragma unroll
            for (int u = 0; u < kLoadsInFlight; ++u) v += a[u];
          }
          for (; s < splits; ++s) v += __ldcg(p + s * mn);
          v = Num<T>::round(v);
        }
        ys[i] = v;
      }
      __syncthreads();
      return;
    }
    const int items = rows * (kBlockN / 4);
    const size_t step = mn / 4;
    if (splits < kLoadsInFlight) {
      for (int i0 = tid; i0 < items; i0 += NT * kItemsInFlight) {
        float4 v[kItemsInFlight];
        const float4* p[kItemsInFlight];    // null: nothing to read
#pragma unroll
        for (int b = 0; b < kItemsInFlight; ++b) {
          const int i = i0 + b * NT;
          const int r = i / (kBlockN / 4), j = (i % (kBlockN / 4)) * 4;
          v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
          p[b] = i < items && j < ce - cs && cs + j < n
                     ? reinterpret_cast<const float4*>(
                           partial + static_cast<size_t>(r0 + r) * n + cs + j)
                     : nullptr;
        }
        for (int s = 0; s < splits; ++s) {
          float4 a[kItemsInFlight];
#pragma unroll
          for (int b = 0; b < kItemsInFlight; ++b) {
            a[b] = p[b] != nullptr ? __ldcg(p[b] + s * step)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int b = 0; b < kItemsInFlight; ++b) {
            v[b].x += a[b].x;
            v[b].y += a[b].y;
            v[b].z += a[b].z;
            v[b].w += a[b].w;
          }
        }
#pragma unroll
        for (int b = 0; b < kItemsInFlight; ++b) {
          const int i = i0 + b * NT;
          const int r = i / (kBlockN / 4), j = (i % (kBlockN / 4)) * 4;
          if (i >= items || j >= ce - cs) continue;
          *reinterpret_cast<float4*>(ys + r * kBlockN + j) =
              p[b] == nullptr
                  ? make_float4(0.f, 0.f, 0.f, 0.f)
                  : make_float4(Num<T>::round(v[b].x), Num<T>::round(v[b].y),
                                Num<T>::round(v[b].z), Num<T>::round(v[b].w));
        }
      }
      __syncthreads();
      return;
    }
    for (int i = tid; i < items; i += NT) {
      const int r = i / (kBlockN / 4), j = (i % (kBlockN / 4)) * 4;
      if (j >= ce - cs) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cs + j < n) {
        const float4* p = reinterpret_cast<const float4*>(
            partial + static_cast<size_t>(r0 + r) * n + cs + j);
        int s = 0;
        for (; s + kLoadsInFlight <= splits; s += kLoadsInFlight) {
          float4 a[kLoadsInFlight];
#pragma unroll
          for (int u = 0; u < kLoadsInFlight; ++u) {
            a[u] = __ldcg(p + (s + u) * step);
          }
#pragma unroll
          for (int u = 0; u < kLoadsInFlight; ++u) {
            v.x += a[u].x;
            v.y += a[u].y;
            v.z += a[u].z;
            v.w += a[u].w;
          }
        }
        for (; s < splits; ++s) {
          const float4 a = __ldcg(p + s * step);
          v.x += a.x;
          v.y += a.y;
          v.z += a.z;
          v.w += a.w;
        }
        v = make_float4(Num<T>::round(v.x), Num<T>::round(v.y),
                        Num<T>::round(v.z), Num<T>::round(v.w));
      }
      *reinterpret_cast<float4*>(ys + r * kBlockN + j) = v;
    }
    __syncthreads();
  }

  // Rows r0..r0 + rows - 1 of the unit's columns [c0, c1).
  __device__ void quantize_rows(unsigned char* smem, int r0, int rows,
                                int c0, int c1) const {
    float* ys = reinterpret_cast<float*>(smem);
    const int b0 = c0 / bs, nb = (c1 - c0) / bs;
    float* hi = ys + slab * kBlockN;        // max|v| (int8) or max v
    float* lo = hi + slab * units.max_blocks;  // min v (int4)
    const int chunks = (c1 - c0 + kBlockN - 1) / kBlockN;
    const int tid = threadIdx.x;
    for (int i = tid; i < rows * nb; i += NT) {
      hi[i] = 0.f;                          // the reductions include 0
      lo[i] = 0.f;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const int cs = c0 + ch * kBlockN, ce = min(cs + kBlockN, c1);
      stage(ys, r0, rows, cs, ce);
      // a warp per (row, quant block) of the chunk when the warps cover
      // them all, else 8 lanes: each lane takes every lanes-th column,
      // then the group's lanes combine
      const int bf = cs / bs, nbc = (ce - 1) / bs - bf + 1;
      const int items = rows * nbc;
      const int lanes = items <= kWarpsPer ? 32 : 8;
      const int group = tid / lanes, sub = tid % lanes;
      for (int first = 0; first < items; first += NT / lanes) {
        const int item = first + group;     // the whole warp shuffles
        const bool have = item < items;
        float h = 0.f, l = 0.f;
        const int r = have ? item / nbc : 0, b = bf + (have ? item % nbc : 0);
        if (have) {
          const int lo_c = max(cs, b * bs), hi_c = min(ce, (b + 1) * bs);
          for (int c = lo_c + sub; c < hi_c; c += lanes) {
            const float v = ys[r * kBlockN + c - cs];
            if (BITS == 8) {
              h = fmaxf(h, fabsf(v));
            } else {
              h = fmaxf(h, v);
              l = fminf(l, v);
            }
          }
        }
        for (int off = lanes / 2; off > 0; off >>= 1) {
          h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
          if (BITS == 4) l = fminf(l, __shfl_xor_sync(0xffffffffu, l, off));
        }
        if (have && sub == 0) {
          float* hp = hi + r * nb + b - b0;
          *hp = fmaxf(*hp, h);
          if (BITS == 4) lo[r * nb + b - b0] = fminf(lo[r * nb + b - b0], l);
        }
      }
      __syncthreads();                      // before ys is staged again
    }
    // the scales (and zeros): float16 to the wire, float32 kept in hi, lo
    const int nbr = n_pad / bs;             // quant blocks per row
    for (int i = tid; i < rows * nb; i += NT) {
      const size_t out = static_cast<size_t>(r0 + i / nb) * nbr + b0 + i % nb;
      float s, z = 0.f;
      if (BITS == 8) {
        s = fmaxf(__fdiv_rn(hi[i], 127.f), FLT_MIN);
      } else {
        s = __fdiv_rn(__fsub_rn(hi[i], lo[i]), 15.f);
        if (s <= 0.f) s = 1.f;
        z = fminf(fmaxf(rintf(__fdiv_rn(-lo[i], s)), 0.f), 15.f);
        wzeros[out] = __float2half_rn(z);
      }
      wscales[out] = __float2half_rn(s);
      hi[i] = s;
      lo[i] = z;
    }
    __syncthreads();
    for (int ch = 0; ch < chunks; ++ch) {
      const int cs = c0 + ch * kBlockN, ce = min(cs + kBlockN, c1);
      if (chunks > 1) {                     // one chunk is still staged
        stage(ys, r0, rows, cs, ce);
      }
      if (BITS == 8) {
        int8_t* out = static_cast<int8_t*>(payload);
        for (int i = tid; i < rows * kBlockN; i += NT) {
          const int r = i / kBlockN, j = i % kBlockN;
          if (j >= ce - cs) continue;
          const float q = rintf(__fdiv_rn(ys[i], hi[r * nb + (cs + j) / bs
                                                     - b0]));
          out[static_cast<size_t>(r0 + r) * n_pad + cs + j] =
              static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
        }
      } else {                              // cs and ce are whole words
        uint32_t* out = static_cast<uint32_t*>(payload);
        const int words = (ce - cs) / 8;
        for (int i = tid; i < rows * words; i += NT) {
          const int r = i / words, w = i % words;
          uint32_t word = 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = cs + 8 * w + j;
            const int sz = r * nb + col / bs - b0;
            const float q = rintf(__fadd_rn(
                __fdiv_rn(ys[r * kBlockN + 8 * w + j], hi[sz]), lo[sz]));
            word |= static_cast<uint32_t>(fminf(fmaxf(q, 0.f), 15.f))
                    << (4 * j);
          }
          out[static_cast<size_t>(r0 + r) * (n_pad / 8) + cs / 8 + w] = word;
        }
      }
      __syncthreads();                      // before ys, hi, lo are reused
    }
  }
};

bool valid_wire(const WireShape& w) {
  return valid_shape(w.m, w.n, w.k, w.gs, w.bk) && w.n_pad >= w.n &&
         w.bs > 0 && w.n_pad % w.bs == 0 &&
         (w.bits == 8 || (w.bits == 4 && w.n_pad % 8 == 0));
}

// How a call runs: the main loop (and its rows per block), the K split,
// the units, the counters and the dynamic shared memory of its launch.
struct Plan {
  bool tc;                                  // the large-M tensor-core loop
  int bm, mt;                               // rows per block; m16 tiles
                                            // (tc) or row tiles of 4
                                            // (the float32 decode loop)
  Split split;
  Units units;
  int slab;                                 // rows the quantize holds
  long long counters;
  int smem;
};

cudaError_t make_plan(const WireShape& w, bool bf16, Plan* p) {
  cudaError_t err = plan_split(w.m, w.n, w.k, w.gs, w.bk, bf16, &p->split);
  if (err != cudaSuccess) return err;
  p->units = units_of(w.n, w.n_pad, w.bs);
  p->tc = tensor_core_path(w.m, w.gs, bf16);
  int gemm;                                 // the GEMM's shared memory
  if (p->tc) {
    int sms = 0;
    err = device_sm_count(&sms);
    if (err != cudaSuccess) return err;
    p->mt = tc_mtiles(w.m, w.n, sms);
    p->bm = kTcWarpsM * 16 * p->mt;
    gemm = tc_smem_bytes(w.gs, p->bm);
  } else if (!bf16) {
    p->mt = dec_tiles(w.m);
    p->bm = 4 * p->mt;
    gemm = dec_smem_bytes(w.gs, p->mt);
  } else {
    p->mt = 0;
    p->bm = block_m(w.m);
    gemm = p->bm == 4 ? smem_bytes<__nv_bfloat16, 4>(w.bk, w.gs)
                      : smem_bytes<__nv_bfloat16, 16>(w.bk, w.gs);
  }
  p->slab = slab_rows(p->bm, gemm, p->units);
  const int epi = p->slab * slab_row_bytes(p->units) + 16;  // + the flag
  p->smem = gemm > epi ? gemm : epi;
  p->counters = static_cast<long long>((w.m + p->bm - 1) / p->bm) *
                p->units.count;
  return cudaSuccess;
}

struct WireOut {
  void* payload;
  void* wscales;
  void* wzeros;
  float* partial;
  int* counters;
};

template <typename Epi>
Epi make_epilogue(const WireOut& o, const WireShape& w, const Plan& p) {
  return Epi{o.partial, o.payload, static_cast<__half*>(o.wscales),
             static_cast<__half*>(o.wzeros), o.counters, w.m, w.n, w.n_pad,
             w.bs, p.units, p.slab};
}

// The bfloat16 decode loop with the wire epilogue: one launch.
template <typename T, int BM, int BITS>
cudaError_t launch_decode(const void* x, const void* qweight,
                          const void* scales, const void* zeros,
                          const WireOut& o, const WireShape& w,
                          const Plan& p, cudaStream_t stream) {
  using Epi = WireEpilogue<T, BITS, kThreads, BM>;
  static int opted_in = 48 * 1024;          // bytes allowed without opt-in
  if (p.smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_ordered_kernel<T, BM, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    opted_in = p.smem;
  }
  const dim3 grid((w.n + kBlockN - 1) / kBlockN, (w.m + BM - 1) / BM,
                  p.split.splits);
  dequant_matmul_ordered_kernel<T, BM, Epi><<<grid, kThreads, p.smem,
                                              stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      nullptr, o.partial, w.m, w.n, w.k, w.gs, w.bk,
      p.split.steps_per_split, make_epilogue<Epi>(o, w, p));
  return cudaGetLastError();
}

// The float32 decode loop with the wire epilogue: one launch.
template <int R4, bool kVec, int BITS>
cudaError_t launch_decode_tc_wire(const void* x, const void* qweight,
                                  const void* scales, const void* zeros,
                                  const WireOut& o, const WireShape& w,
                                  const Plan& p, cudaStream_t stream) {
  using Epi = WireEpilogue<float, BITS, kThreads, 4 * R4>;
  const cudaError_t err = decode_tc_opt_in<R4, kVec, Epi>(p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w.n + kBlockN - 1) / kBlockN, (w.m + p.bm - 1) / p.bm,
                  p.split.splits);
  dequant_matmul_decode_tc_kernel<R4, kVec, Epi><<<grid, kThreads, p.smem,
                                                   stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      nullptr, o.partial, w.m, w.n, w.k, w.gs, w.bk,
      p.split.steps_per_split, make_epilogue<Epi>(o, w, p));
  return cudaGetLastError();
}

// The tensor-core loop (float32, no K split) with the wire epilogue: one
// launch; its one partial tile is y itself.
template <int MT, int BITS>
cudaError_t launch_tc_wire(const void* x, const void* qweight,
                           const void* scales, const void* zeros,
                           const WireOut& o, const WireShape& w,
                           const Plan& p, cudaStream_t stream) {
  constexpr int kBM = kTcWarpsM * 16 * MT;
  using Epi = WireEpilogue<float, BITS, kTcThreads, kBM>;
  static int opted_in = 48 * 1024;
  if (p.smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_tc_kernel<MT, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    opted_in = p.smem;
  }
  const dim3 grid((w.n + kTcBN - 1) / kTcBN, (w.m + kBM - 1) / kBM);
  dequant_matmul_tc_kernel<MT, Epi><<<grid, kTcThreads, p.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      o.partial, w.m, w.n, w.k, w.gs, make_epilogue<Epi>(o, w, p));
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const void* x, const void* qweight,
                        const void* scales, const void* zeros,
                        const WireOut& o, const WireShape& w, const Plan& p,
                        bool bf16, cudaStream_t s) {
  if (p.tc) {
    return p.mt == 5
               ? launch_tc_wire<5, BITS>(x, qweight, scales, zeros, o, w, p, s)
               : launch_tc_wire<4, BITS>(x, qweight, scales, zeros, o, w, p,
                                         s);
  }
  if (!bf16) {
    const bool vec = w.n % 4 == 0;
    if (p.mt == 1) {
      return vec ? launch_decode_tc_wire<1, true, BITS>(x, qweight, scales,
                                                        zeros, o, w, p, s)
                 : launch_decode_tc_wire<1, false, BITS>(x, qweight, scales,
                                                         zeros, o, w, p, s);
    }
    return vec ? launch_decode_tc_wire<2, true, BITS>(x, qweight, scales,
                                                      zeros, o, w, p, s)
               : launch_decode_tc_wire<2, false, BITS>(x, qweight, scales,
                                                       zeros, o, w, p, s);
  }
  return p.bm == 4 ? launch_decode<__nv_bfloat16, 4, BITS>(
                         x, qweight, scales, zeros, o, w, p, s)
                   : launch_decode<__nv_bfloat16, 16, BITS>(
                         x, qweight, scales, zeros, o, w, p, s);
}

// The plan of a call from the C arguments, or an error.
cudaError_t plan_of(int m, int n, int k, int group_size, int block_k,
                    int n_pad, int wire_block, int bits, int bf16,
                    WireShape* w, Plan* p) {
  *w = WireShape{m, n, k, group_size, block_k, n_pad, wire_block, bits};
  if (!valid_wire(*w) || !takes_group(m, group_size, bf16 != 0)) {
    return cudaErrorInvalidValue;
  }
  return make_plan(*w, bf16 != 0, p);
}

}  // namespace

// What a call of this shape and compute type (bf16 != 0: bfloat16) needs
// on the current device: sizes[0] floats of scratch (the splits' partial
// tiles), sizes[1] int32 counters (one per row tile and epilogue unit; 0
// before the call and 0 again after it) and sizes[2] bytes of dynamic
// shared memory a block.  Returns the CUDA error code (0 on success).
extern "C" int dequant_matmul_wire_sizes(int m, int n, int k, int group_size,
                                         int block_k, int n_pad,
                                         int wire_block, int bits, int bf16,
                                         long long* sizes) {
  WireShape w;
  Plan p;
  const cudaError_t err = plan_of(m, n, k, group_size, block_k, n_pad,
                                  wire_block, bits, bf16, &w, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  sizes[0] = static_cast<long long>(p.split.splits) * m * n;
  sizes[1] = p.counters;
  sizes[2] = p.smem;
  return 0;
}

// x (M, K) in the compute type (bf16 != 0: bfloat16, else float32),
// qweight (K/8, N) 32-bit words, scales and zeros (K/gs, N) float32 with
// integer zero-points; payload (M, n_pad) int8 (bits 8) or (M, n_pad/8)
// 32-bit words (bits 4), wire scales and zeros (M, n_pad/wire_block)
// float16 (zeros only for bits 4); all contiguous, 16-byte aligned where
// K1 needs it.  `scratch` holds `scratch_floats` floats and `counters`
// `counters_given` int32 counters, at least what dequant_matmul_wire_sizes
// asks for; the counters are all 0 (and 0 again when the call has run).
// Launches one kernel on `stream` and returns the CUDA error code (0 on
// success).
extern "C" int dequant_matmul_wire_ordered(
    const void* x, const void* qweight, const void* scales,
    const void* zeros, void* payload, void* wscales, void* wzeros,
    void* scratch, long long scratch_floats_given, void* counters,
    long long counters_given, int m, int n, int k, int group_size,
    int block_k, int n_pad, int wire_block, int bits, int bf16,
    void* stream) {
  WireShape w;
  Plan p;
  const cudaError_t err = plan_of(m, n, k, group_size, block_k, n_pad,
                                  wire_block, bits, bf16, &w, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((bits == 4 && wzeros == nullptr) || scratch == nullptr ||
      scratch_floats_given <
          static_cast<long long>(p.split.splits) * m * n ||
      counters == nullptr || counters_given < p.counters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WireOut o{payload, wscales, wzeros, static_cast<float*>(scratch),
                  static_cast<int*>(counters)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bits == 8 ? launch_bits<8>(x, qweight, scales, zeros, o, w, p,
                                 bf16 != 0, s)
                : launch_bits<4>(x, qweight, scales, zeros, o, w, p,
                                 bf16 != 0, s));
}

extern "C" const char* dequant_matmul_wire_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
