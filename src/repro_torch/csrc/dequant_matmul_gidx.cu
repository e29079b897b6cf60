// g_idx int4 dequant-GEMM for Hopper (sm_90a): the naive act-order layout.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_matmul.py::dequant_matmul_gidx
//   (body _dequant_matmul_gidx_kernel, which keeps the whole (G, bn)
//   metadata tile resident and gathers it per row by g_idx)
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
// What bounds it: in decode M is 1..32, so its floor is the bytes it must
// read: the packed weight (K/2 x N bytes), the metadata table once
// (G x N x 8 bytes per launch: 1.56 MB for the qwen3-4b up/gate
// projection, 2.62 MB for down), g_idx, x and y; 43.9 MB for one layer's
// three launches at M = 4, 0.0131 ms at 3.35 TB/s.  On top of the ordered
// kernel's work each nibble costs its own lookup of a scale and a zero in
// shared memory, and under the float32 policy each element M CUDA-core
// FMAs beside its unpack and dequantize.  What the kernel runs into is
// that instruction stream's latency: a slot's rows are a chain of
// dependent shared-memory reads (g_idx, then the table), so the time
// follows the rows each warp owns and the warps an SM holds (on an H100,
// reading the table once per packed row instead of once per nibble saves
// only 5-7%, tools/k4_forms.py).
//
// Design (the K split inside the block):
//  * One thread block per (BM rows x BN columns) output tile owns all of
//    K: one launch, no partial tiles in device memory, no second pass.
//    It stages its columns of the whole scale and 2^23 + zero table in
//    shared memory once, so a launch reads the table from device memory
//    once per column tile: G x N x 8 bytes.
//  * The packed rows are dealt to kSlots = 64 row slots: slot s owns rows
//    r = s (mod 64).  A slot is BN / 4 lanes, each owning 4 adjacent
//    columns (one 16-byte quad of packed words); all slots share the one
//    table.  A block is 64 x BN / 4 threads: 16 warps at BN = 32, 8 at 16.
//  * Weight rows, x and g_idx stream through a 3-stage cp.async ring
//    (kSlots x R packed rows a stage, R = 2 for BM = 4).  The table is
//    copied by cp.async in the same prologue, ahead of the first stage;
//    the block waits for it only before its first dequantize.
//  * BN is 32, or 16 where two 16-column blocks fit on an SM and leave its
//    busiest SM fewer columns (pick_block_n): 608 blocks of 16 columns for
//    the up/gate projection (N 9728), 80 of 32 for down (N 2560).
//  * Sum order: each slot sums its rows in increasing k with fmaf; the 64
//    slot sums are then added in shared memory in a fixed order, 8 groups
//    of 8 consecutive slots, each group in slot order, then the 8 group
//    sums in order.  That order depends on K and the constants kSlots and
//    kGroupSlots only, never on M, BM, BN or the card, so a row's result
//    does not depend on the batch it runs in or the tile width picked.
//  * A nibble q becomes the float 2^23 + q by OR-ing it into the mantissa
//    of 2^23; subtracting 2^23 + z (exact for the integer zero-points
//    0..15 that the quantizer writes) gives q - z exactly, so w is
//    bit-equal to the reference's (q - z) * s.
//  * The gather has no bank conflicts: at BN = 32 the 8 lanes of a quarter
//    warp read one 128-byte half row; at BN = 16 a quarter warp holds two
//    slots reading two random groups, so the table is kept in two copies
//    whose scales and zeros sit in opposite halves of a 128-byte block
//    (Table).  With one copy the 2-way conflicts cost 20-22% at BN = 16
//    on an H100.
//
// The form not taken: a thread-block cluster of C = 1, 2 or 4 blocks on
// one 32-column tile, each with 64 / C of the slots, sharing the table
// through distributed shared memory and adding the slots' sums in the same
// order.  Timed beside this form's first version (one table copy) on an
// H100 80GB HBM3 at 700 W, M = 4, float32: up/gate 0.0323 ms at C = 2
// (0.0267 at C = 1, 0.0316 at C = 4) against 0.0238, down 0.0278 at C = 4
// against 0.0330 at 16 columns (0.0260-0.0262 at 32 columns in the calls
// around it).  Its blocks spread a tile over more SMs, but each SM then
// holds fewer warps of it, and the cluster's barriers and remote table
// reads come on top.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;           // output columns per lane
constexpr int kSlots = 64;         // row slots: slot s sums rows r = s mod 64
constexpr int kGroupSlots = 8;     // slots per group of the fixed-order sum
constexpr int kStages = 3;         // cp.async ring depth
// Threads an SM is meant to hold: the register budget (128 a thread)
constexpr int kThreadsPerSM = 512;
constexpr uint32_t kMagicBits = 0x4B000000u;  // 2^23 as float bits
constexpr float kMagic = 8388608.f;           // 2^23

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  __device__ static float to_float(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// Rows of x per block: 4 for decode batches, else 16.
inline int block_m(int m) { return m <= 4 ? 4 : 16; }

// Where the scales and the 2^23 + zeros of group g lie in shared memory
// for BN (16 or 32) columns: at byte g * kRow of the table.  At BN = 32 a
// group's row is 256 bytes, scales then zeros, and the 8 lanes of a
// quarter warp (one 128-byte read phase of 16-byte reads) are one slot
// reading one half row.  At BN = 16 a quarter warp is two slots reading
// two random groups, so each group is held in two 128-byte copies with
// scales and zeros in opposite halves: slot parity j reads copy j, at
// s(j) and z(j), and the two slots of a phase read disjoint banks.
template <int BN>
struct Table {
  static_assert(BN == 16 || BN == 32, "16- or 32-column tiles");
  static constexpr int kCopies = 32 / BN;
  static constexpr int kBlock = BN == 32 ? 256 : 128;   // bytes a copy
  static constexpr int kRow = kCopies * kBlock;           // bytes a group
  __host__ __device__ static constexpr int s(int j) { return 64 * j; }
  __host__ __device__ static constexpr int z(int j) {
    return BN == 32 ? 128 : 64 * (1 - j);
  }
};

// Threads, stage layout (byte offsets) and shared memory of one block.
template <typename T, int BM, int BN>
struct Layout {
  static constexpr int kLanes = BN / kCols;            // lanes per packed row
  static constexpr int kThreads = kSlots * kLanes;
  static constexpr int kRows = kSlots * (BM <= 4 ? 2 : 1);  // rows a stage
  static constexpr int kW = 0;                          // (kRows, BN) words
  static constexpr int kX = kW + kRows * BN * 4;        // (BM, 8 kRows) x
  static constexpr int kG = kX + BM * kRows * 8 * static_cast<int>(sizeof(T));
  static constexpr int kStage = kG + kRows * 8 * 4;     // + (8 kRows) g_idx
  // the slots' partial sums, then the groups' sums
  static constexpr int kRed = (kSlots + kSlots / kGroupSlots) * BM * BN * 4;
  static int bytes(int groups) {
    const int main = groups * Table<BN>::kRow + kStages * kStage;
    return main > kRed ? main : kRed;
  }
};

// Copy `rows` rows of BN consecutive 32-bit values (row r starts at
// src + r * stride) to dst + r * dst_stride.  Columns >= valid are
// zeroed.  16-byte copies when every row start is 16-byte aligned (vec),
// else 4.
template <int BN, int kThreads>
__device__ __forceinline__ void stage_rows(uint32_t* dst, int dst_stride,
                                           const uint32_t* src, size_t stride,
                                           int rows, int valid, bool vec,
                                           int tid) {
  if (vec) {
    for (int i = tid; i < rows * (BN / 4); i += kThreads) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      uint32_t* d = dst + r * dst_stride + c;
      if (c < valid) {
        __pipeline_memcpy_async(d, src + r * stride + c, 16);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = tid; i < rows * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      uint32_t* d = dst + r * dst_stride + c;
      if (c < valid) {
        __pipeline_memcpy_async(d, src + r * stride + c, 4);
      } else {
        *d = 0u;
      }
    }
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(Layout<T, BM, BN>::kThreads,
                                  kThreadsPerSM / Layout<T, BM, BN>::kThreads)
dequant_matmul_gidx_kernel(const T* __restrict__ x,
                           const uint32_t* __restrict__ qweight,
                           const float* __restrict__ scales,
                           const float* __restrict__ zeros,
                           const int* __restrict__ g_idx,
                           T* __restrict__ y, int M, int N, int K, int G) {
  using L = Layout<T, BM, BN>;
  using Tab = Table<BN>;
  constexpr int kThreads = L::kThreads;
  constexpr int kRows = L::kRows;
  constexpr int kXChunks = kRows * 8 * static_cast<int>(sizeof(T)) / 16;
  constexpr int kXPerChunk = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  // the table (Table<BN>: 2^23 + z once it has landed), then the ring
  unsigned char* table = smem;
  unsigned char* ring = smem + G * Tab::kRow;
  const int tid = threadIdx.x;
  const int slot = tid / L::kLanes;
  const int col = (tid % L::kLanes) * kCols;   // within the block's tile
  // this lane's scales and zeros of group g: at g * kRow + its offsets
  const int copy = slot % Tab::kCopies;
  const unsigned char* s_lane =
      table + copy * Tab::kBlock + Tab::s(copy) + col * 4;
  const unsigned char* z_lane =
      table + copy * Tab::kBlock + Tab::z(copy) + col * 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int rows = K / 8;                      // packed rows
  const int nsteps = (rows + kRows - 1) / kRows;
  const int valid_n = N - n0;
  const bool vec = N % 4 == 0;                 // 16-byte aligned rows

  // The table first (into copy 0), so it is in flight while the ring
  // fills.
  stage_rows<BN, kThreads>(reinterpret_cast<uint32_t*>(table), Tab::kRow / 4,
                           reinterpret_cast<const uint32_t*>(scales) + n0, N,
                           G, valid_n, vec, tid);
  stage_rows<BN, kThreads>(
      reinterpret_cast<uint32_t*>(table + Tab::z(0)), Tab::kRow / 4,
      reinterpret_cast<const uint32_t*>(zeros) + n0, N, G, valid_n, vec,
      tid);
  __pipeline_commit();

  // Start the copies of step j (packed rows j kRows ..) into its ring slot.
  auto issue = [&](int j) {
    unsigned char* st = ring + (j % kStages) * L::kStage;
    const int r0 = j * kRows;
    const int nr = min(kRows, rows - r0);
    stage_rows<BN, kThreads>(reinterpret_cast<uint32_t*>(st + L::kW), BN,
                             qweight + static_cast<size_t>(r0) * N + n0, N,
                             nr, valid_n, vec, tid);
    // g_idx: two 16-byte chunks a packed row (K is a multiple of 8)
    for (int i = tid; i < 2 * nr; i += kThreads) {
      __pipeline_memcpy_async(st + L::kG + i * 16, g_idx + r0 * 8 + i * 4,
                              16);
    }
    // x rows are 16-byte aligned and K is a multiple of 8, so a chunk
    // lies wholly inside or outside K
    unsigned char* xs = st + L::kX;
    for (int i = tid; i < BM * kXChunks; i += kThreads) {
      const int m = i / kXChunks, u = i % kXChunks;
      const int k = r0 * 8 + u * kXPerChunk;
      if (m0 + m < M && k < K) {
        __pipeline_memcpy_async(xs + i * 16,
                                x + static_cast<size_t>(m0 + m) * K + k, 16);
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
    if (j == 0) {   // copy 0 has landed: 2^23 + z, and the other copies
      for (int i = tid; i < G * BN; i += kThreads) {
        unsigned char* row = table + (i / BN) * Tab::kRow;
        const int c = 4 * (i % BN);
        float* z0 = reinterpret_cast<float*>(row + Tab::z(0) + c);
        const float zm = *z0 + kMagic;
        const float sv = *reinterpret_cast<const float*>(row + c);
        *z0 = zm;
#pragma unroll
        for (int k = 1; k < Tab::kCopies; ++k) {
          unsigned char* blk = row + k * Tab::kBlock;
          *reinterpret_cast<float*>(blk + Tab::s(k) + c) = sv;
          *reinterpret_cast<float*>(blk + Tab::z(k) + c) = zm;
        }
      }
      __syncthreads();
    }

    const unsigned char* st = ring + (j % kStages) * L::kStage;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + L::kW);
    const T* xs = reinterpret_cast<const T*>(st + L::kX);
    const int* gs = reinterpret_cast<const int*>(st + L::kG);
    const int r0 = j * kRows;
#pragma unroll
    for (int t = 0; t < kRows / kSlots; ++t) {
      const int rl = t * kSlots + slot;        // this slot's row in the step
      if (r0 + rl >= rows) break;
      const uint4 quad = *reinterpret_cast<const uint4*>(ws + rl * BN + col);
      const uint32_t words[kCols] = {quad.x, quad.y, quad.z, quad.w};
      const int4 ga = reinterpret_cast<const int4*>(gs + rl * 8)[0];
      const int4 gb = reinterpret_cast<const int4*>(gs + rl * 8)[1];
      const int gi[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      // nibble by nibble, so only one k's weights are live at a time
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int off = gi[i] * Tab::kRow;
        const float4 s = *reinterpret_cast<const float4*>(s_lane + off);
        const float4 zm = *reinterpret_cast<const float4*>(z_lane + off);
        const float sv[kCols] = {s.x, s.y, s.z, s.w};
        const float zv[kCols] = {zm.x, zm.y, zm.z, zm.w};
        float w[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float qm =
              __uint_as_float(kMagicBits | ((words[c] >> (4 * i)) & 0xFu));
          w[c] = Num<T>::round((qm - zv[c]) * sv[c]);
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xv = Num<T>::to_float(xs[m * kRows * 8 + rl * 8 + i]);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[m][c] = fmaf(xv, w[c], acc[m][c]);
          }
        }
      }
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);

  // Add the slots' sums in the fixed order: 8 groups of 8 consecutive
  // slots, each in slot order, then the groups in order.
  constexpr int kTile = BM * BN;
  float* red = reinterpret_cast<float*>(smem);   // (kSlots, BM, BN)
  float* grp = red + kSlots * kTile;             // (kSlots / 8, BM, BN)
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    *reinterpret_cast<float4*>(red + (slot * BM + m) * BN + col) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  for (int i = tid; i < (kSlots / kGroupSlots) * kTile; i += kThreads) {
    const float* p = red + (i / kTile) * kGroupSlots * kTile + i % kTile;
    float sum = p[0];
    for (int s = 1; s < kGroupSlots; ++s) sum += p[s * kTile];
    grp[i] = sum;
  }
  __syncthreads();
  for (int i = tid; i < kTile; i += kThreads) {
    const int m = i / BN, c = i % BN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float sum = grp[i];
    for (int g = 1; g < kSlots / kGroupSlots; ++g) sum += grp[g * kTile + i];
    y[static_cast<size_t>(m0 + m) * N + n0 + c] = Num<T>::from_float(sum);
  }
}

// The current device's SM count and the shared memory a block may opt in
// to, read once per device.
struct DeviceLimits {
  int sms, smem_optin, smem_per_sm, smem_reserved;
};

cudaError_t device_limits(DeviceLimits* out) {
  static DeviceLimits cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev].sms == 0) {
    DeviceLimits l;
    err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&l.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &l.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&l.smem_reserved,
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = l;
  }
  *out = cached[dev];
  return cudaSuccess;
}

template <typename T>
int smem_bytes(int m, int groups, int bn) {
  const bool small = block_m(m) == 4;
  if (bn == 16) {
    return small ? Layout<T, 4, 16>::bytes(groups)
                 : Layout<T, 16, 16>::bytes(groups);
  }
  return small ? Layout<T, 4, 32>::bytes(groups)
               : Layout<T, 16, 32>::bytes(groups);
}

int smem_bytes(int m, int groups, int bn, int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>(m, groups, bn)
              : smem_bytes<float>(m, groups, bn);
}

// Columns per block, 16 or 32.  A 32-column block is 16 warps, as many
// as an SM holds at 128 registers a thread; 16 columns are taken when two
// 16-column blocks (8 warps each) fit in an SM's shared memory and leave
// the busiest SM fewer columns (ceil(blocks / SMs) x width), or when a
// 32-column block does not fit.  At M = 4 in float32 that is 16 for the
// qwen3-4b up/gate projection (608 blocks: at most 5 x 16 columns an SM
// against 3 x 32) and 32 for down (two 16-column blocks and their
// 32-group table exceed an SM's shared memory).  The sum order does not
// depend on it.
int pick_block_n(int m, int n, int groups, int bf16,
                 const DeviceLimits& lim) {
  const long long mtiles = (m + block_m(m) - 1) / block_m(m);
  const long long blocks16 = (n + 15) / 16 * mtiles;
  const long long blocks32 = (n + 31) / 32 * mtiles;
  const long long cols16 = (blocks16 + lim.sms - 1) / lim.sms * 16;
  const long long cols32 = (blocks32 + lim.sms - 1) / lim.sms * 32;
  const int smem16 = smem_bytes(m, groups, 16, bf16) + lim.smem_reserved;
  if (smem_bytes(m, groups, 32, bf16) > lim.smem_optin) return 16;
  return 2 * smem16 <= lim.smem_per_sm && cols16 < cols32 ? 16 : 32;
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* x, const void* qweight, const void* scales,
                   const void* zeros, const void* g_idx, void* y, int m,
                   int n, int k, int groups, cudaStream_t stream) {
  using L = Layout<T, BM, BN>;
  const int smem = L::bytes(groups);
  static int opted_in = 48 * 1024;          // bytes allowed without opt-in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_gidx_kernel<T, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  dequant_matmul_gidx_kernel<T, BM, BN><<<grid, L::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const int*>(g_idx), static_cast<T*>(y), m, n, k, groups);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_bm(const void* x, const void* qweight, const void* scales,
                      const void* zeros, const void* g_idx, void* y, int m,
                      int n, int k, int groups, int bn, cudaStream_t stream) {
  return bn == 16 ? launch<T, BM, 16>(x, qweight, scales, zeros, g_idx, y, m,
                                      n, k, groups, stream)
                  : launch<T, BM, 32>(x, qweight, scales, zeros, g_idx, y, m,
                                      n, k, groups, stream);
}

bool valid_shape(int m, int n, int k, int groups) {
  return m > 0 && n > 0 && k > 0 && k % 8 == 0 && groups > 0;
}

}  // namespace

bool valid_block_n(int bn) { return bn == 16 || bn == 32; }

// Columns per block that dequant_matmul_gidx picks for M x N, `groups`
// groups and the compute type (bf16 != 0: bfloat16, else float32) on the
// current device (16 or 32), or minus a CUDA error code.
extern "C" int dequant_matmul_gidx_block_n(int m, int n, int groups,
                                           int bf16) {
  DeviceLimits lim;
  const cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return pick_block_n(m, n, groups, bf16, lim);
}

// Dynamic shared memory of one block for M rows of x in the compute type,
// `groups` groups and `block_n` columns (16 or 32; 0: the kernel's
// pick), or minus a CUDA error code.
extern "C" int dequant_matmul_gidx_smem_bytes(int m, int n, int groups,
                                              int block_n, int bf16) {
  if (block_n == 0) {
    block_n = dequant_matmul_gidx_block_n(m, n, groups, bf16);
  }
  if (block_n < 0) return block_n;
  if (!valid_block_n(block_n)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return smem_bytes(m, groups, block_n, bf16);
}

// Dynamic shared memory a block may use on the current device, or minus
// a CUDA error code.
extern "C" int dequant_matmul_gidx_smem_limit() {
  DeviceLimits lim;
  const cudaError_t err = device_limits(&lim);
  return err != cudaSuccess ? -static_cast<int>(err) : lim.smem_optin;
}

// x (M, K) and y (M, N) in the compute type (bf16 != 0: bfloat16, else
// float32), qweight (K/8, N) 32-bit words, scales and zeros (groups, N)
// float32 with integer zero-points, g_idx (K,) int32 with every value in
// [0, groups); all contiguous and 16-byte aligned.  block_n: columns per
// block, 16 or 32, or 0 for the kernel's pick
// (dequant_matmul_gidx_block_n).  One launch on `stream`; returns the
// CUDA error code (0 on success), and cudaErrorInvalidValue when a
// block's shared memory (dequant_matmul_gidx_smem_bytes) exceeds
// dequant_matmul_gidx_smem_limit.
extern "C" int dequant_matmul_gidx(const void* x, const void* qweight,
                                   const void* scales, const void* zeros,
                                   const void* g_idx, void* y, int m, int n,
                                   int k, int groups, int bf16, int block_n,
                                   void* stream) {
  if (!valid_shape(m, n, k, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceLimits lim;
  const cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn =
      block_n == 0 ? pick_block_n(m, n, groups, bf16, lim) : block_n;
  if (!valid_block_n(bn) ||
      smem_bytes(m, groups, bn, bf16) > lim.smem_optin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = block_m(m) == 4;
  if (bf16) {
    return static_cast<int>(
        small ? launch_bm<__nv_bfloat16, 4>(x, qweight, scales, zeros, g_idx,
                                            y, m, n, k, groups, bn, s)
              : launch_bm<__nv_bfloat16, 16>(x, qweight, scales, zeros,
                                             g_idx, y, m, n, k, groups, bn,
                                             s));
  }
  return static_cast<int>(
      small ? launch_bm<float, 4>(x, qweight, scales, zeros, g_idx, y, m, n,
                                  k, groups, bn, s)
            : launch_bm<float, 16>(x, qweight, scales, zeros, g_idx, y, m, n,
                                   k, groups, bn, s));
}

extern "C" const char* dequant_matmul_gidx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
