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
// Three main loops, chosen by M, the group size and the compute type
// (tensor_core_path and dec_tiles in the header):
//
// The float32 decode loop (M < kTcMinM; groups of a multiple of 4 rows,
// at least 8, as every configuration's are; else the call is refused).
// It computes
//   y[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * (q[k, n] - z[g, n])
// with the products on the tensor cores: mma.sync m16n8k8 TF32 with the
// weight on the A side (yT = WT xT), so 16 columns of N fill the A rows
// and the batch rows the B side's 8 columns.
//  * The weight operand is q - z, an integer in [-15, 15], exact in TF32:
//    the nibble q at bits 4c..4c + 3 of a float whose exponent is
//    2^(23 - 4c) makes the float 2^(23 - 4c) + q with one LOP3 (no shift
//    for the low half of a word), and one subtraction of 2^(23 - 4c) + z
//    leaves q - z.  This rests on integer zero-points in 0..15, which the
//    quantizer writes and the C API requires: a fractional z would not be
//    exact, and neither would q - z.
//  * x goes in two TF32 parts: big = x rounded to TF32 (nearest, ties
//    away, as cvt.rna.tf32.f32, here by integer adds on the bits) and
//    small = the remainder x - big rounded to TF32.  big * (q - z) and
//    small * (q - z) are exact in float32 (an 11-bit significand times a
//    5-bit integer), and their sum carries x to about 22 bits; big alone
//    misses the float32 limit (1e-5 * max|ref| + 1e-4) by more than 4x
//    at the full-width shapes (tests/test_torch_kernels.py, emulated).  With at
//    most 4 rows the B tile holds the 4 rows' big parts in its columns
//    0-3 and their small parts in 4-7, so one mma a tile takes both; 5-8
//    rows take two tiles.
//  * The scale comes after the group's sum: each 64-k chunk of a warp
//    sums one 8-k step at a time, per x part, into a zeroed fragment for
//    each group it touches, and s[g, n] times that fragment is added to
//    the warp's float32 sum with a fused multiply-add.  Scaling inside
//    the product would need (q - z) * s split in two TF32 parts too (the
//    large-M loop's form, 4 more operations a weight).  The tensor cores
//    truncate as they accumulate, and over all of K one accumulator
//    gathers a bias above the limit (5e-3 at K 2560: tools/k1_tc_cost.py,
//    no_part); at most 8 steps a fragment the emulated error is within
//    it (tests/test_torch_kernels.py).  A group boundary at a step's
//    start closes the fragment; one between a step's nibbles 3 and 4
//    (groups of 4 (2i + 1) rows, such as qwen3-4b's down projection's 76)
//    runs the step as two m16n8k4 halves, one for each group.
//
// What bounds it, by count: at M <= 8 a weight costs about 2.6 CUDA-core
// instructions (the LOP3, the subtraction, a shift a high nibble, and a
// share of x's split, the group's zero and scale) and 1/128 of an mma;
// at the served decode shapes that issue stream is below the bytes (at
// qwen3-4b's up/gate, 24.9 M weights: about 2.5 us of issue on 528 warp
// schedulers against the 4.2 us the 12.5 MB of packed weight and 1.6 MB
// of metadata take at 3.35 TB/s).  As measured on an H100 the loop is
// still held by that issue stream, which runs far below one instruction
// a cycle with 3-5 warps a scheduler, and by each stage's copy issue
// (PERF.md; tools/k1_time.py).
//
// Design (no TMA, no wgmma yet):
//  * One block of 4 warps per (4 or 8 rows x 128 columns) output tile and
//    K split; warp (wn, wk) owns columns 64 wn..+63 and the 64-k chunks
//    wk, wk + 2, ... of the split's K range.  Its sums live in registers;
//    the two warps' sums of a column (big parts, then small parts) are
//    added in a fixed order at the end.  Lane (g, c) takes nibbles c and
//    c + 4 of each word, so the mma's k order is the word's and x needs
//    no permutation.
//  * A 2-stage cp.async ring of 256-k stages: 32 packed rows, x's rows
//    and the scale and zero rows of every group the stage touches; each
//    thread copies 16 bytes a row at a fixed column (single words where
//    N is not a multiple of 4).  Lanes split x themselves, a k-step at a
//    time.  Per-stage work is what the loop spends besides the products:
//    256-k stages in 2 slots beat 128-k stages in 3 at mistral-large's
//    down projection (tools/k1_decode_forms.py), and each thread's copy
//    addresses are worked out once, before the loop.
//  * The K split and the split-add pass are the bfloat16 loop's
//    (choose_split: N, K and the card, never M).
//  * Registers: 4 blocks a SM (128 registers) at 4 rows, 3 (168) at 8, no
//    spill (phase 2 of chip_smoke.py prints ptxas's lines).
//
// The bfloat16 decode loop (M < kTcMinM in bfloat16, and every bfloat16
// call: the large-M loop is float32 only).  In decode M is 1..32, so the
// kernel does ~2*M*K*N flops against ~K*N/2 bytes of packed weight; at
// M = 4 that is 16 flops per byte, far below the card's ridge, so its
// floor is the bytes it reads from device memory (packed weight + scales
// + zeros).  Each weight also costs M CUDA-core FMAs plus its unpack and
// dequantize.
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
//    depends only on N, K and the card, never on M.  The caller asks
//    dequant_matmul_partial_floats for the scratch this takes.
//
// The tensor-core loop (float32, M >= kTcMinM, groups of at least
// kTcMinGroup rows: the full-sequence forward's MLP, M = 2048 tokens).
// What bounds it: operations; at the full-width shapes one launch is
// 2 * 2048 * 2560 * 9728 = 102 GFLOP against about 100 MB.  On CUDA cores that
// is 1.52 ms at the float32 rate, which the CUDA-core decode loop's design
// (the bfloat16 loop's) missed by 5.5x.  So the products run on the
// tensor cores with mma.sync m16n8k8 TF32.  The float32 policy holds the
// kernel to 1e-5 of max|ref| + 1e-4, and one TF32 product (10 mantissa
// bits) misses that by 26-32x at these K, so both operands are split
// 3xTF32 as in flash_attention.cu:
// v = big + small with big = cvt.rna.tf32(v) and small =
// cvt.rna.tf32(v - big); each
// k-step adds small*big, big*small and big*big.  The floor is then 3 x 102
// GFLOP at the dense TF32 rate (0.62 ms), and mma.sync reaches about 62%
// of that rate (tools/mma_tf32_probe.py).
//
// Design (no TMA, no wgmma yet):
//  * One block of 8 warps per output tile of 128 columns and 32 MT rows;
//    warp (wm, wn) owns rows 16 MT wm..+16 MT - 1 and columns 32 wn..+31:
//    MT m16 x 4 n8 accumulator tiles in registers.  No K split: at
//    M = 2048 the tiles alone give 1216 blocks (up/gate) and 320 (down)
//    for 132 SMs, so no partial tiles and no second pass;
//    dequant_matmul_partial_floats asks for no scratch.  MT is 4, or 5
//    where that leaves each SM fewer rows (tc_mtiles): the down
//    projection's 320 blocks of 128 rows take 3 waves, the last 42% full,
//    and its 260 blocks of 160 rows take 2.
//  * K steps of 32 through a 4-stage cp.async ring: the x tile (rows of
//    32 + 16 floats, so each 16-byte fragment read is conflict-free), the
//    4 packed rows (rows of 128 + 8 words) and the scale and zero rows of
//    every group the step touches.  The step is decoupled from the
//    groups: each lane takes the group of its own k, k / gs, followed by
//    a running boundary; at gs = 76 a group boundary falls inside a
//    packed word and inside a k-step.
//  * The sum over k runs in any order, so in each pair of k-steps lane c
//    takes k = 4c..4c + 3: its x values are one 16-byte read a row, and
//    its B fragments are 4 nibbles of one packed word.  Each lane
//    dequantizes and splits its 16 weights of a chunk once, in registers,
//    and reuses them for the warp's MT m16 tiles; x is split per warp.
//    Two forms that split once per block into shared memory were slower
//    at both full-width shapes (PERF.md §6): x and the weights as big
//    and small TF32 planes, and x alone (big parts in place, small parts
//    in a second buffer).  Both read x's fragments from shared memory
//    twice over (big and small parts), and the split's arithmetic they
//    save (at most 14-19% of the loop's time: tools/k1_tc_cost.py,
//    no_split) did not pay for that.
//  * Each chunk of 16 k is summed in zeroed fragments, then added to the
//    float32 sums with rounded adds: the tensor cores truncate when they
//    accumulate, and one accumulator over all of K keeps its sign and
//    gathers a bias above the limit (5e-3 at K 2560, 3.6e-2 at K 9728:
//    tools/k1_tc_cost.py, no_part), while the chunks' truncations cancel.
//  * The nibble dequantize is the decode loop's (2^23 | q minus 2^23 + z),
//    so the weight the tensor cores see is bit-equal to (q - z) * s
//    before its split.
//  * Tiles past M, N or K are zero-filled by the copies (a ragged K step,
//    N not a multiple of 4 through 4-byte copies) and never stored.
//    Groups of fewer than 4 rows would stage more scale and zero rows a
//    step than shared memory holds; those shapes keep the decode loop.
//
// Sum order: within each loop a row's float32 sum depends on N, K, the
// group size and the card, never on M, so a row's result does not depend
// on the batch it runs in as long as the batch stays on one side of
// kTcMinM.  In the float32 decode loop an mma's output element depends
// only on its own A row, B column and accumulator, each row's big and
// small parts sit in the same columns of a 4-row tile whatever M is, and
// the K split, the chunks, the steps and every add are fixed by N, K, gs
// and the card; blocks of 4 or 8 rows and the rows past M change none of
// them.  The loops sum in different orders.  K3
// (dequant_matmul_wire_ordered.cu) takes the same loop at the same M, so
// its sums are K1's bit for bit.
//
// Every loop: the group of each row is k / gs per row, never per word:
// with gs = 76 a packed word straddles two groups.  A nibble q becomes the
// float 2^23 + q by OR-ing it into the mantissa of 2^23; subtracting
// 2^23 + z (exact for the integer zero-points 0..15 that the quantizer
// writes) gives q - z exactly, so w is bit-equal to the reference's
// (q - z) * s without an int-to-float conversion per element.
#include "dequant_matmul_ordered.cuh"

namespace {

// Launch the float32 decode loop on `stream`, as launch_gemm does the
// bfloat16 one.  Here, not in the header: K3 launches its own instances.
template <int R4, bool kVec>
cudaError_t launch_decode_tc_as(const void* x, const void* qweight,
                                const void* scales, const void* zeros,
                                float* y, float* partial, int m, int n, int k,
                                int gs, int bk, Split split,
                                cudaStream_t stream) {
  const int smem = dec_smem_bytes(gs, R4);
  const cudaError_t err = decode_tc_opt_in<R4, kVec>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + 4 * R4 - 1) / (4 * R4),
                  split.splits);
  dequant_matmul_decode_tc_kernel<R4, kVec><<<grid, kThreads, smem,
                                              stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros), y,
      partial, m, n, k, gs, bk, split.steps_per_split);
  return cudaGetLastError();
}

cudaError_t launch_decode_tc(const void* x, const void* qweight,
                             const void* scales, const void* zeros, float* y,
                             float* partial, int m, int n, int k, int gs,
                             int bk, Split split, cudaStream_t stream) {
  auto* launch = n % 4 == 0 ? (dec_tiles(m) == 1
                                    ? launch_decode_tc_as<1, true>
                                    : launch_decode_tc_as<2, true>)
                             : (dec_tiles(m) == 1
                                    ? launch_decode_tc_as<1, false>
                                    : launch_decode_tc_as<2, false>);
  return launch(x, qweight, scales, zeros, y, partial, m, n, k, gs, bk, split,
                stream);
}

// The split-add pass, when K is split.
template <typename T>
cudaError_t add_splits(const float* part, void* y, int splits, int mn,
                       cudaStream_t stream) {
  add_splits_kernel<T><<<(mn + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(y), splits, mn);
  return cudaGetLastError();
}

// K1 on either decode loop: the GEMM, then, when K is split, the
// split-add pass.
cudaError_t launch_decode(const void* x, const void* qweight,
                          const void* scales, const void* zeros, void* y,
                          void* partial, int m, int n, int k, int gs, int bk,
                          bool bf16, Split split, cudaStream_t stream) {
  float* part = split.splits == 1 ? nullptr : static_cast<float*>(partial);
  cudaError_t err;
  if (!bf16) {
    err = launch_decode_tc(x, qweight, scales, zeros, static_cast<float*>(y),
                           part, m, n, k, gs, bk, split, stream);
  } else if (block_m(m) == 4) {
    err = launch_gemm<__nv_bfloat16, 4>(x, qweight, scales, zeros, y, part,
                                        m, n, k, gs, bk, split, stream);
  } else {
    err = launch_gemm<__nv_bfloat16, 16>(x, qweight, scales, zeros, y, part,
                                         m, n, k, gs, bk, split, stream);
  }
  if (err != cudaSuccess || part == nullptr) return err;
  return bf16 ? add_splits<__nv_bfloat16>(part, y, split.splits, m * n,
                                          stream)
              : add_splits<float>(part, y, split.splits, m * n, stream);
}

}  // namespace

// Floats of scratch that dequant_matmul_ordered needs in `partial` for
// this shape and compute type (bf16 != 0: bfloat16) on the current
// device (0 when K is not split), or minus a CUDA error code.
extern "C" long long dequant_matmul_partial_floats(int m, int n, int k,
                                                   int group_size,
                                                   int block_k, int bf16) {
  if (!valid_shape(m, n, k, group_size, block_k) ||
      !takes_group(m, group_size, bf16 != 0)) {
    return -static_cast<long long>(cudaErrorInvalidValue);
  }
  Split split;
  const cudaError_t err =
      plan_split(m, n, k, group_size, block_k, bf16 != 0, &split);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return split.splits == 1
             ? 0
             : static_cast<long long>(split.splits) * m * n;
}

// x (M, K) and y (M, N) in the compute type (bf16 != 0: bfloat16, else
// float32), qweight (K/8, N) 32-bit words, scales and zeros (K/gs, N)
// float32 with integer zero-points, all contiguous and 16-byte aligned.
// float32 calls below kTcMinM take groups of a multiple of 4 rows, at
// least kDecMinGroup.
// `partial` holds `partial_floats` floats of scratch, at least what
// dequant_matmul_partial_floats asks for.  Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int dequant_matmul_ordered(const void* x, const void* qweight,
                                      const void* scales, const void* zeros,
                                      void* y, void* partial,
                                      long long partial_floats, int m, int n,
                                      int k, int group_size, int block_k,
                                      int bf16, void* stream) {
  if (!valid_shape(m, n, k, group_size, block_k) ||
      !takes_group(m, group_size, bf16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core_path(m, group_size, bf16 != 0)) {
    return static_cast<int>(launch_tc(x, qweight, scales, zeros,
                                      static_cast<float*>(y), m, n, k,
                                      group_size, s));
  }
  Split split;
  const cudaError_t err = choose_split(n, k, block_k, &split);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split.splits > 1 &&
      (partial == nullptr ||
       partial_floats < static_cast<long long>(split.splits) * m * n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_decode(x, qweight, scales, zeros, y,
                                        partial, m, n, k, group_size,
                                        block_k, bf16 != 0, split, s));
}

// Dynamic shared memory of one block for an (M, N) output, or minus a
// CUDA error code.
extern "C" int dequant_matmul_smem_bytes(int m, int n, int group_size,
                                         int block_k, int bf16) {
  if (!takes_group(m, group_size, bf16 != 0)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  if (tensor_core_path(m, group_size, bf16 != 0)) {
    int bytes = 0;
    const cudaError_t err = tc_block_smem(m, n, group_size, &bytes);
    return err == cudaSuccess ? bytes : -static_cast<int>(err);
  }
  if (!bf16) return dec_smem_bytes(group_size, dec_tiles(m));
  return block_m(m) == 4 ? smem_bytes<__nv_bfloat16, 4>(block_k, group_size)
                         : smem_bytes<__nv_bfloat16, 16>(block_k,
                                                         group_size);
}

// 1 when an M-row call with this group size and compute type takes the
// tensor-core loop.
extern "C" int dequant_matmul_tensor_cores(int m, int group_size, int bf16) {
  return tensor_core_path(m, group_size, bf16 != 0) ? 1 : 0;
}

// The smallest M that takes the tensor-core path in float32.
extern "C" int dequant_matmul_tensor_core_min_m() { return kTcMinM; }

// 1 when an M-row call with this group size and compute type has a main
// loop that takes it (the float32 decode loop: multiples of 4 rows, at
// least kDecMinGroup).
extern "C" int dequant_matmul_takes_group(int m, int group_size, int bf16) {
  return takes_group(m, group_size, bf16 != 0) ? 1 : 0;
}

extern "C" const char* dequant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
