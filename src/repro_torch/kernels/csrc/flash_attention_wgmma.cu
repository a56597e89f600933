// flash_attention_wgmma: FlashAttention-2 forward in bf16 on Hopper's tensor
// cores: wgmma products, Q, K and V fed by TMA through a ring of shared-
// memory stages, the online softmax in registers.  Head widths (DK, DV) of
// q / k and of v: (64, 64), (80, 80), (128, 128) and (192, 128).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas / _flash_kernel (and the reference's XLA flash
// path `_sdpa_flash`) for bf16 inputs at those widths: the main path's
// types and widths (qwen1.5-0.5b D 64; hubert-xlarge D 80; yi-6b,
// minitron-8b, qwen2-72b, mixtral-8x22b, qwen2-vl-7b, jamba D 128;
// deepseek-v3's MLA prefill DK 192 = nope 128 + rope 64, DV 128).  float32
// inputs and the small check widths keep flash_attention.cu.
//
// Contract: as flash_attention.cu.  q (B, S, H, DK), k (B, T, KV, DK), v
// (B, T, KV, DV) contiguous bf16, 16-byte aligned; out (B, S, H, DV) bf16.
// Query row i sits at q_offset + i and keeps key j when j <= it (causal),
// j > it - window (window > 0) and j < written_upto; head h reads kv head
// h / (H / KV); logits = (q . k) * scale in float32 (the wrapper passes
// 1 / sqrt(DK), q's width, as the Pallas kernel), masked logits add p = 0,
// shift = isfinite(m_new) ? m_new : 0, the rescale is 0 while m = -inf,
// and out = acc / max(l, 1e-30), rounded to bf16 (nearest even).
//
// Bound on an H100: 2 (DK + DV) operations a kept (query, key) pair and
// head against the bytes of q, k, v and out.  At the qwen1.5-0.5b prefill
// (S 4096, T 8192, written_upto 4096, causal, H 16, D 64) that is 34 GFLOP
// against 50 MB: bound by the bf16 tensor cores (0.035 ms at 989 TFLOP/s).
// flash_attention.cu ran both products as float32 FMAs (67 TFLOP/s peak)
// and reached about 16 TFLOP/s, 61x the bound.  This kernel moves both
// products onto wgmma:
//   - one block owns one (b, h, 128-row query tile): a producer warpgroup
//     (one thread issues TMA; setmaxnreg gives its registers away) and two
//     consumer warpgroups of 64 rows each;
//   - the producer loads the Q tile once and K / V tiles of BK keys (128 at
//     DK 64 and 80, 64 at DK 128 and 192) into a 3-stage ring, each stage
//     guarded by a full and an empty mbarrier.  k and v are (B, T, KV, D):
//     a tile's rows are KV * D apart, so the loads go through 4-d tensor
//     maps (built on the host per call), with 128-byte swizzle; a row wider
//     than 64 is
//     loaded as 64-column parts (three for DK 192: Q 48 KB, a stage of K
//     24 KB and of V 16 KB, 169 KB in all with the ring).  A row of 80
//     takes two parts, the second 16 real columns and 48 zeros: the maps
//     end at the row's width and TMA fills columns past it with zeros, and
//     the transaction count of a box is its full bytes, zeros included
//     (Q 32 KB, a stage of K and of V 32 KB each, 225 KB in all).  The
//     K / V maps end at written_upto, so keys past it read as zeros, never
//     as whatever the cache holds there;
//   - S = Q K^T is wgmma m64nBKk16 over DK / 16 k-steps (12 at DK 192; 5
//     at DK 80, four in part 0 and one in part 1: the zero columns are
//     never multiplied), bf16 operands from shared memory (both K-major, as
//     loaded), float32 accumulator;
//   - the online softmax runs on the accumulator fragment: each thread
//     holds two rows, row max by quad shuffles, the row sum kept per thread
//     and reduced once at the end.  Masks are computed from positions, and
//     only on tiles that cross a mask edge; a tile the mask drops whole for
//     a warpgroup's rows is skipped (exact: m, l and acc stay as they are),
//     and the heaviest causal query tiles are scheduled first;
//   - p . V keeps the reference's float32 p: p is split in registers into
//     three bf16 parts, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1
//     - p2), whose sum is p to float32's 24 bits, and three wgmma m64nDVk16
//     per 16 keys take them as A from registers (the accumulator fragment
//     is the A fragment's layout) against the V tile in shared memory,
//     read N-major through the transpose bit (at DV 80, n80 reads part 0
//     and the first 16 columns of part 1 through the descriptor n128
//     uses), into a per-tile accumulator
//     that float32 FMAs add to o (o = o * rescale + pv): wgmma's float32
//     accumulation truncates, so accumulating across tiles in it drifted
//     by ~1e-6 on outputs near 0 over deepseek-v3's 8000-key rows (on an
//     H100, against the float32 plain version and a float64 one).  A single
//     bf16 p errs by about 2^-9 of each term, as much as the bf16 output
//     rounding itself.
//     Two parts leave 2^-18 of each term: up to 5.5e-6 on rows that keep
//     few keys (the first rows of a causal prefill), 5x the check's 1e-6
//     floor where such a row's output is near 0.  The price of three parts
//     is 2x the tensor work of p . V (6 DV operations a kept pair and head,
//     against 2 DV).
// Ragged S and T need no padding: TMA fills rows out of bounds with zeros
// and the masks drop them.
#include <cuda_bf16.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int BM = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int STAGES = 3;     // depth of the K / V ring
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128*24 + 256*240 <= 64K
constexpr int LINE = 128;     // bytes of one swizzled shared-memory row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

// q and k rows of DK columns, v and out rows of DV; a row is held as
// 64-column parts of LINE bytes, the last part's columns past the width
// zero (TMA's out-of-bounds fill), and the byte counts are the parts' full
// boxes, which is what each TMA box's transaction count adds
template <int DK, int DV>
struct Tile {
  static constexpr int BK = DK <= 80 ? 128 : 64;     // keys a tile
  static constexpr int QK_PARTS = (DK + 63) / 64;    // 64-column parts of a q / k row
  static constexpr int V_PARTS = (DV + 63) / 64;     // 64-column parts of a v row
  static constexpr int Q_BYTES = BM * QK_PARTS * LINE;
  static constexpr int K_BYTES = BK * QK_PARTS * LINE;  // one K stage
  static constexpr int V_BYTES = BK * V_PARTS * LINE;   // one V stage
  // 1024-byte alignment slack (the swizzle atom), the tiles, 1 + 2 * STAGES
  // mbarriers
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "a block's shared memory on Hopper");
};

// e^x by ex2.approx (2 ulp); e^-inf = 0
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, f32) = [d +] A (64 x 16) . B (64 x 16)^T, both bf16 in shared
// memory, K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) = [d +] A (64 x 16) . B (128 x 16)^T, both bf16 in shared
// memory, K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) . B (16 x 64,
// bf16 in shared memory, N-major: the transpose bit is set), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80, f32) += A (64 x 16, bf16 fragments in registers) . B (16 x 80,
// bf16 in shared memory, N-major: the transpose bit is set), 128-byte
// swizzle: columns 0-63 from the first 64-column part, 64-79 from the next
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) . B (16 x 128,
// bf16 in shared memory, N-major: the transpose bit is set), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BK>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (BK == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (DV == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (DV == 80) wgmma_rs_n80(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                   int S, int H, int KV, int causal, int window, int q_offset, int kv_limit,
                   float scale) {
  using C = Tile<DK, DV>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1 KB
  const uint32_t ks = qs + C::Q_BYTES;                         // stage s at + s * K_BYTES
  const uint32_t vs = ks + STAGES * C::K_BYTES;                // stage s at + s * V_BYTES
  const uint32_t q_full = vs + STAGES * C::V_BYTES;            // then full[s], empty[s]
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BM;
  const int rows = min(BM, S - q0);

  // keys [k_lo, k_hi) hold every key some row of the block keeps
  const int pos_first = q_offset + q0, pos_last = pos_first + rows - 1;
  int k_hi = kv_limit;
  if (causal) k_hi = min(k_hi, pos_last + 1);
  const int k_lo = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int j0 = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - j0 : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::QK_PARTS; ++p)
        tma_load_4d(qs + p * BM * LINE, &tm_q, q_full, 64 * p, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, C::K_BYTES + C::V_BYTES);
        const int k0 = (j0 + i) * BK;
#pragma unroll
        for (int p = 0; p < C::QK_PARTS; ++p)
          tma_load_4d(ks + s * C::K_BYTES + p * BK * LINE, &tm_k, full + 8 * s, 64 * p, kvh,
                      k0, b);
#pragma unroll
        for (int p = 0; p < C::V_PARTS; ++p)
          tma_load_4d(vs + s * C::V_BYTES + p * BK * LINE, &tm_v, full + 8 * s, 64 * p, kvh,
                      k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;  // consumer warpgroup: rows [64 cw, 64 cw + 64) of the block
    const int warp = (tid % 128) / 32, lane = tid % 32, t = lane % 4;
    const int r0 = cw * 64 + warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
    const int qp0 = q_offset + q0 + r0, qp1 = qp0 + 8;
    const int wg_first = q_offset + q0 + cw * 64, wg_last = wg_first + 63;
    const float neg_inf = __int_as_float(0xff800000);

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = (j0 + i) * BK;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const bool skip = k0 >= kv_limit || (causal && k0 > wg_last) ||
                        (window > 0 && k0 + BK - 1 <= wg_first - window);
      if (!skip) {
        const bool edge = k0 + BK > kv_limit || (causal && k0 + BK - 1 > wg_first) ||
                          (window > 0 && k0 <= wg_last - window);
        // S = Q K^T: 64 x BK, accumulator fragment: n-block nb, entries
        // (r0, c), (r0, c + 1), (r0 + 8, c), (r0 + 8, c + 1), c = 8 nb + 2 t
        float sc[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t qa = qs + (kk / 4) * BM * LINE + cw * 64 * LINE + (kk % 4) * 32;
          const uint32_t kb = ks + s * C::K_BYTES + (kk / 4) * BK * LINE + (kk % 4) * 32;
          wgmma_qk<BK>(sc, sw128_desc(qa, 16, 1024), sw128_desc(kb, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<BK / 2>(sc);

        float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          float x = sc[e] * scale;
          if (edge) {
            const int kp = k0 + (e / 4) * 8 + 2 * t + (e & 1);
            const int qp = (e & 2) ? qp1 : qp0;
            bool ok = kp < kv_limit;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) x = neg_inf;
          }
          sc[e] = x;
          if (e & 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float sh0 = isfinite(mn0) ? mn0 : 0.f, sh1 = isfinite(mn1) ? mn1 : 0.f;
        const float rs0 = isfinite(m0) ? fexp(m0 - sh0) : 0.f;
        const float rs1 = isfinite(m1) ? fexp(m1 - sh1) : 0.f;
        m0 = mn0;
        m1 = mn1;

        // p in the A-fragment layout of k16 chunk kc: register j holds
        // sc[8 kc + 2 j], sc[8 kc + 2 j + 1], of row r0 (j even) or r0 + 8;
        // p = p1 + p2 + p3, each bf16
        uint32_t p1[BK / 16][4], p2[BK / 16][4], p3[BK / 16][4];
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float sh = (j & 1) ? sh1 : sh0;
            const float pa = fexp(sc[8 * kc + 2 * j] - sh);
            const float pb = fexp(sc[8 * kc + 2 * j + 1] - sh);
            if (j & 1) sum1 += pa + pb;
            else sum0 += pa + pb;
            const __nv_bfloat162 h1 = __floats2bfloat162_rn(pa, pb);
            const float2 f1 = __bfloat1622float2(h1);
            const float ra = pa - f1.x, rb = pb - f1.y;  // exact
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(ra, rb);
            const float2 f2 = __bfloat1622float2(h2);
            p1[kc][j] = bf16x2_bits(h1);
            p2[kc][j] = bf16x2_bits(h2);
            p3[kc][j] = bf16x2_bits(__floats2bfloat162_rn(ra - f2.x, rb - f2.y));
          }
        }
        l0 = l0 * rs0 + sum0;
        l1 = l1 * rs1 + sum1;
        // the tile's p . V in a fresh accumulator, the parts smallest first
        // over the whole tile (p3 of every 16 keys, then p2, then p1), then
        // o = o * rescale + pv by float32 FMAs: the tensor cores' float32
        // accumulation truncates, so a small part added onto o's running
        // sum of thousands of keys would lose its low bits at every step.
        // V stage: BK rows of 128 bytes per 64-column part, parts BK * 128
        // bytes apart (the leading offset), 8-row groups 1 KB apart (the
        // stride offset)
        float pv[DV / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) pv[i] = 0.f;
        fence_regs<DV / 2>(pv);
        wgmma_fence();
#pragma unroll
        for (int part = 0; part < 3; ++part) {
#pragma unroll
          for (int kc = 0; kc < BK / 16; ++kc) {
            const uint64_t dv =
                sw128_desc(vs + s * C::V_BYTES + kc * 16 * LINE, BK * LINE, 1024);
            wgmma_pv<DV>(pv, part == 0 ? p3[kc] : part == 1 ? p2[kc] : p1[kc], dv);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<DV / 2>(pv);
#pragma unroll
        for (int c = 0; c < DV / 8; ++c) {
          o[4 * c] = fmaf(o[4 * c], rs0, pv[4 * c]);
          o[4 * c + 1] = fmaf(o[4 * c + 1], rs0, pv[4 * c + 1]);
          o[4 * c + 2] = fmaf(o[4 * c + 2], rs1, pv[4 * c + 2]);
          o[4 * c + 3] = fmaf(o[4 * c + 3], rs1, pv[4 * c + 3]);
        }
      }
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int srow = q0 + r0 + 8 * half;
      if (srow >= S) continue;
      const float den = fmaxf(half ? l1 : l0, 1e-30f);
      __nv_bfloat16* op = out + (((size_t)b * S + srow) * H + h) * DV;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * c + 2 * t) =
            __floats2bfloat162_rn(o[4 * c + 2 * half] / den, o[4 * c + 2 * half + 1] / den);
    }
  }
}

// a 4-d bf16 map (D, heads, rows, B) of a contiguous (B, rows, heads, D)
// tensor whose rows dimension is cut at `extent`; box (64, 1, box_rows, 1),
// 128-byte swizzle, zeros out of bounds
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int heads, int rows,
            int extent, int B, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)extent,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T, int H,
           int KV, int causal, int window, int q_offset, int kv_limit, float scale,
           cudaStream_t stream) {
  using C = Tile<DK, DV>;
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  const int extent = kv_limit > 0 ? kv_limit : 1;  // no tile is loaded at kv_limit 0
  if (!encode(enc, &tq, q, DK, H, S, S, B, BM) ||
      !encode(enc, &tk, k, DK, KV, T > 0 ? T : 1, extent, B, C::BK) ||
      !encode(enc, &tv, v, DV, KV, T > 0 ? T : 1, extent, B, C::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_wgmma_kernel<DK, DV><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, S, H, KV, causal, window, q_offset, kv_limit, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, DK), k (B, T, KV, DK), v (B, T, KV, DV), out (B, S, H, DV):
// contiguous bf16 on the device, 16-byte aligned.  (DK, DV) in {(64, 64),
// (80, 80), (128, 128), (192, 128)}, H % KV == 0, written_upto <= T (the wrapper
// passes T for None).  Launches on `stream` and returns a CUDA error code as
// an int (0 on success).
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int T, int H, int KV, int DK, int DV,
                                     int causal, int window, int q_offset, int written_upto,
                                     float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(dk, dv)                                                                     \
  if (DK == dk && DV == dv)                                                                   \
    return launch<dk, dv>(q, k, v, out, B, S, T, H, KV, causal, window, q_offset, written_upto, \
                          scale, s);
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}
