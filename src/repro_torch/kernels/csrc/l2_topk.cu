// l2_topk: fused squared-L2 distance + per-block top-k; the (Q, N)
// distance matrix never reaches device memory.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py: l2_topk_pallas /
// _l2_topk_kernel with extract_block_topk (each 128 x 128 tile emits its k
// smallest (distance, global id); the wrapper merges the partials).
//
// Bound on an H100: one read of the catalog, N*D*4 bytes (512 MB at
// 1M x 128: 0.153 ms at 3.35 TB/s; 4.1 GB at 1M x 1024: 1.22 ms), against
// 2*Q*N*D operations, 16.4 GFLOP at Q 64 x 1M x 128: 0.033 ms at the
// 495 TFLOP/s TF32 tensor-core rate.  On the tensor cores the kernel is
// bound by the bytes.  The float32 FMA version before it ran at about
// 5 TFLOP/s and held the query tile at full depth in shared memory, so no
// tile fit at D 4096.
//
// Why split precision: a plain TF32 product keeps 11 bits of each operand
// and changes which ids make a top k.  Each operand is split into a TF32
// high part and a TF32 remainder, v = hi + lo, and the product is
// x_lo.q_hi + x_hi.q_lo + x_hi.q_hi, accumulated in float32 (3xTF32): only
// x_lo.q_lo (about 2^-22 of each term) is dropped, about the rounding of a
// float32 product.  The tensor cores round their sums toward zero; summed
// over the whole depth in one accumulator, that bias reached 1.5e-4 at
// 1M x 128 (values in [0, 1)), the size of the check's tolerance, so each
// 64-deep chunk sums into a fresh accumulator, the small products first,
// that is added to the running distance with a float32 add (round to
// nearest): the dot products then err less than a float32 loop's.
//
// Why wgmma and TMA: a first version ran the three products as mma.sync
// m16n8k8 with every warp splitting its own fragments, and loaded chunks by
// 16-byte cp.async from every thread; it streamed at about 0.9 TB/s
// whatever its work.  Here thread 0 keeps a ring of stages filled by TMA, and each
// warpgroup issues asynchronous wgmma, three a k-step: the catalog rows as
// A from registers (each thread reads and splits its fragment once), the
// queries as B from shared memory, split by the wrapper (q_hi, q_lo).  A
// step's products run on while the next step's fragments are read; a
// stage goes back to the producer (an mbarrier) once both warpgroups have
// waited for the products that read it.  Alone, the TMA loads stream
// near the bytes bound, and the products at the TF32 rate take about two
// thirds of it (0.39 TFLOP of the three products at 1M x 1024, Q 64).
//
// Design: a block holds BQ = 16*QT queries and walks a contiguous run of
// catalog rows in tiles of BN = 128 (two warpgroups of 64 rows), so each
// catalog row is read from device memory once per query tile; the query
// tiles are the fastest grid dimension, so the tiles that share a run of
// rows are resident together and share it through L2.  The depth is
// streamed in 64-deep chunks, two 128-byte sub-rows a row with the 128-byte
// swizzle wgmma reads, so shared memory does not grow with D: a 64-query
// tile fits at every width.  wgmma computes the (catalog row x query)
// tile, so small batches cost no padding: BQ is the instruction's N.  The
// catalog rows' squared norms are summed in float32 from the fragments.
// Each finished tile gets the norm epilogue max(|q|^2 - 2 q.x + |x|^2, 0)
// and the row masks (end of the run, optional `valid`, and rows beyond the
// query's `tau` bound: +inf), written transposed over the stage just
// consumed; then selection keeps one sorted top-k list per query in
// shared memory: a warp ballots the tile's distances below the list's
// current k-th value and, when some pass, takes the list into registers
// and inserts them in ascending row order (the lowest id wins a tie, as in
// topk_common.cuh), by ballots and shuffles.  A list longer than REG_K
// (128: four slots a lane) is not taken into registers: the warp inserts
// into it in shared memory (topk_common.cuh's warp_insert), in the same
// order, so k up to TOPK_MAX_K (1024) keeps the tie rule; its BQ x k lists
// make the wrapper's plan shrink the query tile (16 queries at k 1024).  Building a list costs about
// k (1 + ln(run / k)) inserts a query in every block; the wrapper's bound
// (`tau`) cuts that to about k N / 16384.  The per-block lists go out as
// (Q, nblocks*k) partials in block order, and the wrapper merges them with
// one stable sort (as the reference merges outside the Pallas body).
#include "hopper_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int BN = 128;      // catalog rows per tile: two warpgroups of 64
constexpr int DK = 64;       // depth chunk
constexpr int ROW = 128;     // bytes of a swizzled sub-row: 32 floats
constexpr int SUB = DK / 32; // sub-rows a row of a chunk
constexpr int STAGES = 2;    // depth of the ring
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int REG_K = 128;   // longest list a warp selects into in registers

__host__ __device__ constexpr int q_tile(int qt) { return 16 * qt; }

// one ring stage: the catalog rows' chunk (float32), the queries' TF32 hi
// and lo halves; all 1 KB aligned
__host__ __device__ constexpr int stage_bytes(int bq) { return (BN + 2 * bq) * ROW * SUB; }

// byte offset of float c (0..DK) of row r in a chunk of `rows` rows: sub-row
// c / 32 in block c / 32 (128-byte rows), where the 16-byte unit c / 4 % 8
// moves to (c / 4 % 8) ^ (r % 8), the 128-byte swizzle of TMA and wgmma
__device__ __forceinline__ int swz(int r, int c, int rows) {
  return (c >> 5) * rows * ROW + r * ROW + (((((c >> 2) & 7) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// v = hi + lo with hi, lo TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}


// d (64 catalog rows x BQ queries, f32) = [d +] A (64 x 8) . B (BQ x 8)^T:
// A TF32 fragments in registers (the m16n8k8 layout, a warp's 16 rows), B
// TF32 in shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_n16(float* d, const uint32_t* a, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The list of the query a warp is selecting for, in registers: entry
// j = lane + 32 m sits in (rv[m], ri[m]) of lane `lane` (k <= REG_K: four
// slots a lane), ascending, +inf / -1 in the unused tail.  Its k-th value:
__device__ __forceinline__ float reg_kth(const float (&rv)[4], int k) {
  const int m = (k - 1) >> 5;
  const float x = m == 0 ? rv[0] : m == 1 ? rv[1] : m == 2 ? rv[2] : rv[3];
  return __shfl_sync(TOPK_FULL_MASK, x, (k - 1) & 31);
}

// Insert (v, id) after every entry <= v, so equal distances keep the lowest
// id first (candidates come in ascending id order).  The whole warp calls it
// with the same arguments, and only when v is below the k-th value, so the
// last entry drops.  Ballots and shuffles only: no shared memory.
__device__ __forceinline__ void reg_insert(float (&rv)[4], int (&ri)[4], int k, float v,
                                           int id, int lane) {
  int pos = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (32 * m < k)
      pos += __popc(__ballot_sync(TOPK_FULL_MASK, lane + 32 * m < k && rv[m] <= v));
#pragma unroll
  for (int m = 3; m >= 0; --m) {  // each slot reads its old left neighbour
    if (32 * m >= k) continue;
    float up = __shfl_up_sync(TOPK_FULL_MASK, rv[m], 1);
    int upi = __shfl_up_sync(TOPK_FULL_MASK, ri[m], 1);
    if (m > 0) {
      const float cv = __shfl_sync(TOPK_FULL_MASK, rv[m > 0 ? m - 1 : 0], 31);
      const int ci = __shfl_sync(TOPK_FULL_MASK, ri[m > 0 ? m - 1 : 0], 31);
      if (lane == 0) {
        up = cv;
        upi = ci;
      }
    }
    const int j = lane + 32 * m;
    if (j > pos) {
      rv[m] = up;
      ri[m] = upi;
    } else if (j == pos) {
      rv[m] = v;
      ri[m] = id;
    }
  }
}

template <int BQ>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db, int acc) {
  if constexpr (BQ == 16) wgmma_tf32_n16(d, a, db, acc);
  else if constexpr (BQ == 32) wgmma_tf32_n32(d, a, db, acc);
  else wgmma_tf32_n64(d, a, db, acc);
}

// One block: BQ queries against a run of catalog rows.  Thread 0 keeps
// the ring filled by TMA; both warpgroups read their catalog fragments,
// wait for the previous step's products, release that step's stage, and
// issue this step's.
template <int QT>
__global__ void __launch_bounds__(THREADS)
l2_topk_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_qh,
               const __grid_constant__ CUtensorMap tm_ql, const float* __restrict__ qn_in,
               const uint8_t* __restrict__ valid, const float* __restrict__ tau,
               float* __restrict__ out_d, int* __restrict__ out_i, int Q, int N, int D, int k,
               int chunk) {
  constexpr int BQ = q_tile(QT);
  constexpr int STAGE = stage_bytes(BQ);
  constexpr int XB = BN * ROW * SUB, QB = BQ * ROW * SUB;  // bytes of a chunk's rows / queries
  constexpr int ACC = BQ / 2;                              // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  // stage s: x at ring + s*STAGE, q hi + XB, q lo + XB + QB
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(ring + STAGES * STAGE);  // STAGES mbarriers: landed
  const uint32_t empty = full + 8 * STAGES;               // STAGES mbarriers: released
  float* qn = reinterpret_cast<float*>(ring + STAGES * STAGE + 16 * STAGES);  // BQ
  float* xn = qn + BQ;                                    // BN
  float* lv = xn + BN;                                    // BQ x k, running top-k values
  int* li = reinterpret_cast<int*>(lv + BQ * k);          // BQ x k, their ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int row_begin = blockIdx.y * chunk;
  const int row_end = min(N, row_begin + chunk);
  const int nd = (D + DK - 1) / DK;
  const int total = (row_end - row_begin + BN - 1) / BN * nd;  // (tile, depth chunk) steps
  const float inf = __int_as_float(0x7f800000);

  for (int e = tid; e < BQ * k; e += THREADS) {
    lv[e] = inf;
    li[e] = -1;
  }
  for (int e = tid; e < BQ; e += THREADS) qn[e] = q0 + e < Q ? qn_in[q0 + e] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0: step it (depth chunk it % nd of catalog tile it / nd) into
  // stage buf.  TMA zero-fills rows past N and Q and columns past D; rows
  // past the run are masked in the epilogue.
  auto load = [&](int it, int buf) {
    const uint32_t base = smem_u32(ring + buf * STAGE), bar = full + 8 * buf;
    const int d0 = (it % nd) * DK;
    const int r0 = row_begin + (it / nd) * BN;
    mbar_expect_tx(bar, XB + 2 * QB);
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      tma_load_2d(base + u * BN * ROW, &tm_x, bar, d0 + 32 * u, r0);
      tma_load_2d(base + XB + u * BQ * ROW, &tm_qh, bar, d0 + 32 * u, q0);
      tma_load_2d(base + XB + QB + u * BQ * ROW, &tm_ql, bar, d0 + 32 * u, q0);
    }
  };
  if (tid == 0)
    for (int s = 0; s < STAGES - 1 && s < total; ++s) load(s, s);

  // acc: the tile's (catalog row x query) products, in the wgmma fragment:
  // rows wr and wr + 8, queries 8 i + 2 t (+ 1); part: one step's, added
  // to acc once they are waited for, while the next step's loads and
  // fragments proceed
  const int wr = wg * 64 + (warp & 3) * 16 + g;
  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
  float xn0 = 0.f, xn1 = 0.f;  // squared norms of rows wr, wr + 8: a quad of lanes
  bool pending = false;
  const bool leader = (tid & 127) == 0;

  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES;
    const uint8_t* st = ring + s * STAGE;
    const int tile = it / nd;
    const bool last = it % nd == nd - 1;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);

    // this warpgroup's catalog fragments, split in registers: A of wgmma
    const float* xs = reinterpret_cast<const float*>(st);
    uint32_t ah[DK / 8][4], al[DK / 8][4];
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      const float f0 = xs[swz(wr, 8 * ks + t, BN) / 4];
      const float f1 = xs[swz(wr + 8, 8 * ks + t, BN) / 4];
      const float f2 = xs[swz(wr, 8 * ks + t + 4, BN) / 4];
      const float f3 = xs[swz(wr + 8, 8 * ks + t + 4, BN) / 4];
      xn0 = fmaf(f0, f0, fmaf(f2, f2, xn0));
      xn1 = fmaf(f1, f1, fmaf(f3, f3, xn1));
      split_tf32(f0, ah[ks][0], al[ks][0]);
      split_tf32(f1, ah[ks][1], al[ks][1]);
      split_tf32(f2, ah[ks][2], al[ks][2]);
      split_tf32(f3, ah[ks][3], al[ks][3]);
    }

    // the previous step's products are done: its stage goes back to the
    // producer, which refills it with step it + STAGES - 1
    if (pending) {
      wgmma_wait_all();
      fence_regs<ACC>(part);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
      if (leader) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    if (tid == 0 && it + STAGES - 1 < total) {
      const int buf = (it + STAGES - 1) % STAGES;
      if (it >= 1) mbar_wait(empty + 8 * buf, ((it - 1) / STAGES) & 1);
      load(it + STAGES - 1, buf);
    }

    // part = x_lo.q_hi + x_hi.q_lo + x_hi.q_hi over the step's k-steps, the
    // small products first: while they sum, part stays small, so only the
    // eight x_hi.q_hi products see part's rounding toward zero at full size
    const uint32_t qh = smem_u32(st + XB), ql = smem_u32(st + XB + QB);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      const int off = (ks / 4) * BQ * ROW + (ks % 4) * 32;  // k-step ks's 32 bytes
      wgmma_tf32<BQ>(part, al[ks], sw128_desc(qh + off, 16, 1024), ks > 0);
      wgmma_tf32<BQ>(part, ah[ks], sw128_desc(ql + off, 16, 1024), 1);
    }
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      const int off = (ks / 4) * BQ * ROW + (ks % 4) * 32;
      wgmma_tf32<BQ>(part, ah[ks], sw128_desc(qh + off, 16, 1024), 1);
    }
    wgmma_commit();
    pending = !last;
    if (!last) continue;
    wgmma_wait_all();
    fence_regs<ACC>(part);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] += part[i];

    // the tile is complete: norms, epilogue, selection
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      xn0 += __shfl_xor_sync(TOPK_FULL_MASK, xn0, o);
      xn1 += __shfl_xor_sync(TOPK_FULL_MASK, xn1, o);
    }
    if (t == 0) {
      xn[wr] = xn0;
      xn[wr + 8] = xn1;
    }
    xn0 = xn1 = 0.f;
    __syncthreads();  // norms written; every warpgroup is done with the stage
    // ds: BQ x BN over the spent stage; row qi's column j sits at
    // j ^ (qi % 32), so the transposed writes spread over the banks
    float* ds = reinterpret_cast<float*>(ring + s * STAGE);
    static_assert(BQ * BN * 4 <= STAGE, "the distance tile fits a stage");
    const int r0 = row_begin + tile * BN;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int qi = 8 * (i / 4) + 2 * t + (i & 1);
      const int rj = wr + (i & 2) * 4, gx = r0 + rj;
      float dv = fmaxf(qn[qi] - 2.f * acc[i] + xn[rj], 0.f);
      if (gx >= row_end || (valid != nullptr && !valid[gx])) dv = inf;
      ds[qi * BN + (rj ^ (qi & 31))] = dv;
      acc[i] = 0.f;
    }
    fence_proxy_async();  // ds is written over a stage TMA refills
    __syncthreads();

    // selection: a warp a query; the list comes into registers only when
    // some distance of the tile is at most the query's bound and below its
    // k-th value
    for (int qi = warp; qi < BQ && q0 + qi < Q; qi += WARPS) {
      float* L = lv + qi * k;
      int* I = li + qi * k;
      const float bound = tau != nullptr ? tau[q0 + qi] : inf;
      float v[BN / 32];
      unsigned any = 0;
#pragma unroll
      for (int p = 0; p < BN / 32; ++p) {
        v[p] = ds[qi * BN + ((p * 32 + lane) ^ (qi & 31))];
        if (v[p] > bound) v[p] = inf;
        any |= __ballot_sync(TOPK_FULL_MASK, v[p] < L[k - 1]);
      }
      if (!any) continue;
      if (k > REG_K) {
        // a list longer than the registers hold stays in shared memory,
        // where the warp inserts into it (topk_common.cuh), same order
        float kth = L[k - 1];
#pragma unroll
        for (int p = 0; p < BN / 32; ++p) {
          unsigned m = __ballot_sync(TOPK_FULL_MASK, v[p] < kth);
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float cv = __shfl_sync(TOPK_FULL_MASK, v[p], src);
            if (cv < kth) {
              warp_insert(L, I, k, cv, r0 + p * 32 + src, lane);
              kth = L[k - 1];
            }
          }
        }
        continue;
      }
      float rv[4];
      int ri[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = lane + 32 * m;
        rv[m] = j < k ? L[j] : inf;
        ri[m] = j < k ? I[j] : -1;
      }
      float kth = reg_kth(rv, k);
#pragma unroll
      for (int p = 0; p < BN / 32; ++p) {
        unsigned m = __ballot_sync(TOPK_FULL_MASK, v[p] < kth);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cv = __shfl_sync(TOPK_FULL_MASK, v[p], src);
          if (cv < kth) {
            reg_insert(rv, ri, k, cv, r0 + p * 32 + src, lane);
            kth = reg_kth(rv, k);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = lane + 32 * m;
        if (j < k) {
          L[j] = rv[m];
          I[j] = ri[m];
        }
      }
    }
    __syncthreads();  // ds is read: the stage goes back to the producer
    if (leader) mbar_arrive(empty + 8 * s);
  }
  __syncthreads();

  const size_t stride = (size_t)gridDim.y * k;
  for (int e = tid; e < BQ * k; e += THREADS) {
    const int qi = e / k, j = e % k, gq = q0 + qi;
    if (gq < Q) {
      out_d[(size_t)gq * stride + (size_t)blockIdx.y * k + j] = lv[e];
      out_i[(size_t)gq * stride + (size_t)blockIdx.y * k + j] = li[e];
    }
  }
}

// the depth is streamed, so D does not enter; it stays an argument so the
// wrapper's plan reads one function of (qt, D, k)
size_t smem_bytes(int qt, int /*D*/, int k) {
  const int bq = q_tile(qt);
  return 1024 + (size_t)STAGES * stage_bytes(bq) + 16 * STAGES +
         sizeof(float) * ((size_t)bq + BN + 2 * (size_t)bq * k);
}

// a 2-d float32 map of a contiguous (rows, D) matrix: box (32, box_rows),
// 128-byte swizzle, zeros out of bounds
bool encode(EncodeTiled enc, CUtensorMap* map, const float* ptr, int D, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {ROW / 4, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QT>
int launch(const float* q_hi, const float* q_lo, const float* qn, const float* x,
           const uint8_t* valid, const float* tau, float* out_d, int* out_i, int Q, int N, int D,
           int k, int chunk, int nchunks, cudaStream_t stream) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_x, tm_qh, tm_ql;
  if (!encode(enc, &tm_x, x, D, N, BN) || !encode(enc, &tm_qh, q_hi, D, Q, q_tile(QT)) ||
      !encode(enc, &tm_ql, q_lo, D, Q, q_tile(QT)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(QT, D, k);
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + q_tile(QT) - 1) / q_tile(QT), nchunks);
  l2_topk_kernel<QT><<<grid, THREADS, smem, stream>>>(tm_x, tm_qh, tm_ql, qn, valid, tau, out_d,
                                                      out_i, Q, N, D, k, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs (the wrapper refuses shapes whose
// need exceeds the card's 227 KB per block).
extern "C" long long l2_topk_smem_bytes(int qt, int D, int k) {
  return (long long)smem_bytes(qt, D, k);
}

// q_hi, q_lo (Q, D): the queries' TF32 split (q = q_hi + q_lo, each
// rounded to nearest, as cvt.rna.tf32); qn (Q,): their squared norms; x
// (N, D): the catalog.  All float32, contiguous, 16-byte aligned, D % 4 ==
// 0 (TMA).  valid (N,) bool or NULL; tau (Q,) float32 or NULL: per query,
// a distance that no row of its top k exceeds (rows farther away are never
// offered to its list); out_d / out_i (Q, nchunks*k).  Block y scans rows
// [y*chunk, min(N, (y+1)*chunk)).  qt in {1, 2, 4} sets the query tile
// (16*qt).  k <= TOPK_MAX_K.  Launches on `stream` and returns a CUDA error code as
// an int (0 on success).
extern "C" int l2_topk_partial(const float* q_hi, const float* q_lo, const float* qn,
                               const float* x, const uint8_t* valid, const float* tau,
                               float* out_d, int* out_i, int Q, int N, int D, int k, int chunk,
                               int nchunks, int qt, void* stream) {
  if (Q <= 0 || nchunks <= 0) return 0;
  if (k < 1 || k > TOPK_MAX_K || D % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qt) {
    case 1: return launch<1>(q_hi, q_lo, qn, x, valid, tau, out_d, out_i, Q, N, D, k, chunk, nchunks, s);
    case 2: return launch<2>(q_hi, q_lo, qn, x, valid, tau, out_d, out_i, Q, N, D, k, chunk, nchunks, s);
    case 4: return launch<4>(q_hi, q_lo, qn, x, valid, tau, out_d, out_i, Q, N, D, k, chunk, nchunks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
