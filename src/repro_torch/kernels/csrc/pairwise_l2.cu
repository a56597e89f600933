// pairwise_l2: out[i, j] = max(||q_i||^2 - 2 q_i . x_j + ||x_j||^2, 0), for
// one (Q, D) x (N, D) pair or for M pairs at once (the PQ distance tables:
// q (M, Q, d), x (M, C, d) -> (Q, M, C)).
//
// Replaces the TPU kernel src/repro/kernels/l2.py: pairwise_l2_pallas /
// _l2_kernel (the MXU tile GEMM with the norm epilogue).
//
// Bound on an H100: 2*Q*N*D operations in IEEE float32, which must not go
// to the TF32 tensor cores (the top-k ids that follow have to match the
// reference, and topk_l2's sample bound counts on these sums erring less
// than l2_topk's), so the peak is the 67 TFLOP/s of the float32 FMA units;
// the bytes are (Q*D + N*D + Q*N) * 4.  The main path's shapes fall into
// three kinds, and each gets its own design, chosen by the wrapper from
// the shape (ops.pairwise_l2_plan), never by a failed launch:
//
// - skinny queries over a large catalog (Q <= 16: the semantic tier's
//   exact scan of 1 or 8 requests over 1M x 1024 rows, the B = 8 scans):
//   bound by the catalog's bytes (4 GB at 1M x 1024, 1.22 ms).  A 64-row
//   tile padded 56 or 63 of its query rows there and spent >= 2 ms on
//   FMAs for nothing.  `pairwise_l2_skinny`: the queries sit in shared
//   memory; each warp streams 32-row tiles of the catalog through its own
//   two-stage shared-memory ring, 64 columns (256 bytes a row) a stage, by
//   16-byte cp.async (zero-filled past N and D), and each lane owns one
//   row: it reads its row's float4s and every query's float4 as a
//   broadcast, so no FMA is spent on padding, and ||x||^2 accumulates from
//   the same loaded row.  Warps loop over the tiles (a persistent grid of
//   one block an SM).
// - small grids (the cached-row scan 64 x 864, the coarse quantizer
//   64 x 256, the PQ tables 64 x 256 x 16 x 8): a 64 x 64 tile gives 14,
//   4 and 32 blocks on 132 SMs; a 32 x 32 tile (2 x 2 outputs a thread, a
//   64-deep chunk: half the round trips to device memory at D = 128)
//   gives four times as many.  These are a few microseconds of work; the
//   wrapper's host cost may set their pace.
// - large grids (k-means' 1M x 256, the 64 x 16384 sample bound): the
//   64 x 64 SIMT tile, each thread 4 x 4 outputs over 32-deep chunks.
//
// Every design sums q . x, ||q||^2 and ||x||^2 with one float32 FMA per
// column in column order, so all three give bitwise the same distances.
// Ragged Q, N and D are masked at the loads and the stores, with no
// padding copies.  The batch index is blockIdx.z, with the queries read
// through strides, so the PQ tables' (M, B, d) view of the requests needs
// no copy and the output lands in adc_lut's (B, M, C) layout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

// ---------------------------------------------------------------- tiles --

// BATCHED: pair blockIdx.z, q and out through strides; else one pair,
// q (Q, D) and out (Q, N) contiguous
template <int BM, int BN, int TM, int TN, int DK, bool BATCHED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
pairwise_l2_tile(const float* __restrict__ q, const float* __restrict__ x,
                 float* __restrict__ out, int Q, int N, int D, long long sqz,
                 long long sqi, long long sxz, long long ldo, long long soz) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int CW = BN / TN;  // threads across the catalog tile
  static_assert(THREADS >= BM + BN, "norms need a thread per row");
  static_assert(BM == BN, "q and x tiles load in one loop");
  __shared__ float qs[BM][DK + 1];
  __shared__ float xs[BN][DK + 1];
  __shared__ float qn[BM];
  __shared__ float xn[BN];

  if (BATCHED) {
    q += blockIdx.z * sqz;
    x += blockIdx.z * sxz;
    out += blockIdx.z * soz;
  }
  const size_t qld = BATCHED ? (size_t)sqi : (size_t)D;
  const size_t ld_out = BATCHED ? (size_t)ldo : (size_t)N;
  const int tid = threadIdx.x;
  const int tq = tid / CW;  // rows tq*TM .. tq*TM+TM-1 of the query tile
  const int tr = tid % CW;  // rows tr + CW*j of the catalog tile
  const int q0 = blockIdx.y * BM;
  const int r0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (tid < BM) qn[tid] = 0.f;
  else if (tid < BM + BN) xn[tid - BM] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, gd = d0 + c;
      const int gq = q0 + r, gx = r0 + r;
      qs[r][c] = (gq < Q && gd < D) ? q[gq * qld + gd] : 0.f;
      xs[r][c] = (gx < N && gd < D) ? x[(size_t)gx * D + gd] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
      float s = qn[tid];
#pragma unroll 8
      for (int c = 0; c < DK; ++c) s = fmaf(qs[tid][c], qs[tid][c], s);
      qn[tid] = s;
    } else if (tid < BM + BN) {
      const int r = tid - BM;
      float s = xn[r];
#pragma unroll 8
      for (int c = 0; c < DK; ++c) s = fmaf(xs[r][c], xs[r][c], s);
      xn[r] = s;
    }
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[tq * TM + i][c];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = xs[tr + CW * j][c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = tq * TM + i, gq = q0 + qi;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int rj = tr + CW * j, gx = r0 + rj;
      if (gx < N) out[gq * ld_out + gx] = fmaxf(qn[qi] - 2.f * acc[i][j] + xn[rj], 0.f);
    }
  }
}

// --------------------------------------------------------------- skinny --

constexpr int SK_WARPS = 8;
constexpr int SK_ROWS = 32;    // catalog rows of a warp's tile, one a lane
constexpr int SK_DK = 64;      // columns of a stage: 256 bytes of each row
constexpr int SK_STAGES = 2;   // a warp's ring
constexpr int SK_LD = SK_DK + 4;  // padded row: conflict-free float4 reads
constexpr int SK_STAGE_FLOATS = SK_ROWS * SK_LD;

__host__ __device__ inline int sk_dpad(int D) { return (D + SK_DK - 1) / SK_DK * SK_DK; }

// the queries' norms take qm floats rounded up to 4, so the rings start
// on 16 bytes (cp.async's 16-byte pieces)
__host__ __device__ inline int sk_qn(int qm) { return (qm + 3) / 4 * 4; }

size_t skinny_smem_bytes(int qm, int D) {
  return sizeof(float) * ((size_t)qm * sk_dpad(D) + sk_qn(qm) +
                          (size_t)SK_WARPS * SK_STAGES * SK_STAGE_FLOATS);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// QM >= Q queries; D % 4 == 0 and x on 16 bytes (the wrapper checks)
template <int QM>
__global__ void __launch_bounds__(SK_WARPS * 32, 1)
pairwise_l2_skinny(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int Q, int N, int D) {
  extern __shared__ __align__(16) float smem[];
  const int dpad = sk_dpad(D);
  float* qs = smem;                    // QM x dpad, zero past D and Q
  float* qn = qs + QM * dpad;          // QM (sk_qn(QM) reserved)
  float* ring = qn + sk_qn(QM);        // SK_WARPS x SK_STAGES x SK_STAGE_FLOATS
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < QM * dpad; e += SK_WARPS * 32) {
    const int i = e / dpad, c = e % dpad;
    qs[e] = (i < Q && c < D) ? q[(size_t)i * D + c] : 0.f;
  }
  __syncthreads();
  // ||q_i||^2 in column order, as every design sums its norms
  for (int i = warp; i < QM; i += SK_WARPS) {
    if (lane == 0) {
      const float* qi = qs + i * dpad;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qi[c], qi[c], s);
      qn[i] = s;
    }
  }
  __syncthreads();

  float* wring = ring + warp * SK_STAGES * SK_STAGE_FLOATS;
  const uint32_t wring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(wring));
  const int nchunks = dpad / SK_DK;
  const int ntiles = (N + SK_ROWS - 1) / SK_ROWS;
  const int gw = blockIdx.x * SK_WARPS + warp, nw = gridDim.x * SK_WARPS;
  const int mine = gw < ntiles ? (ntiles - 1 - gw) / nw + 1 : 0;
  const int steps = mine * nchunks;

  // step s: chunk s % nchunks of this warp's tile s / nchunks; lanes 0-15
  // copy one row's 256 bytes and lanes 16-31 the next row's
  auto issue = [&](int s) {
    if (s < steps) {
      const int tile = gw + (s / nchunks) * nw, chunk = s % nchunks;
      const uint32_t dst0 = wring_u32 + (s % SK_STAGES) * SK_STAGE_FLOATS * 4;
#pragma unroll
      for (int u = 0; u < SK_ROWS * SK_DK / 4 / 32; ++u) {
        const int p = lane + 32 * u, r = p / (SK_DK / 4), c4 = p % (SK_DK / 4);
        const int grow = tile * SK_ROWS + r, gcol = chunk * SK_DK + c4 * 4;
        const bool ok = grow < N && gcol < D;
        cp_async16(dst0 + (r * SK_LD + c4 * 4) * 4,
                   ok ? x + (size_t)grow * D + gcol : x, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[QM], xn = 0.f;
#pragma unroll
  for (int i = 0; i < QM; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<SK_STAGES - 2>();
    __syncwarp();
    issue(s + SK_STAGES - 1);  // into the stage step s - 1 read
    const int chunk = s % nchunks;
    const float* row = wring + (s % SK_STAGES) * SK_STAGE_FLOATS + lane * SK_LD;
    const float* qc = qs + chunk * SK_DK;
#pragma unroll 4
    for (int c4 = 0; c4 < SK_DK / 4; ++c4) {
      const float4 xv = *reinterpret_cast<const float4*>(row + c4 * 4);
      xn = fmaf(xv.x, xv.x, xn);
      xn = fmaf(xv.y, xv.y, xn);
      xn = fmaf(xv.z, xv.z, xn);
      xn = fmaf(xv.w, xv.w, xn);
#pragma unroll
      for (int i = 0; i < QM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qc + i * dpad + c4 * 4);
        acc[i] = fmaf(xv.x, qv.x, acc[i]);
        acc[i] = fmaf(xv.y, qv.y, acc[i]);
        acc[i] = fmaf(xv.z, qv.z, acc[i]);
        acc[i] = fmaf(xv.w, qv.w, acc[i]);
      }
    }
    __syncwarp();
    if (chunk == nchunks - 1) {  // the tile's last chunk: write, reset
      const int grow = (gw + (s / nchunks) * nw) * SK_ROWS + lane;
      if (grow < N) {
#pragma unroll
        for (int i = 0; i < QM; ++i)
          if (i < Q) out[(size_t)i * N + grow] = fmaxf(qn[i] - 2.f * acc[i] + xn, 0.f);
      }
#pragma unroll
      for (int i = 0; i < QM; ++i) acc[i] = 0.f;
      xn = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <int QM>
int launch_skinny(const float* q, const float* x, float* out, int Q, int N, int D,
                  int blocks, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        pairwise_l2_skinny<QM>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const size_t smem = skinny_smem_bytes(QM, D);
  pairwise_l2_skinny<QM><<<blocks, SK_WARPS * 32, smem, stream>>>(q, x, out, Q, N, D);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int TM, int TN, int DK>
int launch_tile(const float* q, const float* x, float* out, int Q, int N, int D, int M,
                long long sqz, long long sqi, long long sxz, long long ldo, long long soz,
                cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM, M);
  constexpr int threads = (BM / TM) * (BN / TN);
  if (M > 1 || sqi != D || ldo != N)
    pairwise_l2_tile<BM, BN, TM, TN, DK, true><<<grid, threads, 0, stream>>>(
        q, x, out, Q, N, D, sqz, sqi, sxz, ldo, soz);
  else
    pairwise_l2_tile<BM, BN, TM, TN, DK, false><<<grid, threads, 0, stream>>>(
        q, x, out, Q, N, D, sqz, sqi, sxz, ldo, soz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long pairwise_l2_skinny_smem_bytes(int qm, int D) {
  return (long long)skinny_smem_bytes(qm, D);
}

// kind 0: the 64 x 64 tile, 1: the 32 x 32 tile, both over M pairs (grid
// z), q's element (z, i, c) at q[z*sqz + i*sqi + c], x (M, N, D)
// contiguous with sxz = N*D, out's element (z, i, j) at
// out[z*soz + i*ldo + j]; kind 2: the skinny design for one pair, q
// (Q, D) and x (N, D) contiguous, out (Q, N), qm the template's bound on
// Q (1, 2, 4, 8 or 16), `blocks` its persistent grid.  Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int pairwise_l2(const float* q, const float* x, float* out, int Q, int N, int D,
                           int M, long long sqz, long long sqi, long long sxz,
                           long long ldo, long long soz, int kind, int qm, int blocks,
                           void* stream) {
  if (Q <= 0 || N <= 0 || M <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      return launch_tile<64, 64, 4, 4, 32>(q, x, out, Q, N, D, M, sqz, sqi, sxz, ldo, soz, s);
    case 1:
      return launch_tile<32, 32, 2, 2, 64>(q, x, out, Q, N, D, M, sqz, sqi, sxz, ldo, soz, s);
    case 2:
      if (M != 1 || Q > qm || D % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
          skinny_smem_bytes(qm, D) > (size_t)SMEM_MAX)
        return (int)cudaErrorInvalidValue;
      switch (qm) {
        case 1: return launch_skinny<1>(q, x, out, Q, N, D, blocks, s);
        case 2: return launch_skinny<2>(q, x, out, Q, N, D, blocks, s);
        case 4: return launch_skinny<4>(q, x, out, Q, N, D, blocks, s);
        case 8: return launch_skinny<8>(q, x, out, Q, N, D, blocks, s);
        case 16: return launch_skinny<16>(q, x, out, Q, N, D, blocks, s);
      }
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaErrorInvalidValue;
}
