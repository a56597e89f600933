// l2_topk: fused squared-L2 distance + per-block top-k; the (Q, N)
// distance matrix never reaches device memory.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py: l2_topk_pallas /
// _l2_topk_kernel with extract_block_topk (each 128 x 128 tile emits its k
// smallest (distance, global id); the wrapper merges the partials).
//
// Bound on an H100: one read of the catalog, N*D*4 bytes (512 MB at
// 1M x 128, 0.15 ms at 3.35 TB/s), against 2*Q*N*D float32 operations on
// the 67 TFLOP/s FMA units (16.4 GFLOP at Q = 64: 0.25 ms).  Small batches
// are bound by the bytes, Q = 64 by the operations.  TF32 tensor cores are
// off the table: a TF32 product changes which ids make the top k.
//
// Design: a block holds a tile of 16*QT queries in shared memory and walks
// a contiguous run of catalog rows in tiles of 64, so each catalog row is
// read from device memory once per query tile; the query tiles are the
// fastest grid dimension, so the tiles that share a run of rows are
// resident together and share it through L2.  Each 64-row tile is a
// register-blocked float32 GEMM (QT x 4 outputs per thread, depth staged
// in chunks of 32) with the norm epilogue and the clamp, then the row
// masks (end of the run, optional `valid`) set +inf.  Selection keeps one
// sorted top-k list per query in shared memory: a warp ballots the tile's
// distances below the list's current k-th value and inserts the few that
// pass, in ascending row order (topk_common.cuh).  Past the first tiles
// almost nothing passes, so selection costs little beside the GEMM.  The
// per-block lists go out as (Q, nblocks*k) partials in block order, and
// the wrapper merges them with one stable sort (as the reference merges
// outside the Pallas body).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int BN = 64;       // catalog rows per tile
constexpr int DK = 32;       // depth chunk of the catalog tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__host__ __device__ constexpr int q_tile(int qt) { return 16 * qt; }

template <int QT>
__global__ void __launch_bounds__(THREADS)
l2_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
               const uint8_t* __restrict__ valid, float* __restrict__ out_d,
               int* __restrict__ out_i, int Q, int N, int D, int k,
               int chunk) {
  constexpr int BQ = q_tile(QT);
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ x (D + 1), resident queries
  float* xs = qs + BQ * (D + 1);       // BN x (DK + 1), catalog chunk
  float* ds = xs + BN * (DK + 1);      // BQ x (BN + 1), tile distances
  float* qn = ds + BQ * (BN + 1);      // BQ
  float* xn = qn + BQ;                 // BN
  float* lv = xn + BN;                 // BQ x k, running top-k values
  int* li = reinterpret_cast<int*>(lv + BQ * k);  // BQ x k, their ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = tid / 16, tr = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int row_begin = blockIdx.y * chunk;
  const int row_end = min(N, row_begin + chunk);
  const float inf = __int_as_float(0x7f800000);

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, gq = q0 + r;
    qs[r * (D + 1) + c] = gq < Q ? q[(size_t)gq * D + c] : 0.f;
  }
  for (int e = tid; e < BQ * k; e += THREADS) {
    lv[e] = inf;
    li[e] = -1;
  }
  __syncthreads();
  if (tid < BQ) {
    float s = 0.f;
    for (int c = 0; c < D; ++c) s = fmaf(qs[tid * (D + 1) + c], qs[tid * (D + 1) + c], s);
    qn[tid] = s;
  }

  for (int r0 = row_begin; r0 < row_end; r0 += BN) {
    float acc[QT][4];
#pragma unroll
    for (int i = 0; i < QT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // xn of the previous tile was last read before the barrier ahead of
    // its selection, so resetting it here races with nothing
    if (tid < BN) xn[tid] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // the previous chunk's readers are done with xs
      for (int e = tid; e < BN * DK; e += THREADS) {
        const int r = e / DK, c = e % DK, gx = r0 + r, gd = d0 + c;
        xs[r * (DK + 1) + c] =
            (gx < row_end && gd < D) ? x[(size_t)gx * D + gd] : 0.f;
      }
      __syncthreads();
      if (tid < BN) {
        float s = xn[tid];
#pragma unroll 8
        for (int c = 0; c < DK; ++c) {
          const float v = xs[tid * (DK + 1) + c];
          s = fmaf(v, v, s);
        }
        xn[tid] = s;
      }
      const int dk = min(DK, D - d0);
      for (int c = 0; c < dk; ++c) {
        float a[QT], b[4];
#pragma unroll
        for (int i = 0; i < QT; ++i) a[i] = qs[(tq * QT + i) * (D + 1) + d0 + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[(tr + 16 * j) * (DK + 1) + c];
#pragma unroll
        for (int i = 0; i < QT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // xn complete

#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int qi = tq * QT + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rj = tr + 16 * j, gx = r0 + rj;
        float dv = fmaxf(qn[qi] - 2.f * acc[i][j] + xn[rj], 0.f);
        if (gx >= row_end || (valid != nullptr && !valid[gx])) dv = inf;
        ds[qi * (BN + 1) + rj] = dv;
      }
    }
    __syncthreads();

    for (int qi = warp; qi < BQ && q0 + qi < Q; qi += WARPS) {
      float* L = lv + qi * k;
      int* I = li + qi * k;
#pragma unroll
      for (int half = 0; half < BN / 32; ++half) {
        const float v = ds[qi * (BN + 1) + half * 32 + lane];
        unsigned m = __ballot_sync(TOPK_FULL_MASK, v < L[k - 1]);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cv = __shfl_sync(TOPK_FULL_MASK, v, src);
          if (cv < L[k - 1]) warp_insert(L, I, k, cv, r0 + half * 32 + src, lane);
        }
      }
    }
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

size_t smem_bytes(int qt, int D, int k) {
  const int bq = q_tile(qt);
  return sizeof(float) * ((size_t)bq * (D + 1) + BN * (DK + 1) +
                          (size_t)bq * (BN + 1) + bq + BN + 2 * (size_t)bq * k);
}

template <int QT>
int launch(const float* q, const float* x, const uint8_t* valid, float* out_d,
           int* out_i, int Q, int N, int D, int k, int chunk, int nchunks,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(QT, D, k);
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + q_tile(QT) - 1) / q_tile(QT), nchunks);
  l2_topk_kernel<QT><<<grid, THREADS, smem, stream>>>(q, x, valid, out_d, out_i,
                                                      Q, N, D, k, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs (the wrapper refuses shapes whose
// need exceeds the card's 227 KB per block).
extern "C" long long l2_topk_smem_bytes(int qt, int D, int k) {
  return (long long)smem_bytes(qt, D, k);
}

// q (Q, D), x (N, D) float32; valid (N,) bool or NULL; out_d / out_i
// (Q, nchunks*k).  Block y scans rows [y*chunk, min(N, (y+1)*chunk)).
// qt in {1, 2, 4} sets the query tile (16*qt).  k <= 128.  Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int l2_topk_partial(const float* q, const float* x,
                               const uint8_t* valid, float* out_d, int* out_i,
                               int Q, int N, int D, int k, int chunk,
                               int nchunks, int qt, void* stream) {
  if (Q <= 0 || nchunks <= 0) return 0;
  if (k < 1 || k > TOPK_MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qt) {
    case 1: return launch<1>(q, x, valid, out_d, out_i, Q, N, D, k, chunk, nchunks, s);
    case 2: return launch<2>(q, x, valid, out_d, out_i, Q, N, D, k, chunk, nchunks, s);
    case 4: return launch<4>(q, x, valid, out_d, out_i, Q, N, D, k, chunk, nchunks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
