// pairwise_l2: out[i, j] = max(||q_i||^2 - 2 q_i . x_j + ||x_j||^2, 0).
//
// Replaces the TPU kernel src/repro/kernels/l2.py: pairwise_l2_pallas /
// _l2_kernel (the MXU tile GEMM with the norm epilogue).
//
// Bound on an H100: 2*Q*N*D operations in IEEE float32, which must not go
// to the TF32 tensor cores (the top-k ids that follow have to match the
// reference), so the peak is the 67 TFLOP/s of the float32 FMA units; the
// bytes are (Q*D + N*D + Q*N) * 4.  At the slice's shapes (the cached-row
// scan: Q <= 64 requests by a few hundred cached rows; the IVF coarse
// quantizer: Q requests by 256 centroids; k-means: 1M rows by 256
// centroids) the output write dominates the bytes.
//
// Design: a 64 x 64 output tile per block of 256 threads, each thread a
// 4 x 4 register tile.  The depth runs in chunks of 32 staged in shared
// memory (rows padded to 33 floats so the strided reads hit distinct
// banks); the norms accumulate from the same staged chunks, so q and x
// are read from device memory once per tile.  Ragged Q, N and D are
// masked at the loads and the store, with no padding copies.  A simple
// SIMT GEMM: wgmma/TMA and a TF32-free split-precision scheme are later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // catalog rows per block
constexpr int DK = 32;   // depth chunk staged in shared memory
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int Q, int N, int D) {
  __shared__ float qs[BM][DK + 1];
  __shared__ float xs[BN][DK + 1];
  __shared__ float qn[BM];
  __shared__ float xn[BN];

  const int tid = threadIdx.x;
  const int tq = tid / 16;  // rows tq*4 .. tq*4+3 of the query tile
  const int tr = tid % 16;  // rows tr + 16*j of the catalog tile
  const int q0 = blockIdx.y * BM;
  const int r0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (tid < BM) qn[tid] = 0.f;
  if (tid >= 128 && tid < 128 + BN) xn[tid - 128] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, gd = d0 + c;
      const int gq = q0 + r, gx = r0 + r;
      qs[r][c] = (gq < Q && gd < D) ? q[(size_t)gq * D + gd] : 0.f;
      xs[r][c] = (gx < N && gd < D) ? x[(size_t)gx * D + gd] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
      float s = qn[tid];
#pragma unroll 8
      for (int c = 0; c < DK; ++c) s = fmaf(qs[tid][c], qs[tid][c], s);
      qn[tid] = s;
    } else if (tid >= 128 && tid < 128 + BN) {
      const int r = tid - 128;
      float s = xn[r];
#pragma unroll 8
      for (int c = 0; c < DK; ++c) s = fmaf(xs[r][c], xs[r][c], s);
      xn[r] = s;
    }
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[tq * 4 + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[tr + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = tq * 4 + i, gq = q0 + qi;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rj = tr + 16 * j, gx = r0 + rj;
      if (gx < N)
        out[(size_t)gq * N + gx] = fmaxf(qn[qi] - 2.f * acc[i][j] + xn[rj], 0.f);
    }
  }
}

}  // namespace

// q (Q, D), x (N, D), out (Q, N): contiguous float32 on the device.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int pairwise_l2(const float* q, const float* x, float* out, int Q,
                           int N, int D, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  pairwise_l2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(q, x, out, Q,
                                                                  N, D);
  return (int)cudaGetLastError();
}
