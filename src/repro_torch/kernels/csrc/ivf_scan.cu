// ivf_scan: gather catalog rows at a per-query candidate-id table, squared
// L2 by difference, per-block top-k of positions along the table.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py: ivf_scan_pallas /
// _ivf_scan_kernel (8 x 128 tiles of the (B, P) table gathered from a
// VMEM-resident catalog, each emitting its k best positions).
//
// Bound on an H100: the bytes of the distinct rows the table names, U*D*4
// for U distinct valid ids, plus the (B, P) table itself; 3*V*D float32
// operations for V valid slots are far below the FMA peak.  The gather is
// the cost.  At 1M x 128 with nprobe = 16 of 256 lists a query names about
// 32 MB of rows, and 64 queries together name nearly the whole catalog.
//
// Design: the catalog stays in device memory (the TPU kernel's VMEM
// residency limit does not apply) and rows are gathered straight from it.
// Block (x, b) takes query b and one contiguous run of P; each of its 8
// warps walks its own contiguous sub-run, four candidates at a time: the
// lanes read each row in 128-byte coalesced pieces, accumulate
// sum((x - q)^2) by difference (as the reference does, not by the GEMM
// expansion, which rounds differently), and reduce by shuffles.  -1 slots
// (list padding, folded tombstones) and ids outside [0, N) read nothing
// and score +inf.  Each warp keeps a running sorted top-k of (distance,
// position) in shared memory (topk_common.cuh), and the block merges its
// eight lists into one, so a block writes k entries for its run of P and
// (B, P) distances are never materialised.  Blocks go out in ascending
// position order; the wrapper merges them with one stable sort and maps
// positions to ids.  Each query gathers its own rows, so a row that
// several queries of a batch probe is read once for each of them; the IVF
// probe, whose table is whole inverted lists, takes the list-major kernel
// instead (ivf_scan_lists.cu), which reads a list once for all its
// queries.  This kernel serves tables of arbitrary ids: LSH's buckets, the
// exact re-rank of retrieved ids and IVF-PQ's refine.  A warp's sub-run is
// an eighth of its block's real run, not of the nominal chunk, so a short
// table keeps all eight warps busy.
#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // candidates in flight per warp

__global__ void __launch_bounds__(THREADS)
ivf_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const int* __restrict__ cand, float* __restrict__ out_d,
                int* __restrict__ out_p, int N, int D, int P, int k,
                int chunk) {
  extern __shared__ float smem[];
  float* qs = smem;                                   // D
  float* lv = qs + D;                                 // WARPS x k
  int* li = reinterpret_cast<int*>(lv + WARPS * k);   // WARPS x k

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const float inf = __int_as_float(0x7f800000);

  for (int c = tid; c < D; c += THREADS) qs[c] = q[(size_t)b * D + c];
  for (int e = tid; e < WARPS * k; e += THREADS) {
    lv[e] = inf;
    li[e] = -1;
  }
  __syncthreads();

  const int blk_begin = blockIdx.x * chunk;
  const int blk_end = min(P, blk_begin + chunk);
  // each warp a share of the block's real run, so a short table (the
  // IVF-PQ re-rank's 256 slots) still spreads over all eight warps
  const int sub = (blk_end - blk_begin + WARPS - 1) / WARPS;
  const int w_begin = min(blk_end, blk_begin + warp * sub);
  const int w_end = min(blk_end, w_begin + sub);
  float* L = lv + warp * k;
  int* I = li + warp * k;
  const int* crow = cand + (size_t)b * P;

  for (int p0 = w_begin; p0 < w_end; p0 += UNROLL) {
    int id[UNROLL];
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u;
      const int c = p < w_end ? crow[p] : -1;
      id[u] = (c >= 0 && c < N) ? c : -1;
      acc[u] = 0.f;
    }
    for (int c = lane; c < D; c += 32) {
      const float qc = qs[c];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (id[u] >= 0) {
          const float diff = x[(size_t)id[u] * D + c] - qc;
          acc[u] = fmaf(diff, diff, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float dv = id[u] >= 0 ? warp_sum_float(acc[u]) : inf;
      if (dv < L[k - 1]) warp_insert(L, I, k, dv, p0 + u, lane);
    }
  }
  __syncthreads();

  // Merge the warp lists into the block's k best.  Entry (v, w, i) of
  // warp w's list ranks after every entry of a lower warp with value <= v
  // and of a higher warp with value < v: ordering by (value, warp, slot)
  // is ordering by (value, position), so ties keep the lowest position.
  // The ranks are distinct, and the k smallest go straight out.
  float* od = out_d + ((size_t)b * gridDim.x + blockIdx.x) * k;
  int* op = out_p + ((size_t)b * gridDim.x + blockIdx.x) * k;
  for (int e = tid; e < WARPS * k; e += THREADS) {
    const int w = e / k;
    const float v = lv[e];
    int rank = e - w * k;
    for (int w2 = 0; w2 < WARPS && rank < k; ++w2) {
      if (w2 == w) continue;
      const float* M = lv + w2 * k;
      int lo = 0, hi = k;  // first slot of M that ranks after v
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (w2 < w ? M[mid] <= v : M[mid] < v) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    if (rank < k) {
      od[rank] = v;
      op[rank] = li[e];
    }
  }
}

size_t smem_bytes(int D, int k) {
  return sizeof(float) * ((size_t)D + 2 * (size_t)WARPS * k);
}

}  // namespace

extern "C" long long ivf_scan_smem_bytes(int D, int k) {
  return (long long)smem_bytes(D, k);
}

// q (B, D), x (N, D) float32; cand (B, P) int32, -1 = invalid slot;
// out_d / out_p (B, nchunks * k).  Block x scans positions
// [x*chunk, min(P, (x+1)*chunk)).  k <= TOPK_MAX_K.  Launches on `stream` and
// returns cudaGetLastError() as an int.
extern "C" int ivf_scan_partial(const float* q, const float* x, const int* cand,
                                float* out_d, int* out_p, int B, int N, int D,
                                int P, int k, int chunk, int nchunks,
                                void* stream) {
  if (B <= 0 || nchunks <= 0) return 0;
  if (k < 1 || k > TOPK_MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nchunks, B);
  ivf_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, x, cand, out_d, out_p, N, D, P, k, chunk);
  return (int)cudaGetLastError();
}
