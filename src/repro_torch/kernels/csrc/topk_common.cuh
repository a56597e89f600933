// Shared device helpers of the two top-k kernels (l2_topk.cu, ivf_scan.cu).
//
// A query's running top-k is a list of k (value, index) pairs in shared
// memory, sorted ascending with +inf / -1 in its unused tail.  One warp
// owns a list and inserts into it cooperatively.  Candidates are offered
// in ascending index order and a new value goes after every equal value
// already present, so equal distances keep the lowest index first — the
// tie rule of jnp.argmin and lax.top_k that the reference's ids follow.
#pragma once

#include <cuda_runtime.h>

#define TOPK_FULL_MASK 0xffffffffu
#define TOPK_MAX_K 128  // four list slots per lane

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(TOPK_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum_float(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(TOPK_FULL_MASK, v, o);
  return v;
}

// Insert (v, id) into the sorted list (lv, li) of length k <= TOPK_MAX_K.
// The whole warp calls it with the same arguments, and only when
// v < lv[k - 1], so the insert position is < k and the last entry drops.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float v,
                                            int id, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += (lv[j] <= v) ? 1 : 0;
  const int pos = warp_sum_int(cnt);
  float tv[4];
  int ti[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    if (j < k && j > pos) {
      tv[m] = lv[j - 1];
      ti[m] = li[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    if (j < k && j > pos) {
      lv[j] = tv[m];
      li[j] = ti[m];
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}
