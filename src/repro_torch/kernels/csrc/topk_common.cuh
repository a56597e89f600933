// Shared device helpers of the top-k kernels (l2_topk.cu, ivf_scan.cu,
// ivf_scan_lists.cu).
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
// the longest list: the reference's benchmarks ask for up to k 400 (fig4 at
// --full); a list of 1024 pairs takes 8 KB of shared memory
#define TOPK_MAX_K 1024

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
// Slots (pos, k) move up one, 32 at a time from the top stripe down: a
// stripe reads its left neighbours, syncs, then writes, and the stripe
// below it writes only after that sync, so no slot is read after it is
// overwritten.  A stripe wholly at or below pos is not touched.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float v,
                                            int id, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += (lv[j] <= v) ? 1 : 0;
  const int pos = warp_sum_int(cnt);
  for (int base = (k - 1) & ~31; base + 31 > pos; base -= 32) {
    const int j = base + lane;
    const bool move = j < k && j > pos;
    float tv = 0.f;
    int ti = -1;
    if (move) {
      tv = lv[j - 1];
      ti = li[j - 1];
    }
    __syncwarp();
    if (move) {
      lv[j] = tv;
      li[j] = ti;
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}
