// ivf_scan_lists: the IVF probe scanned list-major.  For a batch of B
// queries, each probing nprobe inverted lists, the top k of the probed
// lists' rows by squared L2, taken by difference in float32: the same ids
// as the per-query ivf_scan over the (B, nprobe * cap) table of the probed
// lists, with the same tie rule (the lowest position r * cap + slot first).
//
// Replaces, for the IVF probe, the TPU kernel src/repro/kernels/ivf_scan.py:
// ivf_scan_pallas / _ivf_scan_kernel (8 x 128 tiles of the gathered table
// from a VMEM-resident catalog, each emitting its k best positions).
//
// Bound on an H100: the bytes of the distinct rows the probed lists hold
// (at 1M x 128, 16 of 256 lists, B = 64: about 0.52 GB, 0.156 ms at
// 3.35 TB/s); the 3*D float32 operations a (query, row) pair are far below
// the FMA peak.  The per-query kernel reads a row once for every query
// that probes its list, about 2.1 GB at B = 64.  Measured, the bytes did
// not hold either design alone: the per-pair arithmetic (a lane-split sum
// and a five-shuffle tree in the first version) and above all the top-k
// selection (every list's first k rows are inserts) took as long as the
// stream.
//
// Design: block (list L, run j) walks slots [j*run, min((j+1)*run, len(L)))
// of list L, its true length: the lists' padding is never read.  The block
// finds the queries that probe L in the (B, nprobe) probe table itself
// (256 entries a pass, ordered by a ballot compaction; no host sync, the
// grid is nlist * nruns), and takes them in groups of up to GMAX = 8.  For
// a group it streams the run's rows from device memory through a
// two-stage shared-memory ring of 32-row tiles by cp.async (a warp a row,
// 16-byte pieces where D % 4 == 0; each tile's ids are loaded a tile ahead,
// so no copy waits on its id): each listed row is read once for the whole
// group; a group after the first streams the run again (from L2, mostly).
// Distances: warp w sums (x - q)^2 over columns w, w + 8, ... (16-byte
// pieces) of lane l's row, for every query of the group, from the row read
// once (rows padded to an odd count of 16-byte pieces: conflict-free) and
// each query's piece as a broadcast; the eight slices are added in warp
// order, so a distance is the same sum whatever the group.  Selection:
// warp g keeps query g's sorted top k of (distance, slot) in shared
// memory.  While the list fills, the lanes below its k-th distance append
// in slot order, and one bitonic sort by (distance, slot) orders them;
// then a ballot offers each tile's lanes below the k-th distance, in slot
// order, to the sorted list (topk_common.cuh: equal distances keep the
// lower slot first).  A full list's k-th distance bounds its query's k-th
// from above: the warp publishes it (atomicMin on the float's bits in a
// per-query slot of device memory) and reads the query's bound back a
// tile ahead, and rows above it are never offered, so the lists of a
// query's other probes and runs fill and insert less.  A row at or below
// the bound is kept, so ties still resolve by position, and the result
// does not depend on which block published first.  -1 slots met mid-list
// (folded tombstones), ids outside [0, N) and rows `valid` marks dead
// score +inf.  Warp g writes its list as the (query, probe rank r, run j)
// partial: the wrapper's stable sort over a query's nprobe * nruns * k
// partials keeps the lowest position first among equal distances, as the
// per-query kernel's merge does.  D <= 256 (the wrapper takes the
// per-query kernel beyond).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = WARPS;  // queries a block holds at once, a warp each
constexpr int STAGES = 2;    // tiles in the ring
constexpr int TILE = 32;     // rows a tile, one a lane
constexpr int MAX_D = 256;

// floats a staged row takes: an odd count of 16-byte pieces (vec4), or an
// odd count of floats, so 32 lanes reading their own rows hit distinct banks
__host__ __device__ inline int row_ld(int D, int vec4) {
  return vec4 ? 4 * ((D / 4) | 1) : (D | 1);
}

// a list's slots: k rounded up to a power of two, at least 32 (the bitonic
// sort's width)
__host__ __device__ inline int list_slots(int k) {
  int kpow = 32;
  while (kpow < k) kpow *= 2;
  return kpow;
}

size_t smem_bytes(int D, int vec4, int k) {
  return sizeof(float) * ((size_t)STAGES * TILE * row_ld(D, vec4) + (size_t)GMAX * D +
                          (size_t)WARPS * GMAX * TILE) +
         sizeof(int) * (size_t)STAGES * TILE +
         (sizeof(float) + sizeof(int)) * (size_t)GMAX * list_slots(k);
}

// (v2, s2) ranks before (v, s): by distance, then by slot
__device__ __forceinline__ bool key_less(float v2, int s2, float v, int s) {
  return v2 < v || (v2 == v && s2 < s);
}

// Sort a warp's list of kpow (a power of two, 32 to TOPK_MAX_K) (distance, slot)
// entries ascending by (distance, slot), a bitonic network in shared
// memory: the +inf / -1 tail stays last, and equal distances keep the
// lower slot first.
__device__ void sort_list(float* v, int* s, int kpow, int lane) {
  for (int size = 2; size <= kpow; size *= 2) {
    for (int stride = size / 2; stride > 0; stride /= 2) {
      for (int i = lane; i < kpow / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const float va = v[lo], vb = v[hi];
        const int sa = s[lo], sb = s[hi];
        if (key_less(vb, sb, va, sa) == up) {
          v[lo] = vb;
          v[hi] = va;
          s[lo] = sb;
          s[hi] = sa;
        }
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int vec4) {
  if (vec4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// q (B, D), x (N, D), lists (nlist, cap), lens (nlist), probe (B, nprobe),
// valid (N) or null; out (B, nprobe * nruns * k).  VEC: D % 4 == 0 and x
// on 16 bytes.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ivf_scan_lists_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      const int* __restrict__ lists, const int* __restrict__ lens,
                      const int* __restrict__ probe, const unsigned char* __restrict__ valid,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      float* __restrict__ bound, int B, int N, int D, int nlist, int cap,
                      int nprobe, int k, int nruns, int run) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_ld(D, VEC);
  float* ring = smem;                                         // STAGES x TILE x ld
  float* qs = ring + STAGES * TILE * ld;                      // GMAX x D
  int* ids = reinterpret_cast<int*>(qs + GMAX * D);           // STAGES x TILE
  const int kpow = list_slots(k);
  float* lv = reinterpret_cast<float*>(ids + STAGES * TILE);  // GMAX x kpow
  int* ls = reinterpret_cast<int*>(lv + GMAX * kpow);         // GMAX x kpow
  float* part = reinterpret_cast<float*>(ls + GMAX * kpow);   // WARPS x GMAX x TILE
  __shared__ int gb[GMAX], gr[GMAX], wcnt[WARPS], next_cursor;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = blockIdx.x / nruns, j = blockIdx.x % nruns;
  const int s0 = j * run;
  const int s1 = max(s0, min(s0 + run, lens[L]));
  const int ntiles = (s1 - s0 + TILE - 1) / TILE;
  const int total = B * nprobe;
  const int* lrow = lists + (size_t)L * cap;
  const float inf = __int_as_float(0x7f800000);
  const int pieces = VEC ? D / 4 : D;  // cp.async pieces a row
  const uint32_t ring_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // a probe entry outside [0, nlist) names no list, so no block below
  // scans it: its nruns * k partials are written empty here, the entries
  // shared out over the grid
  for (int e = blockIdx.x * THREADS + tid; e < total; e += gridDim.x * THREADS) {
    const int l = probe[e];
    if (l < 0 || l >= nlist) {
      for (int i = 0; i < nruns * k; ++i) {
        out_d[(size_t)e * nruns * k + i] = inf;
        out_i[(size_t)e * nruns * k + i] = -1;
      }
    }
  }

  // the ids of warp `warp`'s rows of tile t (rows warp + 8u, u < 4), one
  // a lane u: a slot past the run, a -1 slot, an id outside [0, N) or a
  // dead row is -1.  Loaded a tile ahead of its issue, so the copies never
  // wait on these loads.
  auto load_ids = [&](int t) {
    int id = -1;
    const int slot = s0 + t * TILE + warp + WARPS * lane;
    if (t < ntiles && lane < TILE / WARPS && slot < s1) {
      id = lrow[slot];
      if (id >= N || (id >= 0 && valid != nullptr && !valid[id])) id = -1;
    }
    return id;
  };
  // tile t into stage t % STAGES: warp w copies its rows, the lanes a row's
  // 16-byte (or 4-byte) pieces side by side
  auto issue = [&](int t, int my_ids) {
    if (t < ntiles) {
      const int st = t % STAGES;
      for (int u = 0; u < TILE / WARPS; ++u) {
        const int id = __shfl_sync(TOPK_FULL_MASK, my_ids, u), r = warp + WARPS * u;
        if (lane == 0) ids[st * TILE + r] = id;
        if (id >= 0) {
          for (int c = lane; c < pieces; c += 32) {
            const int col = VEC ? 4 * c : c;
            cp_async(ring_u32 + 4u * ((st * TILE + r) * ld + col), x + (size_t)id * D + col,
                     VEC);
          }
        }
      }
    }
    cp_async_commit();
  };

  int cursor = 0;
  for (;;) {
    // the next group: up to GMAX (query, probe rank) entries of the probe
    // table naming L, in table order, from `cursor` on
    int cnt = 0;
    while (cursor < total && cnt < GMAX) {
      const int e = cursor + tid;
      const bool hit = e < total && probe[e] == L;
      const unsigned m = __ballot_sync(TOPK_FULL_MASK, hit);
      if (lane == 0) wcnt[warp] = __popc(m);
      __syncthreads();
      int before = 0, all = 0;
      for (int w = 0; w < WARPS; ++w) {
        before += w < warp ? wcnt[w] : 0;
        all += wcnt[w];
      }
      const int rank = cnt + before + __popc(m & ((1u << lane) - 1u));
      if (hit && rank < GMAX) {
        gb[rank] = e / nprobe;
        gr[rank] = e % nprobe;
        if (rank == GMAX - 1) next_cursor = e + 1;
      }
      __syncthreads();
      if (cnt + all >= GMAX) {
        cursor = next_cursor;
        cnt = GMAX;
      } else {
        cursor += THREADS;
        cnt += all;
      }
    }
    if (cnt == 0) break;
    const int G = cnt;
    for (int e = tid; e < G * D; e += THREADS) qs[e] = q[(size_t)gb[e / D] * D + e % D];
    __syncthreads();

    for (int e = tid; e < GMAX * kpow; e += THREADS) {
      lv[e] = inf;
      ls[e] = -1;
    }
    __syncthreads();

    float* L_v = lv + warp * kpow;
    int* L_s = ls + warp * kpow;
    int fill = 0;  // entries appended while the list fills
    float* my_bound = bound + gb[warp < G ? warp : 0];
    float bnd = inf;
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) issue(t, load_ids(t));
    int next_ids = load_ids(STAGES - 1);
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      issue(t + STAGES - 1, next_ids);  // into the stage tile t - 1 used
      next_ids = load_ids(t + STAGES);
      // the query's bound for the next tile: a stale value only filters less
      const float bnd_next = warp < G ? *reinterpret_cast<volatile float*>(my_bound) : inf;
      const int st = t % STAGES;
      // warp w: columns w, w + 8, ... (16-byte pieces, or floats) of lane
      // l's row, against every query of the group, read once
      {
        const float* row = ring + (st * TILE + lane) * ld;
        float acc[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
        if (VEC) {
          for (int c = 4 * warp; c < D; c += 4 * WARPS) {
            const float4 xv = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g < G) {
                const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + c);
                float dx = xv.x - qv.x;
                acc[g] = fmaf(dx, dx, acc[g]);
                dx = xv.y - qv.y;
                acc[g] = fmaf(dx, dx, acc[g]);
                dx = xv.z - qv.z;
                acc[g] = fmaf(dx, dx, acc[g]);
                dx = xv.w - qv.w;
                acc[g] = fmaf(dx, dx, acc[g]);
              }
            }
          }
        } else {
          for (int c = warp; c < D; c += WARPS) {
            const float xc = row[c];
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g < G) {
                const float dx = xc - qs[g * D + c];
                acc[g] = fmaf(dx, dx, acc[g]);
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) part[(warp * GMAX + g) * TILE + lane] = acc[g];
      }
      __syncthreads();
      if (warp < G) {
        // warp g: its query's distances, the eight slices summed in order
        const int id = ids[st * TILE + lane];
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += part[(w * GMAX + warp) * TILE + lane];
        const float dv = id >= 0 ? acc : inf;
        // offer the lanes below the list's k-th distance and at most the
        // query's bound, in slot order
        unsigned m = __ballot_sync(TOPK_FULL_MASK, dv < L_v[k - 1] && dv <= bnd);
        if (fill < k && m) {
          // the list is filling: append in slot order, sort once it is full
          const int take = min(__popc(m), k - fill);
          const int at = fill + __popc(m & ((1u << lane) - 1u));
          if (((m >> lane) & 1u) && at < k) {
            L_v[at] = dv;
            L_s[at] = s0 + t * TILE + lane;
          }
          for (int i = 0; i < take; ++i) m &= m - 1;
          fill += take;
          __syncwarp();
          if (fill == k) sort_list(L_v, L_s, kpow, lane);
        }
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(TOPK_FULL_MASK, dv, src);
          if (v < L_v[k - 1]) warp_insert(L_v, L_s, k, v, s0 + t * TILE + src, lane);
        }
        // a full list's k-th distance bounds the query's k-th from above
        const float kth = L_v[k - 1];
        if (lane == 0 && kth < bnd_next)
          atomicMin(reinterpret_cast<int*>(my_bound), __float_as_int(kth));
        bnd = fminf(bnd_next, kth);
      }
    }
    cp_async_wait<0>();
    if (warp < G && fill < k) sort_list(L_v, L_s, kpow, lane);
    __syncthreads();

    // warp g's list is query g's partial for (probe rank, run), sorted by
    // (distance, slot)
    if (warp < G) {
      const size_t o = (((size_t)gb[warp] * nprobe + gr[warp]) * nruns + j) * k;
      for (int i = lane; i < k; i += 32) {
        const float v = L_v[i];
        out_d[o + i] = v;
        out_i[o + i] = v < inf ? lrow[L_s[i]] : -1;
      }
    }
    __syncthreads();
  }
}

template <bool VEC>
int launch(const float* q, const float* x, const int* lists, const int* lens,
           const int* probe, const unsigned char* valid, float* out_d, int* out_i,
           float* bound, int B, int N, int D, int nlist, int cap, int nprobe, int k, int nruns,
           int run, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, VEC, k);
  cudaError_t err = cudaFuncSetAttribute(ivf_scan_lists_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // no bound yet: 0x7f7f7f7f is 3.4e38, above any distance
  err = cudaMemsetAsync(bound, 0x7f, sizeof(float) * (size_t)B, stream);
  if (err != cudaSuccess) return (int)err;
  ivf_scan_lists_kernel<VEC><<<nlist * nruns, THREADS, smem, stream>>>(
      q, x, lists, lens, probe, valid, out_d, out_i, bound, B, N, D, nlist, cap, nprobe, k,
      nruns, run);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long ivf_scan_lists_smem_bytes(int D, int vec4, int k) {
  return (long long)smem_bytes(D, vec4, k);
}

// q (B, D), x (N, D) float32; lists (nlist, cap), lens (nlist), probe
// (B, nprobe) int32 (an entry outside [0, nlist) scans nothing: its
// partials come back +inf / -1); valid (N) bool or null;
// out_d / out_i (B, nprobe * nruns * k); bound (B) float32 scratch.
// Block (L, j) walks slots [j*run, min((j+1)*run, lens[L])) of list L.
// D <= 256, k <= TOPK_MAX_K; vec4 = D % 4 == 0 and x on 16 bytes.  Launches on
// `stream` and returns the first CUDA error as an int.
extern "C" int ivf_scan_lists(const float* q, const float* x, const int* lists,
                              const int* lens, const int* probe, const unsigned char* valid,
                              float* out_d, int* out_i, float* bound, int B, int N, int D,
                              int nlist, int cap, int nprobe, int k, int nruns, int run,
                              int vec4, void* stream) {
  if (B <= 0 || nlist <= 0 || nruns <= 0) return 0;
  if (k < 1 || k > TOPK_MAX_K || D < 1 || D > MAX_D || (vec4 && D % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    return launch<true>(q, x, lists, lens, probe, valid, out_d, out_i, bound, B, N, D, nlist,
                        cap, nprobe, k, nruns, run, s);
  return launch<false>(q, x, lists, lens, probe, valid, out_d, out_i, bound, B, N, D, nlist,
                       cap, nprobe, k, nruns, run, s);
}
