// ivf_scan: gather catalog rows at a per-query candidate-id table, squared
// L2 by difference, and each query's k best (distance, id), in one launch.
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py: ivf_scan_pallas /
// _ivf_scan_kernel (8 x 128 tiles of the (B, P) table gathered from a
// VMEM-resident catalog, each emitting its k best positions), for the
// per-query tables: LSH's buckets, the exact re-rank of retrieved ids and
// IVF-PQ's refine.  The IVF probe, whose table is whole inverted lists,
// takes the list-major kernel (ivf_scan_lists.cu), which reads a list once
// for all its queries.
//
// Bound on an H100: the bytes of the distinct rows the table names, U*D*4
// for U distinct valid ids, plus the (B, P) table itself; 3*V*D float32
// operations for V valid slots are far below the FMA peak.  At the IVF-PQ
// re-rank (B 8, P 256, D 128) that is 1 MB: 0.3 us.  The time is latency:
// a few rounds of row reads, the selection, and the launch itself.
//
// Design: a query's table is cut into runs over a thread block cluster
// along x (ops.ivf_scan_plan: runs of at least 64 slots, at most 16 blocks,
// non-portable above 8), a block of 8 warps a run, walked in passes of
// PASS slots.  A block's time is a chain of dependent reads (the pass's
// ids and liveness, read by the whole block at once into shared memory,
// then the rows, 64 in flight a block), so the IVF-PQ re-rank's 256 slots
// go to 4 blocks of one round each, not to one block of four rounds.
//   - Rows are gathered straight from device memory: each warp takes UNROLL
//     slots at a time, the lanes read each row in coalesced 16-byte pieces
//     (4-byte ones where D % 4 or the catalog's alignment forbid them) and
//     sum (x - q)^2 by difference, as the reference does, reduced by
//     shuffles.  A -1 slot, an id outside [0, N) and an id whose `valid`
//     byte is 0 read nothing and are dropped (they would score +inf).
//   - A scored slot becomes one 64-bit key, (distance bits << 32) |
//     position: distances are >= 0, so their float bits order as unsigned
//     integers, and equal distances order by position, the reference's tie
//     rule (lowest position first), exactly.  A key below the block's
//     current k-th best is appended to shared memory; at the end of a pass
//     the kept keys and the new ones are sorted together (bitonic, in
//     shared memory; the first pass sorts its new keys alone), and the
//     first k are kept.  So the selection is one block-wide sort a pass,
//     not a chain of serial inserts, and after the first pass only keys
//     that beat the k-th best are sorted.
//   - A cluster's blocks each keep their k best; then each block ranks its
//     own keys against the other blocks' lists through distributed shared
//     memory (a key's rank in the query's top k is its own index plus, in
//     every other list, the count of smaller keys, one binary search a
//     (key, list) pair and thread: the keys are distinct, so the ranks are
//     too) and writes those ranked below k.  The merge is spread over the
//     cluster's blocks, where a rank-0 merge would leave the others idle.  Every key of
//     the query's top k is in its block's list, and a key outside it ranks
//     k or more.  A cluster barrier before any block exits keeps every
//     list readable until all are ranked.
//   - The epilogue maps position -> id (read from `cand`) and writes the
//     final (B, k) outputs; slots past the query's valid keys (fewer than k
//     valid slots, k > P included) are +inf / -1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;             // slots in flight a warp
constexpr int PASS = 1024;            // slots a pass: new keys a pass at most
constexpr int KEYS = 2 * PASS;        // kept keys (<= TOPK_MAX_K = PASS) + new ones
constexpr int MAX_CLUSTER = 16;
constexpr unsigned long long EMPTY = ~0ull;
constexpr unsigned INF_BITS = 0x7f800000u;

static_assert(TOPK_MAX_K <= PASS, "the kept keys and a pass's new ones fit KEYS");

// ascending bitonic sort of keys[0, n), n a power of two, by the block
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
ivf_scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const int* __restrict__ cand, const unsigned char* __restrict__ valid,
                float* __restrict__ out_d, int* __restrict__ out_i, int N, int D, int P,
                int k, int kp, int run) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // KEYS
  int* ids = reinterpret_cast<int*>(keys + KEYS);                          // PASS
  float* qs = reinterpret_cast<float*>(ids + PASS);                        // D
  __shared__ int s_cnt, s_kept, s_n;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int* crow = cand + (size_t)b * P;

  for (int c = tid; c < D; c += THREADS) qs[c] = q[(size_t)b * D + c];
  for (int e = tid; e < kp; e += THREADS) keys[e] = EMPTY;
  if (tid == 0) {
    s_cnt = 0;
    s_kept = 0;
  }

  const int begin = min(P, rank * run), end = min(P, begin + run);
  for (int s0 = begin; s0 < end; s0 += PASS) {
    const int len = min(end - s0, PASS);
    // the pass's live ids, read in one round by the whole block (-1: a -1
    // slot, an id outside [0, N), a tombstone)
    for (int i = tid; i < len; i += THREADS) {
      const int c = crow[s0 + i];
      ids[i] = (c >= 0 && c < N && (valid == nullptr || valid[c])) ? c : -1;
    }
    __syncthreads();
    const unsigned long long thr = keys[k - 1];  // the k-th best so far
    const int base = s_kept ? kp : 0;            // new keys go after the kept ones
    for (int g0 = warp * UNROLL; g0 < len; g0 += WARPS * UNROLL) {
      int id[UNROLL];
      float acc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        id[u] = g0 + u < len ? ids[g0 + u] : -1;
        acc[u] = 0.f;
      }
      if (VEC4) {
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        for (int c4 = lane; c4 < (D >> 2); c4 += 32) {
          const float4 qv = q4[c4];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (id[u] >= 0) {
              const float4 xv =
                  __ldg(reinterpret_cast<const float4*>(x + (size_t)id[u] * D) + c4);
              const float d0 = xv.x - qv.x, d1 = xv.y - qv.y, d2 = xv.z - qv.z,
                          d3 = xv.w - qv.w;
              acc[u] = fmaf(d0, d0, acc[u]);
              acc[u] = fmaf(d1, d1, acc[u]);
              acc[u] = fmaf(d2, d2, acc[u]);
              acc[u] = fmaf(d3, d3, acc[u]);
            }
          }
        }
      } else {
        for (int c = lane; c < D; c += 32) {
          const float qc = qs[c];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (id[u] >= 0) {
              const float diff = __ldg(x + (size_t)id[u] * D + c) - qc;
              acc[u] = fmaf(diff, diff, acc[u]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float dv = warp_sum_float(acc[u]);
        const unsigned bits = __float_as_uint(dv);
        // +inf (and NaN) scores as a dropped slot, as the reference's +inf
        if (lane == u && id[u] >= 0 && bits < INF_BITS) {
          const unsigned long long key =
              ((unsigned long long)bits << 32) | (unsigned)(s0 + g0 + u);
          if (key < thr) keys[base + atomicAdd(&s_cnt, 1)] = key;
        }
      }
    }
    __syncthreads();
    const int cnt = s_cnt;
    if (cnt > 0) {
      int n = 1;
      while (n < base + cnt || n < kp) n <<= 1;
      for (int e = base + cnt + tid; e < n; e += THREADS) keys[e] = EMPTY;
      __syncthreads();
      bitonic_sort(keys, n);
    }
    if (tid == 0) {
      s_kept = min(kp, s_kept + cnt);
      s_cnt = 0;
    }
    __syncthreads();
  }

  // each block's list: its valid keys among the first k, and each key's
  // rank in the query's top k, counted into ranks[] (free key slots)
  __syncthreads();  // s_kept, where the block's run was empty
  const int own = min(s_kept, k);
  if (tid == 0) s_n = own;
  int* ranks = reinterpret_cast<int*>(keys + kp);
  for (int i = tid; i < own; i += THREADS) ranks[i] = i;
  cluster.sync();

  for (int e = tid; e < own * (csize - 1); e += THREADS) {
    const int i = e % own, o = e / own + (e / own >= rank);
    const unsigned long long key = keys[i];
    const unsigned long long* other = cluster.map_shared_rank(keys, o);
    int lo = 0, hi = *cluster.map_shared_rank(&s_n, o);
    while (lo < hi) {  // keys of block o below `key`
      const int mid = (lo + hi) >> 1;
      if (other[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    if (lo) atomicAdd(&ranks[i], lo);
  }
  __syncthreads();
  float* od = out_d + (size_t)b * k;
  int* oi = out_i + (size_t)b * k;
  for (int i = tid; i < own; i += THREADS) {
    const int r = ranks[i];
    if (r < k) {
      const unsigned long long key = keys[i];
      od[r] = __uint_as_float((unsigned)(key >> 32));
      oi[r] = crow[(unsigned)(key & 0xffffffffu)];
    }
  }
  if (rank == 0) {
    int total = own;
    for (int o = 1; o < csize; ++o) total += *cluster.map_shared_rank(&s_n, o);
    for (int j = min(total, k) + tid; j < k; j += THREADS) {
      od[j] = __uint_as_float(INF_BITS);
      oi[j] = -1;
    }
  }
  cluster.sync();  // every list stays readable until all are ranked
}

// the keys, a pass's ids, the query
size_t smem_bytes(int D) {
  return sizeof(unsigned long long) * (size_t)KEYS + sizeof(int) * (size_t)PASS +
         sizeof(float) * (size_t)D;
}

}  // namespace

extern "C" long long ivf_scan_smem_bytes(int D) { return (long long)smem_bytes(D); }

// q (B, D), x (N, D) float32; cand (B, P) int32, -1 = invalid slot; valid
// (N,) bool or null; out_d / out_i (B, k) float32 / int32, written whole.
// The query's `cluster` blocks take runs of `run` slots ([r * run, (r + 1)
// * run) for block r; cluster * run >= P).  vec4: D % 4 == 0 and x on 16
// bytes.  k <= TOPK_MAX_K.  Launches on `stream` and returns the launch's
// CUDA error code as an int (0 on success).
extern "C" int ivf_scan_topk(const float* q, const float* x, const int* cand,
                             const unsigned char* valid, float* out_d, int* out_i, int B,
                             int N, int D, int P, int k, int run, int cluster, int vec4,
                             void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || k > TOPK_MAX_K || cluster < 1 || cluster > MAX_CLUSTER || run < 1 ||
      (long long)run * cluster < P || (vec4 && D % 4))
    return (int)cudaErrorInvalidValue;
  int kp = 1;
  while (kp < k) kp <<= 1;
  const size_t smem = smem_bytes(D);
  void (*kern)(const float*, const float*, const int*, const unsigned char*, float*, int*, int,
               int, int, int, int, int) =
      vec4 ? ivf_scan_kernel<true> : ivf_scan_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, x, cand, valid, out_d, out_i, N, D, P, k, kp, run);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
