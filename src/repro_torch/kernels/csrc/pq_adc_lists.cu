// pq_adc_lists: the IVF-PQ shortlist scanned list-major.  For a batch of B
// queries, each probing nprobe inverted lists, the kk probed slots of
// smallest PQ asymmetric distance (ADC), dist = sum_m lut[b, m, code[m]],
// with the plain version's tie rule (the lowest position r * cap + slot
// first) and the plain version's sums bit for bit (the M lookups added in
// m order from 0.0f, as pq_adc.cu adds them).
//
// Replaces, for the IVF-PQ probe, the TPU kernel src/repro/kernels/pq_adc.py:
// pq_adc_pallas / _adc_kernel (the ADC as a one-hot x LUT product on the
// MXU over a (B, P) code slab) together with the top-r that follows it in
// the reference (src/repro/index/pq.py:126-136).  pq_adc.cu, the
// per-query gather kernel, stays for the dense and gathered forms.
//
// Bound on an H100: bytes.  The distinct probed lists' code rows and ids
// (M + 4 bytes a slot, at the lists' true lengths), the probe table, the
// list lengths, the LUTs and the partials written: about 14.5 MB at
// B = 64 (988k slots in 253 of 256 lists), 4.3 us at 3.35 TB/s.  The M
// adds a (query, slot) are far below any peak; the M * G shared-memory
// lookups a row (G queries of the group) are what the arithmetic costs.
// What the per-query design paid on top: a (B, P) id table built and read
// back, each 8-byte code row gathered by id (a 32-byte sector) once for
// every query probing its list, the (B, P) distances written, and a
// stable sort over P-wide rows (PyTorch's segmented radix sort, several
// launches) to pick kk of them.
//
// Design: block (list L, run j) walks slots [j*run, min((j+1)*run,
// lens[L])) of list L: codes are stored list-major, (nlist, ccap, M), so
// the run's code rows are contiguous (at M = 8 a thread loads two rows as
// one 16-byte piece; the lists' padding is never read).  The block finds
// the queries that probe L in the (B, nprobe) probe table itself (2048
// entries a pass, ordered by a ballot compaction; no host sync, the grid
// is nlist * nruns * qsplit) and takes them in groups of up to gmax (the
// plan's, <= 8), the z-th block of a (list, run) every qsplit-th group, so
// a list many queries probe is spread over blocks: the group's LUTs sit in
// shared memory and each code row is read once for all of them.  Each
// (query, slot) distance goes into shared memory as an order-preserving
// 32-bit key (dead slots: a -1 id, an id outside [0, N), a row `valid`
// marks dead, score +inf and never count).
//
// Selection keeps no sorted list: a slot is a candidate when its key is at
// most the query's bound (see below); if the run has at most kk
// candidates, all are kept; else a select by histograms finds the kk-th
// key: at most 256 bins of a power-of-two width (a shift, no division)
// over the key range still open (at first the candidates' smallest to
// largest key), one shared-memory histogram a query a pass, each pass
// narrowing the range to the bin that holds the kk-th key (so a pass
// spreads the keys over its bins as evenly as their distances spread, and
// at most 4 passes reach a single key); it stops as soon as that bin is
// taken whole, or at a single key, where ties go to the first slots.  The
// warps then place the kept slots, in slot order (each warp counts its
// segment of the run, a scan over the warps places every segment), and the
// block writes them as the (query, probe rank r, run j) partial of kk
// (distance, id) entries, +inf / -1 after them, all ids fetched at once.
// The wrapper's stable sort over a query's nprobe * nruns * kk partials
// (laid out in (r, j, slot) order, which is position order) keeps the
// lowest position first among equal distances, as the plain version's
// stable top kk over the (B, nprobe * cap) table does.  A full partial's
// largest key bounds its query's kk-th from above: the block publishes it
// (atomicMin on the key in a per-query slot of device memory), and the
// groups that start later count no slot above it.  A slot equal to the
// bound is kept, so ties still resolve by position, and the result does
// not depend on which block published first.  A probe entry outside
// [0, nlist) names no list: its partials are written empty.
//
// Measured on an H100, latency holds it, not bytes: a group's phases
// (distances, select, placing) each take microseconds with one block's
// warps on an SM, and at B = 64 the distances are about what the
// shared-memory lookups cost (random codes meet bank conflicts).  The
// first version (256 threads, one global load an iteration, the ids of
// the kept slots read one warp step at a time, a 64-bit division a key a
// pass) took 43 us at B = 8 and 122 at B = 64; this one issues the loads
// together, runs 512 threads a block and bins by shifts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;    // queries a group at most (the plan's gmax <= GMAX)
constexpr int BINS = 256;  // the bins of a histogram pass
constexpr int UNROLL = 2;  // code-row loads a thread issues together
constexpr int SCAN = 4;    // probe-table windows a block loads together
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned KEY_INF = 0xff800000u;  // the key of +inf: no candidate reaches it
constexpr unsigned KEY_DEAD = 0xffffffffu;

// float -> uint32 in the same order (-0 as +0); key2f inverts it
__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned b = f == 0.f ? 0u : __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

size_t smem_bytes(int gmax, int M, int C, int run, int kp) {
  // the group's LUTs, its keys, its histograms, its kept slots
  return sizeof(float) *
         ((size_t)gmax * M * C + (size_t)gmax * run + (size_t)gmax * BINS + (size_t)gmax * kp);
}

// the shift of a histogram pass over the open key range [lo, hi]: bins of
// 2^sh keys, the fewest that keep (hi - lo) >> sh below 256, so each pass
// takes at least 8 bits off the range's width (at most 4 passes)
__device__ __forceinline__ int bin_shift(unsigned lo, unsigned hi) {
  const unsigned long long width = (unsigned long long)(hi - lo) + 1;  // <= 2^32
  const int bits = 64 - __clzll(width - 1);                           // ceil(log2 width)
  return bits > 8 ? bits - 8 : 0;
}

// one subspace's lookup; a code >= C adds 0, as the reference's one-hot
__device__ __forceinline__ float lookup(const float* lg, int m, int C, unsigned code) {
  return code < (unsigned)C ? lg[m * C + code] : 0.f;
}

// the ADC sum of an M = 8 row held in two words, m in order from 0.0f
__device__ __forceinline__ float adc8(const float* lg, int C, unsigned lo, unsigned hi) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = acc + lookup(lg, j, C, (lo >> (8 * j)) & 0xffu);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = acc + lookup(lg, 4 + j, C, (hi >> (8 * j)) & 0xffu);
  return acc;
}

// lut (B, M, C) float32; codes (nlist, ccap, M) uint8; lists (nlist, lcap)
// int32; lens (nlist); probe (B, nprobe); valid (N) or null; out (B,
// nprobe * nruns * kp); bound (B) keys.  VEC8: M == 8, ccap and run even,
// codes on 16 bytes (a 16-byte load holds two rows).
template <bool VEC8>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: registers <= 64
pq_adc_lists_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                    const int* __restrict__ lists, const int* __restrict__ lens,
                    const int* __restrict__ probe, const unsigned char* __restrict__ valid,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    unsigned* __restrict__ bound, int B, int N, int M, int C, int nlist,
                    int lcap, int ccap, int nprobe, int kp, int nruns, int run, int gmax,
                    int qsplit) {
  extern __shared__ __align__(16) float smem[];
  const int MC = M * C;
  float* lut_s = smem;                                              // gmax x M x C
  unsigned* keys = reinterpret_cast<unsigned*>(lut_s + gmax * MC);  // gmax x run
  int* hist = reinterpret_cast<int*>(keys + gmax * run);            // gmax x BINS
  int* kept_s = hist + gmax * BINS;                                 // gmax x kp
  __shared__ int gb[GMAX], gr[GMAX], wcnt[WARPS], next_cursor;
  // per query of the group: the bound read at its start, candidates and
  // their key range, then the selection (the open key range [lo, hi], how
  // many of its keys to take, still searching), the largest key kept, and
  // each warp's segment counts below / in the open range
  __shared__ unsigned q_bk[GMAX], q_min[GMAX], q_max[GMAX], q_lo[GMAX], q_hi[GMAX],
      q_top[GMAX];
  __shared__ int q_cnt[GMAX], q_need[GMAX], q_act[GMAX], q_kept[GMAX];
  __shared__ int c_lt[GMAX][WARPS], c_eq[GMAX][WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int L = blockIdx.x / (nruns * qsplit), j = blockIdx.x / qsplit % nruns;
  const int zq = blockIdx.x % qsplit;  // this block's share of the list's groups
  const int s0 = j * run;
  const int s1 = max(s0, min(s0 + run, lens[L]));
  const int R = s1 - s0;
  const int total = B * nprobe;
  const int* lrow = lists + (size_t)L * lcap;
  const uint8_t* crow = codes + (size_t)L * ccap * M;
  const float inf = __int_as_float(0x7f800000);

  // a probe entry outside [0, nlist) names no list, so no block below
  // scans it: its nruns * kp partials are written empty here, the entries
  // shared out over the grid
  for (int e = blockIdx.x * THREADS + tid; e < total; e += gridDim.x * THREADS) {
    const int l = probe[e];
    if (l < 0 || l >= nlist) {
      for (int i = 0; i < nruns * kp; ++i) {
        out_d[(size_t)e * nruns * kp + i] = inf;
        out_i[(size_t)e * nruns * kp + i] = -1;
      }
    }
  }

  // an id if it is live, else -1
  auto live = [&](int id) {
    return (id < 0 || id >= N || (valid != nullptr && !valid[id])) ? -1 : id;
  };

  int cursor = 0;
  for (int group = 0;; ++group) {
    // the next group: up to gmax (query, probe rank) entries of the probe
    // table naming L, in table order, from `cursor` on
    int cnt = 0;
    while (cursor < total && cnt < gmax) {
      // SCAN windows of THREADS entries loaded together
      int pv[SCAN];
#pragma unroll
      for (int u = 0; u < SCAN; ++u) {
        const int e = cursor + u * THREADS + tid;
        pv[u] = e < total ? probe[e] : -1;
      }
#pragma unroll
      for (int u = 0; u < SCAN; ++u) {
        if (cursor < total && cnt < gmax) {  // cursor is the u-th window's start here
          const int e = cursor + tid;
          const bool hit = e < total && pv[u] == L;
          const unsigned m = __ballot_sync(FULL, hit);
          if (lane == 0) wcnt[warp] = __popc(m);
          __syncthreads();
          int before = 0, all = 0;
          for (int w = 0; w < WARPS; ++w) {
            before += w < warp ? wcnt[w] : 0;
            all += wcnt[w];
          }
          const int rank = cnt + before + __popc(m & below);
          if (hit && rank < gmax) {
            gb[rank] = e / nprobe;
            gr[rank] = e % nprobe;
            if (rank == gmax - 1) next_cursor = e + 1;
          }
          __syncthreads();
          if (cnt + all >= gmax) {
            cursor = next_cursor;
            cnt = gmax;
          } else {
            cursor += THREADS;
            cnt += all;
          }
        }
      }
    }
    if (cnt == 0) break;
    if (group % qsplit != zq) continue;  // another block's group
    const int G = cnt;

    // the group's LUTs, and each query's bound (a stale value only
    // counts more candidates)
    if (MC % 4 == 0) {
      const int MC4 = MC / 4;
#pragma unroll 8
      for (int e = tid; e < G * MC4; e += THREADS)
        reinterpret_cast<float4*>(lut_s)[e] =
            reinterpret_cast<const float4*>(lut)[(size_t)gb[e / MC4] * MC4 + e % MC4];
    } else {
      for (int e = tid; e < G * MC; e += THREADS)
        lut_s[e] = lut[(size_t)gb[e / MC] * MC + e % MC];
    }
    if (tid < G) {
      q_bk[tid] = *reinterpret_cast<volatile unsigned*>(bound + gb[tid]);
      q_cnt[tid] = 0;
      q_min[tid] = KEY_DEAD;
      q_max[tid] = 0u;
      q_top[tid] = 0u;
    }
    __syncthreads();

    // distances: each code row read once for the group
    if (VEC8) {
      // UNROLL iterations' loads issued together, so a run costs a few
      // round trips to device memory, not one an iteration
      for (int base = 2 * tid; base < R; base += 2 * THREADS * UNROLL) {
        uint4 w[UNROLL];
        int i0[UNROLL], i1[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int s = base + 2 * THREADS * u;
          w[u] = make_uint4(0u, 0u, 0u, 0u);
          i0[u] = i1[u] = -1;
          if (s < R) {
            w[u] = *reinterpret_cast<const uint4*>(crow + (size_t)(s0 + s) * 8);
            i0[u] = lrow[s0 + s];
            if (s + 1 < R) i1[u] = lrow[s0 + s + 1];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int s = base + 2 * THREADS * u;
          if (s >= R) break;
          const int id0 = live(i0[u]), id1 = live(i1[u]);
          for (int g = 0; g < G; ++g) {
            const float* lg = lut_s + g * MC;
            keys[g * run + s] = id0 >= 0 ? f2key(adc8(lg, C, w[u].x, w[u].y)) : KEY_DEAD;
            if (s + 1 < R)
              keys[g * run + s + 1] = id1 >= 0 ? f2key(adc8(lg, C, w[u].z, w[u].w)) : KEY_DEAD;
          }
        }
      }
    } else {
      for (int s = tid; s < R; s += THREADS) {
        const uint8_t* cr = crow + (size_t)(s0 + s) * M;
        const int id = live(lrow[s0 + s]);
        for (int g = 0; g < G; ++g) {
          unsigned k = KEY_DEAD;
          if (id >= 0) {
            const float* lg = lut_s + g * MC;
            float acc = 0.f;
            for (int m = 0; m < M; ++m) acc = acc + lookup(lg, m, C, cr[m]);
            k = f2key(acc);
          }
          keys[g * run + s] = k;
        }
      }
    }
    __syncthreads();
    // each query's candidates (at most its bound, below +inf): their count
    // and key range
    for (int g = 0; g < G; ++g) {
      const unsigned bkg = q_bk[g];
      unsigned cn = 0u, mn = KEY_DEAD, mx = 0u;
      for (int s = tid; s < R; s += THREADS) {
        const unsigned k = keys[g * run + s];
        if (k < KEY_INF && k <= bkg) {
          ++cn;
          mn = min(mn, k);
          mx = max(mx, k);
        }
      }
      cn = __reduce_add_sync(FULL, cn);
      mn = __reduce_min_sync(FULL, mn);
      mx = __reduce_max_sync(FULL, mx);
      if (lane == 0 && cn) {
        atomicAdd(&q_cnt[g], (int)cn);
        atomicMin(&q_min[g], mn);
        atomicMax(&q_max[g], mx);
      }
    }
    __syncthreads();

    // what to keep: every candidate (at most kk of them: the open range is
    // every key), or the kk smallest, selected by histograms
    if (tid < G) {
      const int g = tid;
      q_need[g] = kp;
      q_act[g] = 0;
      if (q_cnt[g] <= kp) {
        q_lo[g] = 0u;
        q_hi[g] = KEY_DEAD;
      } else {
        q_lo[g] = q_min[g];
        q_hi[g] = q_max[g];
        q_act[g] = q_min[g] != q_max[g];  // one key: the first kk in slot order
      }
    }
    __syncthreads();
    for (int pass = 0; pass < 4; ++pass) {
      bool any = false;
      for (int g = 0; g < G; ++g) any |= q_act[g] != 0;
      if (!any) break;
      for (int e = tid; e < G * BINS; e += THREADS) hist[e] = 0;
      __syncthreads();
      for (int g = 0; g < G; ++g) {
        if (!q_act[g]) continue;
        // bins of 2^sh keys over [lo, hi], at most 256: bin = (k - lo) >> sh
        const unsigned lo = q_lo[g], hi = q_hi[g], bkg = q_bk[g];
        const int sh = bin_shift(lo, hi);
        const unsigned* kg = keys + g * run;
        int* hg = hist + g * BINS;
        for (int s = tid; s < R; s += THREADS) {
          const unsigned k = kg[s];
          if (k < KEY_INF && k <= bkg && k >= lo && k <= hi) atomicAdd(&hg[(k - lo) >> sh], 1);
        }
      }
      __syncthreads();
      if (warp < G && q_act[warp]) {
        // warp g: the bin holding the need-th key of the open range
        const int g = warp, need = q_need[g];
        const unsigned lo = q_lo[g], hi = q_hi[g];
        const int sh = bin_shift(lo, hi);
        int h[BINS / 32], sum = 0;
#pragma unroll
        for (int i = 0; i < BINS / 32; ++i) {
          h[i] = hist[g * BINS + lane * (BINS / 32) + i];
          sum += h[i];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int before = incl - sum;
#pragma unroll
        for (int i = 0; i < BINS / 32; ++i) {
          if (before < need && need <= before + h[i]) {  // one lane, one bin
            const unsigned long long t = lane * (BINS / 32) + i;
            const int left = need - before;
            // bin t holds the keys lo + t 2^sh .. min(hi, lo + (t+1) 2^sh - 1)
            const unsigned nlo = lo + (unsigned)(t << sh);
            const unsigned long long top = (unsigned long long)lo + ((t + 1) << sh) - 1;
            const unsigned nhi = top < hi ? (unsigned)top : hi;
            q_lo[g] = nlo;
            q_hi[g] = nhi;
            q_need[g] = left;
            if (h[i] == left || nlo == nhi) q_act[g] = 0;
          }
          before += h[i];
        }
      }
      __syncthreads();
    }

    // kept: candidates below the open range, and the first `need` in slot
    // order of those inside it (all of them, unless it closed on one key).
    // Warp w takes a segment of the run; first each warp counts its own
    const int seg = ((R + WARPS - 1) / WARPS + 31) & ~31;
    const int a = min(R, warp * seg), z = min(R, a + seg);
    for (int g = 0; g < G; ++g) {
      const unsigned lo = q_lo[g], hi = q_hi[g], bkg = q_bk[g];
      int lt = 0, eq = 0;
      for (int s = a + lane; s < z; s += 32) {
        const unsigned k = keys[g * run + s];
        const bool cand = k < KEY_INF && k <= bkg;
        lt += cand && k < lo;
        eq += cand && k >= lo && k <= hi;
      }
      lt = (int)__reduce_add_sync(FULL, (unsigned)lt);
      eq = (int)__reduce_add_sync(FULL, (unsigned)eq);
      if (lane == 0) {
        c_lt[g][warp] = lt;
        c_eq[g][warp] = eq;
      }
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const int need = q_need[g];
      const unsigned lo = q_lo[g], hi = q_hi[g], bkg = q_bk[g];
      int lt_b = 0, eq_b = 0;
      for (int w = 0; w < warp; ++w) {
        lt_b += c_lt[g][w];
        eq_b += c_eq[g][w];
      }
      int pos = lt_b + min(eq_b, need), eqs = eq_b;
      unsigned top = 0u;
      float* od = out_d + (((size_t)gb[g] * nprobe + gr[g]) * nruns + j) * kp;
      for (int base = a; base < z; base += 32) {
        const int s = base + lane;
        const unsigned k = s < z ? keys[g * run + s] : KEY_DEAD;
        const bool cand = k < KEY_INF && k <= bkg;
        const bool lt = cand && k < lo, iseq = cand && k >= lo && k <= hi;
        const unsigned em = __ballot_sync(FULL, iseq);
        const bool sel = lt || (iseq && eqs + __popc(em & below) < need);
        eqs += __popc(em);
        const unsigned sm = __ballot_sync(FULL, sel);
        if (sel) {
          const int at = pos + __popc(sm & below);
          od[at] = key2f(k);
          kept_s[g * kp + at] = s;
          top = max(top, k);
        }
        pos += __popc(sm);
      }
      top = __reduce_max_sync(FULL, top);
      if (lane == 0 && top) atomicMax(&q_top[g], top);
      if (warp == WARPS - 1 && lane == 0) q_kept[g] = pos;  // the last segment ends the count
    }
    __syncthreads();

    // the partials' ids, every load in flight at once, and their empty
    // tails; a full partial bounds its query's kk-th
#pragma unroll 4
    for (int e = tid; e < G * kp; e += THREADS) {
      const int g = e / kp, i = e - g * kp;
      const size_t o = (((size_t)gb[g] * nprobe + gr[g]) * nruns + j) * kp + i;
      if (i < q_kept[g]) {
        out_i[o] = lrow[s0 + kept_s[e]];
      } else {
        out_d[o] = inf;
        out_i[o] = -1;
      }
    }
    if (tid < G && q_kept[tid] == kp && q_top[tid] < q_bk[tid])
      atomicMin(bound + gb[tid], q_top[tid]);
    __syncthreads();
  }
}

template <bool VEC8>
int launch(const float* lut, const uint8_t* codes, const int* lists, const int* lens,
           const int* probe, const unsigned char* valid, float* out_d, int* out_i,
           unsigned* bound, int B, int N, int M, int C, int nlist, int lcap, int ccap,
           int nprobe, int kp, int nruns, int run, int gmax, int qsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes(gmax, M, C, run, kp);
  cudaError_t err = cudaFuncSetAttribute(pq_adc_lists_kernel<VEC8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // no bound yet: the key 0xffffffff is above every key
  err = cudaMemsetAsync(bound, 0xff, sizeof(unsigned) * (size_t)B, stream);
  if (err != cudaSuccess) return (int)err;
  pq_adc_lists_kernel<VEC8><<<nlist * nruns * qsplit, THREADS, smem, stream>>>(
      lut, codes, lists, lens, probe, valid, out_d, out_i, bound, B, N, M, C, nlist, lcap,
      ccap, nprobe, kp, nruns, run, gmax, qsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long pq_adc_lists_smem_bytes(int gmax, int M, int C, int run, int kp) {
  return (long long)smem_bytes(gmax, M, C, run, kp);
}

// lut (B, M, C) float32 (C <= 256); codes (nlist, ccap, M) uint8, the
// codes of list l's slot s at [l, s]; lists (nlist, lcap) int32 padded
// with -1, lens (nlist) their true lengths (<= min(lcap, ccap)); probe
// (B, nprobe) int32 (an entry outside [0, nlist) scans nothing: its
// partials come back +inf / -1); valid (N) bool or null; out_d / out_i
// (B, nprobe * nruns * kp), query b's partial for (probe rank r, run j)
// at (r * nruns + j) * kp: the run's kp smallest (distance, slot) in slot
// order, +inf / -1 after them; bound (B) uint32 scratch.  Block (L, j, z)
// walks slots [j*run, min((j+1)*run, lens[L])) of list L for the z-th of
// every qsplit groups of up to gmax <= 8 queries.  vec8: M == 8, ccap and
// run even, codes on 16 bytes.
// Launches on `stream` and returns the first CUDA error as an int.
extern "C" int pq_adc_lists(const float* lut, const uint8_t* codes, const int* lists,
                            const int* lens, const int* probe, const unsigned char* valid,
                            float* out_d, int* out_i, unsigned* bound, int B, int N, int M,
                            int C, int nlist, int lcap, int ccap, int nprobe, int kp,
                            int nruns, int run, int gmax, int qsplit, int vec8,
                            void* stream) {
  if (B <= 0 || nlist <= 0 || nruns <= 0) return 0;
  if (M < 1 || C < 1 || C > 256 || kp < 1 || run < 0 || gmax < 1 || gmax > GMAX ||
      qsplit < 1 || (vec8 && (M != 8 || ccap % 2 || run % 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec8)
    return launch<true>(lut, codes, lists, lens, probe, valid, out_d, out_i, bound, B, N, M,
                        C, nlist, lcap, ccap, nprobe, kp, nruns, run, gmax, qsplit, s);
  return launch<false>(lut, codes, lists, lens, probe, valid, out_d, out_i, bound, B, N, M,
                       C, nlist, lcap, ccap, nprobe, kp, nruns, run, gmax, qsplit, s);
}
