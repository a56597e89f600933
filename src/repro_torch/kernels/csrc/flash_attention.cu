// flash_attention: FlashAttention-2 forward with the online softmax,
// causal / sliding-window / written_upto masks and GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas / _flash_kernel, and with it the reference's XLA
// flash path `_sdpa_flash` (models/layers.py), which computes the same
// function: the port's attention_core takes this kernel on every flash
// call with a CUDA tensor, cached prefill included.
//
// Contract: q (B, S, H, DK), k (B, T, KV, DK), v (B, T, KV, DV)
// contiguous, float32 or bf16; out (B, S, H, DV) in q's type.  Query row i sits at absolute
// position q_offset + i and keeps key j when j <= it (causal), j > it -
// window (window > 0) and j < written_upto.  Head h reads kv head
// h / (H / KV).  logits = (q . k) * scale in float32; masked logits are
// -inf and add p = 0; the running max is guarded by isfinite, so a row
// with no kept key returns acc / max(l, 1e-30) = 0.  Accumulation and the
// p . V product stay in float32, as the reference keeps them.
//
// Bound on an H100: 2 (DK + DV) operations per kept (query, key) pair and
// head (products of DK and DV multiply-adds), against the bytes of q, k,
// v and out.  At the qwen1.5-0.5b prefill (S 4096, T 8192, written_upto 4096,
// causal, H 16, D 64) that is 34 GFLOP against 50 MB: bound by the
// operations on the bf16 tensor cores (0.035 ms at 989 TFLOP/s).  This
// kernel keeps p in float32 and multiplies on the 67 TFLOP/s FMA units,
// so it cannot come within 15x of that bound.  The wrapper sends bf16 at
// (DK, DV) (64, 64), (128, 128) and (192, 128), the main path's types and
// widths, to flash_attention_wgmma.cu (wgmma products, TMA-fed K / V, p
// split into three bf16 parts); this kernel keeps float32 inputs, held to
// 1e-4, which tensor cores cannot promise, and the widths TMA's 64-column
// boxes do not tile: hubert-xlarge's 80 in bf16 on the main path, and
// (16, 16), (24, 16) (deepseek-v3's SMOKE MLA) and (32, 32).
//
// Why not the TPU design: the Pallas kernel keeps a whole (T, D) KV
// stream of one (b, kv head) resident in VMEM per grid cell (8 MiB at
// T = 32k) and walks it in order.  A Hopper block has at most 227 KB of
// shared memory, and blocks run in parallel in no order, so here each
// block owns one (b, h, tile of 64 query rows) and streams K and V
// through shared memory in tiles of 64 keys:
//   - the tile's K and V are converted to float32 as they are staged;
//   - S = Q K^T for the 64 x 64 tile is a register-blocked float32 GEMM
//     (4 x 4 outputs a thread), masked and written to shared memory;
//   - one warp per row updates m and l (warp shuffles for the max and the
//     sum) and turns the row into p in place;
//   - acc (64 x DV, 4 x DV/16 a thread, in registers) is rescaled and gets
//     p . V.
// KV tiles that the causal, window or written_upto mask drops whole are
// never visited (exact: such a tile leaves m, l and acc unchanged), and
// the causal query tiles with the most keys are scheduled first.  S and T
// need no padding: ragged rows and keys are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bf16)
}

__host__ __device__ constexpr size_t smem_floats(int dk, int dv) {
  return (size_t)BQ * (dk + 1) + (size_t)BK * (dk + 1) + (size_t)BK * dv +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
             int H, int KV, int causal, int window, int q_offset,
             int written_upto, float scale) {
  static_assert(DV % 16 == 0, "a thread owns DV / 16 output columns");
  constexpr int JD = DV / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;                   // BQ x (DK + 1), the query tile
  float* ks = qs + BQ * (DK + 1);     // BK x (DK + 1), keys
  float* vs = ks + BK * (DK + 1);     // BK x DV, values
  float* ps = vs + BK * DV;           // BQ x (BK + 1), logits then p
  float* row_m = ps + BQ * (BK + 1);  // running max
  float* row_l = row_m + BQ;          // running denominator
  float* row_r = row_l + BQ;          // this tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = tid / 16, tr = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int rows = min(BQ, S - q0);
  const float neg_inf = __int_as_float(0xff800000);

  // keys [k_lo, k_hi) hold every key some row of the tile keeps
  const int pos_first = q_offset + q0, pos_last = q_offset + q0 + rows - 1;
  int k_hi = min(Tk, written_upto);
  if (causal) k_hi = min(k_hi, pos_last + 1);
  const int k_lo = window > 0 ? max(0, pos_first - window + 1) : 0;

  for (int e = tid; e < BQ * DK; e += THREADS) {
    const int r = e / DK, c = e % DK;
    qs[r * (DK + 1) + c] =
        r < rows ? load_f32(q + (((size_t)b * S + q0 + r) * H + h) * DK + c) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = neg_inf;
    row_l[tid] = 0.f;
  }
  float acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, t = k0 + r;
      ks[r * (DK + 1) + c] =
          t < k_hi ? load_f32(k + (((size_t)b * Tk + t) * KV + kvh) * DK + c) : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int r = e / DV, c = e % DV, t = k0 + r;
      vs[r * DV + c] =
          t < k_hi ? load_f32(v + (((size_t)b * Tk + t) * KV + kvh) * DV + c) : 0.f;
    }
    __syncthreads();

    // logits of the tile: rows tq*4 + i, keys tr + 16*j
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(tq * 4 + i) * (DK + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tr + 16 * j) * (DK + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(a[i], bk[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tq * 4 + i, qp = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tr + 16 * j, kp = k0 + c;
        bool ok = r < rows && kp < k_hi;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        ps[r * (BK + 1) + c] = ok ? sacc[i][j] * scale : neg_inf;
      }
    }
    __syncthreads();

    // online softmax, one warp a row
    for (int r = warp; r < BQ; r += WARPS) {
      float* row = ps + r * (BK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float p0 = s0 != neg_inf ? expf(s0 - shift) : 0.f;
      const float p1 = s1 != neg_inf ? expf(s1 - shift) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if (lane == 0) {
        const float resc = isfinite(m_old) ? expf(m_old - shift) : 0.f;
        row_r[r] = resc;
        row_l[r] = row_l[r] * resc + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * rescale + p . V: rows tq*4 + i, columns tr + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float resc = row_r[tq * 4 + i];
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= resc;
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(tq * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < JD; ++j) vv[j] = vs[kk * DV + tr + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // row_l is final (also when no tile was visited)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq * 4 + i;
    if (r >= rows) continue;
    const float denom = fmaxf(row_l[r], 1e-30f);
    T* o = out + (((size_t)b * S + q0 + r) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < JD; ++j) store_f32(o + tr + 16 * j, acc[i][j] / denom);
  }
}

template <int DK, int DV, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, int causal, int window, int q_offset,
           int written_upto, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(DK, DV) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DK, DV, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<DK, DV, T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Tk, H, KV, causal,
      window, q_offset, written_upto, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int Tk, int H, int KV, int DK, int DV, int causal, int window,
             int q_offset, int written_upto, float scale, cudaStream_t s) {
#define FLASH_CASE(dk, dv)                                                               \
  if (DK == dk && DV == dv)                                                             \
    return launch<dk, dv, T>(q, k, v, out, B, S, Tk, H, KV, causal, window, q_offset,  \
                             written_upto, scale, s);
  FLASH_CASE(16, 16)
  FLASH_CASE(24, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, DK), k (B, T, KV, DK), v (B, T, KV, DV), out (B, S, H, DV),
// contiguous on the device; bf16 = 1 for __nv_bfloat16, 0 for float32.
// (DK, DV) in {(16, 16), (24, 16), (32, 32), (64, 64), (80, 80), (128, 128),
// (192, 128)}, H % KV == 0, written_upto <= T (the wrapper passes T for
// None).  Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int T, int H, int KV,
                               int DK, int DV, int causal, int window, int q_offset,
                               int written_upto, float scale, int bf16,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, DK, DV, causal,
                                   window, q_offset, written_upto, scale, s);
  return launch_d<float>(q, k, v, out, B, S, T, H, KV, DK, DV, causal, window,
                         q_offset, written_upto, scale, s);
}
