// pq_adc: product-quantization asymmetric distances, the per-query lookup
// table (LUT) in shared memory and a gather over uint8 codes.
//
// Replaces the TPU kernel src/repro/kernels/pq_adc.py: pq_adc_pallas /
// _adc_kernel, which expands each subspace's codes into a one-hot matrix
// and contracts it with the LUT on the MXU (DESIGN.md §3).  Hopper has the
// per-lane gather the TPU lacks, so this goes back to FAISS's GPU scan:
// dist[b, p] = Σ_m lut[b, m, codes[row(b, p), m]].
//
// Two forms in one kernel.  Gathered (cand != nullptr): row(b, p) =
// cand[b, p], -1 (or any id outside [0, N)) reads nothing and scores +inf;
// one launch covers the (B, P) candidate table of a batch, and the code
// rows are read straight from the (N, M) table, never copied to a (B, P, M)
// slab.  Dense (cand == nullptr): row(b, p) = p for p < N, the reference's
// (Q, N) contract.
//
// Bound on an H100: bytes.  The table and the output are 4*B*P bytes each,
// the code rows the table names M bytes each (each distinct row once) and
// the LUTs 4*B*M*C; the M adds a slot are far below any peak.  The code
// rows are a gather: an 8-byte row at M = 8 costs a 32-byte sector, so
// the rows move up to 4x the bytes the bound counts.
//
// Design: block (x, b) loads lut[b] (M*C floats, 8 KB at M = 8, C = 256)
// into shared memory and takes a contiguous run of `chunk` slots of query
// b; each thread takes slots THREADS apart, so the cand reads and output
// writes coalesce.  A thread reads its row's M code bytes in 8-byte loads
// when M % 8 == 0 and sums the M shared-memory lookups in m order, one
// float add at a time, starting from 0: the reference's one-hot product
// has exactly one non-zero term per subspace, so its sum is bitwise this
// one.  A code >= C adds 0, as the reference's one-hot does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float lookup(const float* sl, int m, int C,
                                        unsigned code) {
  return code < (unsigned)C ? sl[m * C + code] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              const int* __restrict__ cand, float* __restrict__ out, int N,
              int M, int C, int P, int chunk, int vec8) {
  extern __shared__ float sl[];  // M x C
  const int b = blockIdx.y;
  const float* lb = lut + (size_t)b * M * C;
  for (int e = threadIdx.x; e < M * C; e += THREADS) sl[e] = lb[e];
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  const int begin = blockIdx.x * chunk;
  const int end = min(P, begin + chunk);
  const int* crow = cand == nullptr ? nullptr : cand + (size_t)b * P;
  float* orow = out + (size_t)b * P;
  for (int p = begin + threadIdx.x; p < end; p += THREADS) {
    const int row = crow == nullptr ? p : crow[p];
    float acc = inf;
    if (row >= 0 && row < N) {
      const uint8_t* cr = codes + (size_t)row * M;
      acc = 0.f;
      if (vec8) {
        for (int m0 = 0; m0 < M; m0 += 8) {
          const uint2 w = *reinterpret_cast<const uint2*>(cr + m0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc = acc + lookup(sl, m0 + j, C, (w.x >> (8 * j)) & 0xffu);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc = acc + lookup(sl, m0 + 4 + j, C, (w.y >> (8 * j)) & 0xffu);
        }
      } else {
        for (int m = 0; m < M; ++m) acc = acc + lookup(sl, m, C, cr[m]);
      }
    }
    orow[p] = acc;
  }
}

}  // namespace

extern "C" long long pq_adc_smem_bytes(int M, int C) {
  return (long long)sizeof(float) * M * C;
}

// lut (B, M, C) float32; codes (N, M) uint8; cand (B, P) int32 with -1 =
// invalid slot, or nullptr for the dense form (P = N); out (B, P) float32.
// Block x takes slots [x*chunk, min(P, (x+1)*chunk)) of query blockIdx.y.
// vec8 != 0 asks for 8-byte code loads (M % 8 == 0, codes 8-byte aligned).
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int pq_adc(const float* lut, const uint8_t* codes, const int* cand,
                      float* out, int B, int N, int M, int C, int P, int chunk,
                      int nchunks, int vec8, void* stream) {
  if (B <= 0 || nchunks <= 0) return 0;
  if (M < 1 || C < 1 || C > 256 || chunk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)M * C;
  cudaError_t err = cudaFuncSetAttribute(
      pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nchunks, B);
  pq_adc_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      lut, codes, cand, out, N, M, C, P, chunk, vec8);
  return (int)cudaGetLastError();
}
