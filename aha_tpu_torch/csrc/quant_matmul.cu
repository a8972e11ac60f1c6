// y = x @ W over a GGUF grid, small M: the int8 grid (q8) and the affine
// 4-bit grid (q4) in one source, templated on the grid.
//
// Replaces aha_tpu/ops/quant_matmul.py:quant_matmul (Pallas body _qmm_kernel
// with _quant_acts and _dot_q8_tile) and :quant_matmul_q4 (_q4mm_kernel with
// _dot_q4_tile).
//
//   x    (M, K) bf16; K ≤ Kp, columns past K read as 0
//   w    (N, Kp) int8 (q8) or (N, Kp/2) nibble bytes (q4): column-major rows
//   s    (N, Kp/128) f32 scales; b (N, Kp/128) f32 mins (q4 only)
//   y    (M, N) bf16
//
// Bound: the weight bytes, read once — N·Kp (q8) or N·Kp/2 (q4) plus
// N·Kp/128·4 per scale array — over the card's memory rate; the integer dot
// is one dp4a per four weights.  The decode projections are a few MB, so a
// launch (a few µs) outweighs the 1–3 µs their bytes need: this kernel is
// launch-bound there, and the fused q8/q4 decode stack is what removes that.
// The head logits at B slots (160 MB q8) are byte-bound.
//
// Design: the Pallas kernel walks a sequential (m, n, k) grid with an f32
// accumulator in VMEM.  Here every block first quantizes the activations of
// up to R rows into shared memory (int8 values, per-group sx and sums, as
// _quant_acts), then its warps take whole columns: lanes stream a column's
// contiguous bytes with 16-byte loads, __dp4a accumulates int32 per (row,
// group), and the scales apply per group in f32 (quant_dot.cuh).  More than
// R rows run in passes of R, so M = 64 at Kp = 3072 needs 52 KB of shared
// memory, not 196; R steps down from 16 where a wide K would pass the
// block's opt-in limit (227 KB on the H100: 8 rows at Qwen3-14B's
// intermediate 17408).  Blocks stride over columns, which masks the ragged
// last tile of a 151936-column head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_dot.cuh"

namespace {

using namespace aha_quant;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int R, bool Q4>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                    const uint8_t* __restrict__ w, const float* __restrict__ s,
                    const float* __restrict__ b, int N, int Kp,
                    __nv_bfloat16* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Staged st = carve(smem, R, Kp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = Kp / kGroup;
  const size_t col_bytes = Q4 ? Kp / 2 : Kp;
  for (int r0 = 0; r0 < M; r0 += R) {
    const int rows = min(R, M - r0);
    __syncthreads();                      // the previous pass is read
    quantize_rows(x + (size_t)r0 * K, K, K, Kp, rows, st.xq, st.sx, st.xsum);
    for (int n = blockIdx.x * kWarps + warp; n < N; n += gridDim.x * kWarps) {
      float acc[R];
      warp_column_dot<R, Q4>(w + n * col_bytes, s + (size_t)n * G,
                             Q4 ? b + (size_t)n * G : nullptr, st.xq, st.sx,
                             st.xsum, Kp, rows, acc);
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (m < rows && lane == m % 32)
          y[(size_t)(r0 + m) * N + n] = __float2bfloat16(acc[m]);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int R, bool Q4>
int launch(const __nv_bfloat16* x, int M, int K, const uint8_t* w,
           const float* s, const float* b, int N, int Kp, __nv_bfloat16* y,
           cudaStream_t st) {
  auto* fn = quant_matmul_kernel<R, Q4>;
  const size_t smem = staged_bytes(R, Kp);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int want = (N + kWarps - 1) / kWarps;
  const int cap = 8 * sm_count();
  fn<<<want < cap ? want : cap, kThreads, smem, st>>>(x, M, K, w, s, b, N, Kp, y);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q4>
int dispatch(int R, const __nv_bfloat16* x, int M, int K, const uint8_t* w,
             const float* s, const float* b, int N, int Kp, __nv_bfloat16* y,
             cudaStream_t st) {
  switch (R) {
    case 1: return launch<1, Q4>(x, M, K, w, s, b, N, Kp, y, st);
    case 2: return launch<2, Q4>(x, M, K, w, s, b, N, Kp, y, st);
    case 4: return launch<4, Q4>(x, M, K, w, s, b, N, Kp, y, st);
    case 8: return launch<8, Q4>(x, M, K, w, s, b, N, Kp, y, st);
    case 16: return launch<16, Q4>(x, M, K, w, s, b, N, Kp, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 @ the q8 (q4 = 0) or q4 (q4 = 1) grid, in
// passes of R rows (1, 2, 4, 8 or 16: ops/quant_matmul.pass_rows picks the
// most that fit the block's shared memory).  Kp a multiple of 128 and ≥ K;
// b is read for q4 only.
extern "C" int aha_quant_matmul(const void* x, const void* w, const void* s,
                                const void* b, void* y, int M, int K, int N,
                                int Kp, int q4, int R, void* stream) {
  if (M < 1 || N < 1 || K < 1 || Kp % kGroup != 0 || K > Kp || (q4 && !b))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* sf = static_cast<const float*>(s);
  const auto* bf = static_cast<const float*>(b);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q4 ? dispatch<true>(R, xb, M, K, wb, sf, bf, N, Kp, yb, st)
            : dispatch<false>(R, xb, M, K, wb, sf, bf, N, Kp, yb, st);
}

// The most shared memory one block of `device` may opt in to, in bytes.
extern "C" int aha_smem_optin(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return n;
}
