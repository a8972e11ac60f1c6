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
// N·Kp/128·4 per scale array — over the card's memory rate; the integer
// product is 2·M·N·Kp operations at the int8 tensor rate, far below.  The
// decode projections are a few MB (1–3 µs of bytes), so latency decides
// them; the head logits at B slots (160 MB q8) are byte-bound.
//
// Design: the Pallas kernel takes each group's dot as one s8×s8→s32 product
// on the matrix unit over a sequential (m, n, k) grid.  Here the product is
// mma.sync.m16n8k32 on s8 (quant_mma.cuh).  Every block stages up to R rows
// of the activations (int8 values, per-group sx and sums, as _quant_acts);
// more rows run in passes of R (16 rows a pass fill the mma's M; R steps
// down where a wide K would pass the block's 227 KB:
// ops/quant_matmul.pass_rows).  Quantizing x costs every block the same
// instructions, so there is at most one block an SM where the units allow
// (the decode projections: one step of 96–128 blocks of 8 warps), and two
// for the head's stream.  A block step takes 8 / wk units, wk warps a unit
// splitting its K; each warp loads its first chunk before x is staged and
// every next one before it multiplies the current, and one lane pulls the
// block's units three steps ahead into L2 (a bulk prefetch of their
// contiguous columns and scales).  Warps that share a unit sum their f32
// partials in warp order in shared memory (two buffers, alternate steps);
// a warp alone on its unit stores its fragment.  The plan depends on Kp, N
// and the SM count only: a row's value is the same whatever M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_mma.cuh"

namespace {

using namespace aha_quant;


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct MatmulArgs {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const float* s;
  const float* b;
  __nv_bfloat16* y;
  int M, K, N, Kp, R, wk, span, chunks;
};

constexpr int kPrefetch = 2;   // block steps whose units are pulled into L2 ahead

// Shared memory: two buffers of the warps' partials (block steps alternate,
// so one step's partials are written while the last one's are read) where
// warps share a unit, then the staged rows.
__host__ __device__ inline size_t red_bytes(int wk) {
  return wk > 1 ? 2 * kWarps * 128 * sizeof(float) : 0;
}

template <bool Q4, bool TALL>
__global__ void __launch_bounds__(kThreads, 2) quant_matmul_kernel(const MatmulArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int gb = Q4 ? 64 : 128;
  const int G = a.Kp / kGroup;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = a.wk, upb = kWarps / wk;           // warps a unit, units a block step
  const int us = warp / wk, kp = warp - us * wk;    // this warp's unit slot and K part
  float* reds = reinterpret_cast<float*>(smem);
  const Staged st = carve_mma(smem + red_bytes(wk), a.R, a.Kp);

  // block step k takes units (blockIdx.x + k·grid)·upb + [0, upb)
  const int U = (a.N + kUnitCols - 1) / kUnitCols;
  const int steps_all = (U + upb - 1) / upb;
  const int nsteps = blockIdx.x < steps_all
                         ? (steps_all - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int passes = (a.M + a.R - 1) / a.R;
  const int per_pass = nsteps * a.chunks, total = passes * per_pass;
  const size_t col_bytes = (size_t)G * gb;

  auto unit_of = [&](int k) { return (blockIdx.x + k * gridDim.x) * upb + us; };
  auto load = [&](Frags<Q4, 1>& f, int it) {
    const int rem = it % per_pass;
    const int c0 = unit_of(rem / a.chunks) * kUnitCols, N = a.N;
    load_frags<Q4, 1>(f, a.w, a.s, a.b, G,
                      [=](int, int j) { return c0 + j < N ? c0 + j : -1; },
                      (rem % a.chunks) * wk * a.span + kp * a.span, a.span);
  };
  // one lane pulls a block step's columns (contiguous) and scales into L2
  auto prefetch = [&](int k) {
    if (warp != 0 || lane != 0 || k >= nsteps) return;
    const int u0 = (blockIdx.x + k * gridDim.x) * upb;
    const int n0 = u0 * kUnitCols, n1 = min(a.N, (u0 + upb) * kUnitCols);
    prefetch_l2(a.w + (size_t)n0 * col_bytes, (int)((size_t)(n1 - n0) * col_bytes));
    const int sb = ((n1 - n0) * G * 4) & ~15;   // n0 is a multiple of 8: aligned
    if (sb > 0) {
      prefetch_l2(a.s + (size_t)n0 * G, sb);
      if (Q4) prefetch_l2(a.b + (size_t)n0 * G, sb);
    }
  };

  Frags<Q4, 1> cur, nxt;
  if (total > 0) load(cur, 0);                   // in flight while x is quantized
  for (int k = 1; k <= kPrefetch; ++k) prefetch(k);
  int it = 0;
  for (int p = 0; p < passes; ++p) {
    const int r0 = p * a.R, rows = min(a.R, a.M - r0);
    const __nv_bfloat16* x = a.x + (size_t)r0 * a.K;
    const int K = a.K;
    __syncthreads();                      // the previous pass's rows are read
    stage_rows<Q4>([=](int m, int k) { return load_act(x + (size_t)m * K + k); }, a.K, a.Kp,
                   rows, st);
    for (int k = 0; k < nsteps; ++k) {
      if (p == 0) prefetch(k + kPrefetch + 1);
      const int c0 = unit_of(k) * kUnitCols;
      float* red = reds + (k & 1) * kWarps * 128;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      for (int c = 0; c < a.chunks; ++c, ++it) {
        if (it + 1 < total) load(nxt, it + 1);
        mma_frags<Q4, TALL, 1>(cur, c * wk * a.span + kp * a.span, a.span, st, a.Kp, rows, acc);
        cur = nxt;
      }
      const int g = lane >> 2, t = lane & 3;
      if (wk == 1) {                      // the warp's own unit: store its fragment
        const int n = c0 + 2 * t;
#pragma unroll
        for (int h = 0; h < (TALL ? 2 : 1); ++h) {
          const int m = g + 8 * h;
          if (m < rows && n < a.N) {
            __nv_bfloat16* yr = a.y + (size_t)(r0 + m) * a.N + n;
            yr[0] = __float2bfloat16(acc[0][2 * h]);
            if (n + 1 < a.N) yr[1] = __float2bfloat16(acc[0][2 * h + 1]);
          }
        }
        continue;
      }
      store_partials<TALL, 1>(red, warp, acc);
      __syncthreads();                    // the step's partials are in
      for (int i = threadIdx.x; i < upb * 128; i += kThreads) {
        const int e = i & 127, m = e >> 3, n = unit_of(k) - us + (i >> 7);
        const int col = n * kUnitCols + (e & 7);
        if (m < rows && col < a.N)
          a.y[(size_t)(r0 + m) * a.N + col] =
              __float2bfloat16(sum_partials<1>(red, (i >> 7) * wk, wk, 0, e));
      }
    }
  }
}

template <bool Q4, bool TALL>
int launch(const MatmulArgs& a, int grid, cudaStream_t st) {
  auto* fn = quant_matmul_kernel<Q4, TALL>;
  const size_t smem = red_bytes(a.wk) + staged_mma_bytes(a.R, a.Kp);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fn<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 @ the q8 (q4 = 0) or q4 (q4 = 1) grid, in
// passes of R rows (1, 2, 4, 8 or 16: ops/quant_matmul.pass_rows picks the
// most that fit), on the plan of ops/quant_matmul.matmul_plan: wk warps
// (a divisor of 8) share a unit of 8 columns, each taking `span` groups (1
// to 4) of each of a unit's `chunks` chunks; `grid` blocks.  Kp a multiple of 128
// and ≥ K; b is read for q4 only.
extern "C" int aha_quant_matmul(const void* x, const void* w, const void* s,
                                const void* b, void* y, int M, int K, int N,
                                int Kp, int q4, int R, int wk, int span, int chunks,
                                int grid, void* stream) {
  if (M < 1 || N < 1 || K < 1 || Kp % kGroup != 0 || K > Kp || (q4 && !b) ||
      (R != 1 && R != 2 && R != 4 && R != 8 && R != 16) || wk < 1 || kWarps % wk != 0 ||
      span < 1 || span > kSpanTiles || chunks * wk * span < Kp / kGroup || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MatmulArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
                     static_cast<const float*>(s), static_cast<const float*>(b),
                     static_cast<__nv_bfloat16*>(y), M, K, N, Kp, R, wk, span, chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q4) return R > 8 ? launch<true, true>(a, grid, st) : launch<true, false>(a, grid, st);
  return R > 8 ? launch<false, true>(a, grid, st) : launch<false, false>(a, grid, st);
}

// The most shared memory one block of `device` may opt in to, in bytes.
extern "C" int aha_smem_optin(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return n;
}

