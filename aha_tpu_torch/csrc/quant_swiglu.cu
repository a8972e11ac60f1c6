// A whole decode MLP over the GGUF grids in ONE launch:
// y = down(SiLU(gate(x)) · up(x)), gate|up and down each on the int8 (q8) or
// the affine 4-bit (q4) grid — four variants, as the Pallas kernel has.
//
// Replaces aha_tpu/ops/quant_matmul.py:quant_swiglu (Pallas body
// _swiglu_kernel).
//
//   x    (M, H) bf16, M ≤ 64
//   gu   the fused [gate | up] weights: (2I, Hp) q8 or (2I, Hp/2) q4 column
//        rows, with (2I, Hp/128) scales (and mins); gate is columns [0, I),
//        up [I, 2I)
//   dn   (Hout, I) q8 or (Hout, I/2) q4 column rows, (Hout, I/128) scales
//   act  (M, I) f32 workspace; y (M, Hout) bf16
//
// Bound: the weight and scale bytes of both products, read once (9.73 MB q8
// at Qwen3-0.6B: 2.90 µs at 3.35 TB/s); one dp4a per four weights.
//
// Design: the Pallas kernel keeps the (M, 2I) intermediate in VMEM, so the
// layer pays one launch instead of two and the intermediate never reaches
// HBM.  CUDA blocks cannot share shared memory, so this is a persistent
// cooperative kernel (one block per SM, cooperative.cuh) with one grid
// barrier:
//
//   1. every block quantizes x into shared memory and computes, for the
//      columns j it owns, both g_j and u_j (columns j and I + j), writing
//      a = SiLU(g)·u = g · (1 / (1 + exp(−g))) · u in f32 to `act` (M·I·4
//      bytes, 12 KB at M = 1: it stays in L2);
//   2. grid barrier;
//   3. every block requantizes all of `act` (the down product reads every
//      group) and runs the down product for the columns it owns.
//
// Rows beyond R run in passes, as in quant_matmul.cu; both passes stage
// R rows of max(H, I) columns, so R steps down for wide intermediates.  The column dot is
// quant_dot.cuh's, shared with quant_matmul.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "quant_dot.cuh"

namespace {

using namespace aha_quant;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct SwigluArgs {
  const __nv_bfloat16* x;
  const uint8_t *gw, *dw;
  const float *gs, *gb, *ds, *db;
  float* act;
  __nv_bfloat16* y;
  int M, H, gKp, I, Hout;
};

template <int R, bool GQ4, bool DQ4>
__global__ void __launch_bounds__(kThreads, 1) quant_swiglu_kernel(const SwigluArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;
  const int I = a.I;
  const int gG = a.gKp / kGroup, dG = I / kGroup;
  const size_t g_bytes = GQ4 ? a.gKp / 2 : a.gKp;
  const size_t d_bytes = DQ4 ? I / 2 : I;

  // 1. gate|up → SiLU·mul → act
  const Staged sg = carve(smem, R, a.gKp);
  for (int r0 = 0; r0 < a.M; r0 += R) {
    const int rows = min(R, a.M - r0);
    __syncthreads();
    quantize_rows(a.x + (size_t)r0 * a.H, a.H, a.H, a.gKp, rows, sg.xq, sg.sx, sg.xsum);
    for (int j = first; j < I; j += stride) {
      float g[R], u[R];
      warp_column_dot<R, GQ4>(a.gw + j * g_bytes, a.gs + (size_t)j * gG,
                              GQ4 ? a.gb + (size_t)j * gG : nullptr, sg.xq, sg.sx,
                              sg.xsum, a.gKp, rows, g);
      const size_t ju = (size_t)I + j;
      warp_column_dot<R, GQ4>(a.gw + ju * g_bytes, a.gs + ju * gG,
                              GQ4 ? a.gb + ju * gG : nullptr, sg.xq, sg.sx, sg.xsum,
                              a.gKp, rows, u);
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (m < rows && lane == m % 32)
          __stcg(a.act + (size_t)(r0 + m) * I + j,
                 g[m] * (1.0f / (1.0f + expf(-g[m]))) * u[m]);
    }
  }
  aha_coop::grid_barrier();

  // 3. requantize act → down
  const Staged sd = carve(smem, R, I);
  for (int r0 = 0; r0 < a.M; r0 += R) {
    const int rows = min(R, a.M - r0);
    __syncthreads();
    quantize_rows(static_cast<const float*>(a.act) + (size_t)r0 * I, I, I, I, rows,
                  sd.xq, sd.sx, sd.xsum);
    for (int n = first; n < a.Hout; n += stride) {
      float acc[R];
      warp_column_dot<R, DQ4>(a.dw + n * d_bytes, a.ds + (size_t)n * dG,
                              DQ4 ? a.db + (size_t)n * dG : nullptr, sd.xq, sd.sx,
                              sd.xsum, I, rows, acc);
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (m < rows && lane == m % 32)
          a.y[(size_t)(r0 + m) * a.Hout + n] = __float2bfloat16(acc[m]);
    }
  }
}

template <int R, bool GQ4, bool DQ4>
int launch(const SwigluArgs& a, int grid, cudaStream_t st) {
  const size_t smem = staged_bytes(R, a.gKp > a.I ? a.gKp : a.I);
  return aha_coop::launch(quant_swiglu_kernel<R, GQ4, DQ4>, a, grid, kThreads, smem, st);
}

template <bool GQ4, bool DQ4>
int dispatch(int R, const SwigluArgs& a, int grid, cudaStream_t st) {
  switch (R) {
    case 1: return launch<1, GQ4, DQ4>(a, grid, st);
    case 4: return launch<4, GQ4, DQ4>(a, grid, st);
    case 8: return launch<8, GQ4, DQ4>(a, grid, st);
    case 16: return launch<16, GQ4, DQ4>(a, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y (M, Hout) bf16 = down(SiLU(gate(x)) · up(x)).  gKp ≥ H and I multiples
// of 128, M ≤ 64, in passes of R rows (1, 4, 8 or 16: ops/quant_matmul.
// pass_rows picks the most that fit the block's shared memory); `grid`
// blocks, one per SM (a cooperative launch fails rather than run blocks that
// are not all resident); act holds M·I f32.
extern "C" int aha_quant_swiglu(const void* x, const void* gw, const void* gs,
                                const void* gb, const void* dw, const void* ds,
                                const void* db, void* act, void* y, int M, int H,
                                int gKp, int I, int Hout, int gq4, int dq4, int R,
                                int grid, void* stream) {
  if (M < 1 || M > 64 || H < 1 || H > gKp || gKp % kGroup != 0 || I % kGroup != 0 ||
      Hout < 1 || grid < 1 || (gq4 && !gb) || (dq4 && !db))
    return static_cast<int>(cudaErrorInvalidValue);
  const SwigluArgs a{static_cast<const __nv_bfloat16*>(x),
                     static_cast<const uint8_t*>(gw),
                     static_cast<const uint8_t*>(dw),
                     static_cast<const float*>(gs),
                     static_cast<const float*>(gb),
                     static_cast<const float*>(ds),
                     static_cast<const float*>(db),
                     static_cast<float*>(act),
                     static_cast<__nv_bfloat16*>(y),
                     M, H, gKp, I, Hout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gq4) return dq4 ? dispatch<true, true>(R, a, grid, st) : dispatch<true, false>(R, a, grid, st);
  return dq4 ? dispatch<false, true>(R, a, grid, st) : dispatch<false, false>(R, a, grid, st);
}
