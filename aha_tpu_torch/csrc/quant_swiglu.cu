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
// at Qwen3-0.6B: 2.90 µs at 3.35 TB/s); the int8 products are far below the
// tensor rate.
//
// Design: the Pallas kernel keeps the (M, 2I) intermediate in VMEM, so the
// layer pays one launch instead of two and the intermediate never reaches
// HBM.  CUDA blocks cannot share shared memory, so this is a persistent
// cooperative kernel (one block of 8 warps per SM, cooperative.cuh) with
// one grid barrier, on the tensor-core dot of quant_mma.cuh:
//
//   1. every block quantizes x into shared memory and computes, for the
//      units j it owns (gate columns 8j..8j+7 and the same up columns, two
//      n-tiles on one A fragment), both g and u, writing
//      a = SiLU(g)·u = g · (1 / (1 + exp(−g))) · u in f32 to `act` (M·I·4
//      bytes, 12 KB at M = 1: it stays in L2);
//   2. grid barrier;
//   3. every block requantizes all of `act` (the down product reads every
//      group) and runs the down product for the 8-column units it owns.
//
// The weights do not depend on the activations, so at the start one lane
// of each block pulls the block's whole share of both products — its gate,
// up and down column blocks with their scales — into L2 with bulk
// prefetches, and each warp's registers carry down's first chunk across
// the barrier: after it only act's requantization and the dot wait.  All
// 8 warps split each unit's K; rows beyond R run in passes, both phases
// staging R rows of max(H, I) columns, so R steps down for wide
// intermediates.  Plan: ops/quant_matmul.swiglu_plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "quant_mma.cuh"

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
  int M, H, gKp, I, Hout, R, span1, chunks1, span3, chunks3;
};

// Shared memory besides the staged rows: two buffers of the warps' partials
// of two tiles (units alternate, so a unit's partials are written while
// the last unit's are read).
constexpr size_t kRedBytes = 2 * kWarps * 2 * 128 * sizeof(float);

template <bool GQ4, bool DQ4, bool TALL>
__global__ void __launch_bounds__(kThreads, 1) quant_swiglu_kernel(const SwigluArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int gb1 = GQ4 ? 64 : 128, gb3 = DQ4 ? 64 : 128;
  const int I = a.I, grid = gridDim.x, blk = blockIdx.x;
  const int G1 = a.gKp / kGroup, G3 = I / kGroup;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* reds = reinterpret_cast<float*>(smem);
  unsigned char* stage_at = smem + kRedBytes;

  const int U1 = I / kUnitCols, U3 = a.Hout / kUnitCols;
  const int n1 = blk < U1 ? (U1 - blk + grid - 1) / grid : 0;
  const int n3 = blk < U3 ? (U3 - blk + grid - 1) / grid : 0;
  const int passes = (a.M + a.R - 1) / a.R;
  const int per1 = n1 * a.chunks1, per3 = n3 * a.chunks3;
  const int tot1 = passes * per1, total = tot1 + passes * per3;

  // The block's whole share of both products into L2 at once: its gate and
  // up column blocks, its down column blocks, with their scales (and mins).
  if (warp == 0 && lane == 0) {
    for (int k = 0; k < n1; ++k) {
      const size_t j8 = (size_t)(blk + k * grid) * kUnitCols;
      for (int h = 0; h < 2; ++h) {       // gate, then up
        const size_t n = j8 + (size_t)h * I;
        prefetch_l2(a.gw + n * G1 * gb1, kUnitCols * G1 * gb1);
        prefetch_l2(a.gs + n * G1, kUnitCols * G1 * 4);
        if (GQ4) prefetch_l2(a.gb + n * G1, kUnitCols * G1 * 4);
      }
    }
    for (int k = 0; k < n3; ++k) {
      const size_t n8 = (size_t)(blk + k * grid) * kUnitCols;
      prefetch_l2(a.dw + n8 * G3 * gb3, kUnitCols * G3 * gb3);
      prefetch_l2(a.ds + n8 * G3, kUnitCols * G3 * 4);
      if (DQ4) prefetch_l2(a.db + n8 * G3, kUnitCols * G3 * 4);
    }
  }

  // chunk `it` of the warp's sequence: phase 1's (pass, unit, chunk), then
  // phase 3's; warp w takes groups [w·span, (w+1)·span) of each chunk
  auto load1 = [&](Frags<GQ4, 2>& f, int it) {
    const int rem = it % per1;
    const int j8 = (blk + (rem / a.chunks1) * grid) * kUnitCols;
    load_frags<GQ4, 2>(f, a.gw, a.gs, a.gb, G1,
                       [=](int nt, int j) { return nt * I + j8 + j; },
                       (rem % a.chunks1) * kWarps * a.span1 + warp * a.span1, a.span1);
  };
  auto load3 = [&](Frags<DQ4, 1>& f, int it) {
    const int rem = (it - tot1) % per3;
    const int n8 = (blk + (rem / a.chunks3) * grid) * kUnitCols;
    load_frags<DQ4, 1>(f, a.dw, a.ds, a.db, G3, [=](int, int j) { return n8 + j; },
                       (rem % a.chunks3) * kWarps * a.span3 + warp * a.span3, a.span3);
  };

  Frags<GQ4, 2> cur1, nxt1;
  Frags<DQ4, 1> cur3, nxt3;
  if (tot1 > 0) load1(cur1, 0);
  else if (total > 0) load3(cur3, 0);
  int it = 0;
  const int i = threadIdx.x;

  // 1. gate|up → SiLU·mul → act
  const Staged sg = carve_mma(stage_at, a.R, a.gKp);
  for (int p = 0; p < passes; ++p) {
    const int r0 = p * a.R, rows = min(a.R, a.M - r0);
    const __nv_bfloat16* x = a.x + (size_t)r0 * a.H;
    const int H = a.H;
    __syncthreads();
    stage_rows<GQ4>([=](int m, int k) { return load_act(x + (size_t)m * H + k); }, a.H, a.gKp,
                    rows, sg);
    for (int k = 0; k < n1; ++k) {
      const int j8 = (blk + k * grid) * kUnitCols;
      float* red = reds + (k & 1) * kWarps * 2 * 128;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int c = 0; c < a.chunks1; ++c, ++it) {
        if (it + 1 < tot1) load1(nxt1, it + 1);
        else if (it + 1 < total) load3(cur3, it + 1);   // down's first chunk crosses the barrier
        mma_frags<GQ4, TALL, 2>(cur1, c * kWarps * a.span1 + warp * a.span1, a.span1, sg,
                                a.gKp, rows, acc);
        cur1 = nxt1;
      }
      store_partials<TALL, 2>(red, warp, acc);
      __syncthreads();
      if (i < rows * kUnitCols) {
        const float g = sum_partials<2>(red, 0, kWarps, 0, i);
        const float u = sum_partials<2>(red, 0, kWarps, 1, i);
        __stcg(a.act + (size_t)(r0 + (i >> 3)) * I + j8 + (i & 7),
               g * (1.0f / (1.0f + expf(-g))) * u);
      }
    }
  }
  aha_coop::grid_barrier();

  // 3. requantize act → down
  const Staged sd = carve_mma(stage_at, a.R, I);
  for (int p = 0; p < passes; ++p) {
    const int r0 = p * a.R, rows = min(a.R, a.M - r0);
    const float* act = a.act + (size_t)r0 * I;
    __syncthreads();
    stage_rows<DQ4>([=](int m, int k) { return load_act(act + (size_t)m * I + k); }, I, I,
                    rows, sd);
    for (int k = 0; k < n3; ++k) {
      const int n8 = (blk + k * grid) * kUnitCols;
      float* red = reds + (k & 1) * kWarps * 2 * 128;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      for (int c = 0; c < a.chunks3; ++c, ++it) {
        if (it + 1 < total) load3(nxt3, it + 1);
        mma_frags<DQ4, TALL, 1>(cur3, c * kWarps * a.span3 + warp * a.span3, a.span3, sd, I,
                                rows, acc);
        cur3 = nxt3;
      }
      store_partials<TALL, 1>(red, warp, acc);
      __syncthreads();
      if (i < rows * kUnitCols)
        a.y[(size_t)(r0 + (i >> 3)) * a.Hout + n8 + (i & 7)] =
            __float2bfloat16(sum_partials<1>(red, 0, kWarps, 0, i));
    }
  }
}

template <bool GQ4, bool DQ4, bool TALL>
int launch(const SwigluArgs& a, int grid, cudaStream_t st) {
  const size_t smem = kRedBytes + staged_mma_bytes(a.R, a.gKp > a.I ? a.gKp : a.I);
  return aha_coop::launch(quant_swiglu_kernel<GQ4, DQ4, TALL>, a, grid, kThreads, smem, st);
}

template <bool GQ4, bool DQ4>
int dispatch(const SwigluArgs& a, int grid, cudaStream_t st) {
  return a.R > 8 ? launch<GQ4, DQ4, true>(a, grid, st) : launch<GQ4, DQ4, false>(a, grid, st);
}

}  // namespace

// y (M, Hout) bf16 = down(SiLU(gate(x)) · up(x)).  gKp ≥ H and I multiples
// of 128, Hout of 8, M ≤ 64, in passes of R rows (1, 4, 8 or 16:
// ops/quant_matmul.pass_rows picks the most that fit), on the plan of
// ops/quant_matmul.swiglu_plan: span1 / span3 groups a warp per chunk
// (span1 ≤ 2, span3 ≤ 4) and chunks1 / chunks3 chunks a unit in phases 1
// and 3; `grid` blocks, one per SM (a cooperative launch fails rather than
// run blocks that are not all resident); act holds M·I f32.
extern "C" int aha_quant_swiglu(const void* x, const void* gw, const void* gs,
                                const void* gb, const void* dw, const void* ds,
                                const void* db, void* act, void* y, int M, int H,
                                int gKp, int I, int Hout, int gq4, int dq4, int R,
                                int span1, int chunks1, int span3, int chunks3, int grid,
                                void* stream) {
  if (M < 1 || M > 64 || H < 1 || H > gKp || gKp % kGroup != 0 || I % kGroup != 0 ||
      Hout < kUnitCols || Hout % kUnitCols != 0 || grid < 1 || (gq4 && !gb) ||
      (dq4 && !db) || (R != 1 && R != 4 && R != 8 && R != 16) || span1 < 1 ||
      span1 > kSpanTiles / 2 || span3 < 1 || span3 > kSpanTiles ||
      chunks1 * kWarps * span1 < gKp / kGroup || chunks3 * kWarps * span3 < I / kGroup)
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
                     M, H, gKp, I, Hout, R, span1, chunks1, span3, chunks3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gq4) return dq4 ? dispatch<true, true>(a, grid, st) : dispatch<true, false>(a, grid, st);
  return dq4 ? dispatch<false, true>(a, grid, st) : dispatch<false, false>(a, grid, st);
}

