// The whole Qwen3 decoder stack for one decode step (B = 1, S = 1) over
// GGUF-grid weights, in ONE launch: fused_decode_stack.cu with every
// projection on the int8 (q8) or the affine 4-bit (q4) grid, each of the
// four on its own grid (llama.cpp mixes formats per tensor: a Q4_K file
// keeps ffn_down in Q6_K, which the port packs int8).
//
// Replaces aha_tpu/ops/fused_layer.py:fused_decode_stack_q8 (Pallas body
// _fused_stack_quant_kernel with _attention_rows).
//
//   x_in     (H,) bf16, the token's embedding row
//   qkv, o, gu, dn   the four projections of every layer on the port's grids
//            (ops/quant_matmul.py): column-major rows (L, N, Kp) int8 or
//            (L, N, Kp/2) nibble bytes, scales (and q4 mins) (L, N, Kp/128)
//            f32, Kp = K exactly; q|k|v and gate|up fused on the columns
//   ln1/ln2 (L, H), q_norm/k_norm (L, D) bf16; cos/sin (D,) f32
//   k/v cache (L, 1, S, HD) bf16 — the new row is written IN PLACE at `pos`
//   pos      int32 on the device, read by the kernel: no host sync
//   x_out    (H,) bf16, the stack's output before the final norm
//
// Bound: the weight and scale bytes, read once: 420 MB int8 + 13 MB scales
// a step for Qwen3-0.6B (210 MB + 26 MB on the 4-bit grid), one dp4a per
// four weights.  The Pallas kernel streams every layer's packed rows through
// a DMA ring in VMEM over a sequential grid; here, as in the bf16 stack, one
// persistent 512-thread block per SM is launched cooperatively, with a grid
// barrier (cooperative.cuh) between the phases that need all of the previous
// phase's output:
//
//   1. rms-norm of the f32 carry (every block, redundantly), quantized per
//      128-group straight into shared memory → q|k|v columns, one warp each
//   2-3. attention and the split combine (fused_stack_attention.cuh)
//   4. attention output quantized → o columns + residual
//   5. rms-norm quantized → gate|up: each warp takes gate column j and up
//      column NI + j and writes SiLU(g)·u in f32
//   6. SiLU·u quantized → down columns + residual (the last layer also
//      writes x_out)
//
// Activations are quantized as the Pallas kernel's _quant_acts quantizes
// them — from f32 values, never rounded to bf16 first — with quant_dot.cuh's
// arithmetic (true division, round half to even, exact group sums), and the
// column dot is quant_dot.cuh's warp_column_dot, shared with the
// quant-matmul, fused-SwiGLU and head kernels.  A warp-uniform branch picks
// each projection's grid at run time, so the four grids cost no template
// variants.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_attention.cuh"
#include "quant_dot.cuh"

namespace {

using namespace aha_stack;
using aha_quant::Staged;
using aha_quant::kGroup;

// One projection's stacked grid tensors.
struct QMat {
  const uint8_t* w;
  const float *s, *b;
  int q4;
};

struct QStackArgs {
  const __nv_bfloat16 *x_in, *ln1, *ln2, *qn, *kn;
  QMat qkv, o, gu, dn;
  const float *cos_r, *sin_r;
  __nv_bfloat16 *k_cache, *v_cache;
  const int* pos;
  __nv_bfloat16* x_out;
  float* ws;
  int L, H, hq, hkv, NI, S;
  float eps, scale;
};

// Σ over column n of layer li's N × K grid with the staged activations.
// Every lane of the warp returns it.
__device__ __forceinline__ float column_dot(const QMat& m, int li, int N, int K, int n,
                                            const Staged& st) {
  const int G = K / kGroup;
  const size_t col = (size_t)li * N + n;
  float acc[1];
  if (m.q4)
    aha_quant::warp_column_dot<1, true>(m.w + col * (K / 2), m.s + col * G, m.b + col * G,
                                        st.xq, st.sx, st.xsum, K, 1, acc);
  else
    aha_quant::warp_column_dot<1, false>(m.w + col * K, m.s + col * G, nullptr, st.xq,
                                         st.sx, st.xsum, K, 1, acc);
  return acc[0];
}

// y_n = column_dot(n) for n < N, one warp per column over the grid's warps;
// lane 0 hands it to epi(n, y).
template <class Epi>
__device__ __forceinline__ void columns(const QMat& m, int li, int N, int K,
                                        const Staged& st, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n = blockIdx.x * kWarps + warp; n < N; n += gridDim.x * kWarps) {
    const float y = column_dot(m, li, N, K, n, st);
    if (lane == 0) epi(n, y);
  }
}

// rms-norm of x (f32 carry, or the bf16 row x_bf) with weights w, quantized
// per 128-group into the staged buffer.
__device__ __forceinline__ void rms_quantize(const float* x, const __nv_bfloat16* x_bf,
                                             const __nv_bfloat16* w, int H, float eps,
                                             float* s_red, const Staged& st) {
  const float rinv = rms_inv(x, x_bf, H, eps, s_red);
  aha_quant::quantize_rows_by(
      [=](int, int k) {
        const float v = x_bf ? __bfloat162float(x_bf[k]) : __ldcg(x + k);
        return v * rinv * __bfloat162float(w[k]);
      },
      H, H, 1, st.xq, st.sx, st.xsum);
}

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_q8_kernel(const QStackArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps];
  float* s_merge = reinterpret_cast<float*>(smem_raw);

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const Workspace w = carve_ws(a.ws, H, NQKV, NQ, NI, a.hq);
  const int pos = clamp_pos(a.pos, a.S);
  const int items_per_split = a.hkv * (a.hq / a.hkv / GC);

  for (int li = 0; li < a.L; ++li) {
    // 1. input norm → q|k|v
    __syncthreads();                 // the staged buffer is free (phase 6 read it)
    Staged st = aha_quant::carve(smem_raw, 1, H);
    if (li == 0) {
      rms_quantize(nullptr, a.x_in, a.ln1, H, a.eps, s_red, st);
      if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < H; k += kThreads) __stcg(w.xbuf + k, __bfloat162float(a.x_in[k]));
    } else {
      rms_quantize(w.xbuf, nullptr, a.ln1 + (size_t)li * H, H, a.eps, s_red, st);
    }
    columns(a.qkv, li, NQKV, H, st, [&](int n, float y) { __stcg(w.qkv + n, y); });
    aha_coop::grid_barrier();
    // 2-3. attention
    attention_phase<D, GC>(a, li, pos, w.qkv, w.part_m, w.part_l, w.part_acc, s_merge);
    aha_coop::grid_barrier();
    combine_phase<D>(a, pos, items_per_split, w.part_m, w.part_l, w.part_acc, w.attn);
    aha_coop::grid_barrier();
    // 4. o-proj + residual
    st = aha_quant::carve(smem_raw, 1, NQ);
    aha_quant::quantize_rows(static_cast<const float*>(w.attn), NQ, NQ, NQ, 1, st.xq, st.sx,
                             st.xsum);
    columns(a.o, li, H, NQ, st,
            [&](int n, float y) { __stcg(w.xbuf + n, __ldcg(w.xbuf + n) + y); });
    aha_coop::grid_barrier();
    // 5. post-attention norm → gate|up → SiLU·u
    st = aha_quant::carve(smem_raw, 1, H);
    rms_quantize(w.xbuf, nullptr, a.ln2 + (size_t)li * H, H, a.eps, s_red, st);
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int j = blockIdx.x * kWarps + warp; j < NI; j += gridDim.x * kWarps) {
        const float g = column_dot(a.gu, li, 2 * NI, H, j, st);
        const float u = column_dot(a.gu, li, 2 * NI, H, NI + j, st);
        if (lane == 0) __stcg(w.act + j, g * (1.f / (1.f + expf(-g))) * u);
      }
    }
    aha_coop::grid_barrier();
    // 6. down + residual
    st = aha_quant::carve(smem_raw, 1, NI);
    aha_quant::quantize_rows(static_cast<const float*>(w.act), NI, NI, NI, 1, st.xq, st.sx,
                             st.xsum);
    const bool last = li == a.L - 1;
    columns(a.dn, li, H, NI, st, [&](int n, float y) {
      const float x3 = __ldcg(w.xbuf + n) + y;
      __stcg(w.xbuf + n, x3);
      if (last) a.x_out[n] = __float2bfloat16(x3);
    });
    if (!last) aha_coop::grid_barrier();
  }
}

template <int D, int GC>
size_t dyn_smem_bytes(int H, int NQ, int NI) {
  int n = H > NQ ? H : NQ;
  n = n > NI ? n : NI;
  const size_t act = aha_quant::staged_bytes(1, n);
  const size_t merge = merge_bytes<D, GC>();
  return ((act > merge ? act : merge) + 15) / 16 * 16;
}

template <int D, int GC>
int launch(const QStackArgs& a, int grid, cudaStream_t st) {
  return aha_coop::launch(fused_stack_q8_kernel<D, GC>, a, grid, kThreads,
                          dyn_smem_bytes<D, GC>(a.H, a.hq * D, a.NI), st);
}

}  // namespace

// x_out = the L-layer stack over the grids applied to x_in; the cache row
// `pos` of every layer is written in place.  Supported: D in {64, 128},
// Hq % Hkv == 0, H, Hq·D and NI multiples of 128 (each projection's K
// exactly its grid's Kp).  Per projection w/s/b point at layer 0's grid
// tensors (b only where q4 is set).  `grid` blocks, one per SM; ws holds
// H + (NQ + 2·HD) + NQ + NI + Hq·grid·(D + 2) f32.
extern "C" int aha_fused_decode_stack_q8(
    const void* x_in, const void* const* w, const void* const* s,
    const void* const* b, const int* q4, const void* ln1, const void* ln2,
    const void* qn, const void* kn, const void* cos_r, const void* sin_r,
    void* k_cache, void* v_cache, const void* pos, void* x_out, void* ws, int L,
    int H, int hq, int hkv, int D, int NI, int S, float eps, float scale, int grid,
    void* stream) {
  if (hkv < 1 || hq % hkv != 0 || H % kGroup != 0 || NI % kGroup != 0 ||
      (hq * D) % kGroup != 0 || grid < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  QMat m[4];
  for (int i = 0; i < 4; ++i) {
    if (!w[i] || !s[i] || (q4[i] && !b[i])) return static_cast<int>(cudaErrorInvalidValue);
    m[i] = {static_cast<const uint8_t*>(w[i]), static_cast<const float*>(s[i]),
            static_cast<const float*>(b[i]), q4[i]};
  }
  using bf = __nv_bfloat16;
  const QStackArgs a{static_cast<const bf*>(x_in), static_cast<const bf*>(ln1),
                     static_cast<const bf*>(ln2), static_cast<const bf*>(qn),
                     static_cast<const bf*>(kn), m[0], m[1], m[2], m[3],
                     static_cast<const float*>(cos_r), static_cast<const float*>(sin_r),
                     static_cast<bf*>(k_cache), static_cast<bf*>(v_cache),
                     static_cast<const int*>(pos), static_cast<bf*>(x_out),
                     static_cast<float*>(ws), L, H, hq, hkv, NI, S, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pair = (hq / hkv) % 2 == 0;
  switch (D) {
    case 128: return pair ? launch<128, 2>(a, grid, st) : launch<128, 1>(a, grid, st);
    case 64: return pair ? launch<64, 2>(a, grid, st) : launch<64, 1>(a, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
