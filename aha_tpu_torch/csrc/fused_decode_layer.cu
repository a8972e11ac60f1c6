// One fused Qwen3 decoder layer at decode time (B = 1, S = 1) in ONE launch;
// the new K/V row is returned, not written.
//
// Replaces aha_tpu/ops/fused_layer.py:fused_decode_layer (Pallas bodies
// _fused_layer_kernel and _attention).
//
//   x_in   (H,) bf16, the layer's input hidden state
//   wqkv, wo, wgu, wdn, ln1, ln2, q_norm, k_norm: the STACKED (L, ...) bf16
//          decode parameters of fused_decode_stack.cu; layer li is used
//   cos/sin (D,) f32, the rope row of this position
//   k/v cache (L, 1, S, HD) bf16, READ ONLY: rows [0, min(pos, window)) of
//          layer li are attended, with the fresh row after them
//   li, pos int32 on the device, read by the kernel: no host sync
//   x_out  (H,) bf16; k_row, v_row (Hkv, D) bf16, the caller writes them
//          into the cache at (li, 0, pos)
//
// Bound: one layer's weight bytes (31.5 MB at Qwen3-0.6B's widths) plus the
// live window's K/V rows, read once.  Design: the fused stack's phases for
// one layer — the GEMV tiles and norms of fused_stack_gemv.cuh, the split-KV
// attention of fused_stack_attention.cuh and the grid barrier of
// cooperative.cuh — in a persistent cooperative launch of one 512-thread
// block per SM, five grid barriers.  The numerics are the per-layer Pallas
// kernel's, not the stack's: x2 = x + attn·Wo is rounded to x's dtype for
// the residual, while the MLP's rms-norm reads the unrounded f32 x2, so
// x_out = bf16(float(bf16(x2)) + mlp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_gemv.cuh"

namespace {

using namespace aha_stack;

struct LayerArgs {
  const __nv_bfloat16 *x_in, *wqkv, *wo, *wgu, *wdn, *ln1, *ln2, *qn, *kn;
  const float *cos_r, *sin_r;
  const __nv_bfloat16 *k_cache, *v_cache;
  const int *li, *pos;
  __nv_bfloat16 *x_out, *k_row, *v_row;
  float* ws;
  int L, H, hq, hkv, NI, S, window;
  float eps, scale;
};

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps * kMaxTile];
  __shared__ float s_out[kMaxTile];
  __nv_bfloat16* s_act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* s_merge = reinterpret_cast<float*>(smem_raw);

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const Workspace w = carve_ws(a.ws, H, NQKV, NQ, NI, a.hq);
  float *xbuf = w.xbuf, *qkv = w.qkv, *attn = w.attn, *act = w.act;
  int li = *a.li;
  li = li < 0 ? 0 : (li >= a.L ? a.L - 1 : li);
  const int pos = clamp_pos(a.pos, a.S);
  const int n_cached = pos < a.window ? pos : a.window;
  const int items_per_split = a.hkv * (a.hq / a.hkv / GC);
  const int nch_qkv = chunks_for(NQKV, 4), nch_h = chunks_for(H, 4);
  const int nc_gu = chunks_for(NI, 4);

  // 1. input norm → qkv
  rms_to_smem(nullptr, a.x_in, a.ln1 + (size_t)li * H, H, a.eps, s_act, s_red);
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < H; k += kThreads) __stcg(xbuf + k, __bfloat162float(a.x_in[k]));
  gemv(nch_qkv, a.wqkv + (size_t)li * H * NQKV, NQKV, H, s_act, s_red, s_out,
       [&](int col, float y) { __stcg(qkv + col, y); });
  aha_coop::grid_barrier();
  // 2-3. attention over the window and the fresh row, which goes to k_row/v_row
  attention_phase<D, GC>(a, li, n_cached, qkv, w.part_m, w.part_l, w.part_acc, s_merge,
                         a.k_row, a.v_row);
  aha_coop::grid_barrier();
  combine_phase<D>(a, n_cached, items_per_split, w.part_m, w.part_l, w.part_acc, attn);
  aha_coop::grid_barrier();
  // 4. o-proj + residual: x2 kept in f32 (the MLP norm reads it unrounded)
  round_to_smem(attn, NQ, s_act);
  gemv(nch_h, a.wo + (size_t)li * NQ * H, H, NQ, s_act, s_red, s_out,
       [&](int col, float y) { __stcg(xbuf + col, __ldcg(xbuf + col) + y); });
  aha_coop::grid_barrier();
  // 5. post-attention norm → gate|up → SwiGLU
  rms_to_smem(xbuf, nullptr, a.ln2 + (size_t)li * H, H, a.eps, s_act, s_red);
  gateup(nc_gu, a.wgu + (size_t)li * H * 2 * NI, NI, H, s_act, s_red, s_out, act);
  aha_coop::grid_barrier();
  // 6. down + the residual on bf16(x2)
  round_to_smem(act, NI, s_act);
  gemv(nch_h, a.wdn + (size_t)li * NI * H, H, NI, s_act, s_red, s_out,
       [&](int col, float y) {
         a.x_out[col] = __float2bfloat16(round_bf16(__ldcg(xbuf + col)) + y);
       });
}

template <int D, int GC>
int launch(const LayerArgs& a, int grid, cudaStream_t st) {
  return aha_coop::launch(fused_layer_kernel<D, GC>, a, grid, kThreads,
                          dyn_smem_bytes<D, GC>(a.H, a.hq * D, a.NI), st);
}

}  // namespace

// (x_out, k_row, v_row) of layer li at position pos; the caches are read,
// never written.  Supported: D in {64, 128}, Hq % Hkv == 0, H and NI
// multiples of 8, 1 ≤ window ≤ S.  `grid` blocks (one per SM); ws holds
// H + (NQ + 2·HD) + NQ + NI + Hq·grid·(D + 2) f32.
extern "C" int aha_fused_decode_layer(
    const void* x_in, const void* wqkv, const void* wo, const void* wgu,
    const void* wdn, const void* ln1, const void* ln2, const void* qn,
    const void* kn, const void* cos_r, const void* sin_r, const void* k_cache,
    const void* v_cache, const void* li, const void* pos, void* x_out, void* k_row,
    void* v_row, void* ws, int L, int H, int hq, int hkv, int D, int NI, int S,
    int window, float eps, float scale, int grid, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || H % 8 != 0 || NI % 8 != 0 || grid < 1 || L < 1 ||
      window < 1 || window > S)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const LayerArgs a{static_cast<const bf*>(x_in), static_cast<const bf*>(wqkv),
                    static_cast<const bf*>(wo), static_cast<const bf*>(wgu),
                    static_cast<const bf*>(wdn), static_cast<const bf*>(ln1),
                    static_cast<const bf*>(ln2), static_cast<const bf*>(qn),
                    static_cast<const bf*>(kn), static_cast<const float*>(cos_r),
                    static_cast<const float*>(sin_r), static_cast<const bf*>(k_cache),
                    static_cast<const bf*>(v_cache), static_cast<const int*>(li),
                    static_cast<const int*>(pos), static_cast<bf*>(x_out),
                    static_cast<bf*>(k_row), static_cast<bf*>(v_row),
                    static_cast<float*>(ws), L, H, hq, hkv, NI, S, window, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pair = (hq / hkv) % 2 == 0;
  switch (D) {
    case 128: return pair ? launch<128, 2>(a, grid, st) : launch<128, 1>(a, grid, st);
    case 64: return pair ? launch<64, 2>(a, grid, st) : launch<64, 1>(a, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
