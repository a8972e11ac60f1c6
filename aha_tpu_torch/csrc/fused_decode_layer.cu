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
// one layer — the weight stream, GEMV phases and norms of
// fused_stack_gemv.cuh, the split-KV attention of fused_stack_attention.cuh
// and the grid barrier of cooperative.cuh — in a persistent cooperative
// launch of one 512-thread block per SM, five grid barriers.  The numerics are the per-layer Pallas kernel's, not the
// stack's: x2 = x + attn·Wo is rounded to x's dtype for the residual, while
// the MLP's rms-norm reads the unrounded f32 x2, so
// x_out = bf16(float(bf16(x2)) + mlp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_gemv.cuh"

namespace {

using namespace aha_stack;

struct LayerArgs {
  WeightMaps maps;
  const __nv_bfloat16 *x_in, *ln1, *ln2, *qn, *kn;
  const float *cos_r, *sin_r;
  const __nv_bfloat16 *k_cache, *v_cache;
  const int *li, *pos;
  __nv_bfloat16 *x_out, *k_row, *v_row;
  float* ws;
  int L, H, hq, hkv, NI, S, window, nbuf;
  float eps, scale;
};

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_layer_kernel(const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps * kTileCols];

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const Workspace w = carve_ws(a.ws, H, NQKV, NQ, NI, a.hq, D);
  int li = *a.li;
  li = li < 0 ? 0 : (li >= a.L ? a.L - 1 : li);
  const int pos = clamp_pos(a.pos, a.S);
  const int n_cached = pos < a.window ? pos : a.window;
  const int nsplit = split_plan(n_cached + 1, a.hkv * (a.hq / a.hkv / GC)).nsplit;
  const SmemCarve sm = carve_smem(smem_raw, a.nbuf, act_bytes<D, GC>(H, NQ, NI), H);
  __nv_bfloat16* s_act = sm.act;
  float* s_merge = reinterpret_cast<float*>(sm.act);
  float* x = sm.x;                       // the hidden state, f32, in every block
  const LayerPlan plan(H, NQKV, NQ, NI, w.part_gemv, sm.table);
  const Phase &qkv = plan.ph[0], &o = plan.ph[1], &gu = plan.ph[2], &dn = plan.ph[3];
  WeightStream ws(a.maps, plan, li, li + 1, sm.ring, sm.bars, a.nbuf);

  // 1. input norm → qkv
  for (int k = threadIdx.x; k < H; k += kThreads) x[k] = __bfloat162float(a.x_in[k]);
  __syncthreads();
  rms_to_smem(x, a.ln1 + (size_t)li * H, H, a.eps, s_act, s_red);
  gemv_phase<1>(ws, qkv, s_act, s_red, plan.part[0]);
  aha_coop::grid_barrier();
  // 2. attention over the window and the fresh row, which goes to k_row/v_row
  attention_phase<D, GC>(a, li, n_cached, QkvPartials{qkv, plan.part[0]}, w.part_m, w.part_l,
                         w.part_acc, nullptr, nullptr, s_merge, a.k_row, a.v_row);
  aha_coop::grid_barrier();
  // 3. o-proj on the merged splits
  rows_to_smem(o, s_act, [&](int r) {
    return combine_split<D>(w.part_m, w.part_l, w.part_acc, r / D, r % D, nsplit);
  });
  gemv_phase<1>(ws, o, s_act, s_red, plan.part[1]);
  aha_coop::grid_barrier();
  // 4. residual: x2 kept in f32 (the MLP norm reads it unrounded) → gate|up
  add_phase(o, plan.part[1], x, H);
  rms_to_smem(x, a.ln2 + (size_t)li * H, H, a.eps, s_act, s_red);
  gemv_phase<2>(ws, gu, s_act, s_red, plan.part[0]);
  aha_coop::grid_barrier();
  // 5. SwiGLU → down
  rows_to_smem(dn, s_act, [&](int r) { return swiglu(gu, plan.part[0], r); });
  gemv_phase<1>(ws, dn, s_act, s_red, plan.part[1]);
  aha_coop::grid_barrier();
  // the residual on bf16(x2)
  if (blockIdx.x == 0)
    for (int n = threadIdx.x; n < H; n += kThreads)
      a.x_out[n] = __float2bfloat16(round_bf16(x[n]) + phase_sum(dn, plan.part[1], n, 0));
}

}  // namespace

// (x_out, k_row, v_row) of layer li at position pos; the caches are read,
// never written.  Supported: D in {64, 128}, Hq % Hkv == 0, H and NI
// multiples of 8, 1 ≤ window ≤ S.  `grid` blocks (one per SM); ws as
// aha_fused_decode_stack's.
extern "C" int aha_fused_decode_layer(
    const void* x_in, const void* wqkv, const void* wo, const void* wgu,
    const void* wdn, const void* ln1, const void* ln2, const void* qn,
    const void* kn, const void* cos_r, const void* sin_r, const void* k_cache,
    const void* v_cache, const void* li, const void* pos, void* x_out, void* k_row,
    void* v_row, void* ws, int L, int H, int hq, int hkv, int D, int NI,
    int S, int window, float eps, float scale, int grid, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || H % 8 != 0 || NI % 8 != 0 || grid < 1 || L < 1 ||
      window < 1 || window > S || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  LayerArgs a{};
  const int NQ = hq * D, NQKV = NQ + 2 * hkv * D;
  if (!make_weight_maps(&a.maps, wqkv, wo, wgu, wdn, L, H, NQKV, NQ, NI))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x_in = static_cast<const bf*>(x_in);
  a.ln1 = static_cast<const bf*>(ln1);
  a.ln2 = static_cast<const bf*>(ln2);
  a.qn = static_cast<const bf*>(qn);
  a.kn = static_cast<const bf*>(kn);
  a.cos_r = static_cast<const float*>(cos_r);
  a.sin_r = static_cast<const float*>(sin_r);
  a.k_cache = static_cast<const bf*>(k_cache);
  a.v_cache = static_cast<const bf*>(v_cache);
  a.li = static_cast<const int*>(li);
  a.pos = static_cast<const int*>(pos);
  a.x_out = static_cast<bf*>(x_out);
  a.k_row = static_cast<bf*>(k_row);
  a.v_row = static_cast<bf*>(v_row);
  a.ws = static_cast<float*>(ws);
  a.L = L;
  a.H = H;
  a.hq = hq;
  a.hkv = hkv;
  a.NI = NI;
  a.S = S;
  a.window = window;
  a.eps = eps;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pair = (hq / hkv) % 2 == 0;
  if (D == 128)
    return pair ? launch_streamed(fused_layer_kernel<128, 2>, a, grid, act_bytes<128, 2>(H, NQ, NI), st)
                : launch_streamed(fused_layer_kernel<128, 1>, a, grid, act_bytes<128, 1>(H, NQ, NI), st);
  return pair ? launch_streamed(fused_layer_kernel<64, 2>, a, grid, act_bytes<64, 2>(H, NQ, NI), st)
              : launch_streamed(fused_layer_kernel<64, 1>, a, grid, act_bytes<64, 1>(H, NQ, NI), st);
}
