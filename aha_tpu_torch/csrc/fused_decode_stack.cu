// The whole dense Qwen3 decoder stack for one decode step (B = 1, S = 1) in
// ONE launch.
//
// Replaces aha_tpu/ops/fused_layer.py:fused_decode_stack (Pallas bodies
// _fused_stack_kernel and _attention_rows).
//
//   x_in   (H,) bf16, the token's embedding row
//   wqkv   (L, H, NQ + 2·HD)   wo (L, NQ, H)   wgu (L, H, 2·NI)   wdn (L, NI, H)
//          bf16, the (in, out) layout of the port's linear weights, with the
//          q|k|v and gate|up columns fused (models/qwen3.py fuse_decode_params)
//   ln1/ln2 (L, H), q_norm/k_norm (L, D) bf16; cos/sin (D,) f32, the rope row
//          of this position (the table row repeated over both halves)
//   k/v cache (L, 1, S, HD) bf16 — the new row is written IN PLACE at `pos`
//   pos    int32 on the device, read by the kernel: no host sync
//   x_out  (H,) bf16, the stack's output before the final norm
//
// Bound: the weight bytes, 2·(H·(NQ+2·HD) + NQ·H + 2·H·NI + NI·H) per layer
// (30 MB for Qwen3-0.6B, 840 MB a step), read once; the arithmetic is one
// FMA per weight.  The Pallas kernel hides per-op launch cost behind one
// sequential grid over layers with a DMA ring in VMEM.  CUDA blocks run in
// no order, so this kernel is persistent and cooperative instead: one
// 512-thread block per SM, launched cooperatively, and five grid-wide
// barriers (cooperative.cuh) per layer between the phases that need all of
// the previous phase's output:
//
//   1. the last layer's down residual, rms-norm (every block, redundantly)
//      → qkv GEMV
//   2. attention: q/k head norms and RoPE in registers, split-KV over
//      (kv-head, head chunk, row split) work items; the fresh k/v row is
//      used from registers and written to the cache by one item
//      (fused_stack_attention.cuh, shared with the stack over the GGUF
//      grids, fused_decode_stack_q8.cu)
//   3. the splits merged for the rows each block reads → o-proj GEMV
//   4. residual, rms-norm → gate|up GEMV, each unit pairing gate and up
//      columns
//   5. SwiGLU of the rows each block reads → down GEMV
//
// and after the last layer's, block 0 writes x_out.  The weights reach the
// SMs as a stream (fused_stack_gemv.cuh): a static plan of 16 KB units per
// block, TMA copies into a shared-memory ring that runs ahead across
// phases, attention and barriers, one FMA a weight on the CUDA cores, each
// block's run partials summed in plan order by whichever phase reads them:
// no atomics, deterministic, two calls bit-equal.  The hidden state rides
// in f32 between layers as in the Pallas kernel (each block keeps it in
// shared memory); activations are rounded to bf16 where its dots round
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_gemv.cuh"

namespace {

using namespace aha_stack;

struct StackArgs {
  WeightMaps maps;
  const __nv_bfloat16 *x_in, *ln1, *ln2, *qn, *kn;
  const float *cos_r, *sin_r;
  __nv_bfloat16 *k_cache, *v_cache;
  const int* pos;
  __nv_bfloat16* x_out;
  float* ws;
  int L, H, hq, hkv, NI, S, nbuf;
  float eps, scale;
};

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_kernel(const __grid_constant__ StackArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps * kTileCols];

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const Workspace w = carve_ws(a.ws, H, NQKV, NQ, NI, a.hq, D);
  const int pos = clamp_pos(a.pos, a.S);
  const int nsplit = split_plan(pos + 1, a.hkv * (a.hq / a.hkv / GC)).nsplit;
  const SmemCarve sm = carve_smem(smem_raw, a.nbuf, act_bytes<D, GC>(H, NQ, NI), H);
  __nv_bfloat16* s_act = sm.act;
  float* s_merge = reinterpret_cast<float*>(sm.act);
  float* x = sm.x;                       // the hidden state, f32, in every block
  const LayerPlan plan(H, NQKV, NQ, NI, w.part_gemv, sm.table);
  const Phase &qkv = plan.ph[0], &o = plan.ph[1], &gu = plan.ph[2], &dn = plan.ph[3];
  WeightStream ws(a.maps, plan, 0, a.L, sm.ring, sm.bars, a.nbuf);

  for (int k = threadIdx.x; k < H; k += kThreads) x[k] = __bfloat162float(a.x_in[k]);
  __syncthreads();
  for (int li = 0; li < a.L; ++li) {
    // 1. input norm → qkv
    if (li > 0) add_phase(dn, plan.part[1], x, H);      // the last layer's down
    rms_to_smem(x, a.ln1 + (size_t)li * H, H, a.eps, s_act, s_red);
    gemv_phase<1>(ws, qkv, s_act, s_red, plan.part[0]);
    aha_coop::grid_barrier();
    // 2. attention, its splits merged where the o-proj reads them
    attention_phase<D, GC>(a, li, pos, QkvPartials{qkv, plan.part[0]}, w.part_m, w.part_l,
                           w.part_acc, nullptr, nullptr, s_merge,
                           cache_row<D>(a, a.k_cache, li, pos),
                           cache_row<D>(a, a.v_cache, li, pos));
    aha_coop::grid_barrier();
    // 3. o-proj
    rows_to_smem(o, s_act, [&](int r) {
      return combine_split<D>(w.part_m, w.part_l, w.part_acc, r / D, r % D, nsplit);
    });
    gemv_phase<1>(ws, o, s_act, s_red, plan.part[1]);
    aha_coop::grid_barrier();
    // 4. residual, post-attention norm → gate|up
    add_phase(o, plan.part[1], x, H);
    rms_to_smem(x, a.ln2 + (size_t)li * H, H, a.eps, s_act, s_red);
    gemv_phase<2>(ws, gu, s_act, s_red, plan.part[0]);
    aha_coop::grid_barrier();
    // 5. SwiGLU → down
    rows_to_smem(dn, s_act, [&](int r) { return swiglu(gu, plan.part[0], r); });
    gemv_phase<1>(ws, dn, s_act, s_red, plan.part[1]);
    aha_coop::grid_barrier();
  }
  // the last residual
  if (blockIdx.x == 0)
    for (int n = threadIdx.x; n < H; n += kThreads)
      a.x_out[n] = __float2bfloat16(x[n] + phase_sum(dn, plan.part[1], n, 0));
}

}  // namespace

// x_out = the L-layer stack applied to x_in; the cache row `pos` of every
// layer is written in place.  Supported: D in {64, 128}, Hq % Hkv == 0,
// H and NI multiples of 8; the weights 16-byte aligned.  `grid` blocks (one
// per SM: a cooperative launch fails rather than run blocks that are not
// all resident); ws (16-byte aligned) holds H + (NQ + 2·HD) + NQ + NI +
// Hq·grid·(D + 2) + 4 f32 and the GEMV partials after them, twice the most of
// ⌈K/rows⌉·⌈N/64⌉·64·pieces over the four phases (rows 128, pieces 1;
// gate|up rows 64, pieces 2, N = NI).
extern "C" int aha_fused_decode_stack(
    const void* x_in, const void* wqkv, const void* wo, const void* wgu,
    const void* wdn, const void* ln1, const void* ln2, const void* qn,
    const void* kn, const void* cos_r, const void* sin_r, void* k_cache,
    void* v_cache, const void* pos, void* x_out, void* ws, int L, int H,
    int hq, int hkv, int D, int NI, int S, float eps, float scale, int grid, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || H % 8 != 0 || NI % 8 != 0 || grid < 1 || L < 1 ||
      (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  StackArgs a{};
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
  a.k_cache = static_cast<bf*>(k_cache);
  a.v_cache = static_cast<bf*>(v_cache);
  a.pos = static_cast<const int*>(pos);
  a.x_out = static_cast<bf*>(x_out);
  a.ws = static_cast<float*>(ws);
  a.L = L;
  a.H = H;
  a.hq = hq;
  a.hkv = hkv;
  a.NI = NI;
  a.S = S;
  a.eps = eps;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pair = (hq / hkv) % 2 == 0;
  if (D == 128)
    return pair ? launch_streamed(fused_stack_kernel<128, 2>, a, grid, act_bytes<128, 2>(H, NQ, NI), st)
                : launch_streamed(fused_stack_kernel<128, 1>, a, grid, act_bytes<128, 1>(H, NQ, NI), st);
  return pair ? launch_streamed(fused_stack_kernel<64, 2>, a, grid, act_bytes<64, 2>(H, NQ, NI), st)
              : launch_streamed(fused_stack_kernel<64, 1>, a, grid, act_bytes<64, 1>(H, NQ, NI), st);
}
