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
// 512-thread block per SM, launched cooperatively, and six grid-wide
// barriers (cooperative.cuh) per layer between the phases that need all of the
// previous phase's output:
//
//   1. rms-norm (every block, redundantly) → qkv GEMV, columns over blocks
//   2. attention partials: q/k head norms and RoPE in registers, split-KV
//      over (kv-head, head chunk, row split) work items; the fresh k/v row
//      is used from registers and written to the cache by one item
//   3. combine the splits per query head
//      (2 and 3 are fused_stack_attention.cuh, shared with the stack over
//      the GGUF grids, fused_decode_stack_q8.cu)
//   4. o-proj GEMV + residual
//   5. rms-norm → gate|up GEMV, each tile pairing gate and up columns, SwiGLU
//   6. down GEMV + residual (the last layer also writes x_out)
//
// A GEMV tile is TW = 8·NCH columns; every thread streams whole 16-byte
// pieces of its rows (rows spread over the block's threads), and the block
// reduces over rows with shuffles and shared memory: deterministic, no
// atomics.  The hidden state rides in f32 between layers as in the Pallas
// kernel; activations are rounded to bf16 where its dots round them.
// Workspace reads go through L2 (ld.global.cg): other SMs wrote them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_gemv.cuh"

namespace {

using namespace aha_stack;

struct StackArgs {
  const __nv_bfloat16 *x_in, *wqkv, *wo, *wgu, *wdn, *ln1, *ln2, *qn, *kn;
  const float *cos_r, *sin_r;
  __nv_bfloat16 *k_cache, *v_cache;
  const int* pos;
  __nv_bfloat16* x_out;
  float* ws;
  int L, H, hq, hkv, NI, S;
  float eps, scale;
};

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_kernel(const StackArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps * kMaxTile];
  __shared__ float s_out[kMaxTile];
  __nv_bfloat16* s_act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* s_merge = reinterpret_cast<float*>(smem_raw);

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const Workspace w = carve_ws(a.ws, H, NQKV, NQ, NI, a.hq);
  float *xbuf = w.xbuf, *qkv = w.qkv, *attn = w.attn, *act = w.act;
  const int pos = clamp_pos(a.pos, a.S);
  const int items_per_split = a.hkv * (a.hq / a.hkv / GC);
  const int nch_qkv = chunks_for(NQKV, 4), nch_h = chunks_for(H, 4);
  const int nc_gu = chunks_for(NI, 4);

  for (int li = 0; li < a.L; ++li) {
    // 1. input norm → qkv
    if (li == 0) {
      rms_to_smem(nullptr, a.x_in, a.ln1, H, a.eps, s_act, s_red);
      if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < H; k += kThreads) __stcg(xbuf + k, __bfloat162float(a.x_in[k]));
    } else {
      rms_to_smem(xbuf, nullptr, a.ln1 + (size_t)li * H, H, a.eps, s_act, s_red);
    }
    gemv(nch_qkv, a.wqkv + (size_t)li * H * NQKV, NQKV, H, s_act, s_red, s_out,
         [&](int col, float y) { __stcg(qkv + col, y); });
    aha_coop::grid_barrier();
    // 2-3. attention
    attention_phase<D, GC>(a, li, pos, qkv, w.part_m, w.part_l, w.part_acc, s_merge,
                            cache_row<D>(a, a.k_cache, li, pos),
                            cache_row<D>(a, a.v_cache, li, pos));
    aha_coop::grid_barrier();
    combine_phase<D>(a, pos, items_per_split, w.part_m, w.part_l, w.part_acc, attn);
    aha_coop::grid_barrier();
    // 4. o-proj + residual
    round_to_smem(attn, NQ, s_act);
    gemv(nch_h, a.wo + (size_t)li * NQ * H, H, NQ, s_act, s_red, s_out,
         [&](int col, float y) { __stcg(xbuf + col, __ldcg(xbuf + col) + y); });
    aha_coop::grid_barrier();
    // 5. post-attention norm → gate|up → SwiGLU
    rms_to_smem(xbuf, nullptr, a.ln2 + (size_t)li * H, H, a.eps, s_act, s_red);
    gateup(nc_gu, a.wgu + (size_t)li * H * 2 * NI, NI, H, s_act, s_red, s_out, act);
    aha_coop::grid_barrier();
    // 6. down + residual
    round_to_smem(act, NI, s_act);
    const bool last = li == a.L - 1;
    gemv(nch_h, a.wdn + (size_t)li * NI * H, H, NI, s_act, s_red, s_out,
         [&](int col, float y) {
           const float x3 = __ldcg(xbuf + col) + y;
           __stcg(xbuf + col, x3);
           if (last) a.x_out[col] = __float2bfloat16(x3);
         });
    if (!last) aha_coop::grid_barrier();
  }
}

template <int D, int GC>
int launch(const StackArgs& a, int grid, cudaStream_t st) {
  return aha_coop::launch(fused_stack_kernel<D, GC>, a, grid, kThreads,
                          dyn_smem_bytes<D, GC>(a.H, a.hq * D, a.NI), st);
}

}  // namespace

// x_out = the L-layer stack applied to x_in; the cache row `pos` of every
// layer is written in place.  Supported: D in {64, 128}, Hq % Hkv == 0,
// H and NI multiples of 8.  `grid` blocks (one per SM: a cooperative launch
// fails rather than run blocks that are not all resident); ws holds
// H + (NQ + 2·HD) + NQ + NI + Hq·grid·(D + 2) f32.
extern "C" int aha_fused_decode_stack(
    const void* x_in, const void* wqkv, const void* wo, const void* wgu,
    const void* wdn, const void* ln1, const void* ln2, const void* qn,
    const void* kn, const void* cos_r, const void* sin_r, void* k_cache,
    void* v_cache, const void* pos, void* x_out, void* ws, int L, int H, int hq,
    int hkv, int D, int NI, int S, float eps, float scale, int grid, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || H % 8 != 0 || NI % 8 != 0 || grid < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const StackArgs a{static_cast<const bf*>(x_in), static_cast<const bf*>(wqkv),
                    static_cast<const bf*>(wo), static_cast<const bf*>(wgu),
                    static_cast<const bf*>(wdn), static_cast<const bf*>(ln1),
                    static_cast<const bf*>(ln2), static_cast<const bf*>(qn),
                    static_cast<const bf*>(kn), static_cast<const float*>(cos_r),
                    static_cast<const float*>(sin_r), static_cast<bf*>(k_cache),
                    static_cast<bf*>(v_cache), static_cast<const int*>(pos),
                    static_cast<bf*>(x_out), static_cast<float*>(ws), L, H, hq, hkv,
                    NI, S, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pair = (hq / hkv) % 2 == 0;
  switch (D) {
    case 128: return pair ? launch<128, 2>(a, grid, st) : launch<128, 1>(a, grid, st);
    case 64: return pair ? launch<64, 2>(a, grid, st) : launch<64, 1>(a, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
