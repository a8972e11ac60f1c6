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
#include "fused_stack_attention.cuh"

namespace {

using namespace aha_stack;

constexpr int kMaxTile = 64;        // columns of the widest GEMV tile (NCH 8)

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

// Columns per GEMV tile, in 8-column chunks: enough tiles for every block.
__device__ __forceinline__ int chunks_for(int n_cols, int max_chunks) {
  const int c = (n_cols / 8 + gridDim.x - 1) / gridDim.x;
  return c < 1 ? 1 : (c > max_chunks ? max_chunks : c);
}

// s_act[k] = bf16(x[k] · rsqrt(mean(x²) + eps) · w[k]), k < H.  x is the f32
// workspace carry, or (layer 0) the bf16 input row.
__device__ void rms_to_smem(const float* x, const __nv_bfloat16* x_bf,
                            const __nv_bfloat16* w, int H, float eps,
                            __nv_bfloat16* s_act, float* s_red) {
  const float rinv = rms_inv(x, x_bf, H, eps, s_red);
  for (int k = threadIdx.x; k < H; k += kThreads) {
    const float v = x_bf ? __bfloat162float(x_bf[k]) : __ldcg(x + k);
    s_act[k] = __float2bfloat16(v * rinv * __bfloat162float(w[k]));
  }
  __syncthreads();
}

// s_act[k] = bf16(src[k]), k < n: the f32 workspace vector a dot consumes.
__device__ void round_to_smem(const float* src, int n, __nv_bfloat16* s_act) {
  for (int k = threadIdx.x; k < n; k += kThreads) s_act[k] = __float2bfloat16(__ldcg(src + k));
  __syncthreads();
}

// s_out[c·8 + i] = Σ_k a[k] · W[k, cols[c] + i] for the NCH chunks of a tile
// (cols[c] < 0: an empty chunk past the edge).  Rows are spread over the
// block's threads, UNR rows in flight per thread.
template <int NCH>
__device__ void gemv_tile(const __nv_bfloat16* __restrict__ W, int ldw, int K,
                          const int (&cols)[NCH], const __nv_bfloat16* s_a,
                          float* s_red, float* s_out) {
  constexpr int UNR = NCH >= 4 ? 1 : (NCH == 1 ? 4 : 2);
  float acc[NCH * 8];
#pragma unroll
  for (int i = 0; i < NCH * 8; ++i) acc[i] = 0.f;
  for (int r0 = threadIdx.x; r0 < K; r0 += UNR * kThreads) {
    uint4 w[UNR][NCH];
    float a[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int r = r0 + u * kThreads;
      const bool ok = r < K;
      a[u] = ok ? __bfloat162float(s_a[r]) : 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        w[u][c] = (ok && cols[c] >= 0)
                      ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)r * ldw + cols[c]))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float f[8];
        bf16x8_to_float(w[u][c], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[c * 8 + i] = fmaf(a[u], f[i], acc[c * 8 + i]);
      }
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < NCH * 8; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[i] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NCH * 8; ++i) s_red[warp * kMaxTile + i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < NCH * 8) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_red[w * kMaxTile + threadIdx.x];
    s_out[threadIdx.x] = s;
  }
  __syncthreads();
}

// y = a @ W over N columns; epi(col, y) for each column, tiles over blocks.
template <int NCH, class Epi>
__device__ void gemv_phase(const __nv_bfloat16* W, int N, int K,
                           const __nv_bfloat16* s_a, float* s_red, float* s_out,
                           Epi epi) {
  constexpr int TW = NCH * 8;
  const int ntiles = (N + TW - 1) / TW;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int cols[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = tile * TW + 8 * c;
      cols[c] = col < N ? col : -1;
    }
    gemv_tile<NCH>(W, N, K, cols, s_a, s_red, s_out);
    const int col = tile * TW + threadIdx.x;
    if (threadIdx.x < TW && col < N) epi(col, s_out[threadIdx.x]);
  }
}

template <class Epi>
__device__ void gemv(int nch, const __nv_bfloat16* W, int N, int K,
                     const __nv_bfloat16* s_a, float* s_red, float* s_out, Epi epi) {
  switch (nch) {
    case 1: gemv_phase<1>(W, N, K, s_a, s_red, s_out, epi); break;
    case 2: gemv_phase<2>(W, N, K, s_a, s_red, s_out, epi); break;
    case 3: gemv_phase<3>(W, N, K, s_a, s_red, s_out, epi); break;
    default: gemv_phase<4>(W, N, K, s_a, s_red, s_out, epi); break;
  }
}

// act[j] = silu(g_j) · u_j with [g | u] = a @ W (W: (K, 2·NI)); each tile
// takes NC chunks of gate columns and the same NC chunks of up columns.
template <int NC>
__device__ void gateup_phase(const __nv_bfloat16* W, int NI, int K,
                             const __nv_bfloat16* s_a, float* s_red, float* s_out,
                             float* act) {
  constexpr int TW = NC * 8;
  const int ntiles = (NI + TW - 1) / TW;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int cols[2 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tile * TW + 8 * c;
      cols[c] = col < NI ? col : -1;
      cols[NC + c] = col < NI ? NI + col : -1;
    }
    gemv_tile<2 * NC>(W, 2 * NI, K, cols, s_a, s_red, s_out);
    const int j = tile * TW + threadIdx.x;
    if (threadIdx.x < TW && j < NI) {
      const float g = s_out[threadIdx.x], u = s_out[TW + threadIdx.x];
      __stcg(act + j, g * (1.f / (1.f + expf(-g))) * u);
    }
  }
}

__device__ void gateup(int nc, const __nv_bfloat16* W, int NI, int K,
                       const __nv_bfloat16* s_a, float* s_red, float* s_out, float* act) {
  switch (nc) {
    case 1: gateup_phase<1>(W, NI, K, s_a, s_red, s_out, act); break;
    case 2: gateup_phase<2>(W, NI, K, s_a, s_red, s_out, act); break;
    case 3: gateup_phase<3>(W, NI, K, s_a, s_red, s_out, act); break;
    default: gateup_phase<4>(W, NI, K, s_a, s_red, s_out, act); break;
  }
}

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
    attention_phase<D, GC>(a, li, pos, qkv, w.part_m, w.part_l, w.part_acc, s_merge);
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
size_t dyn_smem_bytes(int H, int NQ, int NI) {
  int n = H > NQ ? H : NQ;
  n = n > NI ? n : NI;
  const size_t act = (size_t)n * sizeof(__nv_bfloat16);
  const size_t merge = merge_bytes<D, GC>();
  return ((act > merge ? act : merge) + 15) / 16 * 16;
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
