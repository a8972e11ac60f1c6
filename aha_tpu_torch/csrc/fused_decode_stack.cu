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
// 512-thread block per SM, launched with cudaLaunchCooperativeKernel, and
// six grid-wide barriers per layer between the phases that need all of the
// previous phase's output:
//
//   1. rms-norm (every block, redundantly) → qkv GEMV, columns over blocks
//   2. attention partials: q/k head norms and RoPE in registers, split-KV
//      over (kv-head, head chunk, row split) work items; the fresh k/v row
//      is used from registers and written to the cache by one item
//   3. combine the splits per query head
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;        // columns of the widest GEMV tile (NCH 8)
constexpr float kNegInf = -1e30f;   // finite, as the JAX kernel's mask value

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

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 float8_to_bf16x8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive f32 workspace values, read through L2.
__device__ __forceinline__ void load8_cg(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

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
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kThreads) {
    const float v = x_bf ? __bfloat162float(x_bf[k]) : __ldcg(x + k);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) tot += s_red[i];
  const float rinv = rsqrtf(tot / H + eps);
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

// Rows of the attention splits: all blocks derive the same plan from pos.
struct SplitPlan {
  int rows, nsplit;
};

__device__ __forceinline__ SplitPlan split_plan(int live, int items_per_split) {
  int max_split = (int)gridDim.x / items_per_split;
  max_split = max_split < 1 ? 1 : max_split;
  int rows = (live + max_split - 1) / max_split;
  rows = (rows + 15) / 16 * 16;
  return {rows, (live + rows - 1) / rows};
}

// rms-norm over one head's D values held 8 per lane by LPR lanes, then the
// half-rotation RoPE (the partner half sits LPR/2 lanes away).
template <int LPR>
__device__ __forceinline__ void norm_rope(float* v, const __nv_bfloat16* w, int chunk,
                                          const float* cos_r, const float* sin_r,
                                          float eps) {
  constexpr int D = LPR * 8;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rinv = rsqrtf(ss / D + eps);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = v[i] * rinv * __bfloat162float(w[chunk * 8 + i]);
  const float sign = chunk < LPR / 2 ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float other = __shfl_xor_sync(0xffffffffu, v[i], LPR / 2);
    const int d = chunk * 8 + i;
    v[i] = v[i] * cos_r[d] + sign * other * sin_r[d];
  }
}

// Phase 2: one work item per (kv-head h, chunk of GC query heads, split).
// Sub-warps of LPR lanes take rows; each keeps (m, l, acc) per query head in
// f32; the block merges them and writes one partial per (query head, split).
template <int D, int GC>
__device__ void attention_phase(const StackArgs& a, int li, int pos, const float* qkv,
                                float* part_m, float* part_l, float* part_acc,
                                float* s_merge) {
  constexpr int LPR = D / 8;
  constexpr int RPW = 32 / LPR;
  constexpr int kSub = kWarps * RPW;
  const int G = a.hq / a.hkv, NGC = G / GC, HD = a.hkv * D, NQ = a.hq * D;
  const int live = pos + 1;
  const int items_per_split = a.hkv * NGC;
  const SplitPlan plan = split_plan(live, items_per_split);
  const int n_items = items_per_split * plan.nsplit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub_in_warp = lane / LPR, chunk = lane % LPR;
  const __nv_bfloat16* qn = a.qn + (size_t)li * D;
  const __nv_bfloat16* kn = a.kn + (size_t)li * D;
  float* s_m = s_merge;                       // [kWarps][GC]
  float* s_l = s_m + kWarps * GC;             // [kWarps][GC]
  float* s_acc = s_l + kWarps * GC;           // [kWarps][GC][D]
  const size_t layer_base = (size_t)li * a.S * HD;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int split = item / items_per_split;
    const int h = (item % items_per_split) / NGC, gc = item % NGC;
    const int r0 = split * plan.rows;
    const int r1 = min(r0 + plan.rows, live);

    float qf[GC][8];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const int head = h * G + gc * GC + j;
      load8_cg(qkv + head * D + chunk * 8, qf[j]);
      norm_rope<LPR>(qf[j], qn, chunk, a.cos_r, a.sin_r, a.eps);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[j][i] = round_bf16(qf[j][i]) * a.scale;
    }
    // the fresh row (index pos): k/v from this step's projection
    const bool has_fresh = pos >= r0 && pos < r1;
    float k_new[8], v_new[8];
    if (has_fresh) {
      load8_cg(qkv + NQ + h * D + chunk * 8, k_new);
      norm_rope<LPR>(k_new, kn, chunk, a.cos_r, a.sin_r, a.eps);
      load8_cg(qkv + NQ + HD + h * D + chunk * 8, v_new);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k_new[i] = round_bf16(k_new[i]);
        v_new[i] = round_bf16(v_new[i]);
      }
      if (gc == 0 && warp == 0 && sub_in_warp == 0) {
        const size_t off = layer_base + (size_t)pos * HD + h * D + chunk * 8;
        *reinterpret_cast<uint4*>(a.k_cache + off) = float8_to_bf16x8(k_new);
        *reinterpret_cast<uint4*>(a.v_cache + off) = float8_to_bf16x8(v_new);
      }
    }

    float m[GC], l[GC], acc[GC][8];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
    }
    const size_t base = layer_base + (size_t)h * D + chunk * 8;
    // warp-uniform bound: the shuffles below never run under divergence
    for (int rr = r0 + warp * RPW; rr < r1; rr += kSub) {
      const int r = rr + sub_in_warp;
      const bool ok = r < r1;
      float kf[8], vf[8];
      if (ok && r == pos) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          kf[i] = k_new[i];
          vf[i] = v_new[i];
        }
      } else if (ok) {
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(a.k_cache + base + (size_t)r * HD)), kf);
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(a.v_cache + base + (size_t)r * HD)), vf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qf[j][i], kf[i], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (ok) {
          const float m_new = fmaxf(m[j], s);
          const float alpha = __expf(m[j] - m_new);
          const float p = __expf(s - m_new);
          l[j] = l[j] * alpha + p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(acc[j][i], alpha, p * vf[i]);
          m[j] = m_new;
        }
      }
    }
    // merge the sub-warps of each warp (same chunk, other rows)
#pragma unroll
    for (int j = 0; j < GC; ++j) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[j], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[j], off);
        const float M = fmaxf(m[j], m_o);
        const float wa = __expf(m[j] - M), wb = __expf(m_o - M);
        l[j] = l[j] * wa + l_o * wb;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float acc_o = __shfl_xor_sync(0xffffffffu, acc[j][i], off);
          acc[j][i] = acc[j][i] * wa + acc_o * wb;
        }
        m[j] = M;
      }
    }
    if (sub_in_warp == 0) {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (chunk == 0) {
          s_m[warp * GC + j] = m[j];
          s_l[warp * GC + j] = l[j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s_acc[(warp * GC + j) * D + chunk * 8 + i] = acc[j][i];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < GC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * GC + j]);
      float Ls = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = __expf(s_m[w * GC + j] - M);
        Ls = fmaf(s_l[w * GC + j], wt, Ls);
        A = fmaf(s_acc[(w * GC + j) * D + d], wt, A);
      }
      const size_t row = (size_t)(h * G + gc * GC + j) * gridDim.x + split;
      __stcg(part_acc + row * D + d, A);
      if (d == 0) {
        __stcg(part_m + row, M);
        __stcg(part_l + row, Ls);
      }
    }
    __syncthreads();
  }
}

// Phase 3: attn[head, d] = Σ_s acc·e^(m−M) / Σ_s l·e^(m−M).
template <int D>
__device__ void combine_phase(const StackArgs& a, int pos, int items_per_split,
                              const float* part_m, const float* part_l,
                              const float* part_acc, float* attn) {
  const SplitPlan plan = split_plan(pos + 1, items_per_split);
  for (int head = blockIdx.x; head < a.hq; head += gridDim.x) {
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const size_t row0 = (size_t)head * gridDim.x;
      float M = kNegInf;
      for (int s = 0; s < plan.nsplit; ++s) M = fmaxf(M, __ldcg(part_m + row0 + s));
      float Ls = 0.f, A = 0.f;
      for (int s = 0; s < plan.nsplit; ++s) {
        const float wt = __expf(__ldcg(part_m + row0 + s) - M);
        Ls = fmaf(__ldcg(part_l + row0 + s), wt, Ls);
        A = fmaf(__ldcg(part_acc + (row0 + s) * D + d), wt, A);
      }
      __stcg(attn + head * D + d, A / fmaxf(Ls, 1e-30f));
    }
  }
}

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_kernel(const StackArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps * kMaxTile];
  __shared__ float s_out[kMaxTile];
  __nv_bfloat16* s_act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* s_merge = reinterpret_cast<float*>(smem_raw);

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const int P = gridDim.x;
  float* xbuf = a.ws;
  float* qkv = xbuf + H;
  float* attn = qkv + NQKV;
  float* act = attn + NQ;
  float* part_m = act + NI;
  float* part_l = part_m + a.hq * P;
  float* part_acc = part_l + a.hq * P;
  int pos = *a.pos;
  pos = pos < 0 ? 0 : (pos >= a.S ? a.S - 1 : pos);
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
    grid.sync();
    // 2-3. attention
    attention_phase<D, GC>(a, li, pos, qkv, part_m, part_l, part_acc, s_merge);
    grid.sync();
    combine_phase<D>(a, pos, items_per_split, part_m, part_l, part_acc, attn);
    grid.sync();
    // 4. o-proj + residual
    round_to_smem(attn, NQ, s_act);
    gemv(nch_h, a.wo + (size_t)li * NQ * H, H, NQ, s_act, s_red, s_out,
         [&](int col, float y) { __stcg(xbuf + col, __ldcg(xbuf + col) + y); });
    grid.sync();
    // 5. post-attention norm → gate|up → SwiGLU
    rms_to_smem(xbuf, nullptr, a.ln2 + (size_t)li * H, H, a.eps, s_act, s_red);
    gateup(nc_gu, a.wgu + (size_t)li * H * 2 * NI, NI, H, s_act, s_red, s_out, act);
    grid.sync();
    // 6. down + residual
    round_to_smem(act, NI, s_act);
    const bool last = li == a.L - 1;
    gemv(nch_h, a.wdn + (size_t)li * NI * H, H, NI, s_act, s_red, s_out,
         [&](int col, float y) {
           const float x3 = __ldcg(xbuf + col) + y;
           __stcg(xbuf + col, x3);
           if (last) a.x_out[col] = __float2bfloat16(x3);
         });
    if (!last) grid.sync();
  }
}

template <int D, int GC>
size_t dyn_smem_bytes(int H, int NQ, int NI) {
  int n = H > NQ ? H : NQ;
  n = n > NI ? n : NI;
  const size_t act = (size_t)n * sizeof(__nv_bfloat16);
  const size_t merge = (size_t)kWarps * GC * (D + 2) * sizeof(float);
  return ((act > merge ? act : merge) + 15) / 16 * 16;
}

template <int D, int GC>
int launch(const StackArgs& a, int grid, cudaStream_t st) {
  auto* fn = fused_stack_kernel<D, GC>;
  const size_t smem = dyn_smem_bytes<D, GC>(a.H, a.hq * D, a.NI);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  StackArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid),
                                    dim3(kThreads), params, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
