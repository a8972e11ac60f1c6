// The attention of the one-launch decode stacks (fused_decode_stack.cu over
// bf16 weights, fused_decode_stack_q8.cu over the GGUF grids): one decode
// token's attention over the flat bf16 cache rows of layer `li` plus the
// fresh row, as two phases of a persistent cooperative kernel of kThreads
// threads per block, a grid barrier between them (cooperative.cuh).
//
//   attention_phase: q/k head norms and RoPE in registers, split-KV over
//     (kv-head, head chunk, row split) work items over cache rows
//     [0, n_cached) and the fresh row after them; the fresh k/v row is used
//     from registers and written by one item where the caller says (the
//     stacks: the cache row at pos = n_cached; the one-layer kernel
//     fused_decode_layer.cu: its output rows, the cache untouched);
//   combine_phase:   the splits merged per query head.
//
// Both read the projected q|k|v (f32 workspace, NQ + 2·HD) and the stack's
// arguments through any struct with the fields they name (qn, kn, cos_r,
// sin_r, k_cache, v_cache, hq, hkv, S, eps, scale).  Numerics follow the
// Pallas _attention_rows: q and the fresh k/v rounded to bf16 after RoPE,
// f32 scores and softmax state, the output left in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aha_stack {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;   // finite, as the JAX kernel's mask value

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

// 1 / sqrt(mean(x²) + eps) over x[0, H): x is the f32 workspace carry, or
// (layer 0) the bf16 input row.  Every thread returns it; s_red holds
// kWarps floats.
__device__ __forceinline__ float rms_inv(const float* x, const __nv_bfloat16* x_bf, int H,
                                         float eps, float* s_red) {
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
  __syncthreads();     // s_red is free again
  return rsqrtf(tot / H + eps);
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

// Shared memory the attention phase needs (dynamic, aliased with the
// activations of the other phases).
template <int D, int GC>
constexpr size_t merge_bytes() {
  return (size_t)kWarps * GC * (D + 2) * sizeof(float);
}

// Row `pos` of layer `li` of a flat (L, 1, S, Hkv·D) cache.
template <int D, class Args>
__device__ __forceinline__ __nv_bfloat16* cache_row(const Args& a, __nv_bfloat16* cache,
                                                    int li, int pos) {
  return cache + ((size_t)li * a.S + pos) * a.hkv * D;
}

// One work item per (kv-head h, chunk of GC query heads, split).  Sub-warps
// of LPR lanes take rows; each keeps (m, l, acc) per query head in f32; the
// block merges them and writes one partial per (query head, split).  Row
// index n_cached is the fresh row; its Hkv·D k and v values go to
// k_fresh / v_fresh.
template <int D, int GC, class Args>
__device__ void attention_phase(const Args& a, int li, int n_cached, const float* qkv,
                                float* part_m, float* part_l, float* part_acc,
                                float* s_merge, __nv_bfloat16* k_fresh,
                                __nv_bfloat16* v_fresh) {
  const int pos = n_cached;
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
        const size_t off = (size_t)h * D + chunk * 8;
        *reinterpret_cast<uint4*>(k_fresh + off) = float8_to_bf16x8(k_new);
        *reinterpret_cast<uint4*>(v_fresh + off) = float8_to_bf16x8(v_new);
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

// attn[head, d] = Σ_s acc·e^(m−M) / Σ_s l·e^(m−M).
template <int D, class Args>
__device__ void combine_phase(const Args& a, int n_cached, int items_per_split,
                              const float* part_m, const float* part_l,
                              const float* part_acc, float* attn) {
  const SplitPlan plan = split_plan(n_cached + 1, items_per_split);
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

// The stacks' f32 workspace, carved the same way by both kernels.
struct Workspace {
  float *xbuf, *qkv, *attn, *act, *part_m, *part_l, *part_acc;
};

__device__ __forceinline__ Workspace carve_ws(float* ws, int H, int NQKV, int NQ, int NI,
                                              int hq) {
  const int P = gridDim.x;
  Workspace w;
  w.xbuf = ws;
  w.qkv = w.xbuf + H;
  w.attn = w.qkv + NQKV;
  w.act = w.attn + NQ;
  w.part_m = w.act + NI;
  w.part_l = w.part_m + hq * P;
  w.part_acc = w.part_l + hq * P;
  return w;
}

__device__ __forceinline__ int clamp_pos(const int* pos, int S) {
  const int p = *pos;
  return p < 0 ? 0 : (p >= S ? S - 1 : p);
}

}  // namespace aha_stack
