// The attention of the one-launch decode stacks (fused_decode_stack.cu over
// bf16 weights, fused_decode_stack_q8.cu over the GGUF grids) and of the
// one-layer block (fused_decode_layer.cu): one decode token's attention
// over the flat bf16 cache rows of layer `li` plus the fresh row, as one
// phase of a persistent cooperative kernel of kThreads threads per block
// (cooperative.cuh).
//
//   attention_phase: q/k head norms and RoPE in registers, split-KV over
//     (kv-head, head chunk, row split) work items over cache rows
//     [0, n_cached) and the fresh row after them; the fresh k/v row is used
//     from registers and written by one item where the caller says (the
//     stacks: the cache row at pos = n_cached; the one-layer kernel: its
//     output rows, the cache untouched).  Each item writes a partial
//     (m, l, acc) per query head.  Given tickets, the last split of a
//     (kv-head, head chunk) to finish — an atomic ticket it resets to 0, as
//     decode_attention.cu's — merges the chunk's splits into `attn` (the
//     quantized stack); without, the caller's next phase merges the rows
//     it reads (combine_split, the bf16 kernels).  Either way no grid
//     barrier separates a combine pass.
//
// An item reads its heads' projected q|k|v values through `qkv(col)` (col
// in [0, NQ + 2·HD)) into shared memory first, and the stack's arguments
// through any struct with the fields it names (qn, kn, cos_r, sin_r,
// k_cache, v_cache, hq, hkv, S, eps, scale).  Numerics follow the
// Pallas _attention_rows: q and the fresh k/v rounded to bf16 after RoPE,
// f32 scores and softmax state, the output left in f32; the splits merge
// in split order, whichever comes last.

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
// activations of the other phases): the merge, then an item's q|k|v.
template <int D, int GC>
__host__ __device__ constexpr size_t merge_bytes() {
  return ((size_t)kWarps * GC * (D + 2) + (GC + 2) * D) * sizeof(float);
}

// Eight consecutive f32 values of shared memory.
__device__ __forceinline__ void load8_s(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The projected q|k|v as an f32 vector that other SMs wrote.
struct QkvVector {
  const float* qkv;
  __device__ float operator()(int col) const { return __ldcg(qkv + col); }
};

// attn[head, d] = Σ_s acc·e^(m−M) / Σ_s l·e^(m−M) over the `nsplit` split
// partials of one query head (rows head·P + s, P = gridDim.x), in split
// order.
template <int D>
__device__ __forceinline__ float combine_split(const float* part_m, const float* part_l,
                                               const float* part_acc, int head, int d,
                                               int nsplit) {
  constexpr int kBatch = 16;              // splits loaded at once
  const size_t row0 = (size_t)head * gridDim.x;
  float M = kNegInf, Ls = 0.f, A = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += kBatch) {
    float m[kBatch], l[kBatch], acc[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = s0 + i < nsplit;
      m[i] = ok ? __ldcg(part_m + row0 + s0 + i) : kNegInf;
      l[i] = ok ? __ldcg(part_l + row0 + s0 + i) : 0.f;
      acc[i] = ok ? __ldcg(part_acc + (row0 + s0 + i) * D + d) : 0.f;
    }
    float Mb = M;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) Mb = fmaxf(Mb, m[i]);
    const float r = __expf(M - Mb);
    Ls *= r;
    A *= r;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const float wt = __expf(m[i] - Mb);
      Ls = fmaf(l[i], wt, Ls);
      A = fmaf(acc[i], wt, A);
    }
    M = Mb;
  }
  return A / fmaxf(Ls, 1e-30f);
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
template <int D, int GC, class Args, class Qkv>
__device__ void attention_phase(const Args& a, int li, int n_cached, Qkv qkv,
                                float* part_m, float* part_l, float* part_acc,
                                int* tickets, float* attn, float* s_merge,
                                __nv_bfloat16* k_fresh, __nv_bfloat16* v_fresh) {
  __shared__ int s_last;
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
  float* s_qkv = s_acc + kWarps * GC * D;     // [GC + 2][D]: q of the heads, k, v
  const size_t layer_base = (size_t)li * a.S * HD;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int split = item / items_per_split;
    const int h = (item % items_per_split) / NGC, gc = item % NGC;
    const int r0 = split * plan.rows;
    const int r1 = min(r0 + plan.rows, live);

    for (int i = threadIdx.x; i < (GC + 2) * D; i += kThreads) {
      const int j = i / D, d = i % D;
      s_qkv[i] = qkv(j < GC ? (h * G + gc * GC + j) * D + d : NQ + (j - GC) * HD + h * D + d);
    }
    __syncthreads();
    float qf[GC][8];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      load8_s(s_qkv + j * D + chunk * 8, qf[j]);
      norm_rope<LPR>(qf[j], qn, chunk, a.cos_r, a.sin_r, a.eps);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[j][i] = round_bf16(qf[j][i]) * a.scale;
    }
    // the fresh row (index pos): k/v from this step's projection
    const bool has_fresh = pos >= r0 && pos < r1;
    float k_new[8], v_new[8];
    if (has_fresh) {
      load8_s(s_qkv + GC * D + chunk * 8, k_new);
      norm_rope<LPR>(k_new, kn, chunk, a.cos_r, a.sin_r, a.eps);
      load8_s(s_qkv + (GC + 1) * D + chunk * 8, v_new);
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
#pragma unroll 2
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
    // the ticket: the last split of this (kv-head, head chunk) folds them
    if (tickets != nullptr) __threadfence();
    __syncthreads();
    if (tickets == nullptr) continue;
    if (threadIdx.x == 0) {
      int* ctr = tickets + h * NGC + gc;
      const int ticket = atomicAdd(ctr, 1);
      s_last = ticket == plan.nsplit - 1;
      if (s_last) *ctr = 0;                 // ready for the next layer
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int idx = threadIdx.x; idx < GC * D; idx += kThreads) {
        const int head = h * G + gc * GC + idx / D, d = idx % D;
        __stcg(attn + head * D + d,
               combine_split<D>(part_m, part_l, part_acc, head, d, plan.nsplit));
      }
    }
    __syncthreads();
  }
}

// The one-launch kernels' f32 workspace, carved the same way by each.
struct Workspace {
  float *xbuf, *qkv, *attn, *act, *part_m, *part_l, *part_acc;
  float* part_gemv;   // the streamed stacks' GEMV partials (fused_stack_gemv.cuh)
};

__device__ __forceinline__ Workspace carve_ws(float* ws, int H, int NQKV, int NQ, int NI,
                                              int hq, int D) {
  const int P = gridDim.x;
  Workspace w;
  w.xbuf = ws;
  w.qkv = w.xbuf + H;
  w.attn = w.qkv + NQKV;
  w.act = w.attn + NQ;
  w.part_m = w.act + NI;
  w.part_l = w.part_m + hq * P;
  w.part_acc = w.part_l + hq * P;
  // 16-byte aligned (add_phase reads float4s): the wrapper allots 4 more
  const size_t off = (w.part_acc + (size_t)hq * P * D) - ws;
  w.part_gemv = ws + (off + 3) / 4 * 4;
  return w;
}

__device__ __forceinline__ int clamp_pos(const int* pos, int S) {
  const int p = *pos;
  return p < 0 ? 0 : (p >= S ? S - 1 : p);
}

}  // namespace aha_stack
