// The fold of the one-launch split-KV decode kernels (decode_attention.cu
// over the bf16 and float32 caches, decode_attention_q8.cu over the int8
// one), run by the last block of each (slot, grid row) to finish.
//
//   part_m/part_l (B, Hq, maxsplit) f32: a split's score max and the sum of
//   exp(s - m) over its rows; part_acc (B, Hq, maxsplit, D) f32: the split's
//   sum of exp(s - m) · v.  A split with no live rows has m = kNegInf,
//   l = 0, acc = 0, and weighs nothing.
//
// Every block of a (slot, kv-head, share) — blockIdx.z, blockIdx.y — takes
// an atomic ticket on its own counter after writing its partials; the
// block that draws the last one resets the counter to 0 for the next
// launch and folds the slot's `nsplit` splits for the share's G query
// heads: the per-split weights exp(m_s - M) and Σ l_s·w_s by warps over
// the splits, then the G·D channels, each summed over the splits by groups
// of threads in a fixed order and the groups folded in a fixed order:
// deterministic, whichever block arrives last.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace aha_decode {

constexpr float kNegInf = -1e30f;    // finite, as the JAX kernels' NEG_INF
constexpr int kMaxSplit = 256;       // splits per (slot, kv-head) at most

// Floats of shared memory the fold takes (float4-aligned).
__host__ __device__ constexpr int fold_floats(int G, int threads) {
  return G * kMaxSplit + 8 + threads * 4;
}

// Four output channels in the output's type: bf16 (the bf16 and int8
// caches) or float32 (the float32 cache).
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c,
                                       float d) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(dst);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// Call with every thread after the block's partial writes; `smem` holds
// fold_floats(G, THREADS) floats, 16-byte aligned, free for the fold.
// head0: the first query head (b·Hq + ...) of the block's share; `out`
// bf16 or float32.
template <int D, int G, int THREADS, typename TOut>
__device__ __forceinline__ void fold_if_last(const float* __restrict__ part_m,
                                             const float* __restrict__ part_l,
                                             const float* __restrict__ part_acc,
                                             int* __restrict__ counters,
                                             TOut* __restrict__ out, size_t head0,
                                             int maxsplit, int nsplit, float* smem) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int s_last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ctr = counters + (size_t)blockIdx.z * gridDim.y + blockIdx.y;
    const int ticket = atomicAdd(ctr, 1);
    s_last = ticket == nsplit - 1;
    if (s_last) *ctr = 0;                   // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  float* s_w = smem;                        // [G][kMaxSplit] exp(m_s - M)
  float* s_inv = s_w + G * kMaxSplit;       // [G ≤ 8] 1 / Σ l_s·w_s
  float4* s_part = reinterpret_cast<float4*>(s_inv + 8);   // [THREADS]
  for (int g = warp; g < G; g += kWarps) {
    const size_t row0 = (head0 + g) * maxsplit;
    float M = kNegInf;
    for (int s = lane; s < nsplit; s += 32) M = fmaxf(M, __ldcg(part_m + row0 + s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float Ls = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float wt = __expf(__ldcg(part_m + row0 + s) - M);
      s_w[g * kMaxSplit + s] = wt;
      Ls = fmaf(__ldcg(part_l + row0 + s), wt, Ls);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) Ls += __shfl_xor_sync(0xffffffffu, Ls, off);
    if (lane == 0) s_inv[g] = 1.f / fmaxf(Ls, 1e-30f);
  }
  __syncthreads();
  // G·D/4 float4 outputs; `groups` threads per output, each summing the
  // splits s ≡ its group (mod groups) in order
  constexpr int kOut = G * D / 4;
  constexpr int kGroups = THREADS / kOut > 0 ? THREADS / kOut : 1;
  static_assert(kOut <= THREADS, "one float4 output per thread at least");
  {
    const int o = threadIdx.x % kOut, gi = threadIdx.x / kOut;
    const int g = o / (D / 4), d4 = o % (D / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi < kGroups) {
      const float4* src = reinterpret_cast<const float4*>(part_acc) +
                          ((head0 + g) * maxsplit) * (D / 4) + d4;
#pragma unroll 8
      for (int s = gi; s < nsplit; s += kGroups) {
        const float wt = s_w[g * kMaxSplit + s];
        const float4 x = __ldcg(src + (size_t)s * (D / 4));
        a.x = fmaf(x.x, wt, a.x);
        a.y = fmaf(x.y, wt, a.y);
        a.z = fmaf(x.z, wt, a.z);
        a.w = fmaf(x.w, wt, a.w);
      }
    }
    s_part[threadIdx.x] = a;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    const int o = threadIdx.x, g = o / (D / 4), d4 = o % (D / 4);
    float4 a = s_part[o];
#pragma unroll
    for (int gi = 1; gi < kGroups; ++gi) {
      const float4 x = s_part[gi * kOut + o];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float inv = s_inv[g];
    store4(out + (head0 + g) * D + d4 * 4, a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

}  // namespace aha_decode
