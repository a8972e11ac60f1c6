// The GEMV and norm phases of the one-launch decode kernels over bf16
// weights (fused_decode_stack.cu: every layer of a step; fused_decode_layer.cu:
// one layer), for a persistent cooperative kernel of kThreads threads per
// block (cooperative.cuh, fused_stack_attention.cuh).
//
// A GEMV tile is TW = 8·NCH columns; every thread streams whole 16-byte
// pieces of its rows (rows spread over the block's threads), and the block
// reduces over rows with shuffles and shared memory: deterministic, no
// atomics.  Activations a dot consumes are rounded to bf16 in shared memory
// (s_act), as the Pallas kernels' dots take them; workspace reads go through
// L2 (ld.global.cg), since other SMs wrote them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_stack_attention.cuh"

namespace aha_stack {

constexpr int kMaxTile = 64;        // columns of the widest GEMV tile (NCH 8)

// Columns per GEMV tile, in 8-column chunks: enough tiles for every block.
__device__ __forceinline__ int chunks_for(int n_cols, int max_chunks) {
  const int c = (n_cols / 8 + gridDim.x - 1) / gridDim.x;
  return c < 1 ? 1 : (c > max_chunks ? max_chunks : c);
}

// s_act[k] = bf16(x[k] · rsqrt(mean(x²) + eps) · w[k]), k < H.  x is the f32
// workspace carry, or (layer 0) the bf16 input row.
static __device__ void rms_to_smem(const float* x, const __nv_bfloat16* x_bf,
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
static __device__ void round_to_smem(const float* src, int n, __nv_bfloat16* s_act) {
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

static __device__ void gateup(int nc, const __nv_bfloat16* W, int NI, int K,
                       const __nv_bfloat16* s_a, float* s_red, float* s_out, float* act) {
  switch (nc) {
    case 1: gateup_phase<1>(W, NI, K, s_a, s_red, s_out, act); break;
    case 2: gateup_phase<2>(W, NI, K, s_a, s_red, s_out, act); break;
    case 3: gateup_phase<3>(W, NI, K, s_a, s_red, s_out, act); break;
    default: gateup_phase<4>(W, NI, K, s_a, s_red, s_out, act); break;
  }
}

// Dynamic shared memory of a bf16 one-launch kernel: the widest bf16
// activation or the attention merge, which alias.
template <int D, int GC>
size_t dyn_smem_bytes(int H, int NQ, int NI) {
  int n = H > NQ ? H : NQ;
  n = n > NI ? n : NI;
  const size_t act = (size_t)n * sizeof(__nv_bfloat16);
  const size_t merge = merge_bytes<D, GC>();
  return ((act > merge ? act : merge) + 15) / 16 * 16;
}

}  // namespace aha_stack
