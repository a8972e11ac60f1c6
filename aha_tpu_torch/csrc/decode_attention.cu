// One-token GQA decode attention over the stacked flat KV cache, in one
// launch: split-KV partials and their fold.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_decode_at_layer_flat
// (Pallas body _decode_stacked_flat_kernel), and through views of the same
// bytes flash_decode_at_layer_flat_batched, flash_decode_at_layer and
// flash_decode.
//
//   q   (B, 1, Hq, D) bf16, contiguous
//   k/v (L, B, S, Hkv*D) bf16, contiguous — the flat cache of core/cache.py
//   layer, valid_len: int32 on the device, read by the kernel itself, so a
//   decode step never syncs the host.  Rows [0, valid_len[b]) are attended.
//
// Bound: HBM bytes, 2 * valid_len * Hkv * D * 2 B per layer per step, and at
// a thousand rows the latency of one launch and a few DRAM round trips.
// Design ("flash decoding" with the combine folded in):
//
// - Grid (nsplit, Hkv · shares, B), nsplit fixed by S and Hkv only (the wrapper:
//   enough blocks to fill 132 SMs at Hkv 2 as at Hkv 8).  Each block takes
//   its share of its slot's LIVE rows: the slot uses ceil(valid / 32)
//   splits at most, so a 1000-row decode spreads over 32 splits per
//   kv-head whatever S is, and a split past the slot's count exits at once.
//   A slot's result depends only on its own length: bit-equal to a B = 1
//   launch on that slot alone.
// - 8 warps; D/8 lanes own a row (16-byte loads; at D 192 the row's 24
//   lanes are a 32-lane sub-warp whose last 8 read nothing and add zeros),
//   each sub-warp loads two rows before it computes, so a 32-row split is
//   one DRAM round trip.  A
//   block scores two of the group's G = Hq/Hkv query heads (all of them at
//   G = 1) from that one read, each keeping its running (max, sum, acc) in
//   f32; the G/2 blocks of a kv-head's heads read the same rows, the later
//   reads from L2, so each share's fold stays short.  Sub-warps merge by
//   shuffles, warps in shared memory, and the block writes one partial per
//   (query head, split).
// - The last block of each (slot, kv-head, share) to finish — an atomic
//   ticket on a counter of its own, which that block resets to 0 for the
//   next launch — folds the slot's splits for its heads in a fixed order
//   (decode_fold.cuh, shared with decode_attention_q8.cu): deterministic,
//   whichever block arrives last.
// - Any group size G = Hq / Hkv: a block scores two heads when G is even
//   and one when it is odd (G 3, 5, 7 — Qwen2.5-VL-7B has 28 over 4), so
//   the shares always tile the group; a group of 16 is 8 blocks a kv-head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_fold.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinRows = 32;         // live rows per split at least
using aha_decode::kMaxSplit;
using aha_decode::kNegInf;

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The smallest power of two >= n (n <= 32): the lanes a sub-warp takes for
// a row of n 16-byte chunks, so the shuffle trees stay whole.
__host__ __device__ constexpr int pow2_lanes(int n) {
  return n <= 1 ? 1 : 2 * pow2_lanes((n + 1) / 2);
}

template <int D, int G>   // G: the query heads one block scores
struct Smem {
  static constexpr int kChunks = D / 8;             // 16-byte chunks a row
  static constexpr int kLanesPerRow = pow2_lanes(kChunks);
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  // phase 1: per-warp (m, l, acc); phase 2 (the fold) reuses the bytes
  static constexpr int kMerge = kWarps * G * (D + 2);
  static constexpr int kFold = aha_decode::fold_floats(G, kThreads);
  static constexpr int kFloats = kMerge > kFold ? kMerge : kFold;
};

// G here is the block's share of a kv-head's query heads (HB): the group's
// Hq/Hkv heads are split over Hq/Hkv/G blocks that read the same rows (the
// second read hits L2), so the fold of each share stays short.
template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ layer,
              const int* __restrict__ valid_len, int vl_stride, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_acc,
              int* __restrict__ counters, __nv_bfloat16* __restrict__ out, int B, int Hq,
              int Hkv, int L, int S, float scale) {
  constexpr int LPR = Smem<D, G>::kLanesPerRow;
  constexpr int RPW = Smem<D, G>::kRowsPerWarp;
  constexpr int kSub = kWarps * RPW;                // rows per load wave
  __shared__ __align__(16) float smem[Smem<D, G>::kFloats];

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_share = Hq / Hkv / G;                 // blocks per kv-head
  const int h = blockIdx.y / n_share, share = blockIdx.y % n_share;
  const int maxsplit = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub_in_warp = lane / LPR, chunk = lane % LPR;
  const int sub = warp * RPW + sub_in_warp;
  const bool live = chunk < Smem<D, G>::kChunks;   // a lane past the row adds zeros

  int li = *layer;
  li = li < 0 ? 0 : (li >= L ? L - 1 : li);
  int valid = valid_len[b * vl_stride];
  valid = valid < 0 ? 0 : (valid > S ? S : valid);
  int nsplit = (valid + kMinRows - 1) / kMinRows;
  nsplit = nsplit < 1 ? 1 : (nsplit > maxsplit ? maxsplit : nsplit);
  if (split >= nsplit) return;
  const int rows = (valid + nsplit - 1) / nsplit;
  const int start = split * rows;
  const int end = min(start + rows, valid);

  float qf[G][8];
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
    const uint4 u = live ? *reinterpret_cast<const uint4*>(
                               q + ((size_t)b * Hq + (size_t)h * (Hq / Hkv) +
                                    (size_t)share * G + g) * D + chunk * 8)
                         : make_uint4(0u, 0u, 0u, 0u);
    bf16x8_to_float(u, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }

  const size_t HD = (size_t)Hkv * D;
  const size_t base = (((size_t)li * B + b) * S) * HD + (size_t)h * D + chunk * 8;
  // the loop bound is block-uniform, so the shuffles never run divergent
  for (int r0 = start; r0 < end; r0 += 2 * kSub) {
    const int ra = r0 + sub, rb = r0 + kSub + sub;
    const bool la = ra < end, lb = rb < end;
    const bool lla = la && live, llb = lb && live;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const uint4 ka = lla ? __ldg(reinterpret_cast<const uint4*>(k + base + ra * HD)) : z;
    const uint4 va = lla ? __ldg(reinterpret_cast<const uint4*>(v + base + ra * HD)) : z;
    const uint4 kb = llb ? __ldg(reinterpret_cast<const uint4*>(k + base + rb * HD)) : z;
    const uint4 vb = llb ? __ldg(reinterpret_cast<const uint4*>(v + base + rb * HD)) : z;
    float kfa[8], kfb[8], vfa[8], vfb[8];
    bf16x8_to_float(ka, kfa);
    bf16x8_to_float(kb, kfb);
    bf16x8_to_float(va, vfa);
    bf16x8_to_float(vb, vfb);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sa = fmaf(qf[g][i], kfa[i], sa);
        sb = fmaf(qf[g][i], kfb[i], sb);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sb += __shfl_xor_sync(0xffffffffu, sb, off);
      }
      sa = la ? sa : -INFINITY;
      sb = lb ? sb : -INFINITY;
      const float m_new = fmaxf(m[g], fmaxf(sa, sb));
      const float alpha = __expf(m[g] - m_new);
      const float pa = __expf(sa - m_new), pb = __expf(sb - m_new);
      l[g] = l[g] * alpha + pa + pb;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] = fmaf(acc[g][i], alpha, fmaf(pa, vfa[i], pb * vfb[i]));
      m[g] = m_new;
    }
  }

  // merge the sub-warps of each warp (same chunk, other rows)
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], m_o);
      const float wa = __expf(m[g] - M), wb = __expf(m_o - M);
      l[g] = l[g] * wa + l_o * wb;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * wa + acc_o * wb;
      }
      m[g] = M;
    }
  }
  float* s_m = smem;                        // [kWarps][G]
  float* s_l = s_m + kWarps * G;            // [kWarps][G]
  float* s_acc = s_l + kWarps * G;          // [kWarps][G][D]
  if (sub_in_warp == 0 && live) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (chunk == 0) {
        s_m[warp * G + g] = m[g];
        s_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s_acc[(warp * G + g) * D + chunk * 8 + i] = acc[g][i];
    }
  }
  __syncthreads();
  // the first query head of this block's share
  const size_t head0 = (size_t)b * Hq + (size_t)h * (Hq / Hkv) + (size_t)share * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * G + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = __expf(s_m[w * G + g] - M);
      Ls = fmaf(s_l[w * G + g], wt, Ls);
      A = fmaf(s_acc[(w * G + g) * D + d], wt, A);
    }
    const size_t row = (head0 + g) * maxsplit + split;
    __stcg(part_acc + row * D + d, A);
    if (d == 0) {
      __stcg(part_m + row, M);
      __stcg(part_l + row, Ls);
    }
  }

  // the ticket: the last split of this (slot, kv-head, share) folds them all
  aha_decode::fold_if_last<D, G, kThreads>(part_m, part_l, part_acc, counters, out, head0,
                                           maxsplit, nsplit, smem);
}

struct Args {
  const void *q, *k, *v, *layer, *valid_len;
  int vl_stride;
  void *part_m, *part_l, *part_acc, *counters, *out;
  int B, Hq, Hkv, L, S;
  float scale;
};

template <int D, int G>
void launch(dim3 grid, cudaStream_t st, const Args& a) {
  decode_kernel<D, G><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.valid_len), a.vl_stride, static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc),
      static_cast<int*>(a.counters), static_cast<__nv_bfloat16*>(a.out), a.B, a.Hq, a.Hkv,
      a.L, a.S, a.scale);
}

// Query heads per block: two of an even group's G, one of an odd group's.
__host__ __device__ constexpr int share_of(int G) { return G % 2 == 0 ? 2 : 1; }

template <int D>
bool launch_for_group(int G, dim3 grid, cudaStream_t st, const Args& a) {
  switch (share_of(G)) {
    case 1: launch<D, 1>(grid, st, a); return true;
    case 2: launch<D, 2>(grid, st, a); return true;
    default: return false;
  }
}

}  // namespace

extern "C" const char* aha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// part_m/part_l: (B, Hq, nsplit) f32 scratch; part_acc: (B, Hq, nsplit, D);
// counters: (B, Hq) int32 (one per block share of a kv-head's heads, at
// most Hq), zero before the launch and left zero after it.
// Supported: D in {64, 128, 192, 256}, any G = Hq / Hkv, 1 ≤ nsplit ≤ 256.
extern "C" int aha_decode_attention(const void* q, const void* k, const void* v,
                                    const void* layer, const void* valid_len,
                                    int vl_stride, void* part_m, void* part_l,
                                    void* part_acc, void* counters, void* out, int B,
                                    int Hq, int Hkv, int D, int L, int S, int nsplit,
                                    float scale, void* stream) {
  if (Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || nsplit < 1 || nsplit > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, layer, valid_len, vl_stride, part_m, part_l, part_acc, counters,
               out, B, Hq, Hkv, L, S, scale};
  const dim3 grid(nsplit, Hkv * (G / share_of(G)), B);
  bool ok = false;
  switch (D) {
    case 64: ok = launch_for_group<64>(G, grid, st, a); break;
    case 128: ok = launch_for_group<128>(G, grid, st, a); break;
    case 192: ok = launch_for_group<192>(G, grid, st, a); break;
    case 256: ok = launch_for_group<256>(G, grid, st, a); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
