// One-token GQA decode attention over the int8 KV cache, in one launch:
// split-KV partials over the live rows and their fold.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_decode_at_layer_q8 (Pallas
// bodies _decode_stacked_q8_kernel and _decode_stacked_q8_mxu_kernel) and
// flash_decode_at_layer_q8_batched (_decode_stacked_q8_batched_kernel and
// its _mxu twin): a (B,) length vector covers the per-slot and the batched
// case, so one kernel serves both wrappers.
//
//   q        (B, 1, Hq, D) bf16, contiguous
//   k/v      (L, B, S, Hkv*D) int8, contiguous — core/cache.py's int8 rows
//   ks/vs    (L, B, S, Hkv) f32: one scale per (row, kv-head)
//   layer, valid_len: int32 on the device; rows [0, valid_len) are live.
//
// Bound: HBM bytes, valid_len * Hkv * 2 * (D + 4) B per layer per step —
// half of the bf16 cache's — and at a thousand rows the latency of one
// launch and a few DRAM round trips.  Design: decode_attention.cu's, over
// int8 rows:
//
// - Grid (maxsplit, Hkv · shares, B), maxsplit fixed by S and Hkv only
//   (ops/flash_attention.decode_splits at Q8_MIN_ROWS).  A slot uses ceil(valid / 64)
//   splits at most, each an equal share of its LIVE rows; a split past
//   that count exits at once and writes nothing.  A slot's result depends
//   only on its own length: bit-equal to a B = 1 launch on that slot.
// - A block scores one of the group's G = Hq/Hkv query heads (all-int8)
//   or two (cast, one when G is odd), of any G.  8 warps; D/16 lanes own a
//   row (16 int8 channels each, one 16-byte load; at D 192 the row's 12
//   lanes are a 16-lane sub-warp whose last 4 read nothing and add zeros)
//   and each sub-warp loads two rows, their K and V and both
//   scales, before it computes: at D 128 a 64-row split is one DRAM round
//   trip.  The scores s = (q · k_i8) · scale · ks[row]; a warp keeps one
//   running max per query head over its rows (no barrier in the loop), and
//   the V scales fold into the probabilities, pw = e^(s - m) · vs[row].
//   Sub-warps merge by sums, warps in shared memory, and the block writes
//   one partial per (query head, split).
// - The last block of each (slot, kv-head, share) to finish folds the
//   splits on an atomic ticket it resets (decode_fold.cuh, shared with the
//   bf16 kernel), in a fixed order: deterministic.
//
// Variants (`mxu`, the JAX name):
//   - cast (0): q in f32 from bf16, int8 channels converted to float,
//     f32 accumulation;
//   - all-int8 (1), the numerics of _decode_stacked_q8_mxu_kernel: q
//     quantized per query row (q_s = max|q| / 127, round half to even, clip
//     +-127); scores as int8 x int8 dots in int32 (__dp4a over 4 packed
//     channels), s = s32 * (q_s * scale) * ks; pw requantized per query row
//     over the rows a warp holds at one step (at most 2 · 32 / (D/16), so
//     well under 64; p_s = max(max pw, 1e-20) / 127), as the TPU kernel
//     requantizes over its block_k rows; p.V as an int32 multiply-add over
//     a lane's two rows (|sum| <= 2 * 127 * 127, exact in f32) scaled back
//     by p_s.  Its block-diagonal q only lets one MXU dot serve every head;
//     here each head's dot is its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_fold.cuh"

namespace {

using aha_decode::kMaxSplit;
using aha_decode::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinRows = 64;         // live rows a split at least

// signed byte j of a packed word
__device__ __forceinline__ int i8_word(int w, int j) { return (w << (24 - 8 * j)) >> 24; }

template <int D, int G>   // G: the query heads one block scores
struct Q8Smem {
  // the merge of the warps' (m, l, acc); the fold reuses the bytes
  static constexpr int kMerge = kWarps * G * (D + 2);
  static constexpr int kFold = aha_decode::fold_floats(G, kThreads);
  static constexpr int kFloats = kMerge > kFold ? kMerge : kFold;
};

template <int D, int G, bool MXU>
__global__ void __launch_bounds__(kThreads)
decode_q8_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ layer,
                 const int* __restrict__ valid_len, int vl_stride,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int* __restrict__ counters,
                 __nv_bfloat16* __restrict__ out, int B, int Hq, int Hkv, int L, int S,
                 float scale) {
  constexpr int kChunks = D / 16;                // 16-byte chunks a row
  constexpr int LPR = kChunks <= 4 ? 4 : (kChunks <= 8 ? 8 : 16);   // lanes a row
  constexpr int RPW = 32 / LPR;                  // rows a warp loads at once
  constexpr int kSub = kWarps * RPW;             // rows the block loads at once
  constexpr int kPackers = RPW < 4 ? RPW : 4;    // sub-warps that share q's packing
  static_assert(kChunks <= 16, "D up to 256");
  __shared__ __align__(16) float smem[Q8Smem<D, G>::kFloats];

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_share = Hq / Hkv / G;
  const int h = blockIdx.y / n_share, share = blockIdx.y % n_share;
  const int maxsplit = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub_in_warp = lane / LPR, chunk = lane % LPR;
  const int sub = warp * RPW + sub_in_warp;
  const bool live = chunk < kChunks;             // a lane past the row adds zeros

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
  const size_t head0 = (size_t)b * Hq + (size_t)h * (Hq / Hkv) + (size_t)share * G;

  // this lane's 16 channels of each query head of the share
  float qf[G][16];
  int qpack[G][4];
  float q_s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4* src = reinterpret_cast<const uint4*>(q + (head0 + g) * D + chunk * 16);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 u = live ? src[half] : make_uint4(0u, 0u, 0u, 0u);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(p2[i]);
        qf[g][half * 8 + 2 * i] = x.x;
        qf[g][half * 8 + 2 * i + 1] = x.y;
      }
    }
    q_s[g] = 0.f;
    if (MXU) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(qf[g][i]));
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      q_s[g] = fmaxf(amax, 1e-20f) / 127.f;
      // the sub-warps share the divisions: sub-warp j packs the words
      // jj ≡ j (mod kPackers) of its chunk, and every lane gathers the four
      // words of its chunk
      int w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj % kPackers != sub_in_warp % kPackers) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float r = fminf(fmaxf(rintf(qf[g][4 * jj + c] / q_s[g]), -127.f), 127.f);
          w[jj] |= (static_cast<int>(r) & 0xff) << (8 * c);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qpack[g][j] = __shfl_sync(0xffffffffu, w[j], (j % kPackers) * LPR + chunk);
    }
  }

  float m[G], l[G], acc[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[g][c] = 0.f;
  }

  const size_t HD = (size_t)Hkv * D;
  const size_t kv_base = (((size_t)li * B + b) * S) * HD + (size_t)h * D + chunk * 16;
  const size_t sc_base = (((size_t)li * B + b) * S) * Hkv + h;
  // the loop bound is block-uniform, so the shuffles never run divergent
  for (int r0 = start; r0 < end; r0 += 2 * kSub) {
    const int ra = r0 + sub, rb = r0 + kSub + sub;
    const bool la = ra < end, lb = rb < end;
    const bool lla = la && live, llb = lb && live;
    const int4 z = make_int4(0, 0, 0, 0);
    const int4 ka = lla ? __ldg(reinterpret_cast<const int4*>(k + kv_base + ra * HD)) : z;
    const int4 va = lla ? __ldg(reinterpret_cast<const int4*>(v + kv_base + ra * HD)) : z;
    const int4 kb = llb ? __ldg(reinterpret_cast<const int4*>(k + kv_base + rb * HD)) : z;
    const int4 vb = llb ? __ldg(reinterpret_cast<const int4*>(v + kv_base + rb * HD)) : z;
    const float ksa = la ? __ldg(ks + sc_base + (size_t)ra * Hkv) : 0.f;
    const float ksb = lb ? __ldg(ks + sc_base + (size_t)rb * Hkv) : 0.f;
    const float vsa = la ? __ldg(vs + sc_base + (size_t)ra * Hkv) : 0.f;
    const float vsb = lb ? __ldg(vs + sc_base + (size_t)rb * Hkv) : 0.f;
    const int kwa[4] = {ka.x, ka.y, ka.z, ka.w}, kwb[4] = {kb.x, kb.y, kb.z, kb.w};
    const int vwa[4] = {va.x, va.y, va.z, va.w}, vwb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sa, sb;
      if (MXU) {
        int ia = 0, ib = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ia = __dp4a(kwa[j], qpack[g][j], ia);
          ib = __dp4a(kwb[j], qpack[g][j], ib);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
          ia += __shfl_xor_sync(0xffffffffu, ia, off);
          ib += __shfl_xor_sync(0xffffffffu, ib, off);
        }
        sa = static_cast<float>(ia) * (q_s[g] * scale) * ksa;
        sb = static_cast<float>(ib) * (q_s[g] * scale) * ksb;
      } else {
        float fa = 0.f, fb = 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          fa = fmaf(qf[g][c], static_cast<float>(i8_word(kwa[c / 4], c % 4)), fa);
          fb = fmaf(qf[g][c], static_cast<float>(i8_word(kwb[c / 4], c % 4)), fb);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
          fa += __shfl_xor_sync(0xffffffffu, fa, off);
          fb += __shfl_xor_sync(0xffffffffu, fb, off);
        }
        sa = fa * scale * ksa;
        sb = fb * scale * ksb;
      }
      sa = la ? sa : -INFINITY;
      sb = lb ? sb : -INFINITY;
      // the warp's running max, shared by its sub-warps
      float mt = fmaxf(sa, sb);
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float M = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - M);
      const float pa = expf(sa - M), pb = expf(sb - M);
      const float pwa = pa * vsa, pwb = pb * vsb;
      l[g] = l[g] * alpha + pa + pb;
      m[g] = M;
      if (MXU) {
        // pw requantized over the warp's rows of this step
        float pmax = fmaxf(pwa, pwb);
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
        const float p_s = fmaxf(pmax, 1e-20f) / 127.f;
        const int qa = static_cast<int>(fminf(fmaxf(rintf(pwa / p_s), -127.f), 127.f));
        const int qb = static_cast<int>(fminf(fmaxf(rintf(pwb / p_s), -127.f), 127.f));
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int t = qa * i8_word(vwa[c / 4], c % 4) + qb * i8_word(vwb[c / 4], c % 4);
          acc[g][c] = fmaf(acc[g][c], alpha, static_cast<float>(t) * p_s);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c)
          acc[g][c] = fmaf(acc[g][c], alpha,
                           fmaf(pwa, static_cast<float>(i8_word(vwa[c / 4], c % 4)),
                                pwb * static_cast<float>(i8_word(vwb[c / 4], c % 4))));
      }
    }
  }

  // a warp's sub-warps share its running max: they merge by sums; the
  // warps merge in shared memory
  float* s_m = smem;                        // [kWarps][G]
  float* s_l = s_m + kWarps * G;            // [kWarps][G]
  float* s_acc = s_l + kWarps * G;          // [kWarps][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float a = acc[g][c];
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (sub_in_warp == 0 && live) s_acc[(warp * G + g) * D + chunk * 16 + c] = a;
    }
    if (lane == 0) {
      s_m[warp * G + g] = m[g];
      s_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * G + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(s_m[w * G + g] - M);
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

struct Q8Args {
  const void *q, *k, *v, *ks, *vs, *layer, *valid_len;
  int vl_stride;
  void *part_m, *part_l, *part_acc, *counters, *out;
  int B, Hq, Hkv, L, S;
  float scale;
};

template <int D, int G, bool MXU>
void launch_q8(dim3 grid, cudaStream_t st, const Q8Args& a) {
  decode_q8_kernel<D, G, MXU><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const int8_t*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.valid_len), a.vl_stride, static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc),
      static_cast<int*>(a.counters), static_cast<__nv_bfloat16*>(a.out), a.B, a.Hq, a.Hkv,
      a.L, a.S, a.scale);
}

// Query heads per block: the all-int8 variant one (its registers then let
// four blocks share an SM: 0.0280 against 0.0355 ms at the batched
// shape on an H100); the cast variant two of an even group's G (0.0232
// against 0.0276), one of an odd group's.
__host__ __device__ constexpr int share_of(int G, int mxu) {
  return !mxu && G % 2 == 0 ? 2 : 1;
}

template <int D, bool MXU>
void launch_q8_for_group(int G, dim3 grid, cudaStream_t st, const Q8Args& a) {
  if (share_of(G, MXU) == 2)
    launch_q8<D, 2, MXU>(grid, st, a);
  else
    launch_q8<D, 1, MXU>(grid, st, a);
}

}  // namespace

// part_m/part_l: (B, Hq, nsplit) f32 scratch; part_acc: (B, Hq, nsplit, D);
// counters: (B, Hq) int32 (one per block share of a kv-head's heads, at
// most Hq), zero before the launch and left zero after it.
// Supported: D in {64, 128, 192, 256}, any G = Hq / Hkv, 1 ≤ nsplit ≤ 256.
extern "C" int aha_decode_attention_q8(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* layer, const void* valid_len,
                                       int vl_stride, void* part_m, void* part_l,
                                       void* part_acc, void* counters, void* out, int B,
                                       int Hq, int Hkv, int D, int L, int S, int nsplit,
                                       float scale, int mxu, void* stream) {
  if (Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || nsplit < 1 || nsplit > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Q8Args a{q, k, v, k_scale, v_scale, layer, valid_len, vl_stride, part_m, part_l,
                 part_acc, counters, out, B, Hq, Hkv, L, S, scale};
  const dim3 grid(nsplit, Hkv * (G / share_of(G, mxu)), B);
  switch (D) {
    case 64: mxu ? launch_q8_for_group<64, true>(G, grid, st, a)
                 : launch_q8_for_group<64, false>(G, grid, st, a); break;
    case 128: mxu ? launch_q8_for_group<128, true>(G, grid, st, a)
                  : launch_q8_for_group<128, false>(G, grid, st, a); break;
    case 192: mxu ? launch_q8_for_group<192, true>(G, grid, st, a)
                  : launch_q8_for_group<192, false>(G, grid, st, a); break;
    case 256: mxu ? launch_q8_for_group<256, true>(G, grid, st, a)
                  : launch_q8_for_group<256, false>(G, grid, st, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
