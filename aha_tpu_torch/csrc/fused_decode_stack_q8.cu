// The whole Qwen3 decoder stack for one decode step (B = 1, S = 1) over
// GGUF-grid weights, in ONE launch: fused_decode_stack.cu with every
// projection on the int8 (q8) or the affine 4-bit (q4) grid, each of the
// four on its own grid (llama.cpp mixes formats per tensor: a Q4_K file
// keeps ffn_down in Q6_K, which the port packs int8).
//
// Replaces aha_tpu/ops/fused_layer.py:fused_decode_stack_q8 (Pallas body
// _fused_stack_quant_kernel with _attention_rows).
//
//   x_in     (H,) bf16, the token's embedding row
//   qkv, o, gu, dn   the four projections of every layer on the port's grids
//            (ops/quant_matmul.py): column-major rows (L, N, Kp) int8 or
//            (L, N, Kp/2) nibble bytes, scales (and q4 mins) (L, N, Gs)
//            f32 (Gs = Kp/128, or the wrapper's copy padded to a multiple
//            of 4), Kp = K exactly; q|k|v and gate|up fused on the columns
//   ln1/ln2 (L, H), q_norm/k_norm (L, D) bf16; cos/sin (D,) f32
//   k/v cache (L, 1, S, HD) bf16 — the new row is written IN PLACE at `pos`
//   pos      int32 on the device, read by the kernel: no host sync
//   x_out    (H,) bf16, the stack's output before the final norm
//
// Bound: the weight and scale bytes, read once: 420 MB int8 + 13 MB scales
// a step for Qwen3-0.6B (210 MB + 26 MB on the 4-bit grid), one dp4a per
// four weights.  The Pallas kernel streams every layer's packed rows through
// a DMA ring in VMEM over a sequential grid.  Here the bf16 stack's weight
// stream (fused_stack_gemv.cuh) carries the grids: one persistent
// 512-thread block per SM, launched cooperatively, five grid barriers a
// layer (cooperative.cuh), and a static plan of units that every block
// streams through a TMA ring running ahead across phases, attention and
// barriers:
//
// - A unit is 32 output columns x 512 bytes of their grid rows (4 groups
//   of 128 K values on the int8 grid, 8 on the 4-bit one): a 16 KB box of
//   the (L, N, Kb) stack, with its 32 x 4 scales (and 32 x 8 scales and
//   mins) as a second (and third) box on the same mbarrier.  Each phase's
//   plan follows its projection's grid.
// - The multiply: thread t takes column t/16 and 2 x 16 bytes of it; per
//   128-group an int32 __dp4a sum over the staged int8 activations, summed
//   over the group's 8 (q8) or 4 (q4) lanes, then quant_dot.cuh's
//   s_g · sx_g · Σ (+ xsum_g · b_g); a column's f32 sum carried over the
//   block's run of units and written as one run partial at the run's end.
// - The phase after each barrier sums the partials it reads in plan order
//   (phase_sum): the attention its heads' q|k|v, the o and down phases'
//   quantization their groups of the attention output and of SiLU(g)·u,
//   every block the whole hidden state (o and down), kept in shared memory
//   in f32.
//
//   1. rms-norm of the hidden state → quantized per 128-group → q|k|v
//   2. attention, the split combine folded in by the last split of each
//      head chunk (fused_stack_attention.cuh) into the f32 attention output
//   3. attention output quantized → o
//   4. residual, rms-norm quantized → gate|up (gate columns then up columns)
//   5. SiLU(g)·u quantized → down; after the last layer block 0 writes
//      x_out = x + down
//
// Activations are quantized as the Pallas kernel's _quant_acts quantizes
// them — from f32 values, never rounded to bf16 first — with quant_dot.cuh's
// arithmetic (true division, round half to even, exact group sums), each
// block only the groups its units read.  Only the f32 order across groups
// and units differs from the per-op kernels; every block sums in the same
// order, so two calls are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_gemv.cuh"
#include "quant_dot.cuh"

namespace {

using namespace aha_stack;
using aha_quant::Staged;
using aha_quant::kGroup;

constexpr int kQCols = 32;                        // output columns a unit
constexpr int kQSpan = 512;                       // bytes of a column a unit
constexpr int kQWeightBytes = kQCols * kQSpan;    // 16 KB
constexpr int kQMaxGroups = 8;                    // groups a unit (4-bit grid)
constexpr int kQStage = kQWeightBytes + 2 * kQCols * kQMaxGroups * 4;

// K values a unit spans and its groups, by grid.
__host__ __device__ constexpr int unit_k(bool q4) { return q4 ? 2 * kQSpan : kQSpan; }
__host__ __device__ constexpr int unit_groups(bool q4) { return unit_k(q4) / kGroup; }

// The tensor maps of the four grids, in phase order, and a unit's copies.
struct QuantMaps {
  static constexpr int kStage = kQStage;
  CUtensorMap w[kPhases], s[kPhases], b[kPhases];
  int q4[kPhases];

  __device__ void copy(uint32_t dst, uint32_t bar, int p, int, int, int, int ct, int rt,
                       int li) const {
    const int ng = unit_groups(q4[p]);
    const int sbytes = kQCols * ng * 4;
    aha_hopper::mbar_expect_tx(bar, kQWeightBytes + (q4[p] ? 2 : 1) * sbytes);
    aha_hopper::tma_load_3d(dst, &w[p], bar, rt * (kQSpan / 4), ct * kQCols, li);
    aha_hopper::tma_load_3d(dst + kQWeightBytes, &s[p], bar, rt * ng, ct * kQCols, li);
    if (q4[p])
      aha_hopper::tma_load_3d(dst + kQWeightBytes + sbytes, &b[p], bar, rt * ng, ct * kQCols,
                              li);
  }
};

struct QStackArgs {
  QuantMaps maps;
  const __nv_bfloat16 *x_in, *ln1, *ln2, *qn, *kn;
  const float *cos_r, *sin_r;
  __nv_bfloat16 *k_cache, *v_cache;
  const int* pos;
  __nv_bfloat16* x_out;
  float* ws;
  int* tickets;
  int L, H, hq, hkv, NI, S, nbuf, kpad;
  float eps, scale;
};

// The plan of a projection of K inputs and N outputs on its grid.
__device__ __forceinline__ Phase grid_phase(int K, int N, bool q4) {
  return make_phase(q4 ? K / 2 : K, N, 1, 0, kQSpan, kQCols);
}

// value(k) for k < K (0 past K) quantized per 128-group into the staged
// buffer (kpad wide): only the groups of the row tiles of this block's
// units of P.  Every thread computes values into s_val (f32, kpad) first,
// one at a time, so their loads overlap; then a warp quantizes each group.
template <class F>
__device__ void stage_groups(const Phase& P, bool q4, int K, int kpad, const Staged& st,
                             float* s_val, F value) {
  const int ng = unit_groups(q4);
  const int n = min(P.hi - P.lo, P.rt) * ng;              // groups
  auto group = [&](int i) { return (P.lo + i / ng) % P.rt * ng + i % ng; };
  for (int i = threadIdx.x; i < n * kGroup; i += kThreads) {
    const int k = group(i / kGroup) * kGroup + i % kGroup;
    s_val[i] = k < K ? value(k) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x / 32; i < n; i += kWarps) {
    const int k0 = group(i) * kGroup;
    aha_quant::quantize_group([&](int, int k) { return s_val[i * kGroup + k - k0]; }, 0,
                              k0 / kGroup, K, kpad, st.xq, st.sx, st.xsum);
  }
  __syncthreads();
}

// part[u0·32 + c] = Σ over the run's units of column c of the unit tile
// (u0 the run's first unit), the staged activations dotted with the grid.
template <bool Q4, class Stream>
__device__ void qgemv_phase(Stream& ws, const Phase& P, const Staged& st, float* part) {
  constexpr int NG = unit_groups(Q4);
  constexpr int LPG = Q4 ? 4 : 8;                // lanes of a group in a half
  const int c = threadIdx.x / 16, j = threadIdx.x % 16;
  float acc = 0.f;
  int u_run = P.lo;
  for (int u = P.lo; u < P.hi; ++u) {
    const int rt = u % P.rt;
    if (u == P.lo || rt == 0) {
      acc = 0.f;
      u_run = u;
    }
    const unsigned char* stage = ws.wait();
    const float* sc = reinterpret_cast<const float*>(stage + kQWeightBytes) + c * NG;
    const float* mn = sc + kQCols * NG;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int bo = half * (kQSpan / 2) + 16 * j;             // byte of the column
      const uint4 w = *reinterpret_cast<const uint4*>(stage + c * kQSpan + bo);
      const int kl = Q4 ? 2 * bo : bo;                          // K within the unit
      const int8_t* xr = st.xq + rt * unit_k(Q4) + kl;
      const uint4 xa = *reinterpret_cast<const uint4*>(xr);
      int t = 0;
      if (Q4) {
        const uint4 xb = *reinterpret_cast<const uint4*>(xr + 16);
        int a0, a1;
        aha_quant::unpack_nibbles(w.x, a0, a1);
        t = __dp4a(a0, (int)xa.x, t);
        t = __dp4a(a1, (int)xa.y, t);
        aha_quant::unpack_nibbles(w.y, a0, a1);
        t = __dp4a(a0, (int)xa.z, t);
        t = __dp4a(a1, (int)xa.w, t);
        aha_quant::unpack_nibbles(w.z, a0, a1);
        t = __dp4a(a0, (int)xb.x, t);
        t = __dp4a(a1, (int)xb.y, t);
        aha_quant::unpack_nibbles(w.w, a0, a1);
        t = __dp4a(a0, (int)xb.z, t);
        t = __dp4a(a1, (int)xb.w, t);
      } else {
        t = __dp4a((int)w.x, (int)xa.x, t);
        t = __dp4a((int)w.y, (int)xa.y, t);
        t = __dp4a((int)w.z, (int)xa.z, t);
        t = __dp4a((int)w.w, (int)xa.w, t);
      }
#pragma unroll
      for (int off = 1; off < LPG; off <<= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (j % LPG == 0) {
        const int gl = kl / kGroup, g = rt * NG + gl;
        float y = (float)t * (st.sx[g] * sc[gl]);
        if (Q4) y = fmaf(st.xsum[g], mn[gl], y);
        acc += y;
      }
    }
    ws.release();
    if (u + 1 < P.hi && rt + 1 < P.rt) continue;    // the run goes on
    float v = acc;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (j == 0) __stcg(part + (size_t)u_run * kQCols + c, v);
  }
}

template <class Stream>
__device__ __forceinline__ void qgemv(Stream& ws, const Phase& P, bool q4, const Staged& st,
                                      float* part) {
  if (q4)
    qgemv_phase<true>(ws, P, st, part);
  else
    qgemv_phase<false>(ws, P, st, part);
}

// SiLU(g)·u of gate column n and up column NI + n.
__device__ __forceinline__ float swiglu_cols(const Phase& P, const float* part, int n, int NI) {
  float gu[2];
  phase_sums<2>(P, part, {n, NI + n}, {0, 0}, gu);
  return gu[0] * (1.f / (1.f + expf(-gu[0]))) * gu[1];
}

// Bytes of the staged activations, the f32 values they are quantized from,
// or the attention's merge (which aliases them).
__host__ __device__ inline size_t staged_pad(int kpad) {
  return (aha_quant::staged_bytes(1, kpad) + 15) / 16 * 16;
}

template <int D, int GC>
__host__ __device__ size_t q_act_bytes(int kpad) {
  const size_t act = staged_pad(kpad) + sizeof(float) * (size_t)kpad;
  const size_t merge = merge_bytes<D, GC>();
  return act > merge ? act : merge;
}

template <int D, int GC>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_q8_kernel(const __grid_constant__ QStackArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_red[kWarps];

  const int H = a.H, NI = a.NI, NQ = a.hq * D, HD = a.hkv * D;
  const int NQKV = NQ + 2 * HD;
  const int* q4 = a.maps.q4;
  const Workspace w = carve_ws(a.ws, H, NQKV, NQ, NI, a.hq, D);
  const int pos = clamp_pos(a.pos, a.S);
  const SmemCarve sm = carve_smem(smem_raw, a.nbuf, q_act_bytes<D, GC>(a.kpad), H, kQStage);
  const Staged st = aha_quant::carve(reinterpret_cast<unsigned char*>(sm.act), 1, a.kpad);
  float* s_merge = reinterpret_cast<float*>(sm.act);
  float* s_val = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sm.act) +
                                          staged_pad(a.kpad));
  float* x = sm.x;                       // the hidden state, f32, in every block
  const LayerPlan plan(grid_phase(H, NQKV, q4[0]), grid_phase(NQ, H, q4[1]),
                       grid_phase(H, 2 * NI, q4[2]), grid_phase(NI, H, q4[3]), w.part_gemv,
                       sm.table);
  const Phase &qkv = plan.ph[0], &o = plan.ph[1], &gu = plan.ph[2], &dn = plan.ph[3];
  WeightStream ws(a.maps, plan, 0, a.L, sm.ring, sm.bars, a.nbuf);

  for (int k = threadIdx.x; k < H; k += kThreads) x[k] = __bfloat162float(a.x_in[k]);
  __syncthreads();
  for (int li = 0; li < a.L; ++li) {
    // 1. input norm → q|k|v
    if (li > 0) add_phase(dn, plan.part[1], x, H);      // the last layer's down
    float rinv = rms_inv_smem(x, H, a.eps, s_red);
    const __nv_bfloat16* ln1 = a.ln1 + (size_t)li * H;
    stage_groups(qkv, q4[0], H, a.kpad, st, s_val,
                 [&](int k) { return x[k] * rinv * __bfloat162float(ln1[k]); });
    qgemv(ws, qkv, q4[0], st, plan.part[0]);
    aha_coop::grid_barrier();
    // 2. attention, its splits folded into w.attn by the last of each chunk
    attention_phase<D, GC>(a, li, pos, QkvPartials{qkv, plan.part[0]}, w.part_m, w.part_l,
                           w.part_acc, a.tickets, w.attn, s_merge,
                           cache_row<D>(a, a.k_cache, li, pos),
                           cache_row<D>(a, a.v_cache, li, pos));
    aha_coop::grid_barrier();
    // 3. o-proj
    stage_groups(o, q4[1], NQ, a.kpad, st, s_val, [&](int k) { return __ldcg(w.attn + k); });
    qgemv(ws, o, q4[1], st, plan.part[1]);
    aha_coop::grid_barrier();
    // 4. residual, post-attention norm → gate|up
    add_phase(o, plan.part[1], x, H);
    rinv = rms_inv_smem(x, H, a.eps, s_red);
    const __nv_bfloat16* ln2 = a.ln2 + (size_t)li * H;
    stage_groups(gu, q4[2], H, a.kpad, st, s_val,
                 [&](int k) { return x[k] * rinv * __bfloat162float(ln2[k]); });
    qgemv(ws, gu, q4[2], st, plan.part[0]);
    aha_coop::grid_barrier();
    // 5. SiLU(g)·u → down
    stage_groups(dn, q4[3], NI, a.kpad, st, s_val,
                 [&](int k) { return swiglu_cols(gu, plan.part[0], k, NI); });
    qgemv(ws, dn, q4[3], st, plan.part[1]);
    aha_coop::grid_barrier();
  }
  // the last residual
  if (blockIdx.x == 0)
    for (int n = threadIdx.x; n < H; n += kThreads)
      a.x_out[n] = __float2bfloat16(x[n] + phase_sum(dn, plan.part[1], n, 0));
}

template <int D, int GC>
int launch(const QStackArgs& a, int grid, cudaStream_t st) {
  return launch_streamed(fused_stack_q8_kernel<D, GC>, a, grid, q_act_bytes<D, GC>(a.kpad), st,
                         kQStage);
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

}  // namespace

// x_out = the L-layer stack over the grids applied to x_in; the cache row
// `pos` of every layer is written in place.  Supported: D in {64, 128},
// Hq % Hkv == 0, H, Hq·D and NI multiples of 128 (each projection's K
// exactly its grid's Kp).  Per projection w/s/b point at layer 0's grid
// tensors (b only where q4 is set), 16-byte aligned; gs its scale tensors'
// groups a column (Kp/128, a multiple of 4).  `grid` blocks, one per SM; ws
// (16-byte aligned) holds H + (NQ + 2·HD) + NQ + NI + Hq·grid·(D + 2) + 4
// f32 and the GEMV partials after them, twice the most of ⌈Kb/512⌉·⌈N/32⌉·32
// over the four projections (Kb the bytes of a column); tickets Hq int32
// zeros, left zero.
extern "C" int aha_fused_decode_stack_q8(
    const void* x_in, const void* const* w, const void* const* s,
    const void* const* b, const int* q4, const int* gs, const void* ln1, const void* ln2,
    const void* qn, const void* kn, const void* cos_r, const void* sin_r,
    void* k_cache, void* v_cache, const void* pos, void* x_out, void* ws, void* tickets,
    int L, int H, int hq, int hkv, int D, int NI, int S, float eps, float scale, int grid,
    void* stream) {
  if (hkv < 1 || hq % hkv != 0 || H % kGroup != 0 || NI % kGroup != 0 ||
      (hq * D) % kGroup != 0 || grid < 1 || L < 1 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  QStackArgs a{};
  const int NQ = hq * D;
  const int K[kPhases] = {H, NQ, H, NI};
  const int N[kPhases] = {NQ + 2 * hkv * D, H, 2 * NI, H};
  a.kpad = 0;
  for (int i = 0; i < kPhases; ++i) {
    const bool g4 = q4[i] != 0;
    if (!w[i] || !s[i] || (g4 && !b[i]) || gs[i] % 4 != 0 || gs[i] < K[i] / kGroup)
      return static_cast<int>(cudaErrorInvalidValue);
    const int Kb = g4 ? K[i] / 2 : K[i];
    const int ng = unit_groups(g4);
    a.maps.q4[i] = g4;
    if (!aha_hopper::make_grid_map(&a.maps.w[i], w[i], Kb, N[i], L, kQSpan / 4, kQCols) ||
        !aha_hopper::make_group_map(&a.maps.s[i], s[i], gs[i], N[i], L, ng, kQCols) ||
        (g4 && !aha_hopper::make_group_map(&a.maps.b[i], b[i], gs[i], N[i], L, ng, kQCols)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int kp = round_up(K[i], unit_k(g4));
    a.kpad = kp > a.kpad ? kp : a.kpad;
  }
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
  a.tickets = static_cast<int*>(tickets);
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
  if (D == 128) return pair ? launch<128, 2>(a, grid, st) : launch<128, 1>(a, grid, st);
  return pair ? launch<64, 2>(a, grid, st) : launch<64, 1>(a, grid, st);
}
