// The weight stream and the GEMV and norm phases of the one-launch decode
// kernels (fused_decode_stack.cu: every layer of a step; fused_decode_layer.cu:
// one layer; the plan, ring and partial sums also carry the GGUF-grid stack,
// fused_decode_stack_q8.cu, whose units and multiply are its own), for a
// persistent cooperative kernel of kThreads threads per block
// (cooperative.cuh, fused_stack_attention.cuh).
//
// The weights do not depend on the activations, so every block knows
// before the launch which weight tiles it reads in every phase of every
// layer (a static plan), and streams them through a ring of 16 KB stages
// in shared memory that runs ahead across the phases, the attention and
// the grid barriers: only the activation vector waits for a barrier.
//
// - The plan: each GEMV phase — q|k|v, o, gate|up, down — cuts its (K, N)
//   weight matrix into units of 128 rows x 64 columns (128-byte row
//   pieces; gate|up: 64 rows of 64 gate columns and the same 64 up
//   columns), column tiles outermost; block b takes units
//   [b·U/grid, (b+1)·U/grid), so every SM streams within one unit of the
//   same bytes in every phase, whatever the widths.  The weights stay in
//   their (L, K, N) layout: a 3-D tensor map per matrix cuts the units.
//   The cutting is study_fused_layer.cu's (contiguous unit ranges, row
//   partials summed in a fixed order); the copies are TMA, not its
//   cp.async groups: one thread moves a 16 KB stage, and the boxes
//   zero-fill the ragged edges of any width.
// - The ring: up to kMaxStages slots (as many as the shared memory holds
//   beside the activations), each a TMA copy (one thread issues it) that
//   completes on the slot's mbarrier.  A block waits for its next stage,
//   multiplies it, frees the slot (one __syncthreads) and issues the
//   copy of the stage `nbuf` further along its plan — the next phase's or
//   the next layer's — so the stages in flight outlast the barriers and
//   the attention phase.
// - The multiply: one FMA a weight on the CUDA cores (M = 1), thread t
//   taking 16 bytes of row pieces t/8 and t/8 + 64 (conflict-free
//   128-byte rows), its 8 column sums carried over the block's run of
//   units of one column tile; at a run's end the block reduces over rows
//   (shuffles, shared memory) and writes the run's partial sums, at the
//   run's first unit, into the phase's f32 partials.
// - No fold before the barrier: a column's value is the sum of its tile's
//   run partials in plan order (phase_sum), and the phase after the barrier
//   sums only what it reads — the attention items their heads' q|k|v, the
//   o and down units their rows of the attention output (the splits merged
//   there, combine_split) and of SiLU(g)·u, every block the whole hidden
//   state (o and down), which it keeps in shared memory in f32.  One read
//   of L2 per phase, no atomics; every block sums in the same order, so
//   the blocks agree and two calls are bit-equal.  Two partial buffers
//   alternate (q|k|v and gate|up; o and down): a phase's partials are read
//   only in the next phase, before the one after overwrites them.
//
// The bf16 GEMV phase (gemv_phase) rounds the activations a dot consumes
// to bf16 in shared memory (s_act), as the Pallas kernels' dots take them,
// zero past K; the quantized stack has its own unit multiply.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "fused_stack_attention.cuh"
#include "hopper_tma.cuh"

namespace aha_stack {

constexpr int kPhases = 4;                  // q|k|v, o, gate|up, down
constexpr int kTileCols = 64;               // a weight piece: 128-byte rows
constexpr int kStageBytes = 16384;          // a ring stage: 128 rows x 64 columns
constexpr int kMaxStages = 4;               // deeper rings queue the phases' own L2
                                            // reads behind weights, and read slower
constexpr int kRowPieces = kThreads / 8;    // row pieces a block multiplies at once

// The tensor maps of the four bf16 weight stacks, in phase order, and the
// copies of one unit: a stream's Maps type gives its stage bytes (kStage) and
// issues a unit's copies onto the stage's mbarrier (copy).
struct WeightMaps {
  static constexpr int kStage = kStageBytes;
  CUtensorMap m[kPhases];

  __device__ void copy(uint32_t dst, uint32_t bar, int p, int pieces, int piece_off,
                       int rows, int ct, int rt, int li) const {
    aha_hopper::mbar_expect_tx(bar, kStageBytes);
    for (int pc = 0; pc < pieces; ++pc)
      aha_hopper::tma_load_3d(dst + pc * (kStageBytes / pieces), &m[p], bar,
                              ct * kTileCols + pc * piece_off, rt * rows, li);
  }
};

// K rounded up to whole 128-row units: the length of s_act.
__host__ __device__ __forceinline__ int k_pad(int K) { return (K + 127) / 128 * 128; }

// One GEMV phase of a layer: K rows, `ncols` output columns of `pieces`
// `tile`-column pieces a unit (the second `piece_off` columns after the
// first), `rows` rows a unit; ct x rt units, this block's [lo, hi); first[b]
// the first unit of block b (b ≤ grid + kRunBatch, U past the grid), in
// shared memory.
struct Phase {
  int K, ncols, pieces, piece_off, rows, tile, ct, rt, lo, hi;
  const int* first;
};

constexpr int kRunBatch = 8;                // run partials a thread loads at once

// Ints of shared memory the plan's first-unit tables take.
__host__ __device__ __forceinline__ int plan_table_ints(int grid) {
  return kPhases * (grid + kRunBatch + 1);
}

// rows 0: the bf16 units' 128 / pieces rows.
__device__ __forceinline__ Phase make_phase(int K, int ncols, int pieces, int piece_off,
                                            int rows = 0, int tile = kTileCols) {
  Phase p;
  p.K = K;
  p.ncols = ncols;
  p.pieces = pieces;
  p.piece_off = piece_off;
  p.rows = rows > 0 ? rows : 128 / pieces;
  p.tile = tile;
  p.ct = (ncols + tile - 1) / tile;
  p.rt = (K + p.rows - 1) / p.rows;
  const long long units = (long long)p.ct * p.rt;
  p.lo = (int)(blockIdx.x * units / gridDim.x);
  p.hi = (int)((blockIdx.x + 1) * units / gridDim.x);
  return p;
}

// The four phases of a Qwen3 layer: q|k|v (H → NQKV), o (NQ → H), gate|up
// (H → NI pairs), down (NI → H).
struct LayerPlan {
  Phase ph[kPhases];
  float* part[2];     // q|k|v and gate|up partials; o and down partials
  // The bf16 weights' plan.  parts: 2 x the most of U·tile·pieces over the
  // phases, f32; table: plan_table_ints(grid) ints of shared memory
  __device__ LayerPlan(int H, int NQKV, int NQ, int NI, float* parts, int* table)
      : LayerPlan(make_phase(H, NQKV, 1, 0), make_phase(NQ, H, 1, 0), make_phase(H, NI, 2, NI),
                  make_phase(NI, H, 1, 0), parts, table) {}

  // Any four phases, in layer order.
  __device__ LayerPlan(Phase qkv, Phase o, Phase gu, Phase dn, float* parts, int* table) {
    ph[0] = qkv;
    ph[1] = o;
    ph[2] = gu;
    ph[3] = dn;
    size_t n = 0;
    const int G = gridDim.x, per = G + kRunBatch + 1;
    for (int p = 0; p < kPhases; ++p) {
      const long long U = (long long)ph[p].ct * ph[p].rt;
      const size_t cols = (size_t)U * ph[p].tile * ph[p].pieces;
      n = cols > n ? cols : n;
      int* first = table + p * per;
      for (int b = threadIdx.x; b < per; b += kThreads)
        first[b] = b <= G ? (int)(b * U / G) : (int)U;
      ph[p].first = first;
    }
    part[0] = parts;
    part[1] = parts + n;
    __syncthreads();
  }
};

// Dynamic shared memory of a streamed one-launch kernel: 128 bytes of
// alignment slack, the ring, the activations (or the attention's merge,
// which aliases them), the f32 hidden state, the plan's tables, the ring's
// mbarriers.
struct RingLayout {
  size_t act, x, table, bars, total;
};

__host__ __device__ __forceinline__ RingLayout ring_layout(int nbuf, size_t act_bytes, int H,
                                                          int grid, int stage = kStageBytes) {
  RingLayout r;
  r.act = (size_t)nbuf * stage;
  r.x = r.act + (act_bytes + 15) / 16 * 16;
  r.table = r.x + (size_t)k_pad(H) * sizeof(float);
  r.bars = r.table + ((size_t)plan_table_ints(grid) * sizeof(int) + 15) / 16 * 16;
  r.total = 128 + r.bars + 8 * (size_t)nbuf;
  return r;
}

// The widest bf16 activation (padded) or the attention's merge, in bytes.
template <int D, int GC>
__host__ __device__ __forceinline__ size_t act_bytes(int H, int NQ, int NI) {
  int n = k_pad(H) > k_pad(NQ) ? k_pad(H) : k_pad(NQ);
  n = n > k_pad(NI) ? n : k_pad(NI);
  const size_t act = (size_t)n * sizeof(__nv_bfloat16);
  const size_t merge = merge_bytes<D, GC>();
  return act > merge ? act : merge;
}

// The block's ring and its place in the plan.  Every thread walks the
// consumer side; thread 0 alone issues copies (Maps::copy).
template <class Maps>
class WeightStream {
 public:
  // Layers [li0, li1) of the plan; the first `nbuf` stages are issued here.
  __device__ WeightStream(const Maps& maps, const LayerPlan& plan, int li0, int li1,
                          unsigned char* ring, uint32_t bars, int nbuf)
      : maps_(maps), plan_(plan), ring_(ring), bars_(bars), nbuf_(nbuf), li1_(li1) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < nbuf; ++s) aha_hopper::mbar_init(bars + 8 * s, 1);
      aha_hopper::mbar_fence_init();
      li_ = li0;
      p_ = 0;
      u_ = plan.ph[0].lo - 1;
      advance();
      for (int s = 0; s < nbuf; ++s) issue();
    }
    __syncthreads();
  }

  // The next stage of the plan, once it has landed.
  __device__ const unsigned char* wait() {
    const int slot = consumed_ % nbuf_;
    aha_hopper::mbar_wait(bars_ + 8 * slot, (consumed_ / nbuf_) & 1);
    return ring_ + (size_t)slot * Maps::kStage;
  }

  // Every thread is done with the stage: its slot takes the copy of the
  // stage nbuf further along.
  __device__ void release() {
    ++consumed_;
    __syncthreads();
    if (threadIdx.x == 0) issue();
  }

 private:
  __device__ void advance() {
    ++u_;
    while (li_ < li1_ && u_ >= plan_.ph[p_].hi) {
      if (++p_ == kPhases) {
        p_ = 0;
        ++li_;
      }
      u_ = plan_.ph[p_].lo;
    }
  }

  __device__ void issue() {
    if (li_ >= li1_) return;
    const Phase& P = plan_.ph[p_];
    const int slot = issued_ % nbuf_;
    const uint32_t dst = aha_hopper::smem_u32(ring_ + (size_t)slot * Maps::kStage);
    const uint32_t bar = bars_ + 8 * slot;
    aha_hopper::fence_proxy_async();      // the slot's last readers came first
    maps_.copy(dst, bar, p_, P.pieces, P.piece_off, P.rows, u_ / P.rt, u_ % P.rt, li_);
    ++issued_;
    advance();
  }

  const Maps& maps_;
  const LayerPlan& plan_;
  unsigned char* ring_;
  uint32_t bars_;
  int nbuf_, li1_;
  int consumed_ = 0;
  int issued_ = 0, li_ = 0, p_ = 0, u_ = 0;    // thread 0's issue cursor
};

// part[u0·TW + j] += (s_act @ W)[column j of the unit tile] for each run of
// this block's units of phase P (u0 the run's first unit, TW = 64·PIECES
// columns a unit).  s_red holds kWarps·kTileCols floats.
template <int PIECES, class Stream>
__device__ void gemv_phase(Stream& ws, const Phase& P, const __nv_bfloat16* s_act,
                           float* s_red, float* part) {
  constexpr int TW = kTileCols * PIECES;          // a unit's output columns
  constexpr int RP = kRowPieces / PIECES;         // rows of a piece at once
  constexpr int ROWS = 128 / PIECES;              // rows of a unit
  constexpr int WPP = kWarps / PIECES;            // warps of a piece
  const int c = threadIdx.x % 8, rp = threadIdx.x / 8;
  const int piece = rp / RP, r0 = rp % RP;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float acc[8];
  int u_run = P.lo;
  for (int u = P.lo; u < P.hi; ++u) {
    const int rt = u % P.rt;
    if (u == P.lo || rt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      u_run = u;
    }
    const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(ws.wait());
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int r = r0 + pass * RP;
      const uint4 wv = *reinterpret_cast<const uint4*>(st + (piece * ROWS + r) * kTileCols + c * 8);
      const float a = __bfloat162float(s_act[rt * ROWS + r]);
      float f[8];
      bf16x8_to_float(wv, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(a, f[i], acc[i]);
    }
    ws.release();
    if (u + 1 < P.hi && rt + 1 < P.rt) continue;    // the run goes on

    // the run's sums: over the 4 row pieces of a warp, then over warps
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i] = v;
    }
    if (lane < 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s_red[warp * kTileCols + lane * 8 + i] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < TW) {
      const int pc = threadIdx.x / kTileCols, j = threadIdx.x % kTileCols;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WPP; ++w) v += s_red[(pc * WPP + w) * kTileCols + j];
      __stcg(part + (size_t)u_run * TW + threadIdx.x, v);
    }
    __syncthreads();                        // s_red is free again
  }
}

// A lower bound of the block that owns unit u of phase P (the plan gives
// block b units [b·U/grid, (b+1)·U/grid)); 32-bit: U·grid stays far below
// 2^32 at any model width.
__device__ __forceinline__ int first_block(const Phase& P, int u) {
  return (int)((unsigned)u * gridDim.x / (unsigned)(P.ct * P.rt));
}

// Columns n[c] (pieces pc[c]) of phase P: each the sum of its tile's run
// partials in plan order — the tile's first unit, then the first unit of
// each later block that starts inside the tile — kRunBatch loads of each
// column in flight at once.
template <int C>
__device__ __forceinline__ void phase_sums(const Phase& P, const float* part, const int (&n)[C],
                                           const int (&pc)[C], float (&out)[C]) {
  const int TW = P.tile * P.pieces;
  const int* first = P.first;
  int b[C], u1[C];
  const float* col[C];
  bool more = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int u0 = n[c] / P.tile * P.rt;
    u1[c] = u0 + P.rt;
    col[c] = part + pc[c] * P.tile + n[c] % P.tile;
    // the first block whose first unit lies past u0 (first[] is monotone)
    b[c] = first_block(P, u0);
    while (first[b[c]] <= u0) ++b[c];
    out[c] = __ldcg(col[c] + (size_t)u0 * TW);
    more |= first[b[c]] < u1[c];
  }
  while (more) {
    float v[C][kRunBatch];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < kRunBatch; ++i) {
        const int f0 = first[b[c] + i], f1 = first[b[c] + i + 1];
        // a block with no units shares its first unit with the next: skip it
        v[c][i] = f0 < u1[c] && f1 > f0 ? __ldcg(col[c] + (size_t)f0 * TW) : 0.f;
      }
    more = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < kRunBatch; ++i) out[c] += v[c][i];
      if (first[b[c]] < u1[c]) b[c] += kRunBatch;
      more |= first[b[c]] < u1[c];
    }
  }
}

// Column n (piece pc) of phase P.
__device__ __forceinline__ float phase_sum(const Phase& P, const float* part, int n, int pc) {
  float out[1];
  phase_sums<1>(P, part, {n}, {pc}, out);
  return out[0];
}

// The projected q|k|v of the q|k|v phase, summed where the attention reads it.
struct QkvPartials {
  const Phase& P;
  const float* part;
  __device__ float operator()(int col) const { return phase_sum(P, part, col, 0); }
};

// s_act[r] = bf16(value(r)) for the rows r of the units of this block's
// range of phase P (0 past K): all a GEMV phase reads of its activations.
template <class F>
__device__ void rows_to_smem(const Phase& P, __nv_bfloat16* s_act, F value) {
  const int n = min(P.hi - P.lo, P.rt) * P.rows;   // distinct row tiles, in rows
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = (P.lo + i / P.rows) % P.rt * P.rows + i % P.rows;
    s_act[r] = __float2bfloat16(r < P.K ? value(r) : 0.f);
  }
  __syncthreads();
}

// x[n] += column n of phase P (one piece a unit), n < H (a multiple of 4):
// every block alike, in shared memory.  phase_sum's walk over the tile's
// run partials, in the same order, four columns a thread with 16-byte
// loads: every block reads all of them at once, and a quarter of the
// requests queue at the same L2 lines.
__device__ __forceinline__ void add_phase(const Phase& P, const float* part, float* x, int H) {
  const int TW4 = P.tile / 4;                    // float4s a unit's partials
  const int* first = P.first;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = threadIdx.x; q < H / 4; q += kThreads) {
    const int n = 4 * q;
    const int u0 = n / P.tile * P.rt, u1 = u0 + P.rt;
    const float4* col = reinterpret_cast<const float4*>(part) + (n % P.tile) / 4;
    int b = first_block(P, u0);
    while (first[b] <= u0) ++b;
    float4 y = __ldcg(col + (size_t)u0 * TW4);
    while (first[b] < u1) {
      float4 v[kRunBatch];
#pragma unroll
      for (int i = 0; i < kRunBatch; ++i) {
        const int f0 = first[b + i], f1 = first[b + i + 1];
        v[i] = f0 < u1 && f1 > f0 ? __ldcg(col + (size_t)f0 * TW4) : zero;
      }
#pragma unroll
      for (int i = 0; i < kRunBatch; ++i) {
        y.x += v[i].x;
        y.y += v[i].y;
        y.z += v[i].z;
        y.w += v[i].w;
      }
      b += kRunBatch;
    }
    x[n] += y.x;
    x[n + 1] += y.y;
    x[n + 2] += y.z;
    x[n + 3] += y.w;
  }
  __syncthreads();
}

// SiLU(g)·u of gate|up column n.
__device__ __forceinline__ float swiglu(const Phase& P, const float* part, int n) {
  float gu[2];
  phase_sums<2>(P, part, {n, n}, {0, 1}, gu);
  return gu[0] * (1.f / (1.f + expf(-gu[0]))) * gu[1];
}

// rsqrt(mean(x²) + eps) over the f32 hidden state x in shared memory;
// every thread returns it.  s_red holds kWarps floats.
static __device__ float rms_inv_smem(const float* x, int H, float eps, float* s_red) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kThreads) ss = fmaf(x[k], x[k], ss);
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

// s_act[k] = bf16(x[k] · rsqrt(mean(x²) + eps) · w[k]) for k < H, 0 up to
// k_pad(H); x the f32 hidden state in shared memory.
static __device__ void rms_to_smem(const float* x, const __nv_bfloat16* w, int H, float eps,
                                   __nv_bfloat16* s_act, float* s_red) {
  const float rinv = rms_inv_smem(x, H, eps, s_red);
  for (int k = threadIdx.x; k < k_pad(H); k += kThreads)
    s_act[k] = __float2bfloat16(k < H ? x[k] * rinv * __bfloat162float(w[k]) : 0.f);
  __syncthreads();
}

// The weight maps of the four (L, K, N) stacks, in phase order.
inline bool make_weight_maps(WeightMaps* m, const void* wqkv, const void* wo, const void* wgu,
                             const void* wdn, int L, int H, int NQKV, int NQ, int NI) {
  return aha_hopper::make_weight_map(&m->m[0], wqkv, NQKV, H, L, 128) &&
         aha_hopper::make_weight_map(&m->m[1], wo, H, NQ, L, 128) &&
         aha_hopper::make_weight_map(&m->m[2], wgu, 2 * NI, H, L, 64) &&
         aha_hopper::make_weight_map(&m->m[3], wdn, H, NI, L, 128);
}

// Launch a streamed one-launch kernel cooperatively with as many ring stages
// of `stage` bytes as the block's shared memory holds beside `act` bytes of
// activations and the hidden state (at most kMaxStages); sets a.nbuf.
template <typename Args>
int launch_streamed(void (*fn)(Args), Args a, int grid, size_t act, cudaStream_t st,
                    int stage = kStageBytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  int nbuf = kMaxStages;
  while (nbuf >= 2 &&
         fa.sharedSizeBytes + ring_layout(nbuf, act, a.H, grid, stage).total > (size_t)optin)
    --nbuf;
  if (nbuf < 2) return static_cast<int>(cudaErrorInvalidValue);
  a.nbuf = nbuf;
  return aha_coop::launch(fn, a, grid, kThreads, ring_layout(nbuf, act, a.H, grid, stage).total,
                          st);
}

// The ring, the activations, the hidden state and the mbarriers in the
// dynamic shared memory.
struct SmemCarve {
  unsigned char* ring;
  __nv_bfloat16* act;
  float* x;
  int* table;
  uint32_t bars;
};

__device__ __forceinline__ SmemCarve carve_smem(unsigned char* raw, int nbuf, size_t act, int H,
                                                int stage = kStageBytes) {
  const RingLayout r = ring_layout(nbuf, act, H, gridDim.x, stage);
  unsigned char* base = raw + ((128 - (aha_hopper::smem_u32(raw) & 127)) & 127);
  return {base, reinterpret_cast<__nv_bfloat16*>(base + r.act),
          reinterpret_cast<float*>(base + r.x), reinterpret_cast<int*>(base + r.table),
          aha_hopper::smem_u32(base + r.bars)};
}

}  // namespace aha_stack
