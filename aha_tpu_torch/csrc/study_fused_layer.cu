// One launch per decoder layer that streams all of the layer's weights: the
// study of scripts/exp_fused_layer.py on the card.
//
// Replaces scripts/exp_fused_layer.py:make_fused (body fused_layer_kernel):
// the weight stream of one Qwen3-0.6B layer at M = 8 rows, bf16 —
//   1. qkv = x . Wqkv (1024 x 4096), f32;
//   2. a = tanh(qkv[:, :2048]) in f32, the stand-in for attention;
//   3. o = a . Wo (2048 x 1024);
//   4. h = x . Wgu (1024 x 6144), f32;
//   5. act = SiLU(g) * u in f32 (g, u the halves of h);
//   6. down = act . Wdn (3072 x 1024);
// the (8, 1024) bf16 output accumulated in bf16 after each 1024-row chunk,
// in the order o chunk 0, o chunk 1, down chunks 0-2 (out = bf16(part0),
// then out = bf16(out + part_i)).  The TPU streams the four matrices through
// `nbuf` rotating VMEM stages by manual DMA inside one sequential kernel.
//
// Bound: bytes, 31.46 MB of weights a layer (BYTES_PER_LAYER of the
// script): 0.00939 ms at 3.35 TB/s, 0.263 ms for 28 layers, whose 881 MB
// stream from HBM (the L2 holds 50 MB).  126 M MACs a layer, 8x that
// padded to wgmma's 64 x 8 tiles, are ~0.002 ms of the bf16 tensor rate.
//
// Design: one cooperative launch, one 256-thread block (two warpgroups) per
// SM.
// - The layer is cut into units of 64 columns (128-byte row pieces) by 256
//   rows: phase 1 the 10,240 columns of [Wqkv | Wgu] in four K quarters (640
//   units, they depend only on x); phase 2 the 1,024 columns of [Wo ; Wdn]
//   in 20 row tiles (320 units; four row tiles a 1024-row chunk).  Block b
//   takes phase-1 units b, b + grid, ... (at each step the blocks read
//   neighbouring pieces of the same rows, as HBM likes) and phase-2 units
//   [b·320/grid, (b+1)·320/grid) (one or two row tiles of activations to
//   stage).  The split is studies/exp_fused_layer.fused_layer_plan's: the
//   kernel reads each block's units from the plan's table, passed in the
//   launch's parameters (constant memory: no load from global memory
//   before the first copy), whose rows are the grid.  Every block streams within one unit of the same bytes in
//   each phase.
// - The weights come by TMA: a tensor map over each stacked matrix, boxes of
//   R rows x 64 columns (R 64 or 128: 8 or 16 KB), 128-byte swizzled, into a
//   ring of `depth` slots, each completing on its mbarrier.  One thread
//   issues a copy as soon as its slot is free; the ring runs straight across
//   the phases, so while a block waits at the grid barrier its next `depth`
//   boxes — at 64-96 KB most or all of its ~79 KB phase-2 share — are landing.
//   (R, depth) are the H100 form of the script's (chunk width, nbuf) sweep.
// - The products are wgmma.m64n8k16: A is the box, read MN-major (the 64
//   weight columns are the product's 64 rows), B the 8 activation rows,
//   K-major in 1 KB chunks of 64 K values swizzled as TMA swizzles the box;
//   f32 64 x 8 accumulators of four registers a thread, four independent
//   chains of k steps, run over the unit's boxes and are summed and stored
//   as the unit's partial (f32, through L2).
//   Phase 1's B is x itself, staged once a block; phase 2's activations are
//   f32, carried as a bf16 hi + lo pair (error ~2^-17 of a value): B's 16
//   rows are the 8 hi rows and the 8 lo rows, one m64n16k16 product a k
//   step (a box read once for both).
// - One grid barrier (cooperative.cuh) between the phases.  A block stages
//   the 256 activation rows of each phase-2 row tile it meets from the
//   phase-1 partials (all loads issued before any is used): tanh of the
//   summed q columns, or SiLU(g) * u of the summed gate and up columns.
// - At its end a block adds its phase-2 units to the atomic tickets of their
//   column tiles, all at once; the one that completes a tile's 20 — and
//   resets its ticket to 0 — folds the tile's partials (two tiles at a
//   time, every load in flight together): each chunk's four row tiles
//   summed in order, then the five chunks in the TPU kernel's order with a
//   bf16 rounding after each.  Deterministic, whichever block comes last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "hopper_tma.cuh"

namespace {

using namespace aha_hopper;

constexpr int kThreads = 256;              // two warpgroups
constexpr int kM = 8;
constexpr int kH = 1024, kNqkv = 4096, kNo = 2048, kNi = 3072;
constexpr int kN1 = kNqkv + 2 * kNi;       // phase-1 columns, [qkv | gate | up]
constexpr int kK2 = kNo + kNi;             // phase-2 rows, [o ; down]
constexpr int kTC = 64;                    // columns of a unit
constexpr int kU1Rows = 256, kU2Rows = 256;
constexpr int kCT1 = kN1 / kTC;            // 160 column tiles
constexpr int kKQ = kH / kU1Rows;          // 4 K quarters
constexpr int kU1 = kCT1 * kKQ;            // 640 units
constexpr int kCT2 = kH / kTC;             // 16 column tiles
constexpr int kRT2 = kK2 / kU2Rows;        // 20 row tiles
constexpr int kU2 = kCT2 * kRT2;           // 320 units
constexpr int kChunkTiles = kH / kU2Rows;  // 4 row tiles a 1024-row chunk
constexpr int kChains = 4;                 // independent accumulator chains a warpgroup
constexpr int kBChunk = kM * 128;          // B's 64 K values: 8 rows of 128 bytes
constexpr int kXBytes = kH / 64 * kBChunk;         // x as B: 16 KB
constexpr int kActChunk = 2 * kBChunk;     // B's 64 K values, 16 rows: hi 0-7, lo 8-15
constexpr int kActBytes = kU2Rows / 64 * kActChunk;  // a row tile's activations: 8 KB
constexpr int kMaxDepth = 16;
constexpr int kMaxGrid = 160;              // plan rows: blocks, one an SM
static_assert(kM * kTC / 2 == kThreads, "the fold: two outputs a thread");
static_assert(kM * kU2Rows / 4 % kThreads == 0, "the staging: whole tasks a thread");

// The four weight maps, in this order: [Wqkv, Wgu] (phase 1), [Wo, Wdn]
// (phase 2), each over its (L, rows, cols) stack.
struct Args {
  CUtensorMap maps[4];
  const __nv_bfloat16* x;
  const int* layer;
  float* p1;      // (4, 8, kN1): phase-1 partials by K quarter
  float* p2;      // (kRT2, 8, kH): phase-2 partials by row tile
  int* tickets;   // (kCT2,) zero before and after
  __nv_bfloat16* out;
  int L, depth;
  // (grid, 5): a block's phase-1 units start, step, count; its phase-2
  // units first, count (every value below the 640 phase-1 units)
  int16_t plan[kMaxGrid][5];
};
static_assert(sizeof(Args) <= 4096, "a kernel's parameters take 4 KB");

// This block's units, its row of fused_layer_plan's table: n1 phase-1 units
// b, b + grid, ... (the start and step every plan has, which the launch
// checks: at each step the blocks read neighbouring column pieces of the
// same rows), phase-2 units the contiguous range [first2, first2 + n2) (one
// or two row tiles of activations to stage).
struct Plan {
  int n1, first2, n2;
  __device__ explicit Plan(const Args& a) {
    const int16_t* row = a.plan[blockIdx.x];
    n1 = row[2];
    first2 = row[3];
    n2 = row[4];
  }
  __device__ int unit1(int i) const { return blockIdx.x + i * gridDim.x; }
};

// Box t of the block's walk (R rows of one unit) onto slot t % depth.
template <int R>
__device__ __forceinline__ void issue(const Args& a, const Plan& p, int li, int t, uint32_t ring,
                                      uint32_t full) {
  constexpr int S1 = kU1Rows / R, S2 = kU2Rows / R;
  const int slot = t % a.depth;
  const uint32_t bar = full + 8 * slot;
  int m, col, row;
  if (t < p.n1 * S1) {
    const int u = p.unit1(t / S1);
    col = (u % kCT1) * kTC;
    row = (u / kCT1) * kU1Rows + (t % S1) * R;
    m = col < kNqkv ? 0 : 1;
    if (m == 1) col -= kNqkv;
  } else {
    const int t2 = t - p.n1 * S1, u = p.first2 + t2 / S2;
    col = (u % kCT2) * kTC;
    row = (u / kCT2) * kU2Rows + (t2 % S2) * R;
    m = row < kNo ? 2 : 3;
    if (m == 3) row -= kNo;
  }
  mbar_expect_tx(bar, R * 128);
  tma_load_3d(ring + slot * (R * 128), &a.maps[m], bar, col, row, li);
}

// Byte offset of B's element (row n, K k) in chunks of `chunk` bytes (rows
// of 128 bytes) of 64 K values, 128-byte swizzled as a TMA box (the 16-byte
// piece's index XOR the row within its 8-row group).
__device__ __forceinline__ int b_offset(int n, int k, int chunk = kBChunk) {
  return (k / 64) * chunk + n * 128 + ((((k % 64) / 8) ^ (n % 8)) << 4) + (k % 8) * 2;
}

// Keeps the compiler from moving a definition of the accumulators into an
// open wgmma stage (which it would answer with waits of its own).
__device__ __forceinline__ void pin(float (&d)[kChains][4]) {
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[c][i])::"memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Row tile rt's 256 activation rows, all 8 of x's rows, from the phase-1
// partials: four rows of one x row a task, every task's loads in flight at
// once; into act as B chunks of 16 rows, the bf16 hi parts in rows 0-7 and
// the lo parts in rows 8-15.
__device__ void stage_acts(const Args& a, int rt, unsigned char* act) {
  constexpr int kTasks = kM * kU2Rows / 4 / kThreads;
  const int row0 = rt * kU2Rows;
  float v[kTasks][4];
  if (row0 < kNo) {
    float4 q[kTasks][kKQ];
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      const int i = threadIdx.x + j * kThreads, m = i / (kU2Rows / 4), r = (i % (kU2Rows / 4)) * 4;
#pragma unroll
      for (int kq = 0; kq < kKQ; ++kq)
        q[j][kq] = __ldcg(reinterpret_cast<const float4*>(a.p1 + ((size_t)kq * kM + m) * kN1 +
                                                          row0 + r));
    }
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < kKQ; ++kq) {
        s[0] += q[j][kq].x;
        s[1] += q[j][kq].y;
        s[2] += q[j][kq].z;
        s[3] += q[j][kq].w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = tanhf(s[e]);
    }
  } else {
    float4 gv[kTasks][kKQ], uv[kTasks][kKQ];
    const int c0 = kNqkv + row0 - kNo;
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      const int i = threadIdx.x + j * kThreads, m = i / (kU2Rows / 4), r = (i % (kU2Rows / 4)) * 4;
#pragma unroll
      for (int kq = 0; kq < kKQ; ++kq) {
        const float* src = a.p1 + ((size_t)kq * kM + m) * kN1 + c0 + r;
        gv[j][kq] = __ldcg(reinterpret_cast<const float4*>(src));
        uv[j][kq] = __ldcg(reinterpret_cast<const float4*>(src + kNi));
      }
    }
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      float g[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < kKQ; ++kq) {
        g[0] += gv[j][kq].x;
        g[1] += gv[j][kq].y;
        g[2] += gv[j][kq].z;
        g[3] += gv[j][kq].w;
        u[0] += uv[j][kq].x;
        u[1] += uv[j][kq].y;
        u[2] += uv[j][kq].z;
        u[3] += uv[j][kq].w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = g[e] * (1.f / (1.f + expf(-g[e]))) * u[e];
    }
  }
#pragma unroll
  for (int j = 0; j < kTasks; ++j) {
    const int i = threadIdx.x + j * kThreads, m = i / (kU2Rows / 4), r = (i % (kU2Rows / 4)) * 4;
    float lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[e] = v[j][e] - bf16_round(v[j][e]);
    // four K values of one 16-byte piece
    *reinterpret_cast<uint2*>(act + b_offset(m, r, kActChunk)) =
        make_uint2(pack_bf16(v[j][0], v[j][1]), pack_bf16(v[j][2], v[j][3]));
    *reinterpret_cast<uint2*>(act + b_offset(m + kM, r, kActChunk)) =
        make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
  }
}

// The outputs of column tiles ct0 and ct1 (ct1 < 0: ct0 alone) from their
// 20 row-tile partials, every load of both in flight at once: each chunk's
// four row tiles in order, then the chunks with a bf16 rounding after each.
__device__ void fold(const Args& a, int ct0, int ct1) {
  const int m = threadIdx.x / (kTC / 2), c2 = (threadIdx.x % (kTC / 2)) * 2;
  const int cts[2] = {ct0, ct1};
  float2 pv[2][kRT2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (cts[t] >= 0)
#pragma unroll
      for (int r = 0; r < kRT2; ++r)
        pv[t][r] = __ldcg(reinterpret_cast<const float2*>(a.p2 + ((size_t)r * kM + m) * kH +
                                                          cts[t] * kTC + c2));
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (cts[t] < 0) continue;
    float o[2] = {0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < kK2 / kH; ++ch) {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j) {
        part[0] += pv[t][ch * kChunkTiles + j].x;
        part[1] += pv[t][ch * kChunkTiles + j].y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) o[e] = bf16_round(ch == 0 ? part[e] : o[e] + part[e]);
    }
    *reinterpret_cast<uint32_t*>(a.out + (size_t)m * kH + cts[t] * kTC + c2) =
        pack_bf16(o[0], o[1]);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) fused_layer_stream_kernel(const __grid_constant__ Args a) {
  constexpr int kBox = R * 128, S1 = kU1Rows / R, S2 = kU2Rows / R;
  extern __shared__ unsigned char smem_raw[];
  // the ring, x, the activations and the mbarriers, from a 1024-byte boundary
  unsigned char* ring_p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs_p = ring_p + (size_t)a.depth * kBox;
  unsigned char* act_p = xs_p + kXBytes;
  const uint32_t ring = smem_u32(ring_p), xs = smem_u32(xs_p), act = smem_u32(act_p);
  const uint32_t full = smem_u32(act_p + kActBytes);
  __shared__ int s_last[kCT2];
  __shared__ float4 xchg[kThreads / 2];     // warpgroup 1's unit sums

  int li = *a.layer;
  li = li < 0 ? 0 : (li >= a.L ? a.L - 1 : li);
  const Plan p(a);
  const int ns = p.n1 * S1 + p.n2 * S2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.depth; ++s) mbar_init(full + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int issued = 0;                           // thread 0's: boxes given to the ring
  {
    // x (kM, kH) bf16 as B chunks: every thread's 16-byte loads in flight
    // before the ring's first copies, which would queue them behind 12 MB
    constexpr int kLoads = kM * kH / 8 / kThreads;
    uint4 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      v[j] = __ldg(reinterpret_cast<const uint4*>(a.x) + threadIdx.x + j * kThreads);
    if (threadIdx.x == 0)
      for (; issued < ns && issued < a.depth; ++issued) issue<R>(a, p, li, issued, ring, full);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads, m = i / (kH / 8), k0 = (i % (kH / 8)) * 8;
      *reinterpret_cast<uint4*>(xs_p + b_offset(m, k0)) = v[j];
    }
  }
  fence_proxy_async();                      // the generic stores, then wgmma's reads
  __syncthreads();

  // Warpgroup wg multiplies k steps kk of half wg of every box.  d[c][0],
  // d[c][1]: weight column r of the unit's 64, x rows 2q, 2q + 1; d[c][2],
  // d[c][3]: column r + 8; four chains c of the warpgroup's products, so
  // the tensor cores wait on no single accumulator: phase 1 its k steps
  // j % 4 (n8), phase 2 its k steps j % 2 (n16: the hi rows' products in
  // d[2c], the lo rows' in d[2c + 1], one read of the box for both).  At a
  // unit's end the chains are summed, warpgroup 1's sums go to warpgroup 0
  // through shared memory, and the chains start again from zero.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane % 4;
  const int wg = warp / 4, r = (warp % 4) * 16 + lane / 4;
  constexpr int kSteps = R / 32;            // a warpgroup's k steps of a box
  float d[kChains][4] = {};
  bool barrier_done = false;
  int staged_rt = -1;                       // the phase-2 row tile in act
  for (int s = 0; s < ns; ++s) {
    const bool p2 = s >= p.n1 * S1;
    const int t2 = s - p.n1 * S1;
    const int u = p2 ? p.first2 + t2 / S2 : p.unit1(s / S1);
    const int step = p2 ? t2 % S2 : s % S1;
    if (p2 && !barrier_done) {
      __threadfence();
      aha_coop::grid_barrier();             // every phase-1 partial is written
      barrier_done = true;
    }
    if (p2 && u / kCT2 != staged_rt) {
      // the previous unit's products are done (wait 0 at its end, and the
      // __syncthreads closing its last box)
      staged_rt = u / kCT2;
      stage_acts(a, staged_rt, act_p);
      fence_proxy_async();
      __syncthreads();
    }
    const int slot = s % a.depth;
    mbar_wait(full + 8 * slot, (s / a.depth) & 1);
    const uint32_t box = ring + slot * kBox;
    pin(d);
    wgmma_fence();
    if (!p2) {
      const int k0 = (u / kCT1) * kU1Rows + step * R;   // x's K of the box's row 0
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kk = wg * kSteps + j, k = k0 + 16 * kk;
        wgmma_ss_n8_amn(d[j % kChains], desc_mn_major(box + kk * 16 * 128, kBox),
                        desc_k_major(xs + (k / 64) * kBChunk + (k % 64) / 16 * 32), 1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kk = wg * kSteps + j, k = step * R + 16 * kk;
        wgmma_ss_n16_amn(reinterpret_cast<float(&)[8]>(d[2 * (j % 2)]),
                         desc_mn_major(box + kk * 16 * 128, kBox),
                         desc_k_major(act + (k / 64) * kActChunk + (k % 64) / 16 * 32), 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();                          // the box's products are done: its slot is free
    pin(d);
    if (step == (p2 ? S2 : S1) - 1) {
      const int ct = u % (p2 ? kCT2 : kCT1), ld = p2 ? kH : kN1;
      float* dst = p2 ? a.p2 + (size_t)(u / kCT2) * kM * kH + ct * kTC
                      : a.p1 + (size_t)(u / kCT1) * kM * kN1 + ct * kTC;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = (d[0][i] + d[1][i]) + (d[2][i] + d[3][i]);
#pragma unroll
        for (int c = 0; c < kChains; ++c) d[c][i] = 0.f;
      }
      pin(d);
      if (wg == 1) xchg[threadIdx.x - 128] = make_float4(v[0], v[1], v[2], v[3]);
      __syncthreads();
      if (wg == 0) {
        const float4 o = xchg[threadIdx.x];
        __stcg(dst + (size_t)(2 * q) * ld + r, v[0] + o.x);
        __stcg(dst + (size_t)(2 * q + 1) * ld + r, v[1] + o.y);
        __stcg(dst + (size_t)(2 * q) * ld + r + 8, v[2] + o.z);
        __stcg(dst + (size_t)(2 * q + 1) * ld + r + 8, v[3] + o.w);
      }
    }
    __syncthreads();                        // every warp is past slot s
    if (threadIdx.x == 0 && issued < ns) issue<R>(a, p, li, issued++, ring, full);
  }
  if (!barrier_done) aha_coop::grid_barrier();   // a block with no phase-2 unit

  // The block's phase-2 partials are written: one ticket add a column tile
  // it wrote (all at once), and the last of a tile's 20 row tiles folds it.
  __threadfence();
  __syncthreads();
  if (threadIdx.x < kCT2) {
    int mine = 0;
    for (int u = p.first2; u < p.first2 + p.n2; ++u) mine += u % kCT2 == (int)threadIdx.x;
    s_last[threadIdx.x] = mine > 0 && atomicAdd(a.tickets + threadIdx.x, mine) + mine == kRT2;
    if (s_last[threadIdx.x]) a.tickets[threadIdx.x] = 0;   // ready for the next launch
  }
  __syncthreads();
  int pending = -1;                         // a tile to fold, waiting for a second
  bool fenced = false;
  for (int ct = 0; ct < kCT2; ++ct) {
    if (!s_last[ct]) continue;
    if (!fenced) {
      __threadfence();                      // the other blocks' partials, then our loads
      fenced = true;
    }
    if (pending < 0) {
      pending = ct;
    } else {
      fold(a, pending, ct);
      pending = -1;
    }
  }
  if (pending >= 0) fold(a, pending, -1);
}

inline size_t smem_bytes(int R, int depth) {
  return 1024 + (size_t)depth * R * 128 + kXBytes + kActBytes + 8 * (size_t)depth;
}

template <int R>
int launch(const Args& a, int grid, cudaStream_t st) {
  return aha_coop::launch(fused_layer_stream_kernel<R>, a, grid, kThreads,
                          smem_bytes(R, a.depth), st);
}

}  // namespace

// x (8, 1024) bf16; wqkv (L, 1024, 4096), wo (L, 2048, 1024), wgu (L, 1024,
// 6144), wdn (L, 3072, 1024) bf16 row-major, 16-byte aligned; layer an int32
// on the device; p1 (4, 8, 10240) and p2 (20, 8, 1024) f32 scratch; tickets
// (16,) int32, zero before the launch and left zero; out (8, 1024) bf16.
// rows (R) 64 or 128, depth 2-16 ring slots; plan (grid, 5) int32 in host
// memory, fused_layer_plan's table, whose blocks take every unit of both
// phases once, block b's phase-1 units starting at b with step grid (a plan
// that walks phase 1 otherwise is refused); grid its rows (at most one
// block an SM: a cooperative launch; at most kMaxGrid).
extern "C" int aha_study_fused_layer(const void* x, const void* wqkv, const void* wo,
                                     const void* wgu, const void* wdn, const void* layer,
                                     const void* plan, void* p1, void* p2, void* tickets,
                                     void* out, int L, int rows, int depth, int grid,
                                     void* stream) {
  if (L < 1 || (rows != 64 && rows != 128) || depth < 2 || depth > kMaxDepth || grid < 1 ||
      grid > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  const int* pl = static_cast<const int*>(plan);
  for (int i = 0; i < 5 * grid; ++i) {
    if (pl[i] < 0 || pl[i] > kU1) return static_cast<int>(cudaErrorInvalidValue);
    a.plan[i / 5][i % 5] = static_cast<int16_t>(pl[i]);
  }
  for (int b = 0; b < grid; ++b)
    if (a.plan[b][0] != b || a.plan[b][1] != grid) return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = make_weight_map(&a.maps[0], wqkv, kNqkv, kH, L, rows, true) &&
                  make_weight_map(&a.maps[1], wgu, 2 * kNi, kH, L, rows, true) &&
                  make_weight_map(&a.maps[2], wo, kH, kNo, L, rows, true) &&
                  make_weight_map(&a.maps[3], wdn, kH, kNi, L, rows, true);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.layer = static_cast<const int*>(layer);
  a.p1 = static_cast<float*>(p1);
  a.p2 = static_cast<float*>(p2);
  a.tickets = static_cast<int*>(tickets);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.L = L;
  a.depth = depth;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 128 ? launch<128>(a, grid, st) : launch<64>(a, grid, st);
}
