// Segment-masked flash attention: row i attends row j iff seg[i] == seg[j]
// >= 0, on Hopper's warpgroup MMA, TMA and mbarriers.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_attention_segmented (Pallas
// body _flash_seg_kernel) — the windowed and full-attention blocks of the
// Qwen2.5-VL vision tower (D 80) and the per-frame blocks of the Qwen3-VL /
// Qwen3.5 tower (D 72).
//
//   q (B, S, Hq, D), k/v (B, S, Hkv, D) bf16, addressed through strides (the
//   channel axis contiguous; a strided view such as one third of a fused
//   qkv product is read in place; bases and batch, row and head strides
//   16-byte aligned, as TMA needs) → o (B, S, Hq, D); seg (S,) int32 shared
//   by the batch; q-head h reads kv-head h / (Hq / Hkv).  Any S ≤ 65536; D
//   in {64, 72, 80, 128}.  Rows with seg < 0 are padding: they match no row and
//   their output is 0 (a patch bucket's tail, which no caller reads).
//
// Bound: the window blocks by bytes (q, k, v read once, o written once);
// the full-attention blocks by tensor-core FLOPs, 4 * Hq * D * (pairs with
// equal seg).  Design: flash_prefill.cu's (its helpers are hopper_tma.cuh),
// with the segment kernel's tile lists:
//
// - a persistent grid, one block of three warpgroups an SM, walking units
//   (128-row q tile, q-head, batch row) round-robin, so one unit's setup
//   runs under the previous one's products: warpgroup 2's first warp is
//   the producer, whose one thread issues TMA copies of each unit's Q tile
//   (two buffers) and of its listed 128-row K and V tiles into a ring of
//   stages that runs on from unit to unit; its other three warps list the
//   next unit's k tiles (two lists); warpgroups 0 and 1 consume 64 rows
//   each, S = Q·Kᵀ by wgmma.m64n128k16 from shared memory, the online
//   softmax on the S accumulators, O += P·V by wgmma with P from
//   registers, each tile's S issued with the previous tile's P·V.  Every
//   hand-over is an mbarrier; setmaxnreg moves registers to the consumers.
// - tile lists: one pass over seg gives the unit's q rows' range of segs
//   >= 0 and each k tile's, and the listing warps list, in order and in
//   shared memory, the k tiles whose range meets the q rows' (the producer
//   walks only the list): 2-3 per q tile in a window block (windows are at
//   most 64 rows), every real tile in a full-image block, none in a tile of
//   pad rows, which writes zeros.  For segs in ascending order, as the
//   tower's, those are exactly the tiles holding a matching seg;
//   otherwise a superset, which the masks keep exact.  A listed pair whose
//   2 x 128 rows all carry one seg is flagged unmasked — every interior
//   tile of the full-image segment — and its softmax runs under the
//   previous tile's P·V as in the prefill kernel; any other pair waits for
//   both products and sets the scores of keys of another seg (or past S)
//   to -inf in place, so one softmax serves both.  The compares read
//   shared memory: the q rows' segs from the list, a whole k tile's from
//   a bulk copy that lands with its K.
// - masked scores are -inf and a row with no match yet takes softmax base
//   0, so a masked entry adds exactly 0 whatever order the tiles come in
//   and a row that never matches (a pad row) ends at 0.
// - D 80 (the tower's head) is a 64-column box, 128-byte swizzled, and a
//   16-column box, 32-byte swizzled, each with its own tensor map and
//   wgmma descriptors: Q·Kᵀ takes 4 k16 steps from the first and 1 from
//   the second, P·V runs as n64 + n16.  The D 128 layout with TMA
//   zero-filling columns 80-127 (the prefill kernel's, tried first) ran
//   P·V at n128 and left the full-image call at 3.5x its bound.
// - D 72 (Qwen3-VL's tower, 1152 / 16) is D 80's layout: the tail box is
//   16 columns wide, and as every tensor map's inner extent is D, not the
//   row stride, TMA fills its columns 72-79 with zeros (never the next
//   head's first 8 columns of a fused qkv row).  The zero columns add
//   exactly 0 to Q·Kᵀ's fifth k16 step and give zero columns of the n16
//   P·V product, which the epilogue does not write: it stores D columns
//   and no column of the next head.
// - the window call's units are latency-bound (2-3 masked tiles each);
//   one block a unit left them at 0.069 ms on an H100, a block an SM at a
//   time, the walk at 0.051 (its setup under the previous unit's products;
//   a fourth ring stage did not help).  The full-image call's units stay
//   4.7 a block (5 on some SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

using namespace aha_hopper;

constexpr int kBlockQ = 128;
constexpr int kBlockK = 128;
constexpr int kThreads = 384;
constexpr int kListThreads = 96;        // warps 9-11
constexpr int kMaxTiles = 512;          // S <= 65536
constexpr uint16_t kUnmasked = 0x8000;  // a list entry's flag bit
constexpr int kTailBytes = 128 * 32;    // one [128 rows][16 bf16] TMA box

// A 128-row tile of a D-wide head: NA boxes of 64 columns, then (D 72, 80)
// a 16-column tail box of the rest, zero-filled past D.  Two Q buffers,
// then the K and V rings.
template <int D>
struct Layout {
  static constexpr int NA = D / 64;
  static constexpr int DT = D % 64 ? 16 : 0;        // the tail box's columns
  static_assert(D == 64 || D == 72 || D == 80 || D == 128, "D is 64, 72, 80 or 128");
  static constexpr int kTail = NA * kBoxBytes;      // the tail box in a tile
  static constexpr int kTile = kTail + (DT ? kTailBytes : 0);
  static constexpr int kStages = D > 80 ? 2 : 3;    // within 227 KB
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kSeg = kV + kStages * kTile;  // each stage's k tile's segs
  static constexpr int kBar = kSeg + kStages * kBlockK * 4;
  static constexpr int kBytes = kBar + 256 + 1024;  // barriers, alignment slack
};

struct OutStrides {
  long long ob, os, oh;
};

struct Units {
  int S, Hq, B, n;                // n = ⌈S/128⌉·Hq·B units, q-heads fastest
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
segment_flash_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq_tail,
                     const __grid_constant__ CUtensorMap tk_tail,
                     const __grid_constant__ CUtensorMap tv_tail,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ o,
                     OutStrides st, Units un, int G, float scale_log2) {
  using Lay = Layout<D>;
  constexpr int NA = Lay::NA, DT = Lay::DT, kStages = Lay::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint16_t tiles_s[2][kMaxTiles];
  __shared__ int n_tiles_s[2];
  __shared__ int qseg_s[2][kBlockQ];  // the unit's q rows' segs (-1 past S)
  __shared__ int range_s[4];          // lo, hi of the q rows' segs >= 0; min, max of all
  __shared__ int warp_n[kListThreads / 32];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;          // swizzle atoms: 1024-aligned
  const uint32_t sQ = base + Lay::kQ, sK = base + Lay::kK, sV = base + Lay::kV;
  const int* seg_s = reinterpret_cast<const int*>(smem_raw + (base - raw) + Lay::kSeg);
  const uint32_t bar = base + Lay::kBar;
  // Q full / empty, list full / empty (one each a buffer), then the ring
  const uint32_t qfull = bar, qempty = bar + 16, lfull = bar + 32, lempty = bar + 48;
  const uint32_t fullk = bar + 64, fullv = fullk + 8 * kStages, empty = fullv + 8 * kStages;
  const int S = un.S, Hq = un.Hq, HB = un.Hq * un.B;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(qfull + 8 * j, 1);
      mbar_init(qempty + 8 * j, 2);               // one arrival per consumer
      mbar_init(lfull + 8 * j, 1);
      mbar_init(lempty + 8 * j, 2);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fullk + 8 * s, 1);
      mbar_init(fullv + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x < 288) {
      // producer: one thread issues every copy
      if (threadIdx.x != 256) return;
      int stage = 0, qn = 0;
      for (int k = 0, u = blockIdx.x; u < un.n; ++k, u += gridDim.x) {
        const int lb = k & 1;
        mbar_wait(lfull + 8 * lb, (k >> 1) & 1);
        const int n = n_tiles_s[lb];
        if (n == 0) continue;
        const int q0 = u / HB * kBlockQ, h = u % Hq, b = u % HB / Hq, hk = h / G;
        const int qb = qn & 1;
        mbar_wait(qempty + 8 * qb, ((qn >> 1) & 1) ^ 1);
        const uint32_t q_at = sQ + qb * Lay::kTile;
        mbar_expect_tx(qfull + 8 * qb, Lay::kTile);
        for (int c = 0; c < NA; ++c) tma_load(q_at + c * kBoxBytes, &tq, qfull + 8 * qb, c * 64, q0, h, b);
        if (DT) tma_load(q_at + Lay::kTail, &tq_tail, qfull + 8 * qb, NA * 64, q0, h, b);
        ++qn;
        for (int i = 0; i < n; ++i, ++stage) {
          const int s = stage % kStages, kt = tiles_s[lb][i] & ~kUnmasked;
          mbar_wait(empty + 8 * s, ((stage / kStages) & 1) ^ 1);
          const uint32_t k_at = sK + s * Lay::kTile, v_at = sV + s * Lay::kTile;
          // a whole k tile's segs come with its K, for the masks
          const bool whole = (kt + 1) * kBlockK <= S;
          mbar_expect_tx(fullk + 8 * s, Lay::kTile + (whole ? kBlockK * 4 : 0));
          for (int c = 0; c < NA; ++c)
            tma_load(k_at + c * kBoxBytes, &tk, fullk + 8 * s, c * 64, kt * kBlockK, hk, b);
          if (DT) tma_load(k_at + Lay::kTail, &tk_tail, fullk + 8 * s, NA * 64, kt * kBlockK, hk, b);
          if (whole)
            bulk_load(base + Lay::kSeg + s * kBlockK * 4, seg + kt * kBlockK, kBlockK * 4,
                      fullk + 8 * s);
          mbar_expect_tx(fullv + 8 * s, Lay::kTile);
          for (int c = 0; c < NA; ++c)
            tma_load(v_at + c * kBoxBytes, &tv, fullv + 8 * s, c * 64, kt * kBlockK, hk, b);
          if (DT) tma_load(v_at + Lay::kTail, &tv_tail, fullv + 8 * s, NA * 64, kt * kBlockK, hk, b);
        }
      }
      return;
    }
    // the listing warps: each unit's k tiles, one unit ahead of the
    // consumers
    const int lt = threadIdx.x - 288, lw = lt / 32;
    const int nkt = (S + kBlockK - 1) / kBlockK;
    auto sync_list = [] { asm volatile("bar.sync 1, 96;\n" ::: "memory"); };
    for (int k = 0, u = blockIdx.x; u < un.n; ++k, u += gridDim.x) {
      const int lb = k & 1;
      mbar_wait(lempty + 8 * lb, ((k >> 1) & 1) ^ 1);
      const int q0 = u / HB * kBlockQ;
      sync_list();                        // every lister is past the last unit's range
      if (lt == 0) {
        range_s[0] = INT_MAX;
        range_s[1] = INT_MIN;
        range_s[2] = INT_MAX;
        range_s[3] = INT_MIN;
      }
      sync_list();
      for (int i = lt; i < kBlockQ; i += kListThreads) {
        const int r = q0 + i;
        const int s = r < S ? __ldg(seg + r) : -1;
        qseg_s[lb][i] = s;
        if (s >= 0) {
          atomicMin(&range_s[0], s);
          atomicMax(&range_s[1], s);
        }
        atomicMin(&range_s[2], s);
        atomicMax(&range_s[3], s);
      }
      sync_list();
      const int lo = range_s[0], hi = range_s[1];
      const bool q_uniform = range_s[2] == range_s[3] && range_s[2] >= 0;
      int total = 0;
      for (int c = 0; lo <= hi && c < nkt; c += kListThreads) {
        // k tile kt's range of segs >= 0 and its one seg if uniform
        const int kt = c + lt, j0 = kt * kBlockK, n = min(kBlockK, S - j0);
        int mn = INT_MAX, mx = INT_MIN, amn = INT_MAX, amx = INT_MIN;
        auto take = [&](int v) {
          amn = min(amn, v);
          amx = max(amx, v);
          if (v >= 0) {
            mn = min(mn, v);
            mx = max(mx, v);
          }
        };
        if (kt < nkt && n == kBlockK) {   // seg is 16-byte aligned (the wrapper's check)
          const int4* p = reinterpret_cast<const int4*>(seg + j0);
#pragma unroll 8
          for (int i = 0; i < kBlockK / 4; ++i) {
            const int4 v = __ldg(p + i);
            take(v.x);
            take(v.y);
            take(v.z);
            take(v.w);
          }
        } else if (kt < nkt) {
          for (int i = 0; i < n; ++i) take(__ldg(seg + j0 + i));
        }
        const bool hit = kt < nkt && mx >= lo && mn <= hi;
        const bool uniform = q_uniform && kt < nkt && n == kBlockK && amn == amx && amn == lo;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) warp_n[lw] = __popc(ballot);
        sync_list();
        int at = total;
        for (int w = 0; w < lw; ++w) at += warp_n[w];
        if (hit)
          tiles_s[lb][at + __popc(ballot & ((1u << lane) - 1u))] =
              static_cast<uint16_t>(kt) | (uniform ? kUnmasked : 0);
        for (int w = 0; w < kListThreads / 32; ++w) total += warp_n[w];
        sync_list();
      }
      if (lt == 0) {
        n_tiles_s[lb] = total;
        mbar_arrive(lfull + 8 * lb);      // after the list's last sync: its writes are in
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wtid = threadIdx.x % 128, wi = wtid / 32;
  const int g = lane >> 2, t = lane & 3;
  int stage = 0, qn = 0;
  for (int k = 0, u = blockIdx.x; u < un.n; ++k, u += gridDim.x) {
    const int lb = k & 1;
    const int q0 = u / HB * kBlockQ, h = u % Hq, b = u % HB / Hq;
    const int row0 = q0 + wg * 64 + wi * 16 + g;      // rows row0, row0 + 8
    __nv_bfloat16* op = o + b * st.ob + h * st.oh;
    mbar_wait(lfull + 8 * lb, (k >> 1) & 1);
    const int n_tiles = n_tiles_s[lb];
    const uint16_t* tiles = tiles_s[lb];
    if (n_tiles == 0) {              // no row of the tile matches a key: zeros
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + t * 2;
        if (row0 < S) *reinterpret_cast<uint32_t*>(op + row0 * st.os + c) = 0u;
        if (row0 + 8 < S) *reinterpret_cast<uint32_t*>(op + (row0 + 8) * st.os + c) = 0u;
      }
      if (wtid == 0) mbar_arrive(lempty + 8 * lb);
      continue;
    }
    const int qb = qn & 1;
    const uint32_t q_at = sQ + qb * Lay::kTile;

    float acc[NA * 32], acc_t[8];     // columns [0, 64·NA); the tail box's 16
#pragma unroll
    for (int i = 0; i < NA * 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_t[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // this thread's rows' segs; -1 for a pad row or one past S: no match
    const int sq0 = qseg_s[lb][row0 - q0], sq1 = qseg_s[lb][row0 - q0 + 8];

    uint32_t pa[8][4];               // P of the tile whose P·V is next
    float sc[64];
    mbar_wait(qfull + 8 * qb, (qn >> 1) & 1);

    // S = Q·K of list entry i into sc, issued (not waited for)
    auto issue_s = [&](int i) {
      const int s = (stage + i) % kStages;
      mbar_wait(fullk + 8 * s, ((stage + i) / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < NA * 4; ++kk) {
        const uint32_t koff = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_k_major(q_at + koff + wg * 64 * 128),
                      desc_k_major(sK + s * Lay::kTile + koff), kk > 0);
      }
      if (DT)
        wgmma_ss_n128(sc, desc_k_major_sw32(q_at + Lay::kTail + wg * 64 * 32),
                      desc_k_major_sw32(sK + s * Lay::kTile + Lay::kTail), 1);
      wgmma_commit();
    };
    // acc += P·V of list entry i, issued
    auto issue_pv_from = [&](int i, const uint32_t (&p)[8][4]) {
      const int s = (stage + i) % kStages;
      mbar_wait(fullv + 8 * s, ((stage + i) / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wgmma_pv<NA * 64>(acc, p[kk],
                          desc_mn_major(sV + s * Lay::kTile + kk * 16 * 128, kBoxBytes));
        if (DT)
          wgmma_rs_n16(acc_t, p[kk], desc_mn_major_sw32(sV + s * Lay::kTile + Lay::kTail + kk * 16 * 32));
      }
      wgmma_commit();
    };
    // the slot of list entry i is read
    auto free_stage = [&](int i) {
      if (wtid == 0) mbar_arrive(empty + 8 * ((stage + i) % kStages));
    };
    // keep[row] bit 2j + e: key (list entry i's tile) 8j + 2t + e matches
    // the row; a whole tile's segs came with its K into shared memory
    uint32_t keep0 = 0u, keep1 = 0u;
    auto keep_bits = [&](int i) {
      const int kt = tiles[i], key0 = kt * kBlockK + t * 2;
      const int* ss = seg_s + (stage + i) % kStages * kBlockK + t * 2;
      const bool whole = (kt + 1) * kBlockK <= S;
      keep0 = keep1 = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = key0 + j * 8;
        int2 ks = make_int2(-1, -1);
        if (whole) {
          ks = *reinterpret_cast<const int2*>(ss + j * 8);
        } else if (key + 1 < S) {
          ks = __ldg(reinterpret_cast<const int2*>(seg + key));
        } else if (key < S) {
          ks.x = __ldg(seg + key);
        }
        keep0 |= (uint32_t)(sq0 >= 0 && ks.x == sq0) << (2 * j);
        keep0 |= (uint32_t)(sq0 >= 0 && ks.y == sq0) << (2 * j + 1);
        keep1 |= (uint32_t)(sq1 >= 0 && ks.x == sq1) << (2 * j);
        keep1 |= (uint32_t)(sq1 >= 0 && ks.y == sq1) << (2 * j + 1);
      }
    };
    // a masked tile's S, once no wgmma is open: masked scores -inf
    auto mask_scores = [&]() {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(((e >= 2 ? keep1 : keep0) >> (2 * j + (e & 1))) & 1u)) sc[j * 4 + e] = -INFINITY;
    };
    // the online softmax of sc into pn; a0/a1 get the rescale of the rows'
    // output and running sums
    auto softmax = [&](uint32_t (&pn)[8][4], float& a0, float& a1) {
      // sc stays read-only here: it is the accumulator of a wgmma whose
      // pipeline stage is still open, and writing it would serialize them
      auto score = [&](int j, int e) { return sc[j * 4 + e] * scale_log2; };
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(score(j, 0), score(j, 1)));
        mx1 = fmaxf(mx1, fmaxf(score(j, 2), score(j, 3)));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // a row with no match so far keeps m = -inf and takes base 0
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float b0 = mn0 == -INFINITY ? 0.f : mn0;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1;
      a0 = exp2f(m0 - b0);
      a1 = exp2f(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = exp2f(score(j, 0) - b0), p1 = exp2f(score(j, 1) - b0);
        const float p2 = exp2f(score(j, 2) - b1), p3 = exp2f(score(j, 3) - b1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        pn[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pn[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
    };
    // S of list entry i is done: an unmasked tile's softmax overlaps the
    // P·V before it; a masked tile waits for both and masks S in place
    auto wait_s = [&](int i) {
      if (tiles[i] & kUnmasked) {
        wgmma_wait1();
      } else {
        keep_bits(i);
        wgmma_wait0();
        mask_scores();
      }
    };

    // pin the wgmma operands where they stand, so the compiler moves no
    // definition of them into an open wgmma pipeline stage
    auto pin_acc = [&]() {
#pragma unroll
      for (int i = 0; i < NA * 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      if (DT) {
#pragma unroll
        for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(acc_t[i])::"memory");
      }
    };
    auto pin_p = [&](uint32_t (&p)[8][4]) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[kk][e])::"memory");
    };
    // one list entry: its S and the previous entry's P·V on the tensor
    // cores together, the softmax of S into pout while the P·V finishes
    uint32_t pb[8][4];
    float a0, a1;
    auto step = [&](int i, uint32_t (&pin)[8][4], uint32_t (&pout)[8][4]) {
      pin_acc();
      pin_p(pin);
      wgmma_fence();
      issue_s(i);
      issue_pv_from(i - 1, pin);
      wait_s(i);
      softmax(pout, a0, a1);
      pin_p(pout);
      wgmma_wait0();                                                     // P·V done
      pin_acc();
      free_stage(i - 1);
#pragma unroll
      for (int j = 0; j < NA * 8; ++j) {
        acc[j * 4] *= a0;
        acc[j * 4 + 1] *= a0;
        acc[j * 4 + 2] *= a1;
        acc[j * 4 + 3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        acc_t[j * 4] *= a0;
        acc_t[j * 4 + 1] *= a0;
        acc_t[j * 4 + 2] *= a1;
        acc_t[j * 4 + 3] *= a1;
      }
    };
    auto last_pv = [&](uint32_t (&p)[8][4]) {
      pin_acc();
      pin_p(p);
      wgmma_fence();
      issue_pv_from(n_tiles - 1, p);
      wgmma_wait0();
      pin_acc();
      free_stage(n_tiles - 1);
    };
    wgmma_fence();
    issue_s(0);
    wait_s(0);
    wgmma_wait0();
    softmax(pa, a0, a1);
    int i = 1;
    for (; i + 1 < n_tiles; i += 2) {
      step(i, pa, pb);
      step(i + 1, pb, pa);
    }
    if (i < n_tiles) {
      step(i, pa, pb);
      last_pv(pb);
    } else {
      last_pv(pa);
    }
    // the unit's Q buffer and list are read
    if (wtid == 0) {
      mbar_arrive(qempty + 8 * qb);
      mbar_arrive(lempty + 8 * lb);
    }
    stage += n_tiles;
    ++qn;

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + t * 2;
      const float* v = j < NA * 8 ? acc + j * 4 : acc_t + (j - NA * 8) * 4;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(op + row0 * st.os + c) = pack_bf16(v[0] * inv0, v[1] * inv0);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(op + (row0 + 8) * st.os + c) =
            pack_bf16(v[2] * inv1, v[3] * inv1);
    }
  }
}

template <int D>
int launch(int grid, cudaStream_t s, const CUtensorMap (&m)[6], const int* seg,
           __nv_bfloat16* o, OutStrides st, Units un, int G, float scale_log2) {
  const int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      segment_flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_flash_kernel<D><<<grid, kThreads, smem, s>>>(m[0], m[1], m[2], m[3], m[4], m[5], seg,
                                                       o, st, un, G, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, o in order.
extern "C" int aha_segment_flash(const void* q, const void* k, const void* v,
                                 const void* seg, void* o, long long qb,
                                 long long qs, long long qh, long long kb,
                                 long long ks, long long kh, long long vb,
                                 long long vs, long long vh, long long ob,
                                 long long os, long long oh, int B, int S,
                                 int Hq, int Hkv, int D, float scale,
                                 void* stream) {
  if (S < 1 || (S + kBlockK - 1) / kBlockK > kMaxTiles || Hkv < 1 ||
      Hq % Hkv != 0 || (D != 64 && D != 72 && D != 80 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  // q, k, v in 64-column boxes, then (D 72, 80) a 16-column box from
  // column 64; each map's inner extent is D, so columns past it read 0
  CUtensorMap m[6];
  const int tail = D % 64 ? 16 : 64;
  for (int w = 0; w < 2; ++w) {
    const int cols = w == 0 ? 64 : tail;
    if (!make_map(&m[3 * w], q, D, S, Hq, B, qb, qs, qh, cols) ||
        !make_map(&m[3 * w + 1], k, D, S, Hkv, B, kb, ks, kh, cols) ||
        !make_map(&m[3 * w + 2], v, D, S, Hkv, B, vb, vs, vh, cols))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Units un{S, Hq, B, (S + kBlockQ - 1) / kBlockQ * Hq * B};
  const int grid = un.n < sms ? un.n : sms;
  const OutStrides st{ob, os, oh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  const int G = Hq / Hkv;
  switch (D) {
    case 64: return launch<64>(grid, s, m, sg, oo, st, un, G, scale_log2);
    case 72: return launch<72>(grid, s, m, sg, oo, st, un, G, scale_log2);
    case 80: return launch<80>(grid, s, m, sg, oo, st, un, G, scale_log2);
    default: return launch<128>(grid, s, m, sg, oo, st, un, G, scale_log2);
  }
}
