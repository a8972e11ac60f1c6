// The tensor-core column-tile dot over the GGUF grids, shared by
// quant_matmul.cu and quant_swiglu.cu: activation rows staged for
// mma.sync.m16n8k32 (s8 x s8 -> s32), each warp's weight fragments loaded
// into registers one chunk ahead, the per-group scale arithmetic, and the
// fixed-order sum of the warps' partials.
//
// Units and chunks.  A unit is 8 output columns (one mma n-tile; the fused
// MLP's gate|up unit is two tiles: 8 gate and the same 8 up columns).  The
// warps that share a unit split its K in 128-groups: a chunk is `parts ·
// span` groups, part p taking [p·span, (p+1)·span).  A warp loads its
// share of the next chunk — its B words and their scales (and mins) —
// into registers before it multiplies the current one, so its loads are in
// flight while it computes (load_frags, mma_frags); the kernels also pull a
// block's later units into L2 with bulk prefetches.  The plan (warps a
// unit, span, chunks, grid) is a pure function of Kp, N and the SM count
// (ops/quant_matmul.py matmul_plan / swiglu_plan): it does not depend on M.
//
// The product.  The grids are column-major rows (ops/quant_matmul.py), so a
// column's K bytes are contiguous: B's `col` layout.  Lane (g, t) — g =
// lane / 4, t = lane % 4 — takes column g of the tile and bytes
// [32t, 32t + 32) of each 128-group's K (q8: 32 bytes; q4: 16 bytes of
// nibbles), and the same K of activation rows g and g + 8 (A), so a
// 32-bit word as loaded is a fragment register.  Which K a fragment slot
// stands for is a relabelling shared by A and B: the int32 sum of a group
// is unchanged.  On the 4-bit grid the nibbles are unsigned (n ∈ [0, 15],
// w = n·s + b), so `w & 0x0F0F0F0F` and `(w >> 4) & 0x0F0F0F0F` are valid
// s8 words of the even and the odd K of eight; the staged activation rows
// of a q4 product hold each 8 values in that order (x0 x2 x4 x6 x1 x3 x5
// x7).  Rows past the staged ones are zero registers (rows 8–15 when a
// pass holds at most 8 rows).
//
// Per group, 4 k-steps of int32 accumulation, then per (row m, column n) of
// the C fragment: acc += (float)isum · (sx[m, g] · s[n, g]) and, on the
// 4-bit grid, the fmaf(xsum[m, g], b[n, g], ·) min term, with explicit
// round-to-nearest intrinsics, so no contraction depends on the
// instantiation.  A warp sums its groups in K order; the warps of a unit
// sum their partials in warp order in shared memory.  Row r's value
// therefore depends on row r alone: bit-equal whatever M and whichever rows
// share the launch, and on a repeat.  Activations are quantized with
// quant_dot.cuh quantize_group's arithmetic (IEEE division, round half to
// even), several groups of a warp interleaved, into rows of stride
// Kp + 16, which with the lanes' 32-byte reads keeps the A loads free of
// bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_dot.cuh"

namespace aha_quant {

constexpr int kUnitCols = 8;   // output columns of an mma n-tile
constexpr int kRowPad = 16;    // staged row stride Kp + 16
constexpr int kSpanTiles = 4;  // groups × tiles a warp holds in registers per chunk

// Shared memory of `rows` staged rows of Kp (ops/quant_matmul.staged_bytes).
__host__ __device__ inline size_t staged_mma_bytes(int rows, int Kp) {
  return (size_t)rows * (Kp + kRowPad) + 2 * sizeof(float) * (size_t)rows * (Kp / kGroup);
}

__device__ __forceinline__ Staged carve_mma(unsigned char* smem, int rows, int Kp) {
  Staged st;
  st.xq = reinterpret_cast<int8_t*>(smem);
  st.sx = reinterpret_cast<float*>(smem + (size_t)rows * (Kp + kRowPad));
  st.xsum = st.sx + rows * (Kp / kGroup);
  return st;
}

// quantize_group's arithmetic for kB (row, group) items of one warp at
// once: the same operations on each item in the same order — max|x| and
// the pairwise sum over 4 values a lane, then the xor-shuffle reductions,
// sx = max/127 (NaN if any value is), a true division and round half to
// even — interleaved across the items, so their loads and shuffle chains
// overlap instead of running one item after another.  Items with
// live[b] false are computed and not stored.
template <int kB>
__device__ __forceinline__ void quantize_groups(const float (&v)[kB][4], const bool (&live)[kB],
                                                const int (&m)[kB], const int (&g)[kB], int Kp,
                                                int8_t* xq, int row_stride, float* sx,
                                                float* xsum) {
  const int lane = threadIdx.x & 31;
  const int G = Kp / kGroup;
  float amax[kB], sum[kB];
  bool nan[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    amax[b] = fmaxf(fmaxf(fabsf(v[b][0]), fabsf(v[b][1])), fmaxf(fabsf(v[b][2]), fabsf(v[b][3])));
    sum[b] = (v[b][0] + v[b][1]) + (v[b][2] + v[b][3]);
    nan[b] = isnan(v[b][0]) || isnan(v[b][1]) || isnan(v[b][2]) || isnan(v[b][3]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      amax[b] = fmaxf(amax[b], __shfl_xor_sync(0xffffffffu, amax[b], off));
      sum[b] += __shfl_xor_sync(0xffffffffu, sum[b], off);
    }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const float s = __any_sync(0xffffffffu, nan[b]) ? NAN : amax[b] / 127.0f;
    const float d = s == 0.f ? 1.f : s;
    char4 q;
    q.x = (signed char)__float2int_rn(v[b][0] / d);
    q.y = (signed char)__float2int_rn(v[b][1] / d);
    q.z = (signed char)__float2int_rn(v[b][2] / d);
    q.w = (signed char)__float2int_rn(v[b][3] / d);
    if (live[b]) {
      *reinterpret_cast<char4*>(xq + (size_t)m[b] * row_stride + g[b] * kGroup + lane * 4) = q;
      if (lane == 0) {
        sx[m[b] * G + g[b]] = s;
        xsum[m[b] * G + g[b]] = sum[b];
      }
    }
  }
}

// Quantize `rows` rows, load(m, k) for k < K and zero past K up to Kp,
// into rows of stride Kp + kRowPad (quant_dot.cuh quantize_group's
// arithmetic, one warp a (row, group) item, kBatch items of a warp at
// once); on the 4-bit grid each 8 values then go to even/odd order.  Ends
// with the block synchronised.
template <bool Q4, typename Load>
__device__ void stage_rows(Load load, int K, int Kp, int rows, const Staged& st) {
  constexpr int kBatch = 4;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int G = Kp / kGroup, items = rows * G;
  for (int base = warp; base < items; base += kBatch * nwarps) {
    float v[kBatch][4];
    bool live[kBatch];
    int m[kBatch], g[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int item = base + b * nwarps;
      live[b] = item < items;
      m[b] = live[b] ? item / G : 0;
      g[b] = live[b] ? item - m[b] * G : 0;
      const int k0 = g[b] * kGroup + lane * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[b][j] = live[b] && k0 + j < K ? load(m[b], k0 + j) : 0.f;
    }
    quantize_groups<kBatch>(v, live, m, g, Kp, st.xq, Kp + kRowPad, st.sx, st.xsum);
  }
  if (Q4) {
    __syncthreads();
    const int per_row = Kp / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int m = i / per_row;
      uint2* p = reinterpret_cast<uint2*>(st.xq + (size_t)m * (Kp + kRowPad) +
                                          (size_t)(i - m * per_row) * 8);
      const uint2 v = *p;
      *p = make_uint2(__byte_perm(v.x, v.y, 0x6420), __byte_perm(v.x, v.y, 0x7531));
    }
  }
  __syncthreads();
}

// -- the weights in registers ---------------------------------------------------

// Pull `bytes` (a multiple of 16, 16-byte aligned) of global memory into L2.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// One warp's share of a chunk, loaded into registers: for each of its groups
// i < kS and tiles nt, lane (g, t)'s B words of column g of the tile (q8:
// bytes [32t, 32t + 32) of the group, two 16-byte loads; q4: bytes
// [16t, 16t + 16), one), and the scales (and mins) of the C fragment's
// columns 2t and 2t + 1.
template <bool Q4, int NT>
struct Frags {
  static constexpr int kS = kSpanTiles / NT;   // groups at most
  static constexpr int kW = Q4 ? 1 : 2;        // 16-byte loads a group a tile
  uint4 w[kS][NT][kW];
  float s[kS][NT][2];
  float b[kS][NT][2];
};

// Load this warp's groups [gw, gw + span) (span ≤ kS; those at or past G
// skipped) of the NT tiles whose column j is col(nt, j) (< 0: none, read
// as zeros) of a grid with G groups a column.
template <bool Q4, int NT, typename Col>
__device__ __forceinline__ void load_frags(Frags<Q4, NT>& f, const uint8_t* __restrict__ w,
                                           const float* __restrict__ s,
                                           const float* __restrict__ b, int G, Col col,
                                           int gw, int span) {
  constexpr int gb = Q4 ? 64 : 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < Frags<Q4, NT>::kS; ++i) {
    const int gg = gw + i;
    const bool live = i < span && gg < G;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = col(nt, g), n0 = col(nt, 2 * t), n1 = col(nt, 2 * t + 1);
      const uint4* p = reinterpret_cast<const uint4*>(
          w + ((size_t)(n < 0 ? 0 : n) * G + gg) * gb + t * (Q4 ? 16 : 32));
#pragma unroll
      for (int j = 0; j < Frags<Q4, NT>::kW; ++j)
        f.w[i][nt][j] = live && n >= 0 ? __ldg(p + j) : make_uint4(0, 0, 0, 0);
      f.s[i][nt][0] = live && n0 >= 0 ? __ldg(s + (size_t)n0 * G + gg) : 0.f;
      f.s[i][nt][1] = live && n1 >= 0 ? __ldg(s + (size_t)n1 * G + gg) : 0.f;
      if (Q4) {
        f.b[i][nt][0] = live && n0 >= 0 ? __ldg(b + (size_t)n0 * G + gg) : 0.f;
        f.b[i][nt][1] = live && n1 >= 0 ? __ldg(b + (size_t)n1 * G + gg) : 0.f;
      }
    }
  }
}

// -- the multiply --------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds128(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void words(const uint4& lo, const uint4& hi, unsigned (&v)[8]) {
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One group's scaled partial into the f32 accumulator, as the plain version
// orders it: (float)isum · (sx · s), then + xsum · b on the 4-bit grid.
template <bool Q4>
__device__ __forceinline__ float group_term(int isum, float sx, float s, float xsum, float b) {
  const float y = __fmul_rn(__int2float_rn(isum), __fmul_rn(sx, s));
  return Q4 ? __fmaf_rn(xsum, b, y) : y;
}

// The warp's groups [gw, gw + span) of `f` times the staged rows (`rows`
// live of stride Kp + kRowPad), into acc[nt]: the C fragment's f32 sums,
// rows g, g, g + 8, g + 8 and columns 2t, 2t + 1, 2t, 2t + 1 of tile nt.
template <bool Q4, bool TALL, int NT>
__device__ __forceinline__ void mma_frags(const Frags<Q4, NT>& f, int gw, int span,
                                          const Staged& st, int Kp, int rows,
                                          float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int G = Kp / kGroup, RS = Kp + kRowPad;
  const bool live0 = g < rows, live1 = TALL && g + 8 < rows;
#pragma unroll
  for (int i = 0; i < Frags<Q4, NT>::kS; ++i) {
    const int gg = gw + i;
    if (i >= span || gg >= G) break;
    const uint4 z = make_uint4(0, 0, 0, 0);
    unsigned xa[8], xb[8];
    const int8_t* xr = st.xq + (size_t)g * RS + (size_t)gg * kGroup + t * 32;
    words(live0 ? lds128(xr) : z, live0 ? lds128(xr + 16) : z, xa);
    if (TALL) {
      const int8_t* xr8 = xr + 8 * (size_t)RS;
      words(live1 ? lds128(xr8) : z, live1 ? lds128(xr8 + 16) : z, xb);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xb[j] = 0u;
    }
    const float sx0 = live0 ? st.sx[g * G + gg] : 0.f;
    const float sx1 = live1 ? st.sx[(g + 8) * G + gg] : 0.f;
    const float xs0 = Q4 && live0 ? st.xsum[g * G + gg] : 0.f;
    const float xs1 = Q4 && live1 ? st.xsum[(g + 8) * G + gg] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int c[4] = {0, 0, 0, 0};
      if (Q4) {
        const uint4 wv = f.w[i][nt][0];
        const unsigned wd[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(c, xa[2 * j], xb[2 * j], xa[2 * j + 1], xb[2 * j + 1], wd[j] & 0x0F0F0F0Fu,
                 (wd[j] >> 4) & 0x0F0F0F0Fu);
      } else {
        unsigned wd[8];
        words(f.w[i][nt][0], f.w[i][nt][Frags<Q4, NT>::kW - 1], wd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(c, xa[2 * j], xb[2 * j], xa[2 * j + 1], xb[2 * j + 1], wd[2 * j],
                 wd[2 * j + 1]);
      }
      const float s0 = f.s[i][nt][0], s1 = f.s[i][nt][1];
      const float b0 = f.b[i][nt][0], b1 = f.b[i][nt][1];
      acc[nt][0] = __fadd_rn(acc[nt][0], group_term<Q4>(c[0], sx0, s0, xs0, b0));
      acc[nt][1] = __fadd_rn(acc[nt][1], group_term<Q4>(c[1], sx0, s1, xs0, b1));
      if (TALL) {
        acc[nt][2] = __fadd_rn(acc[nt][2], group_term<Q4>(c[2], sx1, s0, xs1, b0));
        acc[nt][3] = __fadd_rn(acc[nt][3], group_term<Q4>(c[3], sx1, s1, xs1, b1));
      }
    }
  }
}

// The warps' partials: red[slot][nt][row][col], 16 × 8 f32 a tile, slot
// the warp's place among those that share its units.
template <bool TALL, int NT>
__device__ __forceinline__ void store_partials(float* red, int slot, const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* r = red + (slot * NT + nt) * 128;
    *reinterpret_cast<float2*>(r + g * 8 + 2 * t) = make_float2(acc[nt][0], acc[nt][1]);
    if (TALL)
      *reinterpret_cast<float2*>(r + (g + 8) * 8 + 2 * t) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Element e = row · 8 + column of tile nt, summed over slots [s0, s0 + n)
// in order.
template <int NT>
__device__ __forceinline__ float sum_partials(const float* red, int s0, int n, int nt, int e) {
  float v = red[(s0 * NT + nt) * 128 + e];
  for (int k = 1; k < n; ++k) v = __fadd_rn(v, red[((s0 + k) * NT + nt) * 128 + e]);
  return v;
}

}  // namespace aha_quant
