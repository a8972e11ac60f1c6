// The int4-weight study on the card: M = 8 activations quantized to int8
// times 4-bit weights, three ways.
//
// Replaces the three TPU kernels of scripts/exp_int4.py (inside main), which
// compute one function: each row of x (8, K) bf16 quantized to int8 by
// absmax / 127 (sx = max|x| / 127, xq = round_half_even(x / (sx or 1)), true
// divisions), xq . W (K, N) int4 accumulated in int32, times sx, to bf16
// (8, N).  No weight scales.
//   - f_i4_pl (body k_i4; scripts/exp_int4.py:101): the int4 block upcast
//     to int8, then the dot.  Here `i4_upcast`, over the k8 words below,
//     on a TMA ring into mma.sync.m16n8k32 s8 (the design further down).
//   - f_i4n_pl (body k_i4n): the int4 block handed to the dot as it is.
//     Here `i4_tensorcore`: Hopper has no s8 x s4 product (mma.sync takes
//     s8 x s8 or s4 x s4, wgmma only s8), so the nibbles are sign-extended
//     into the s8 B fragments of mma.sync.m16n8k32 in registers, with M
//     padded to 16 in registers only.
//   - f_pk (body k_pk): nibbles packed two per byte along K, (K/2, N), row
//     2i the low nibble and 2i+1 the high one.  Here `i4_packed_k`, on that
//     layout exactly, from a TMA ring into mma.sync.m16n8k32 s8.
// All three read 4 bits a weight (77.8 MB at K 1024, N 151936) and agree bit
// for bit with each other and the plain version: the int32 sums are exact,
// and sx and the epilogue round the same way.  The TPU grids (N // 2048)
// leave the last N % 2048 output columns unwritten; these cover all N.
//
// Layouts.  Rows 20-21 read "k8 words": W as (K/8, N) int32, word [q, n]
// holding W[8q + j, n] in bits 4j..4j+3 (ops: studies/exp_int4.pack_k8).
// A word's AND with 0x0F0F0F0F gives its even-k nibbles in bytes, its shift
// right by 4 then the same AND the odd-k ones, so row 21 stages the
// activations once per block as matching words: xlo[q][m] = xq[m][8q + 0,
// 2, 4, 6], xhi[q][m] = xq[m][8q + 1, 3, 5, 7].  For the tensor cores the
// same words are the fragments: the thread (group g, lane-in-group t) of k
// block kb takes word q = 4kb + t of column g as B's two registers and
// xlo / xhi[q][g] as A's row-g registers (which k a byte slot stands for is
// a relabelling shared by A and B, so the sum is unchanged).
//
// Bound: bytes, 77.8 MB of weights + 2.4 MB of output: 0.0240 ms at
// 3.35 TB/s.  The dot is 1.24 G int8 MACs (0.0013 ms of the int8 tensor
// rate).  Row 20 left __dp4a for the tensor cores: its 311 M dp4a, at 64 a
// clock an SM (132 SMs, 1.98 GHz), would take about 0.019 ms of that pipe
// alone, 78 % of the bound, before the nibbles' unpacking and the
// activations' shared-memory reads.  Row 21's grid: 256-thread blocks of 32
// columns a warp, each block quantizing all of x; its sign extension sets a
// nibble's byte's high bits from its bit 3 (b | (b & 0x08) * 0x1E per byte,
// three integer ops for four nibbles; the SIMD __vsub4 is emulated on
// sm_90).  Rows 20 and 22 keep the script's shifts: a nibble shifted to the
// top of its byte is 16x its signed value, so the int32 sum is 16x the dot
// and one arithmetic shift right by 4 ends it (|16 sum| <= 16 K 127 8 <
// 2^31 for every K they take: exact).
//
// Rows 20 and 22 share a design: a persistent grid from
// exp_int4.packed_k_plan (gemv_plan's, with tiles of whole 128-column
// boxes: at N 151936, 1,187 tiles of 128 columns on 132 blocks); each block
// quantizes x once into ready B fragment words; a producer warp keeps a TMA
// ring full across tile ends (hopper_tma.cuh Ring, ring_walk); products on
// mma.sync.m16n8k32 s8 with W's columns as A's 16 rows and x's 8 rows as
// B's 8 columns, so M is not padded.  (wgmma takes 8-bit operands K-major
// only, and both layouts have N contiguous.)
//
// Row 20's design:
// - x: each consumer thread issues the loads of its first kXHeld 16-byte
//   pieces of x, then lets the producer start (a named barrier): the loads
//   are ahead of the ring's first copies (loads issued after them wait
//   behind them), and the ring fills while the consumers take sx per row
//   (a true division) from the pieces held in registers — all of x up to
//   K = 1024 H — and quantize them straight into B fragments: a uint4 a
//   lane for 8 rows of words.  Past that K the rest of x is read twice,
//   from L2.
// - W by TMA: the words as a tensor map of 4-byte elements, row stride 4N
//   bytes (a multiple of 16 for any N a multiple of 4); boxes of 64 rows x
//   32 words (128 bytes), 128-byte swizzled, starting at column n0 + 32 b (a
//   multiple of 128 bytes); a stage is a 64-row K step of a tile, one box a
//   32 columns: 32 KB for 128 columns, 128 KB in flight.  Rows past K/8 and
//   columns past N come as zero fill; a box wholly past N is not issued,
//   and columns past N are never stored.
// - Products: consumer warp b takes box b of every stage, 32 columns and
//   all of K, so its sums stay in registers to the tile's end (no reduction
//   across warps).  Lane (g, t) reads the 16 bytes of columns 4g .. 4g + 3
//   of rows 8i + 2t + e (e = 0, 1): after the swizzle (chunk g ^ (2t + e))
//   the eight lanes of each quarter warp read eight distinct 16-byte bank
//   groups.  Columns 4g, 4g + 1 are A rows g, g + 8 of one m16 tile, 4g + 2,
//   4g + 3 of another; a word's even-k nibbles at the tops of the bytes
//   ((w << 4) & 0xF0F0F0F0) are A's k slots 4t .. 4t + 3, its odd ones
//   (w & 0xF0F0F0F0) slots 16 + 4t .. 19 + 4t, and B's the matching xq.
//
// Row 22's design, on the shared parts above:
// - Weights by TMA.  A tensor map's row stride must be a multiple of 16
//   bytes, and N bytes need not be (N % 16 == 8 is allowed), so the map
//   views the bytes as (K/4, 2N): row i is packed rows 2i and 2i + 1 side
//   by side.  A column tile is two boxes of 64 rows x 128 bytes, 128-byte
//   swizzled, at column n0 (the even packed rows) and N + n0 (the odd ones):
//   256 k values of 128 columns, 16 KB a ring stage, 96 KB in flight.  A
//   box must also start at a multiple of 16 bytes (the card refuses others
//   with an illegal instruction): where N % 16 == 8 the odd rows come as an
//   unswizzled 144-byte box from N + n0 - 8, read 8 bytes in.  Columns past
//   N are read (the odd rows' bytes, or zero fill) but never stored.
// - x is quantized from L2 into the fragments it keeps (x itself is never
//   held in shared memory).
// - A thread loads 16 bytes (16 columns) of four rows of each box and
//   transposes them (byte_perm) into one word a column, whose nibbles
//   shifted to the tops of the bytes are A's registers; the k values they
//   stand for (4·row + 0..3) are relabelled in B.  Four consumer warps a
//   128 columns each take one 64-k group of every stage and sum through
//   shared memory at the tile's end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

constexpr int kThreads = 256;      // row 21's block
constexpr int kM = 8;        // activation rows

constexpr int kLoadBatch = 16;   // 16-byte loads of x in flight per thread

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// sx per row (absmax / 127) of x (kM, K) bf16 at `src`, in shared memory
// (BATCH 1) or global memory (BATCH kLoadBatch: a lane's loads in flight);
// then a block barrier.
template <int BATCH>
__device__ void row_scales(const uint4* src, int K, float* sx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < kM; m += blockDim.x / 32) {
    float a = 0.f;
    for (int q0 = lane; q0 < K / 8; q0 += 32 * BATCH) {
      uint4 v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        if (q0 + 32 * j < K / 8) v[j] = src[m * (K / 8) + q0 + 32 * j];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (q0 + 32 * j >= K / 8) break;
        float f[8];
        bf16x8(v[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(f[e]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) sx[m] = a / 127.f;
  }
  __syncthreads();
}

// x copied to shared memory (xs, K * kM / 8 uint4) with every thread's loads
// in flight at once, then sx per row from there (absmax / 127).
__device__ void stage_x(const __nv_bfloat16* __restrict__ x, int K, uint4* xs, float* sx) {
  const int n16 = K * kM / 8;
  const uint4* src = reinterpret_cast<const uint4*>(x);
  for (int i0 = threadIdx.x; i0 < n16; i0 += kLoadBatch * blockDim.x) {
    uint4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n16) v[j] = __ldg(src + i);
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n16) xs[i] = v[j];
    }
  }
  __syncthreads();
  row_scales<1>(xs, K, sx);
}

// One activation quantized as the TPU kernels quantize it: a true division
// by sx (1 where sx is 0), rounded half to even.
__device__ __forceinline__ int quantize(float f, float sx) {
  return static_cast<int>(rintf(f / (sx == 0.f ? 1.f : sx)));
}

// Stage xq as the xlo / xhi words ([K/8][kM] each) and sx per row.
__device__ void stage_acts(const __nv_bfloat16* __restrict__ x, int K, uint4* xs, int* xlo,
                           int* xhi, float* sx) {
  stage_x(x, K, xs, sx);
  for (int i = threadIdx.x; i < (K / 8) * kM; i += blockDim.x) {
    const int q = i / kM, m = i % kM;
    float f[8];
    bf16x8(xs[m * (K / 8) + q], f);
    int lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= (quantize(f[2 * j], sx[m]) & 0xff) << (8 * j);
      hi |= (quantize(f[2 * j + 1], sx[m]) & 0xff) << (8 * j);
    }
    xlo[i] = lo;
    xhi[i] = hi;
  }
  __syncthreads();
}

// four unsigned nibbles, one per byte, to signed bytes: bit 3 of a byte
// times 0x1E is 0xF0 and stays in its byte
__device__ __forceinline__ int sext4(int b) {
  const unsigned u = static_cast<unsigned>(b);
  return static_cast<int>(u | ((u & 0x08080808u) * 0x1Eu));
}

__device__ __forceinline__ void store_row(__nv_bfloat16* out, int N, int m, int n, int c,
                                          const int* acc, float s) {
  // c consecutive columns from n
  for (int j = 0; j < c; j += 2) {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n + j) =
        __floats2bfloat162_rn(static_cast<float>(acc[j]) * s,
                              static_cast<float>(acc[j + 1]) * s);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a2, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(0), "r"(a2), "r"(0), "r"(b0), "r"(b1));
}

// Row 21: a warp owns kTiles n-tiles of 8 columns; per k block of 32, each
// thread loads one k8 word of its column per tile.
constexpr int kTiles = 4;

__global__ void __launch_bounds__(kThreads)
i4_tensorcore_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int K, int N) {
  extern __shared__ __align__(16) int smem[];
  int* xlo = smem;
  int* xhi = xlo + (K / 8) * kM;
  uint4* xs = reinterpret_cast<uint4*>(xhi + (K / 8) * kM);
  __shared__ float sx[kM];
  stage_acts(x, K, xs, xlo, xhi, sx);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = ((blockIdx.x * (kThreads / 32) + warp) * kTiles) * 8;
  if (n0 >= N) return;                   // warp-uniform
  int c[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0;
  const int KB = K / 32;
  constexpr int U = 8;                   // k blocks in flight
  for (int kb0 = 0; kb0 < KB; kb0 += U) {
    int wv[U][kTiles];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int n = n0 + 8 * j + g;
        wv[i][j] = (kb0 + i < KB && n < N)
                       ? __ldcs(w + (size_t)(4 * (kb0 + i) + t) * N + n) : 0;
      }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (kb0 + i >= KB) break;
      const int q = 4 * (kb0 + i) + t;
      const int a0 = xlo[q * kM + g], a2 = xhi[q * kM + g];
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        mma_s8(c[j], a0, a2, sext4(wv[i][j] & 0x0F0F0F0F), sext4((wv[i][j] >> 4) & 0x0F0F0F0F));
    }
  }
  // c[j][0..1]: row g, columns 2t, 2t + 1 of tile j (rows 8-15 are the pad)
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n < N) store_row(out, N, g, n, 2, c[j], sx[g]);
  }
}

// -- Row 22: the packed bytes from a TMA ring, products on mma.sync s8 -------

using namespace aha_hopper;

constexpr int kPkRows = 64;               // rows of a box of the (K/4, 2N) view
constexpr int kPkBox = kPkRows * 128;     // 8 KB: 128-byte rows, 128-byte swizzled
constexpr int kPkOddBox = kPkRows * 144;  // 9 KB: 144-byte rows, unswizzled (N % 16 == 8)
constexpr int kPkHalf = kPkBox + kPkOddBox;   // a stage's bytes per 128 columns
constexpr int kPkRing = 96 * 1024;        // bytes in flight, as the shared memory allows

// c (16 x 8 s32) += a (16 x 32 s8) . b (32 x 8 s8)
__device__ __forceinline__ void mma_s8_16(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                          unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 rows x 4 columns of bytes (row j the word rj) -> one word per column,
// row j in byte j
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1, unsigned r2, unsigned r3,
                                           unsigned (&col)[4]) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const unsigned t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ unsigned word(const uint4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The bytes a row of xq takes in shared memory: K rounded up to whole ring
// stages, and 16 more, so the 4-byte reads of lanes (t, m) below fall on 32
// distinct banks.
__host__ __device__ __forceinline__ int pk_xq_stride(int nkg) { return nkg * 64 + 16; }

// xq as B fragments, from x in global memory (and sx, row_scales), by the
// `threads` consumer threads (named barrier 1): first xq itself into
// shared memory (8 values from each 16-byte load of x, kLoadBatch loads of
// a thread in flight, zero past K), then
// xw[(kg * kM + m) * 4 + t] — four words for row m, K group kg (64 k
// values) and fragment lane t, word v's byte j being xq[m][64 kg + 16 j +
// 4 t + v]: the k values that the A fragments built from rows
// 16 kg + 4 j + t of the (K/4, 2N) view hold — each from four 4-byte reads
// transposed.
__device__ void stage_packed_acts(int K, int nkg, const uint4* __restrict__ x, unsigned char* xq,
                                  uint4* xw, const float* sx, int threads) {
  const int ld = pk_xq_stride(nkg);
  for (int i0 = threadIdx.x; i0 < K * kM / 8; i0 += kLoadBatch * threads) {
    uint4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j)
      if (i0 + j * threads < K * kM / 8) v[j] = __ldg(x + i0 + j * threads);
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * threads;
      if (i >= K * kM / 8) break;
      const int m = i / (K / 8), k0 = (i % (K / 8)) * 8;
      float f[8];
      bf16x8(v[j], f);
      unsigned lo = 0u, hi = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= (static_cast<unsigned>(quantize(f[e], sx[m])) & 0xffu) << (8 * e);
        hi |= (static_cast<unsigned>(quantize(f[4 + e], sx[m])) & 0xffu) << (8 * e);
      }
      *reinterpret_cast<uint2*>(xq + m * ld + k0) = make_uint2(lo, hi);
    }
  }
  for (int i = threadIdx.x; i < kM * (nkg * 64 - K); i += threads)
    xq[(i / (nkg * 64 - K)) * ld + K + i % (nkg * 64 - K)] = 0;
  named_sync(1, threads);
  for (int i = threadIdx.x; i < nkg * kM * 4; i += threads) {
    const int t = i % 4, m = (i / 4) % kM, k0 = (i / (4 * kM)) * 64 + 4 * t;
    const unsigned* row = reinterpret_cast<const unsigned*>(xq + m * ld + k0);
    unsigned w[4];
    transpose4(row[0], row[4], row[8], row[12], w);   // k0 + 16 j, j = 0 .. 3
    xw[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  named_sync(1, threads);
}

// Shared memory past the ring: xw, then xq while xw is built from it and
// the epilogue's int32 sums after (the same bytes), then 2 x depth
// mbarriers.  x itself is read from global memory, never held here.
__host__ __device__ __forceinline__ size_t pk_scratch(int nkg, int H) {
  const size_t xq = (size_t)kM * pk_xq_stride(nkg), red = (size_t)4 * kM * 128 * H * 4;
  return xq > red ? xq : red;
}

__host__ __device__ __forceinline__ int pk_kgroups(int K) {
  return (K / 4 + kPkRows - 1) / kPkRows * 4;
}

// grid: the plan's persistent blocks (exp_int4.packed_k_plan); block b walks
// column tiles b, b + grid, ... of `tile` = 128·H columns, H boxes of 128
// columns a tile half.  Warps 0 .. 4H-1 consume (warp w: half w / 4, K group w % 4
// of every stage), warp 4H produces.
template <int H>
__global__ void __launch_bounds__(128 * H + 32, 1)
i4_packed_k_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap omap,
                   const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int K,
                   int N, int tile, int depth) {
  constexpr int kCons = 128 * H, kStage = H * kPkHalf, kCols = 128 * H;
  // the odd packed rows of column n0 lie at byte N + n0 of a view row, and a
  // TMA box must start at a multiple of 16 bytes: where N % 16 == 8 they
  // come as a 144-byte box from 8 bytes before (omap), unswizzled
  const int sh = N % 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nkg = pk_kgroups(K), nks = nkg / 4;   // K groups; ring stages a tile
  uint4* xw = reinterpret_cast<uint4*>(ring_p + (size_t)depth * kStage);
  unsigned char* scratch = reinterpret_cast<unsigned char*>(xw + nkg * kM * 4);
  unsigned char* xq = scratch;              // until xw is built
  int* red = reinterpret_cast<int*>(scratch);   // the epilogue's, after
  const uint32_t slots = smem_u32(ring_p);
  const uint32_t full = smem_u32(scratch + pk_scratch(nkg, H));
  const Ring ring{full, full + 8 * depth, depth};
  __shared__ float sx[kM];

  const int ntiles = (N + tile - 1) / tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring.init(kCons / 32);
  __syncthreads();
  // sx first: its loads of x would queue behind the ring's first copies
  // (12 MB over the grid); then the producer issues while the consumers
  // quantize (x again, from L2)
  row_scales<kLoadBatch>(reinterpret_cast<const uint4*>(x), K, sx);
  if (warp == kCons / 32) {
    // a stage: 64 view rows of the tile, the even packed rows at column n0
    // of the view and the odd ones at N + n0
    if (lane == 0)
      ring_walk(ring, ntiles, nks, [&](int) { return H * (kPkBox + (sh ? kPkOddBox : kPkBox)); },
                [&](int s, uint32_t bar, int tt, int ks) {
                  const int row = ks * kPkRows, n0 = tt * tile;
                  for (int h = 0; h < H; ++h) {
                    const uint32_t ev = slots + s * kStage + h * kPkBox;
                    const uint32_t od = slots + s * kStage + H * kPkBox + h * kPkOddBox;
                    tma_load_3d(ev, &wmap, bar, n0 + 128 * h, row, 0);
                    if (sh)
                      tma_load_3d(od, &omap, bar, N + n0 + 128 * h - sh, row, 0);
                    else
                      tma_load_3d(od, &wmap, bar, N + n0 + 128 * h, row, 0);
                  }
                });
    return;
  }
  stage_packed_acts(K, nkg, reinterpret_cast<const uint4*>(x), xq, xw, sx, kCons);

  // thread (g, t): 16 columns of its half, the 16-byte piece c of the
  // 128-byte rows (the pieces of lanes 8i .. 8i + 7 at eight distinct banks
  // after the swizzle), rows 16 kg + 4 j + t of each stage's K group kg.
  // A row g of m16 tile j is column 16 c + 2 j, row g + 8 column 16 c + 2 j + 1.
  const int g = lane / 4, t = lane % 4, h = warp / 4, kg = warp % 4;
  const int c = g / 2 + 4 * (g % 2);
  int f = 0;
  for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
    int acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    for (int ks = 0; ks < nks; ++ks, ++f) {
      const int s = f % depth;
      ring.wait(f);
      const unsigned char* ev = ring_p + (size_t)s * kStage + h * kPkBox;
      const unsigned char* od = ring_p + (size_t)s * kStage + H * kPkBox + h * kPkOddBox;
      uint4 re[4], ro[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kg * 16 + 4 * j + t, off = r * 128 + ((c ^ (r & 7)) << 4);
        re[j] = *reinterpret_cast<const uint4*>(ev + off);
        if (sh) {                             // bytes 16c + 8 .. 16c + 24 of a 144-byte row
          const uint2* p = reinterpret_cast<const uint2*>(od + r * 144 + 16 * c + sh);
          const uint2 lo = p[0], hi = p[1];
          ro[j] = make_uint4(lo.x, lo.y, hi.x, hi.y);
        } else {
          ro[j] = *reinterpret_cast<const uint4*>(od + off);
        }
      }
      const uint4 xv = xw[((ks * 4 + kg) * kM + g) * 4 + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned ce[4], co[4];
        transpose4(word(re[0], e), word(re[1], e), word(re[2], e), word(re[3], e), ce);
        transpose4(word(ro[0], e), word(ro[1], e), word(ro[2], e), word(ro[3], e), co);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // the script's (pk << 4) >> 4 and pk >> 4, the >> 4 taken once on
          // the int32 sum: each nibble at the top of its byte (16x)
          const unsigned e0 = ce[2 * i], e1 = ce[2 * i + 1], o0 = co[2 * i], o1 = co[2 * i + 1];
          mma_s8_16(acc[2 * e + i], (e0 << 4) & 0xF0F0F0F0u, (e1 << 4) & 0xF0F0F0F0u,
                    e0 & 0xF0F0F0F0u, e1 & 0xF0F0F0F0u, xv.x, xv.y);
          mma_s8_16(acc[2 * e + i], (o0 << 4) & 0xF0F0F0F0u, (o1 << 4) & 0xF0F0F0F0u,
                    o0 & 0xF0F0F0F0u, o1 & 0xF0F0F0F0u, xv.z, xv.w);
        }
      }
      __syncwarp();
      if (lane == 0) ring.drain(f);
    }
    // acc[j]: rows (columns) 16c + 2j and + 1, x rows 2t and 2t + 1; the four
    // K groups' sums through shared memory (integers: any order is exact)
    int* rw = red + (size_t)kg * kM * kCols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 128 * h + 16 * c + 2 * j;
      *reinterpret_cast<int2*>(rw + (2 * t) * kCols + col) = make_int2(acc[j][0], acc[j][2]);
      *reinterpret_cast<int2*>(rw + (2 * t + 1) * kCols + col) = make_int2(acc[j][1], acc[j][3]);
    }
    named_sync(1, kCons);
    {
      const int m = threadIdx.x / (kCols / 8), c8 = (threadIdx.x % (kCols / 8)) * 8;
      const int n = tt * tile + c8;
      if (n < N) {                            // N a multiple of 8: whole groups
        int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int4* src = reinterpret_cast<const int4*>(red + ((size_t)k4 * kM + m) * kCols + c8);
          const int4 lo = src[0], hi = src[1];
          v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
          v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
        }
        unsigned o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = pack_bf16(static_cast<float>(v[2 * i] >> 4) * sx[m],
                           static_cast<float>(v[2 * i + 1] >> 4) * sx[m]);
        *reinterpret_cast<uint4*>(out + (size_t)m * N + n) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    named_sync(1, kCons);                     // the sums are read before the next tile's
  }
}

// W's (K/2, N) bytes viewed as (K/4, 2N): row i is packed rows 2i and 2i + 1
// side by side, a row stride of 2N bytes (a multiple of 16 for any N a
// multiple of 8, which N itself need not be); boxes of 64 rows x `cols`
// bytes, 128-byte swizzled (128 columns) or not (144); zero past K/4 and 2N.
inline bool make_packed_map(CUtensorMap* map, const void* w, int K, int N, int cols) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)2 * N, (cuuint64_t)K / 4, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)2 * N, (cuuint64_t)2 * N * (K / 4)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, kPkRows, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides, box, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory of a ring kernel: `fixed` bytes beside `depth`
// stages of `stage` bytes and their two mbarriers, the depth cut from
// `want` to as few as two where the card's opt-in shared memory, less
// `reserved` (the kernel's static arrays), would not hold them; 0 where two
// do not fit (x too long) or the card cannot be asked.
inline size_t ring_smem(size_t fixed, int stage, int want, size_t reserved, int* depth) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const size_t avail = (size_t)optin - reserved;
  int d = want;
  while (d > 2 && fixed + (size_t)d * (stage + 16) > avail) --d;
  *depth = d;
  const size_t smem = fixed + (size_t)d * (stage + 16);
  return smem > avail ? 0 : smem;
}

template <int H>
int launch_packed(const CUtensorMap& map, const CUtensorMap& omap, const __nv_bfloat16* x,
                  __nv_bfloat16* out, int K, int N, int tile, int grid, cudaStream_t st) {
  const int nkg = pk_kgroups(K);
  const size_t fixed = 1024 + (size_t)nkg * kM * 4 * 16 + pk_scratch(nkg, H);
  int depth = 0;
  const size_t smem = ring_smem(fixed, H * kPkHalf, kPkRing / (2 * H * kPkBox), 256, &depth);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      i4_packed_k_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  i4_packed_k_kernel<H><<<grid, 128 * H + 32, smem, st>>>(map, omap, x, out, K, N, tile, depth);
  return static_cast<int>(cudaGetLastError());
}

// -- Row 20: the k8 words from a TMA ring, products on mma.sync s8 ----------

constexpr int kUpRows = 64;               // word rows (512 k values) of a box and a stage
constexpr int kUpBox = kUpRows * 128;     // 8 KB: 32 words a row, 128-byte swizzled
constexpr int kUpRing = 128 * 1024;       // bytes in flight, as the shared memory allows
constexpr int kXHeld = 8;                 // 16-byte pieces of x a consumer thread holds

__host__ __device__ __forceinline__ int up_ksteps(int K) {
  return (K / 8 + kUpRows - 1) / kUpRows;
}

// The B fragments: a uint4 a lane for every 8 word rows of the K steps
__host__ __device__ __forceinline__ size_t up_frag_bytes(int K) {
  return (size_t)up_ksteps(K) * (kUpRows / 8) * 32 * 16;
}

// v[m] for a row m known only at run time, without indexing registers
__device__ __forceinline__ float pick(const float (&v)[kM], int m) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < kM; ++i) r = m == i ? v[i] : r;
  return r;
}

// grid: the plan's persistent blocks (exp_int4.packed_k_plan); block b walks
// column tiles b, b + grid, ... of 128·H columns, 4H boxes of 32 columns a
// stage.  Warps 0 .. 4H-1 consume (warp w: box w of every stage), warp 4H
// produces.  Shared memory: the ring, the B fragments, the warps' row
// maxima of x, the ring's mbarriers.
template <int H>
__global__ void __launch_bounds__(128 * H + 32, 1)
i4_upcast_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out, int K, int N, int depth) {
  constexpr int kCons = 128 * H, kBoxes = 4 * H, kStage = kBoxes * kUpBox, kTile = 128 * H;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int Q = K / 8, nks = up_ksteps(K);
  uint4* xw = reinterpret_cast<uint4*>(ring_p + (size_t)depth * kStage);
  float* rmax = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xw) + up_frag_bytes(K));
  const uint32_t full = smem_u32(rmax + (kCons / 32) * kM);
  const Ring ring{full, full + 8 * depth, depth};
  const int ntiles = (N + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // x as K pieces of 8 values, row m's pieces at m Q .. m Q + Q - 1; a
  // consumer thread takes pieces threadIdx.x + j kCons
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int u0 = threadIdx.x;

  // x's loads are issued before the ring's first copies, the first kXHeld
  // of a thread held in registers; sx[m] is a row's running max |x| until
  // the consumers' barrier
  uint4 held[kXHeld];
  float sx[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) sx[m] = 0.f;
  auto fold = [&](int u, const uint4& v) {
    float f[8];
    bf16x8(v, f);
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(f[e]));
    const int m = u / Q;
#pragma unroll
    for (int i = 0; i < kM; ++i) sx[i] = m == i ? fmaxf(sx[i], a) : sx[i];
  };
  if (warp == kCons / 32) {
    // the producer starts once the consumers' loads of x are issued, ahead
    // of its copies (named barrier 2).  A stage: 64 word rows of the tile,
    // one box a 32 columns; a box wholly past N is not issued (its warp's
    // sums are never stored)
    named_sync(2, kCons + 32);
    if (lane == 0)
      ring_walk(ring, ntiles, nks,
                [&](int tt) { return min(kBoxes, (N - tt * kTile + 31) / 32) * kUpBox; },
                [&](int s, uint32_t bar, int tt, int ks) {
                  for (int b = 0; b < kBoxes && tt * kTile + 32 * b < N; ++b)
                    tma_load_3d(smem_u32(ring_p) + s * kStage + b * kUpBox, &wmap, bar,
                                tt * kTile + 32 * b, ks * kUpRows, 0);
                });
    return;
  }
  if (threadIdx.x == 0) ring.init(kCons / 32);
#pragma unroll
  for (int j = 0; j < kXHeld; ++j)
    if (u0 + j * kCons < K) held[j] = __ldg(xv + u0 + j * kCons);
  named_arrive(2, kCons + 32);
#pragma unroll
  for (int j = 0; j < kXHeld; ++j)
    if (u0 + j * kCons < K) fold(u0 + j * kCons, held[j]);
  for (int j0 = kXHeld; u0 + j0 * kCons < K; j0 += kXHeld) {   // past K = 1024 H
    uint4 v[kXHeld];
#pragma unroll
    for (int j = 0; j < kXHeld; ++j)
      if (u0 + (j0 + j) * kCons < K) v[j] = __ldg(xv + u0 + (j0 + j) * kCons);
#pragma unroll
    for (int j = 0; j < kXHeld; ++j)
      if (u0 + (j0 + j) * kCons < K) fold(u0 + (j0 + j) * kCons, v[j]);
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    float a = sx[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) rmax[warp * kM + m] = a;
  }
  named_sync(1, kCons);   // the row maxima, and the ring's mbarriers initialised

  // sx per row: the warps' maxima over 127, a true division as the plain
  // version's
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    float a = 0.f;
    for (int w = 0; w < kCons / 32; ++w) a = fmaxf(a, rmax[w * kM + m]);
    sx[m] = a / 127.f;
  }
  // xq straight into B fragments: word row q's (lo, hi) pair of row m —
  // xq[m][8q + 0, 2, 4, 6] and xq[m][8q + 1, 3, 5, 7] — is half e = q % 2
  // of lane (m, t = q % 8 / 2)'s uint4 of the 8-row group q / 8
  uint2* xw2 = reinterpret_cast<uint2*>(xw);
  auto frag = [&](int q, int m) { return (((q >> 3) * kM + m) * 4 + ((q & 7) >> 1)) * 2 + (q & 1); };
  auto quant = [&](int u, const uint4& v) {
    const int m = u / Q, q = u % Q;
    const float s = pick(sx, m);
    float f[8];
    bf16x8(v, f);
    unsigned lo = 0u, hi = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo |= (static_cast<unsigned>(quantize(f[2 * e], s)) & 0xffu) << (8 * e);
      hi |= (static_cast<unsigned>(quantize(f[2 * e + 1], s)) & 0xffu) << (8 * e);
    }
    xw2[frag(q, m)] = make_uint2(lo, hi);
  };
#pragma unroll
  for (int j = 0; j < kXHeld; ++j)
    if (u0 + j * kCons < K) quant(u0 + j * kCons, held[j]);
  for (int j0 = kXHeld; u0 + j0 * kCons < K; j0 += kXHeld) {
    uint4 v[kXHeld];
#pragma unroll
    for (int j = 0; j < kXHeld; ++j)
      if (u0 + (j0 + j) * kCons < K) v[j] = __ldg(xv + u0 + (j0 + j) * kCons);
#pragma unroll
    for (int j = 0; j < kXHeld; ++j)
      if (u0 + (j0 + j) * kCons < K) quant(u0 + (j0 + j) * kCons, v[j]);
  }
  // the word rows past K/8 of the last K step are zero fill: zero fragments
  for (int i = u0; i < (nks * kUpRows - Q) * kM; i += kCons)
    xw2[frag(Q + i / kM, i % kM)] = make_uint2(0u, 0u);
  named_sync(1, kCons);

  // lane (g, t): columns 4g .. 4g + 3 of its warp's box, rows 8i + 2t + e
  // of each stage; columns 4g, 4g + 1 are A rows g, g + 8 of m16 tile 0,
  // 4g + 2, 4g + 3 those of tile 1; acc[e][tile], e's two chains summed at
  // the tile's end
  const int g = lane / 4, t = lane % 4;
  const float s0 = pick(sx, 2 * t), s1 = pick(sx, 2 * t + 1);
  const unsigned char* mine = ring_p + warp * kUpBox;
  int f = 0;
  for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
    int acc[2][2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[e][j][i] = 0;
    for (int ks = 0; ks < nks; ++ks, ++f) {
      ring.wait(f);
      const unsigned char* box = mine + (size_t)(f % depth) * kStage;
      const uint4* xk = xw + ks * (kUpRows / 8) * 32 + lane;
#pragma unroll
      for (int i = 0; i < kUpRows / 8; ++i) {
        const uint4 xb = xk[32 * i];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * i + 2 * t + e;
          const uint4 wv = *reinterpret_cast<const uint4*>(box + r * 128 + ((g ^ (2 * t + e)) << 4));
          const unsigned b0 = e ? xb.z : xb.x, b1 = e ? xb.w : xb.y;
          // the script's nibbles at the tops of the bytes (16x), the >> 4
          // taken once on the int32 sum
          mma_s8_16(acc[e][0], (wv.x << 4) & 0xF0F0F0F0u, (wv.y << 4) & 0xF0F0F0F0u,
                    wv.x & 0xF0F0F0F0u, wv.y & 0xF0F0F0F0u, b0, b1);
          mma_s8_16(acc[e][1], (wv.z << 4) & 0xF0F0F0F0u, (wv.w << 4) & 0xF0F0F0F0u,
                    wv.z & 0xF0F0F0F0u, wv.w & 0xF0F0F0F0u, b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) ring.drain(f);
    }
    // acc[.][j][0 / 1]: column 4g + 2j, x rows 2t / 2t + 1; [2 / 3]: column
    // 4g + 2j + 1.  Rows 2t and 2t + 1 of 4 columns each, 8 bytes a store
    const int n = tt * kTile + 32 * warp + 4 * g;
    if (n < N) {                              // N a multiple of 8: whole groups of 4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = h ? s1 : s0;
        auto v = [&](int j, int c) {
          return static_cast<float>((acc[0][j][c] + acc[1][j][c]) >> 4) * s;
        };
        *reinterpret_cast<uint2*>(out + (size_t)(2 * t + h) * N + n) =
            make_uint2(pack_bf16(v(0, h), v(0, 2 + h)), pack_bf16(v(1, h), v(1, 2 + h)));
      }
    }
  }
}

// The k8 words (K/8, N) int32 as 4-byte elements, a row stride of 4N bytes
// (a multiple of 16 for any N a multiple of 4); boxes of 64 rows x 32 words
// (128 bytes), 128-byte swizzled; zero past K/8 and N.
inline bool make_k8_map(CUtensorMap* map, const void* w, int K, int N) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K / 8, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)4 * N, (cuuint64_t)4 * N * (K / 8)};
  const cuuint32_t box[3] = {32, kUpRows, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(w), dims, strides, box, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H>
int launch_upcast(const CUtensorMap& map, const __nv_bfloat16* x, __nv_bfloat16* out, int K,
                  int N, int grid, cudaStream_t st) {
  constexpr int kStage = 4 * H * kUpBox;
  const size_t fixed = 1024 + up_frag_bytes(K) + (size_t)4 * H * kM * sizeof(float);
  int depth = 0;
  const size_t smem = ring_smem(fixed, kStage, kUpRing / kStage, 0, &depth);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      i4_upcast_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  i4_upcast_kernel<H><<<grid, 128 * H + 32, smem, st>>>(map, x, out, K, N, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (8, K) bf16; variant 0 (i4_upcast) and 1 (i4_tensorcore): w the k8
// words (K/8, N) int32; variant 2 (i4_packed_k): w (K/2, N) int8 nibble
// pairs; 16-byte aligned.  Variants 0 and 2 run on the plan's `tile` (128 or
// 256 columns, whole boxes) and `grid` (at most ceil(N / tile) blocks;
// exp_int4.packed_k_plan), which variant 1 does not read.  K up to 12,288
// for variant 0 (its fragments of xq beside a ring of two 256-column stages
// fill the shared memory) and 9,984 for variant 2 (xw and xq beside a ring
// of two stages: 12,032 at tile 128).  out (8, N) bf16.  K a multiple of
// 32, N of 8.
extern "C" int aha_study_int4(const void* x, const void* w, void* out, int K, int N,
                              int variant, int tile, int grid, void* stream) {
  if (K < 32 || K % 32 != 0 || N < 8 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (variant == 0 || variant == 2) {
    if ((tile != 128 && tile != 256) || grid < 1 || grid > (N + tile - 1) / tile)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == 0) {
    CUtensorMap map;
    if (!make_k8_map(&map, w, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    return tile == 256 ? launch_upcast<2>(map, xb, ob, K, N, grid, st)
                       : launch_upcast<1>(map, xb, ob, K, N, grid, st);
  }
  if (variant == 2) {
    CUtensorMap map, omap;
    if (!make_packed_map(&map, w, K, N, 128) ||
        !(N % 16 == 0 ? make_packed_map(&omap, w, K, N, 128) : make_packed_map(&omap, w, K, N, 144)))
      return static_cast<int>(cudaErrorInvalidValue);
    return tile == 256 ? launch_packed<2>(map, omap, xb, ob, K, N, tile, grid, st)
                       : launch_packed<1>(map, omap, xb, ob, K, N, tile, grid, st);
  }
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  // the xlo / xhi words, then x itself
  const size_t smem = 2 * (size_t)(K / 8) * kM * sizeof(int) + (size_t)K * kM * 2;
  cudaError_t err = cudaFuncSetAttribute(i4_tensorcore_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = kThreads / 32 * kTiles * 8;   // a block's
  i4_tensorcore_kernel<<<(N + cols - 1) / cols, kThreads, smem, st>>>(
      xb, static_cast<const int*>(w), ob, K, N);
  return static_cast<int>(cudaGetLastError());
}
