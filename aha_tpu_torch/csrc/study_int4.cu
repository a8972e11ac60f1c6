// The int4-weight study on the card: M = 8 activations quantized to int8
// times 4-bit weights, three ways.
//
// Replaces the three TPU kernels of scripts/exp_int4.py (inside main), which
// compute one function: each row of x (8, K) bf16 quantized to int8 by
// absmax / 127 (sx = max|x| / 127, xq = round_half_even(x / (sx or 1)), true
// divisions), xq . W (K, N) int4 accumulated in int32, times sx, to bf16
// (8, N).  No weight scales.
//   - f_i4_pl (body k_i4): the int4 block upcast to int8, then the dot.
//     Here `i4_upcast`: nibbles sign-extended to int8 in registers, __dp4a
//     on the CUDA cores.
//   - f_i4n_pl (body k_i4n): the int4 block handed to the dot as it is.
//     Here `i4_tensorcore`: Hopper has no s8 x s4 product (mma.sync takes
//     s8 x s8 or s4 x s4, wgmma only s8), so the nibbles are sign-extended
//     into the s8 B fragments of mma.sync.m16n8k32 in registers, with M
//     padded to 16 in registers only.
//   - f_pk (body k_pk): nibbles packed two per byte along K, (K/2, N), row
//     2i the low nibble and 2i+1 the high one.  Here `i4_packed_k`, on that
//     layout exactly, __dp4a.
// All three read 4 bits a weight (77.8 MB at K 1024, N 151936) and agree bit
// for bit with each other and the plain version: the int32 sums are exact,
// and sx and the epilogue round the same way.  The TPU grids (N // 2048)
// leave the last N % 2048 output columns unwritten; these cover all N.
//
// Layouts.  Rows 20-21 read "k8 words": W as (K/8, N) int32, word [q, n]
// holding W[8q + j, n] in bits 4j..4j+3 (ops: studies/exp_int4.pack_k8).
// A word's AND with 0x0F0F0F0F gives its even-k nibbles in bytes, its shift
// right by 4 then the same AND the odd-k ones, so the activations are staged
// once per block as matching words: xlo[q][m] = xq[m][8q + 0, 2, 4, 6],
// xhi[q][m] = xq[m][8q + 1, 3, 5, 7].  For the tensor cores the same words
// are the fragments: the thread (group g, lane-in-group t) of k block kb
// takes word q = 4kb + t of column g as B's two registers and xlo / xhi[q][g]
// as A's row-g registers (which k a byte slot stands for is a relabelling
// shared by A and B, so the sum is unchanged).  Row 22's (K/2, N) bytes, four
// rows at a time, transpose in registers (byte_perm) into words of the same
// even/odd order.
//
// Bound: bytes, 77.8 MB of weights + 2.4 MB of output: 0.0239 ms at
// 3.35 TB/s.  The dot is 1.24 G int8 MACs (311 M __dp4a; 0.0013 ms of the
// int8 tensor rate).  Grids: 64-thread blocks for the __dp4a kernels (594
// of them, 4-5 a SM, where 256-thread blocks made 149 for 132 SMs and a
// second wave), 256-thread blocks of 32 columns a warp for mma.sync.  Sign
// extension: rows 20-21 set a nibble's byte's high bits from its bit 3
// (b | (b & 0x08) * 0x1E per byte, three integer ops for four nibbles; the
// SIMD __vsub4 is emulated on sm_90); row 22 keeps the script's shifts — the
// nibble shifted to the top of its byte is 16x its signed value, so the
// int32 sum is 16x the dot and one arithmetic shift right by 4 ends it
// (|sum| < 2^28: exact).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the mma.sync kernel's block
constexpr int kDp4aThreads = 64;   // the __dp4a kernels' blocks
constexpr int kM = 8;        // activation rows
constexpr int kUnroll = 16;  // k8 words (or packed row quads) in flight

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

// Stage xq as the xlo / xhi words ([K/8][kM] each) and sx per row: x copied
// to shared memory first (xs, K * kM / 8 uint4) with every thread's loads in
// flight at once, then the row maxima and the words from there.
__device__ void stage_acts(const __nv_bfloat16* __restrict__ x, int K, uint4* xs, int* xlo,
                           int* xhi, float* sx) {
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < kM; m += blockDim.x / 32) {
    float a = 0.f;
    for (int q = lane; q < K / 8; q += 32) {
      float f[8];
      bf16x8(xs[m * (K / 8) + q], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) a = fmaxf(a, fabsf(f[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) sx[m] = a / 127.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (K / 8) * kM; i += blockDim.x) {
    const int q = i / kM, m = i % kM;
    const float d = sx[m] == 0.f ? 1.f : sx[m];
    float f[8];
    bf16x8(xs[m * (K / 8) + q], f);
    int lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = static_cast<int>(rintf(f[2 * j] / d));
      const int o = static_cast<int>(rintf(f[2 * j + 1] / d));
      lo |= (e & 0xff) << (8 * j);
      hi |= (o & 0xff) << (8 * j);
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

// Row 20: a thread owns 4 columns, one 16-byte load of k8 words per q.
__global__ void __launch_bounds__(kDp4aThreads)
i4_upcast_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int K, int N) {
  extern __shared__ __align__(16) int smem[];
  int* xlo = smem;
  int* xhi = xlo + (K / 8) * kM;
  uint4* xs = reinterpret_cast<uint4*>(xhi + (K / 8) * kM);
  __shared__ float sx[kM];
  stage_acts(x, K, xs, xlo, xhi, sx);
  const int n0 = 4 * (blockIdx.x * kDp4aThreads + threadIdx.x);
  if (n0 >= N) return;
  int acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;
  const int Q = K / 8;
  const int4* p = reinterpret_cast<const int4*>(w + n0);
  const size_t stride = N / 4;            // int4s per k8 row
  for (int q0 = 0; q0 < Q; q0 += kUnroll) {
    int4 u[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      u[i] = q0 + i < Q ? __ldcs(p + (size_t)(q0 + i) * stride) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (q0 + i >= Q) break;
      const int4 xl0 = reinterpret_cast<const int4*>(xlo)[(q0 + i) * 2];
      const int4 xl1 = reinterpret_cast<const int4*>(xlo)[(q0 + i) * 2 + 1];
      const int4 xh0 = reinterpret_cast<const int4*>(xhi)[(q0 + i) * 2];
      const int4 xh1 = reinterpret_cast<const int4*>(xhi)[(q0 + i) * 2 + 1];
      const int xl[kM] = {xl0.x, xl0.y, xl0.z, xl0.w, xl1.x, xl1.y, xl1.z, xl1.w};
      const int xh[kM] = {xh0.x, xh0.y, xh0.z, xh0.w, xh1.x, xh1.y, xh1.z, xh1.w};
      const int wv[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lo = sext4(wv[c] & 0x0F0F0F0F);
        const int hi = sext4((wv[c] >> 4) & 0x0F0F0F0F);
#pragma unroll
        for (int m = 0; m < kM; ++m) acc[m][c] = __dp4a(hi, xh[m], __dp4a(lo, xl[m], acc[m][c]));
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) store_row(out, N, m, n0, 4, acc[m], sx[m]);
}

// Row 22: a thread owns 4 columns of the (K/2, N) bytes; four packed rows
// (8 k values) per step, transposed into one word per column.
__global__ void __launch_bounds__(kDp4aThreads)
i4_packed_k_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int K, int N) {
  extern __shared__ __align__(16) int smem[];
  int* xlo = smem;
  int* xhi = xlo + (K / 8) * kM;
  uint4* xs = reinterpret_cast<uint4*>(xhi + (K / 8) * kM);
  __shared__ float sx[kM];
  stage_acts(x, K, xs, xlo, xhi, sx);
  const int n0 = 4 * (blockIdx.x * kDp4aThreads + threadIdx.x);
  if (n0 >= N) return;
  int acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;
  const int Q = K / 8;
  const int* p = reinterpret_cast<const int*>(w + n0);
  const size_t stride = N / 4;            // ints per packed row
  constexpr int U = kUnroll;
  for (int q0 = 0; q0 < Q; q0 += U) {
    int r[U][4];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[i][j] = q0 + i < Q ? __ldcs(p + (size_t)(4 * (q0 + i) + j) * stride) : 0;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (q0 + i >= Q) break;
      const int q = q0 + i;
      const int4 xl0 = reinterpret_cast<const int4*>(xlo)[q * 2];
      const int4 xl1 = reinterpret_cast<const int4*>(xlo)[q * 2 + 1];
      const int4 xh0 = reinterpret_cast<const int4*>(xhi)[q * 2];
      const int4 xh1 = reinterpret_cast<const int4*>(xhi)[q * 2 + 1];
      const int xl[kM] = {xl0.x, xl0.y, xl0.z, xl0.w, xl1.x, xl1.y, xl1.z, xl1.w};
      const int xh[kM] = {xh0.x, xh0.y, xh0.z, xh0.w, xh1.x, xh1.y, xh1.z, xh1.w};
      // 4 rows x 4 columns of bytes -> one word per column, row j in byte j
      const unsigned t0 = __byte_perm(r[i][0], r[i][1], 0x5140);
      const unsigned t1 = __byte_perm(r[i][2], r[i][3], 0x5140);
      const unsigned t2 = __byte_perm(r[i][0], r[i][1], 0x7362);
      const unsigned t3 = __byte_perm(r[i][2], r[i][3], 0x7362);
      const unsigned col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the script's (pk << 4) >> 4 and pk >> 4, with the >> 4 taken once
        // on the int32 sum: each nibble sits at the top of its byte (16x)
        const int lo = static_cast<int>((col[c] << 4) & 0xF0F0F0F0u);
        const int hi = static_cast<int>(col[c] & 0xF0F0F0F0u);
#pragma unroll
        for (int m = 0; m < kM; ++m) acc[m][c] = __dp4a(hi, xh[m], __dp4a(lo, xl[m], acc[m][c]));
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] >>= 4;
    store_row(out, N, m, n0, 4, acc[m], sx[m]);
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

}  // namespace

// x (8, K) bf16; variant 0 (i4_upcast) and 1 (i4_tensorcore): w the k8
// words (K/8, N) int32; variant 2 (i4_packed_k): w (K/2, N) int8 nibble
// pairs.  out (8, N) bf16.  K a multiple of 32, N of 8.
extern "C" int aha_study_int4(const void* x, const void* w, void* out, int K, int N,
                              int variant, void* stream) {
  if (K < 32 || K % 32 != 0 || N < 8 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the xlo / xhi words, then x itself
  const size_t smem = 2 * (size_t)(K / 8) * kM * sizeof(int) + (size_t)K * kM * 2;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  void (*fn)(const __nv_bfloat16*, const int*, __nv_bfloat16*, int, int) = nullptr;
  int grid = 0, threads = 0;
  switch (variant) {
    case 0:
      fn = i4_upcast_kernel;
      grid = (N / 4 + kDp4aThreads - 1) / kDp4aThreads;
      threads = kDp4aThreads;
      break;
    case 1:
      fn = i4_tensorcore_kernel;
      grid = (N + kThreads / 32 * kTiles * 8 - 1) / (kThreads / 32 * kTiles * 8);
      threads = kThreads;
      break;
    case 2: {
      cudaError_t err = cudaFuncSetAttribute(i4_packed_k_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      i4_packed_k_kernel<<<(N / 4 + kDp4aThreads - 1) / kDp4aThreads, kDp4aThreads, smem,
                           st>>>(
          xb, static_cast<const int8_t*>(w), ob, K, N);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, threads, smem, st>>>(xb, static_cast<const int*>(w), ob, K, N);
  return static_cast<int>(cudaGetLastError());
}
