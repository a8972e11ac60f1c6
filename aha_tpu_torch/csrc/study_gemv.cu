// The decode-GEMV study on the card: the HBM read ceiling, an M = 8 bf16
// GEMV over the Qwen3 head, and the same GEMV with an argmax epilogue.
//
// Replaces the three TPU kernels of scripts/exp_gemv.py (inside main):
//   - mk_sum (body sum_kernel): a block sum over W (K, N) bf16 into a (1, 128)
//     f32 tile — x[0, 0] plus, for each bn-wide block of columns, the K-sums
//     of its first 128 columns.  The TPU copies every byte in to do it: the
//     practical read ceiling.  Here `stream_sum`.
//   - mk_gemv (body gemv_kernel): xp (M, K) bf16 . W (K, N) bf16 -> (M, N)
//     f32, f32 accumulation, at a block width bn.  Here `gemv` with M = 8.
//   - mk_head and head_once (body head_kernel): that GEMV for row 0 with a
//     (max, first index) epilogue carried across the grid.  Here `gemv` with
//     ARGMAX: x is (1, K) (the TPU's 8-row pad is a Mosaic layout, not the
//     function).
// The TPU grids are N // bn and drop the last N % bn columns; these kernels
// cover all N, masking the ragged edge (N a multiple of 8).
//
// Bound: bytes.  W is 311.2 MB at K 1024, N 151936: 0.0929 ms at 3.35 TB/s;
// the M = 8 GEMV also writes 4.9 MB of f32 (0.0943 ms).
//
// Design:
// - stream_sum: one pass, every thread one 8-column strip (16-byte loads,
//   neighbouring threads on neighbouring addresses) over a slice of K rows,
//   eight loads in flight per thread; 8 row slices x N/2048 column blocks =
//   600 blocks of 256 threads fill 132 SMs.  Each block writes the sums of
//   its head columns and its total to partials; a second one-block pass folds
//   them in a fixed order (no atomics), so both outputs are deterministic.  The
//   total of every element read is the proof that no load was dropped.
//   (The fold: 1024 threads, each one slice's sums of one column.)
// - gemv: the TPU's bn is a VMEM tile width, not a work unit here.  The
//   wrapper's plan (studies/exp_gemv.gemv_plan, a pure function of N and the
//   SM count) gives a column tile of 64, 128 or 256 and a persistent grid of
//   at most one block an SM; block b walks tiles b, b + grid, ...  (at N
//   151936: 128-column tiles, 1,187 of them, 9 rounds of 132 blocks with one
//   slot idle).  Warp specialisation: one producer thread keeps TMA copies of
//   W in flight, (64 K rows x 64 columns) boxes of 8 KB, 128-byte swizzled,
//   in a ring of up to 6 stages of one k-step of the tile each, on across
//   tile ends; each of the tile's 64-column boxes is one consumer
//   warpgroup's, which multiplies it on the tensor cores: wgmma.m64n8k16,
//   A = the box read MN-major (W's columns are the product's 64 rows), B = x
//   K-major (its 8 rows the n = 8 side), staged once a block, an f32 64 x 8
//   accumulator of 4 registers a thread.  M = 8: the accumulator goes through
//   shared memory (it is columns x rows, out rows x columns) and leaves in
//   16-byte stores.  ARGMAX (M = 1): B is x's row 0 and seven zero rows
//   (free: the bytes bound it); each block keeps a running (max, smallest
//   index) over its tiles, and the last block to finish — an atomic ticket it
//   resets for the next launch, as decode_attention.cu does — folds the
//   grid's partials.  A strictly greater value wins and an equal one goes to
//   the smaller index, which is associative, so the fold order does not move
//   the result.  The script's bn reaches neither the grid nor the kernel.
//   TMA zero-fills columns past N and rows past K: a zero logit would beat a
//   row of negative ones, so the argmax masks columns >= N by index, and
//   M = 8 stores none of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumSlices = 8;      // K row slices of stream_sum
constexpr int kSumUnroll = 8;      // loads in flight per thread
constexpr int kHead = 128;         // the TPU tile's lanes

__device__ __forceinline__ void add8(const uint4& u, float* s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s[2 * i] += f.x;
    s[2 * i + 1] += f.y;
  }
}

// grid (ceil(N / 8 / kThreads), kSumSlices)
__global__ void __launch_bounds__(kThreads)
stream_sum_partial(const __nv_bfloat16* __restrict__ w, int K, int N, int bn,
                   float* __restrict__ head_part, float* __restrict__ tot_part) {
  __shared__ float s_tot[kWarps];
  const int nchunk = N / 8;
  const int chunk = blockIdx.x * kThreads + threadIdx.x;
  const int rows = (K + kSumSlices - 1) / kSumSlices;
  const int r0 = blockIdx.y * rows, r1 = min(K, r0 + rows);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (chunk < nchunk) {
    const uint4* p = reinterpret_cast<const uint4*>(w) + chunk;
    int r = r0;
    for (; r + kSumUnroll <= r1; r += kSumUnroll) {
      uint4 u[kSumUnroll];
#pragma unroll
      for (int i = 0; i < kSumUnroll; ++i) u[i] = __ldcs(p + (size_t)(r + i) * nchunk);
#pragma unroll
      for (int i = 0; i < kSumUnroll; ++i) add8(u[i], s);
    }
    for (; r < r1; ++r) add8(__ldcs(p + (size_t)r * nchunk), s);
    const int col = chunk * 8, b = col / bn, c = col % bn;
    if (c < kHead) {
      const int nb = (N + bn - 1) / bn;
      float* dst = head_part + ((size_t)blockIdx.y * nb + b) * kHead + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = s[i];
    }
  }
  float t = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (threadIdx.x % 32 == 0) s_tot[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f;
    for (int i = 0; i < kWarps; ++i) a += s_tot[i];
    tot_part[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = a;
  }
}

// one block of kFold threads, thread (slice r, column c): the head sums of
// slice r over the column blocks, then the slices in order, + x[0] at c = 0;
// total: every block's total, each thread a strided share, then a tree.
// Every sum in a fixed order; the loads of a thread are issued in batches.
constexpr int kFold = kHead * kSumSlices;

__global__ void __launch_bounds__(kFold)
stream_sum_fold(const __nv_bfloat16* __restrict__ x, const float* __restrict__ head_part,
                const float* __restrict__ tot_part, int N, int bn, int nblocks,
                float* __restrict__ out, float* __restrict__ total) {
  __shared__ float s_a[kFold];
  __shared__ float s_t[kFold];
  const int c = threadIdx.x % kHead, r = threadIdx.x / kHead, nb = (N + bn - 1) / bn;
  // the last block may have fewer than kHead columns
  const int nbc = (N - c + bn - 1) / bn;
  const float* src = head_part + (size_t)r * nb * kHead + c;
  constexpr int kBatch = 16;        // loads in flight
  float a = 0.f;
  for (int b0 = 0; b0 < nbc; b0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = b0 + j < nbc ? src[(size_t)(b0 + j) * kHead] : 0.f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) a += v[j];
  }
  s_a[threadIdx.x] = a;
  float t = 0.f;
  for (int i = threadIdx.x; i < nblocks * kSumSlices; i += kFold) t += tot_part[i];
  s_t[threadIdx.x] = t;
  __syncthreads();
  if (r == 0) {
    float v = c == 0 ? __bfloat162float(x[0]) : 0.f;
    for (int i = 0; i < kSumSlices; ++i) v += s_a[i * kHead + c];
    out[c] = v;
  }
  for (int half = kFold / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s_t[threadIdx.x] += s_t[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) total[0] = s_t[0];
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// -- gemv: the product on wgmma, fed by a TMA ring ---------------------------

using namespace aha_hopper;

constexpr int kCols = 64;                    // a box's columns: one consumer warpgroup's
constexpr int kRows = 64;                    // a box's K rows: one k-step
constexpr int kBox = kCols * kRows * 2;      // 8 KB, 128-byte swizzled
constexpr int kXChunk = 8 * kRows * 2;       // x's 8 rows of one k-step, swizzled alike
constexpr int kStages = 6;                   // ring depth, fewer where shared memory is short
constexpr int kSlab = 68;                    // floats a row of the M = 8 slab (no bank conflicts)
constexpr int kMaxWarps = 4 * 4 + 1;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Dynamic shared memory of a tile of 64·C columns: the ring (stages x C
// boxes), x (one 1 KB chunk a k-step), C slabs of (8, kSlab) f32, 2 x stages
// mbarriers, and slack to align the ring to the 1024-byte swizzle atom.
inline size_t gemv_smem(int C, int K, int stages) {
  const int nk = (K + kRows - 1) / kRows;
  return 1024 + (size_t)stages * C * kBox + (size_t)nk * kXChunk + (size_t)C * 8 * kSlab * 4 +
         16 * (size_t)stages;
}

// grid: the plan's persistent blocks; block b walks tiles b, b + grid, ...
// Warps 0 .. 4C-1 are C consumer warpgroups, one a 64-column box; warp 4C
// the producer.
template <int C, bool ARGMAX>
__global__ void __launch_bounds__(128 * C + 32, 1)
gemv_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
            float* __restrict__ out, float* __restrict__ part_val, int* __restrict__ part_idx,
            int* __restrict__ counter, int M, int K, int N, int stages) {
  constexpr int T = C * kCols, kStage = C * kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nk = (K + kRows - 1) / kRows;
  unsigned char* xs_p = ring_p + (size_t)stages * kStage;
  float* slabs = reinterpret_cast<float*>(xs_p + (size_t)nk * kXChunk);
  const uint32_t ring = smem_u32(ring_p), xs = smem_u32(xs_p);
  const uint32_t full = smem_u32(slabs + C * 8 * kSlab), empty = full + 8 * stages;
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_idx[kMaxWarps];
  __shared__ int s_last;

  const int ntiles = (N + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);       // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  float best = -INFINITY;
  int best_i = INT_MAX;
  if (warp == 4 * C) {
    // the producer: one thread keeps the ring full, on across tile ends, so a
    // tile's epilogue overlaps the next tile's loads
    if (lane == 0) {
      int s = 0, ph = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, kStage);
          for (int c = 0; c < C; ++c)
            tma_load_3d(ring + s * kStage + c * kBox, &wmap, full + 8 * s, t * T + c * kCols,
                        kc * kRows, 0);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
    }
  } else {
    // x once a block: B of the product, K-major, 8 rows (rows past M and
    // K zero), each k-step's 64 K a [8][128-byte] chunk, 128-byte swizzled
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
    for (int p = threadIdx.x; p < nk * 64; p += 128 * C) {
      const int kc = p / 64, n = (p / 8) % 8, j = p % 8, k0 = kc * kRows + j * 8;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 2 * e;
        const uint32_t lo = n < M && k < K ? xb[(size_t)n * K + k] : 0u;
        const uint32_t hi = n < M && k + 1 < K ? xb[(size_t)n * K + k + 1] : 0u;
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(xs_p + kc * kXChunk + n * 128 + ((j ^ n) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();                     // x's stores, then wgmma's async reads
    named_sync(1, 128 * C);

    const int wg = warp / 4, wi = warp % 4, g = lane / 4, q = lane % 4, wt = threadIdx.x % 128;
    float* slab = slabs + wg * 8 * kSlab;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0, ph = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      // D (64 columns x 8 rows of x) = W box^T . x: A the box MN-major, B x
      int prev = -1;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t a = ring + s * kStage + wg * kBox, b = xs + kc * kXChunk;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_ss_n8_amn(d, desc_mn_major(a + kk * 16 * 128, kBox), desc_k_major(b + kk * 32),
                          kc + kk > 0);
        wgmma_commit();
        wgmma_wait1();                       // the previous k-step's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait0();
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // d[0], d[1]: column r, x rows 2q, 2q + 1; d[2], d[3]: column r + 8
      const int c0 = t * T + wg * kCols, r = wi * 16 + g;
      if (ARGMAX) {
        // columns past N hold TMA's zero fill: masked by index, not by value
        if (q == 0 && c0 + r < N && better(d[0], c0 + r, best, best_i)) {
          best = d[0];
          best_i = c0 + r;
        }
        if (q == 0 && c0 + r + 8 < N && better(d[2], c0 + r + 8, best, best_i)) {
          best = d[2];
          best_i = c0 + r + 8;
        }
      } else {
        // D is columns x rows, out rows x columns: through the slab, then
        // one 16-byte store a thread (a row's 64 columns are 16 threads)
        named_sync(2 + wg, 128);             // the last tile's reads are done
        slab[2 * q * kSlab + r] = d[0];
        slab[(2 * q + 1) * kSlab + r] = d[1];
        slab[2 * q * kSlab + r + 8] = d[2];
        slab[(2 * q + 1) * kSlab + r + 8] = d[3];
        named_sync(2 + wg, 128);
        const int m = wt / 16, c4 = (wt % 16) * 4;
        if (c0 + c4 < N)                     // N a multiple of 8: whole float4s
          __stcs(reinterpret_cast<float4*>(out + (size_t)m * N + c0 + c4),
                 *reinterpret_cast<const float4*>(slab + m * kSlab + c4));
      }
    }
  }
  if (!ARGMAX) return;

  // the block's (max, first index), then the last block folds every block's
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = s_val[0];
    int bi = s_idx[0];
    for (int i = 1; i < nwarps; ++i)
      if (better(s_val[i], s_idx[i], bv, bi)) {
        bv = s_val[i];
        bi = s_idx[i];
      }
    __stcg(part_val + blockIdx.x, bv);
    __stcg(part_idx + blockIdx.x, bi);
    __threadfence();
    const int ticket = atomicAdd(counter, 1);
    s_last = ticket == (int)gridDim.x - 1;
    if (s_last) *counter = 0;            // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  best = -INFINITY;
  best_i = INT_MAX;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const float v = __ldcg(part_val + b);
    const int i = __ldcg(part_idx + b);
    if (better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  __syncthreads();
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = s_val[0];
    int bi = s_idx[0];
    for (int i = 1; i < nwarps; ++i)
      if (better(s_val[i], s_idx[i], bv, bi)) {
        bv = s_val[i];
        bi = s_idx[i];
      }
    out[0] = bv;
    part_idx[gridDim.x] = bi;            // the result's index slot
  }
}

template <int C, bool ARGMAX>
int launch_gemv(const CUtensorMap& map, const void* x, void* out, void* part_val, void* part_idx,
                void* counter, int M, int K, int N, int grid, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t avail = (size_t)optin - 256;            // the static arrays
  int stages = kStages;
  while (stages > 2 && gemv_smem(C, K, stages) > avail) --stages;
  const size_t smem = gemv_smem(C, K, stages);
  if (smem > avail) return static_cast<int>(cudaErrorInvalidValue);   // x too long
  err = cudaFuncSetAttribute(gemv_kernel<C, ARGMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv_kernel<C, ARGMAX><<<grid, 128 * C + 32, smem, st>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out),
      static_cast<float*>(part_val), static_cast<int*>(part_idx), static_cast<int*>(counter), M,
      K, N, stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool ARGMAX>
int gemv_for_tile(int tile, const CUtensorMap& map, const void* x, void* out, void* pv, void* pi,
                  void* ctr, int M, int K, int N, int grid, cudaStream_t st) {
  switch (tile) {
    case 64: return launch_gemv<1, ARGMAX>(map, x, out, pv, pi, ctr, M, K, N, grid, st);
    case 128: return launch_gemv<2, ARGMAX>(map, x, out, pv, pi, ctr, M, K, N, grid, st);
    case 256: return launch_gemv<4, ARGMAX>(map, x, out, pv, pi, ctr, M, K, N, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (1, K) bf16 (x[0] is read), w (K, N) bf16 row-major; head_part
// (kSumSlices, ceil(N / bn), 128) f32 and tot_part (kSumSlices,
// ceil(N / 8 / 256)) f32 scratch; out (1, 128) f32, total (1,) f32.
// N a multiple of 8, bn a multiple of 128.
extern "C" int aha_study_stream_sum(const void* x, const void* w, void* head_part,
                                    void* tot_part, void* out, void* total, int K, int N,
                                    int bn, void* stream) {
  if (K < 1 || N < 8 || N % 8 != 0 || bn < kHead || bn % kHead != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (N / 8 + kThreads - 1) / kThreads;
  stream_sum_partial<<<dim3(nblocks, kSumSlices), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(w), K, N, bn, static_cast<float*>(head_part),
      static_cast<float*>(tot_part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_sum_fold<<<1, kFold, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<const float*>(head_part),
                                      static_cast<const float*>(tot_part), N, bn, nblocks,
                                      static_cast<float*>(out), static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}

// M = 8, argmax 0: x (8, K) bf16 . w (K, N) bf16 -> out (8, N) f32.
// M = 1, argmax 1: out (1,) f32 the max of x (1, K) . w, and part_idx[grid]
// its first index; part_val / part_idx (grid + 1) scratch, counter one int32
// that is zero before the launch and is left zero.  tile (64, 128 or 256
// columns) and grid (at most ceil(N / tile) blocks) are the wrapper's plan
// (studies/exp_gemv.gemv_plan).  N a multiple of 8, w 16-byte aligned.
extern "C" int aha_study_gemv(const void* x, const void* w, void* out, void* part_val,
                              void* part_idx, void* counter, int M, int K, int N, int argmax,
                              int tile, int grid, void* stream) {
  if (K < 1 || N < 8 || N % 8 != 0 || (argmax ? M != 1 : M != 8) || tile < kCols || grid < 1 ||
      grid > (N + tile - 1) / tile)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!make_weight_map(&map, w, N, K, 1, kRows, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return argmax
             ? gemv_for_tile<true>(tile, map, x, out, part_val, part_idx, counter, M, K, N, grid,
                                   st)
             : gemv_for_tile<false>(tile, map, x, out, part_val, part_idx, counter, M, K, N, grid,
                                    st);
}
