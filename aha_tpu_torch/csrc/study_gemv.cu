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
// the M = 8 GEMV also writes 4.9 MB of f32 (0.0943 ms).  8 FMAs per W element
// at M = 8 (1.24 G FMA, 0.037 ms of the f32 rate) stay under the byte time.
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
// - gemv: a block owns BN columns (the TPU's block width, swept); its threads
//   own 8-column strips, and where BN/8 < 256 the K rows are split across the
//   threads left over, the slices summed through shared memory in a fixed
//   order.  x sits in shared memory as f32 [k][m], 8 accumulators per column
//   per row.  ARGMAX (M = 1): each block reduces its columns to (max, smallest
//   index) and the last block to finish — an atomic ticket it resets for the
//   next launch, as decode_attention.cu does — folds the partials.  A
//   strictly greater value wins and an equal one goes to the smaller index,
//   which is associative, so the fold order does not matter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

template <int M, int BN>
struct GemvShape {
  static constexpr int kChunks = BN / 8;                          // strips per block
  static constexpr int kCols = kChunks < kThreads ? kChunks : kThreads;   // strips at once
  static constexpr int kSlices = kThreads / kCols;                // K slices
  static constexpr int kRed = kSlices > 1 ? M * kCols * 8 : 0;    // floats to fold slices
};

// grid ceil(N / BN); dynamic shared memory: K * M floats of x, then the
// slice-fold buffer
template <int M, int BN, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            float* __restrict__ out, float* __restrict__ part_val, int* __restrict__ part_idx,
            int* __restrict__ counter, int K, int N) {
  using S = GemvShape<M, BN>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [K][M]
  float* red = smem + (size_t)K * M;  // [M][kCols * 8]
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_last;

  for (int i = threadIdx.x; i < K * M; i += kThreads) {
    const int k = i / M, m = i % M;
    xs[i] = __bfloat162float(x[(size_t)m * K + k]);
  }
  __syncthreads();

  const int nchunk = N / 8;
  const int strip = threadIdx.x % S::kCols, slice = threadIdx.x / S::kCols;
  const int rows = (K + S::kSlices - 1) / S::kSlices;
  const int r0 = slice * rows, r1 = min(K, r0 + rows);
  float best = -INFINITY;
  int best_i = INT_MAX;
  for (int c0 = 0; c0 < S::kChunks; c0 += S::kCols) {
    const int chunk = blockIdx.x * S::kChunks + c0 + strip;
    const bool live = chunk < nchunk;
    float acc[M][8];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
    if (live) {
      const uint4* p = reinterpret_cast<const uint4*>(w) + chunk;
      constexpr int U = M > 1 ? 4 : 8;
      int r = r0;
      for (; r + U <= r1; r += U) {
        uint4 u[U];
#pragma unroll
        for (int i = 0; i < U; ++i) u[i] = __ldcs(p + (size_t)(r + i) * nchunk);
#pragma unroll
        for (int i = 0; i < U; ++i) {
          float f[8];
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 t = __bfloat1622float2(h[j]);
            f[2 * j] = t.x;
            f[2 * j + 1] = t.y;
          }
          const float* xr = xs + (size_t)(r + i) * M;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float xm = xr[m];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xm, f[j], acc[m][j]);
          }
        }
      }
      for (; r < r1; ++r) {
        const uint4 u = __ldcs(p + (size_t)r * nchunk);
        float f[8];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 t = __bfloat1622float2(h[j]);
          f[2 * j] = t.x;
          f[2 * j + 1] = t.y;
        }
        const float* xr = xs + (size_t)r * M;
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xr[m], f[j], acc[m][j]);
      }
    }
    if (S::kSlices > 1) {
      // fold the K slices in order: slice 0 writes, each later slice adds
      for (int s = 0; s < S::kSlices; ++s) {
        if (slice == s) {
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float* d = red + ((size_t)m * S::kCols + strip) * 8 + j;
              *d = s == 0 ? acc[m][j] : *d + acc[m][j];
            }
        }
        __syncthreads();
      }
      if (slice == 0) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = red[((size_t)m * S::kCols + strip) * 8 + j];
      }
      __syncthreads();
    }
    if (slice == 0 && live) {
      if (ARGMAX) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (better(acc[0][j], chunk * 8 + j, best, best_i)) {
            best = acc[0][j];
            best_i = chunk * 8 + j;
          }
      } else {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float4* dst = reinterpret_cast<float4*>(out + (size_t)m * N + (size_t)chunk * 8);
          dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
          dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        }
      }
    }
  }
  if (!ARGMAX) return;

  // the block's (max, first index), then the last block folds every block's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
    for (int i = 1; i < kWarps; ++i)
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
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
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
    for (int i = 1; i < kWarps; ++i)
      if (better(s_val[i], s_idx[i], bv, bi)) {
        bv = s_val[i];
        bi = s_idx[i];
      }
    out[0] = bv;
    part_idx[gridDim.x] = bi;            // the result's index slot
  }
}

template <int M, int BN, bool ARGMAX>
int launch_gemv(const void* x, const void* w, void* out, void* part_val, void* part_idx,
                void* counter, int K, int N, cudaStream_t st) {
  const size_t smem = ((size_t)K * M + GemvShape<M, BN>::kRed) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gemv_kernel<M, BN, ARGMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (N + BN - 1) / BN;
  gemv_kernel<M, BN, ARGMAX><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), static_cast<float*>(part_val), static_cast<int*>(part_idx),
      static_cast<int*>(counter), K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int M, bool ARGMAX>
int gemv_for_width(int bn, const void* x, const void* w, void* out, void* pv, void* pi,
                   void* ctr, int K, int N, cudaStream_t st) {
  switch (bn) {
    case 256: return launch_gemv<M, 256, ARGMAX>(x, w, out, pv, pi, ctr, K, N, st);
    case 512: return launch_gemv<M, 512, ARGMAX>(x, w, out, pv, pi, ctr, K, N, st);
    case 1024: return launch_gemv<M, 1024, ARGMAX>(x, w, out, pv, pi, ctr, K, N, st);
    case 2048: return launch_gemv<M, 2048, ARGMAX>(x, w, out, pv, pi, ctr, K, N, st);
    case 4096: return launch_gemv<M, 4096, ARGMAX>(x, w, out, pv, pi, ctr, K, N, st);
    case 8192: return launch_gemv<M, 8192, ARGMAX>(x, w, out, pv, pi, ctr, K, N, st);
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
// its first index; part_val / part_idx (grid + 1) scratch with grid =
// ceil(N / bn), counter one int32 that is zero before the launch and is left
// zero.  bn in {256, 512, 1024, 2048, 4096, 8192}; N a multiple of 8.
extern "C" int aha_study_gemv(const void* x, const void* w, void* out, void* part_val,
                              void* part_idx, void* counter, int M, int K, int N, int bn,
                              int argmax, void* stream) {
  if (K < 1 || N < 8 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (argmax && M == 1)
    return gemv_for_width<1, true>(bn, x, w, out, part_val, part_idx, counter, K, N, st);
  if (!argmax && M == 8)
    return gemv_for_width<8, false>(bn, x, w, out, part_val, part_idx, counter, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
