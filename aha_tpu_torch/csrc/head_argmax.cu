// Greedy token for one hidden state: argmax over V of h . W[v], without
// storing the logits.
//
// Replaces aha_tpu/ops/lm_head.py:head_argmax, bf16 dense head (Pallas
// bodies _head_argmax_bf16_kernel + _argmax_epilogue).
//
//   h (K,) bf16; W (V, K) bf16 row-major — the head stored vocab-major, so
//   a tied head is the embedding table itself and each row is contiguous.
//   Result: int32 index; ties go to the smallest index, and any NaN logit
//   gives V - 1, exactly what fast_argmax returns for such a row.
//
// Bound: reading the K * V * 2 B head once (311 MB for Qwen3-0.6B).
// Design: the TPU kernel carries a running (max, index) across a sequential
// grid; CUDA blocks run in no order, so this is two passes.  Pass 1: each
// block owns 64 vocab rows, one warp per row at a time, lanes streaming the
// row with 16-byte loads against h held in shared memory as f32; the block
// reduces to (max, smallest index attaining it, saw-NaN).  Pass 2: one
// block folds the partials with the same rule — a strictly greater value
// wins, an equal value goes to the smaller index — which is associative, so
// the fold order does not matter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;
constexpr int kFoldThreads = 1024;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
head_argmax_partial(const __nv_bfloat16* __restrict__ h,
                    const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ part_val, int* __restrict__ part_idx,
                    int* __restrict__ part_nan, int K, int V) {
  extern __shared__ float sm_h[];                 // K floats
  __shared__ float sm_val[kWarps];
  __shared__ int sm_idx[kWarps];
  __shared__ int sm_nan[kWarps];

  for (int i = threadIdx.x; i < K; i += kThreads)
    sm_h[i] = __bfloat162float(h[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = K / 8;
  float best = -INFINITY;
  int best_i = INT_MAX;
  int saw_nan = 0;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = row0 + warp; r < min(row0 + kRowsPerBlock, V); r += kWarps) {
    const uint4* wr = reinterpret_cast<const uint4*>(w + (size_t)r * K);
    float s = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const uint4 u = wr[c];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float* hv = sm_h + c * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(p[j]);
        s = fmaf(x.x, hv[2 * j], s);
        s = fmaf(x.y, hv[2 * j + 1], s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (isnan(s)) saw_nan = 1;
    else if (better(s, r, best, best_i)) {
      best = s;
      best_i = r;
    }
  }
  if (lane == 0) {
    sm_val[warp] = best;
    sm_idx[warp] = best_i;
    sm_nan[warp] = saw_nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sm_val[0];
    int bi = sm_idx[0], bn = sm_nan[0];
    for (int i = 1; i < kWarps; ++i) {
      bn |= sm_nan[i];
      if (better(sm_val[i], sm_idx[i], bv, bi)) {
        bv = sm_val[i];
        bi = sm_idx[i];
      }
    }
    part_val[blockIdx.x] = bv;
    part_idx[blockIdx.x] = bi;
    part_nan[blockIdx.x] = bn;
  }
}

__global__ void __launch_bounds__(kFoldThreads)
head_argmax_fold(const float* __restrict__ part_val,
                 const int* __restrict__ part_idx,
                 const int* __restrict__ part_nan, int n_parts, int V,
                 int* __restrict__ out_idx) {
  __shared__ float sv[kFoldThreads];
  __shared__ int si[kFoldThreads];
  __shared__ int sn[kFoldThreads];
  float bv = -INFINITY;
  int bi = INT_MAX, bn = 0;
  for (int i = threadIdx.x; i < n_parts; i += kFoldThreads) {
    bn |= part_nan[i];
    if (better(part_val[i], part_idx[i], bv, bi)) {
      bv = part_val[i];
      bi = part_idx[i];
    }
  }
  sv[threadIdx.x] = bv;
  si[threadIdx.x] = bi;
  sn[threadIdx.x] = bn;
  __syncthreads();
  for (int stride = kFoldThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int o = threadIdx.x + stride;
      sn[threadIdx.x] |= sn[o];
      if (better(sv[o], si[o], sv[threadIdx.x], si[threadIdx.x])) {
        sv[threadIdx.x] = sv[o];
        si[threadIdx.x] = si[o];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int i = si[0];
    out_idx[0] = (sn[0] || i >= V) ? V - 1 : i;
  }
}

}  // namespace

extern "C" int aha_head_argmax_parts(int V) {
  return (V + kRowsPerBlock - 1) / kRowsPerBlock;
}

// part_val f32, part_idx/part_nan int32: aha_head_argmax_parts(V) each.
extern "C" int aha_head_argmax(const void* h, const void* w, void* part_val,
                               void* part_idx, void* part_nan, void* out_idx,
                               int K, int V, void* stream) {
  if (K % 8 != 0 || K <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = aha_head_argmax_parts(V);
  const size_t smem = sizeof(float) * (size_t)K;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        head_argmax_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  head_argmax_partial<<<n_parts, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(part_val), static_cast<int*>(part_idx),
      static_cast<int*>(part_nan), K, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_argmax_fold<<<1, kFoldThreads, 0, st>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx),
      static_cast<const int*>(part_nan), n_parts, V,
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
