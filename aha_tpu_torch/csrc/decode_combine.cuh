// Pass 2 of the split-KV decode kernels (decode_attention.cu,
// decode_attention_q8.cu): fold the per-split partials of each query head.
//
//   part_m/part_l (B, Hq, nsplit) f32: the split's score max and the sum of
//   exp(s - m) over its rows; part_acc (B, Hq, nsplit, D) f32: the split's
//   sum of exp(s - m) * v.  A split with no live rows has m = kNegInf,
//   l = 0, acc = 0, and weighs nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // finite, as the JAX kernels' NEG_INF

// one block per (query head, batch row), one thread per channel
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      __nv_bfloat16* __restrict__ out,
                                      int Hq, int D, int nsplit) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= D) return;
  const size_t row0 = ((size_t)b * Hq + hq) * nsplit;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[row0 + s]);
  float Lsum = 0.f, A = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = __expf(part_m[row0 + s] - M);
    Lsum += part_l[row0 + s] * w;
    A += part_acc[(row0 + s) * D + d] * w;
  }
  out[((size_t)b * Hq + hq) * D + d] = __float2bfloat16(A / fmaxf(Lsum, 1e-30f));
}

inline int launch_decode_combine(void* part_m, void* part_l, void* part_acc,
                                 void* out, int B, int Hq, int D, int nsplit,
                                 cudaStream_t st) {
  decode_combine_kernel<<<dim3(Hq, B), D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), Hq,
      D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
