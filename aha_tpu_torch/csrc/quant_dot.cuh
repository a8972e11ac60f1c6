// Device pieces shared by the kernels over the GGUF grids (quant_matmul.cu,
// quant_swiglu.cu, head_argmax.cu): activation quantization into shared
// memory, and one warp's dot of a quantized weight column with the staged
// rows.
//
// The port's grid layout (ops/quant_matmul.py): column-major rows — column n
// holds its Kp K values contiguously, int8 (q8) or two unsigned nibbles per
// byte with the even k in the low nibble (q4) — and f32 scales (and q4 mins)
// per (column, 128-row group).
//
// Activations are quantized exactly as the plain version (and the Pallas
// _quant_acts) does it: sx = max|x_g| / 127, xq = round-half-even(x / sx)
// with a true division (sx = 0 read as 1), the f32 group sum for the q4 min
// term.  nvcc's default -prec-div keeps `/` IEEE-exact; never build these
// with --use_fast_math, and never multiply by a reciprocal: either flips
// values that sit at .5 boundaries by a whole quantization step.  A NaN in a
// group makes its sx NaN, so the dot is NaN as the plain version's is.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aha_quant {

constexpr int kGroup = 128;

__device__ __forceinline__ float load_act(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// f32 activations come from a workspace other blocks wrote in this launch:
// read them through L2.
__device__ __forceinline__ float load_act(const float* p) { return __ldcg(p); }

// Quantize `rows` rows of activations, load(m, k) for k < K and zero past K
// up to Kp, into shared memory: xq[m·Kp + k] int8, sx[m·G + g], xsum[m·G +
// g].  One warp per (row, group) item, four values per lane.  Ends with the
// block synchronised.
template <typename Load>
__device__ void quantize_rows_by(Load load, int K, int Kp, int rows, int8_t* xq,
                                 float* sx, float* xsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int G = Kp / kGroup;
  for (int item = warp; item < rows * G; item += nwarps) {
    const int m = item / G, g = item % G;
    const int k0 = g * kGroup + lane * 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = k0 + j < K ? load(m, k0 + j) : 0.f;
    float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
    float sum = (v[0] + v[1]) + (v[2] + v[3]);
    const bool nan = isnan(v[0]) || isnan(v[1]) || isnan(v[2]) || isnan(v[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    const float s = __any_sync(0xffffffffu, nan) ? NAN : amax / 127.0f;
    const float d = s == 0.f ? 1.f : s;
    char4 q;
    q.x = (signed char)__float2int_rn(v[0] / d);
    q.y = (signed char)__float2int_rn(v[1] / d);
    q.z = (signed char)__float2int_rn(v[2] / d);
    q.w = (signed char)__float2int_rn(v[3] / d);
    *reinterpret_cast<char4*>(xq + (size_t)m * Kp + k0) = q;
    if (lane == 0) {
      sx[m * G + g] = s;
      xsum[m * G + g] = sum;
    }
  }
  __syncthreads();
}

// quantize_rows_by over the rows of x (row stride ldx).
template <typename T>
__device__ void quantize_rows(const T* __restrict__ x, int ldx, int K, int Kp,
                              int rows, int8_t* xq, float* sx, float* xsum) {
  quantize_rows_by([=](int m, int k) { return load_act(x + (size_t)m * ldx + k); }, K,
                   Kp, rows, xq, sx, xsum);
}

// Four packed bytes of nibbles (k0..k7, even k low) → the two int8x4 words of
// k0..k3 and k4..k7 in K order.
__device__ __forceinline__ void unpack_nibbles(uint32_t w, int& a, int& b) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  a = (int)__byte_perm(lo, hi, 0x5140);
  b = (int)__byte_perm(lo, hi, 0x7362);
}

// One warp: acc[m] = Σ_g (Σ_k xq[m, k] · w[k]) · (sx[m, g] · s[g])
//                    (+ xsum[m, g] · b[g] on the 4-bit grid)
// over the staged rows m < rows, for the column whose Kp (q8) or Kp/2 (q4)
// bytes start at `col`.  Lanes sweep the column in 512-byte steps, 16 bytes
// each (a coalesced read); the 8 (q8) or 4 (q4) lanes of a group add their
// int32 partials with shuffles, the group's first lane applies the scales,
// and the warp reduces the f32 partials.  Every lane returns the sums.
template <int R, bool Q4>
__device__ __forceinline__ void warp_column_dot(
    const uint8_t* __restrict__ col, const float* __restrict__ s,
    const float* __restrict__ b, const int8_t* xq, const float* sx,
    const float* xsum, int Kp, int rows, float (&acc)[R]) {
  constexpr int kLanesPerGroup = Q4 ? 4 : 8;
  const int lane = threadIdx.x & 31;
  const int G = Kp / kGroup;
  const int col_bytes = Q4 ? Kp / 2 : Kp;
#pragma unroll
  for (int m = 0; m < R; ++m) acc[m] = 0.f;
  for (int base = 0; base < col_bytes; base += 512) {
    const int off = base + lane * 16;
    const bool live = off < col_bytes;
    const int k0 = Q4 ? off * 2 : off;
    int isum[R];
#pragma unroll
    for (int m = 0; m < R; ++m) isum[m] = 0;
    if (live) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(col + off));
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m >= rows) break;
        const int8_t* xr = xq + (size_t)m * Kp + k0;
        const uint4 xa = *reinterpret_cast<const uint4*>(xr);
        int t = 0;
        if (Q4) {
          const uint4 xb = *reinterpret_cast<const uint4*>(xr + 16);
          int a0, a1;
          unpack_nibbles(w.x, a0, a1);
          t = __dp4a(a0, (int)xa.x, t);
          t = __dp4a(a1, (int)xa.y, t);
          unpack_nibbles(w.y, a0, a1);
          t = __dp4a(a0, (int)xa.z, t);
          t = __dp4a(a1, (int)xa.w, t);
          unpack_nibbles(w.z, a0, a1);
          t = __dp4a(a0, (int)xb.x, t);
          t = __dp4a(a1, (int)xb.y, t);
          unpack_nibbles(w.w, a0, a1);
          t = __dp4a(a0, (int)xb.z, t);
          t = __dp4a(a1, (int)xb.w, t);
        } else {
          t = __dp4a((int)w.x, (int)xa.x, t);
          t = __dp4a((int)w.y, (int)xa.y, t);
          t = __dp4a((int)w.z, (int)xa.z, t);
          t = __dp4a((int)w.w, (int)xa.w, t);
        }
        isum[m] = t;
      }
    }
#pragma unroll
    for (int off2 = 1; off2 < kLanesPerGroup; off2 <<= 1)
#pragma unroll
      for (int m = 0; m < R; ++m) isum[m] += __shfl_xor_sync(0xffffffffu, isum[m], off2);
    if (live && lane % kLanesPerGroup == 0) {
      const int g = k0 / kGroup;
      const float sg = s[g];
      const float bg = Q4 ? b[g] : 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m >= rows) break;
        float y = (float)isum[m] * (sx[m * G + g] * sg);
        if (Q4) y = fmaf(xsum[m * G + g], bg, y);
        acc[m] += y;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off2);
}

// Shared memory for `rows` staged rows of Kp: int8 values, then sx and xsum.
__host__ __device__ inline size_t staged_bytes(int rows, int Kp) {
  return (size_t)rows * Kp + 2 * sizeof(float) * (size_t)rows * (Kp / kGroup);
}

struct Staged {
  int8_t* xq;
  float* sx;
  float* xsum;
};

__device__ __forceinline__ Staged carve(unsigned char* smem, int rows, int Kp) {
  Staged st;
  st.xq = reinterpret_cast<int8_t*>(smem);
  st.sx = reinterpret_cast<float*>(smem + (size_t)rows * Kp);
  st.xsum = st.sx + rows * (Kp / kGroup);
  return st;
}

}  // namespace aha_quant
