// One-token GQA decode attention over the stacked flat KV cache.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_decode_at_layer_flat
// (Pallas body _decode_stacked_flat_kernel).
//
//   q   (B, 1, Hq, D) bf16, contiguous
//   k/v (L, B, S, Hkv*D) bf16, contiguous — the flat cache of core/cache.py
//   layer, valid_len: int32 on the device, read by the kernel itself, so a
//   decode step never syncs the host.  Rows [0, valid_len) are attended.
//
// Bound: HBM bytes, 2 * valid_len * Hkv * D * 2 B per layer per step; the
// arithmetic is ~1 FMA per byte.  Design: split-KV ("flash decoding").
// Pass 1 gives each (batch, kv-head, split of rows) its own block — the
// wrapper picks 64-row splits, so a 2048-row cache spreads over 256 blocks
// instead of the 8 one block per kv-head would give, each walking 8 serial
// row-iterations.  B > 1 is the continuous-batching step
// (flash_decode_at_layer_flat_batched): one grid z-row per slot, each with
// its own valid_len; a split past its slot's length exits at once.  Inside a block every row is read once with
// 16-byte loads by D/8 lanes, and all G = Hq/Hkv query heads of the group
// are scored from that one read.  Each sub-warp keeps its own running
// (max, sum, acc) in f32; the block merges them in shared memory and writes
// one partial per split.  Pass 2 folds the splits per query head.  Splits
// past valid_len exit after writing an empty partial.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_combine.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ layer,
                      const int* __restrict__ valid_len, int vl_stride,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int B, int Hq, int Hkv,
                      int L, int S, int rows_per_split, float scale) {
  constexpr int kLanesPerRow = D / 8;              // 16-byte chunk per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kSub = kWarps * kRowsPerWarp;      // rows in flight / block
  __shared__ float sm_m[kSub][G];
  __shared__ float sm_l[kSub][G];
  __shared__ float sm_acc[kSub][G][D];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub_in_warp = lane / kLanesPerRow;
  const int sub = warp * kRowsPerWarp + sub_in_warp;
  const int chunk = lane % kLanesPerRow;

  int li = *layer;
  li = li < 0 ? 0 : (li >= L ? L - 1 : li);
  int valid = valid_len[b * vl_stride];
  valid = valid < 0 ? 0 : (valid > S ? S : valid);
  const int start = split * rows_per_split;
  const int end = min(start + rows_per_split, valid);

  float qf[G][8];
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
    const uint4 u = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * Hq + (size_t)h * G + g) * D + chunk * 8);
    bf16x8_to_float(u, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }

  const size_t HD = (size_t)Hkv * D;
  const size_t base = (((size_t)li * B + b) * S) * HD + (size_t)h * D + chunk * 8;
  // the loop bound is warp-uniform (all sub-warps of a warp step together),
  // so the shuffles below never run under divergence
  for (int r0 = start + warp * kRowsPerWarp; r0 < end; r0 += kSub) {
    const int r = r0 + sub_in_warp;
    const bool live = r < end;
    float kf[8], vf[8];
    if (live) {
      bf16x8_to_float(*reinterpret_cast<const uint4*>(k + base + r * HD), kf);
      bf16x8_to_float(*reinterpret_cast<const uint4*>(v + base + r * HD), vf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s = fmaf(qf[g][i], kf[i], s);
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (live) {
        const float m_new = fmaxf(m[g], s);
        const float alpha = __expf(m[g] - m_new);
        const float p = __expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(acc[g][i], alpha, p * vf[i]);
        m[g] = m_new;
      }
    }
  }

  for (int g = 0; g < G; ++g) {
    if (chunk == 0) {
      sm_m[sub][g] = m[g];
      sm_l[sub][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[sub][g][chunk * 8 + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
    for (int s = 0; s < kSub; ++s) M = fmaxf(M, sm_m[s][g]);
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < kSub; ++s) {
      const float w = __expf(sm_m[s][g] - M);
      Lsum += sm_l[s][g] * w;
      A += sm_acc[s][g][d] * w;
    }
    const size_t row = ((size_t)b * Hq + (size_t)h * G + g) * nsplit + split;
    part_acc[row * D + d] = A;
    if (d == 0) {
      part_m[row] = M;
      part_l[row] = Lsum;
    }
  }
}

struct PartialArgs {
  const void *q, *k, *v, *layer, *valid_len;
  int vl_stride;
  void *part_m, *part_l, *part_acc;
  int B, Hq, Hkv, L, S, rows;
  float scale;
};

template <int D, int G>
void launch_partial(dim3 grid, cudaStream_t st, const PartialArgs& a) {
  decode_partial_kernel<D, G><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.valid_len), a.vl_stride,
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
      static_cast<float*>(a.part_acc), a.B, a.Hq, a.Hkv, a.L, a.S, a.rows,
      a.scale);
}

template <int D>
bool launch_for_group(int G, dim3 grid, cudaStream_t st, const PartialArgs& a) {
  switch (G) {
    case 1: launch_partial<D, 1>(grid, st, a); return true;
    case 2: launch_partial<D, 2>(grid, st, a); return true;
    case 4: launch_partial<D, 4>(grid, st, a); return true;
    case 8: launch_partial<D, 8>(grid, st, a); return true;
    default: return false;
  }
}

}  // namespace

extern "C" const char* aha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// part_m/part_l: (B, Hq, nsplit) f32 scratch; part_acc: (B, Hq, nsplit, D).
// Supported: D in {64, 128}, G = Hq / Hkv in {1, 2, 4, 8}.
extern "C" int aha_decode_attention(const void* q, const void* k, const void* v,
                                    const void* layer, const void* valid_len,
                                    int vl_stride, void* part_m, void* part_l,
                                    void* part_acc, void* out, int B, int Hq,
                                    int Hkv, int D, int L, int S, int nsplit,
                                    float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PartialArgs a{q, k, v, layer, valid_len, vl_stride, part_m, part_l,
                      part_acc, B, Hq, Hkv, L, S, (S + nsplit - 1) / nsplit,
                      scale};
  const dim3 grid(nsplit, Hkv, B);
  bool ok = false;
  switch (D) {
    case 64: ok = launch_for_group<64>(G, grid, st, a); break;
    case 128: ok = launch_for_group<128>(G, grid, st, a); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_decode_combine(part_m, part_l, part_acc, out, B, Hq, D, nsplit,
                               st);
}
