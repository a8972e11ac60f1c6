// One-token GQA decode attention over the int8 KV cache.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_decode_at_layer_q8 (Pallas
// bodies _decode_stacked_q8_kernel and _decode_stacked_q8_mxu_kernel) and
// flash_decode_at_layer_q8_batched (_decode_stacked_q8_batched_kernel and
// its _mxu twin): a (B,) length vector covers the per-slot and the batched
// case, so one kernel serves both wrappers.
//
//   q        (B, 1, Hq, D) bf16, contiguous
//   k/v      (L, B, S, Hkv*D) int8, contiguous — core/cache.py's int8 rows
//   ks/vs    (L, B, S, Hkv) f32: one scale per (row, kv-head)
//   layer, valid_len: int32 on the device; rows [0, valid_len) are live.
//
// Bound: HBM bytes, valid_len * Hkv * 2 * (D + 4) B per layer per step —
// half of the bf16 cache's.  Design: the split-KV grid of
// decode_attention.cu, one 128-thread block per (split of <= 64 rows,
// kv-head, slot), then the shared combine pass (decode_combine.cuh).  A
// split past its slot's length writes an empty partial and exits.  Inside a
// block, three phases:
//   1. scores: each K row of the split is read once with 16-byte loads (16
//      channels per lane, D/16 lanes per row) and scores all G query heads
//      of the group; its scale is read once per (row, head) and folds into
//      the score, s = (q . k_i8) * scale * ks[row], not into the K tile;
//   2. softmax over the split's rows in shared memory, one warp per query
//      head: m = max s, p = exp(s - m), l = sum p, and the V row scales
//      fold into the probabilities, pw = p * vs[row];
//   3. p.V: each V row read once with 16-byte loads, accumulated per lane,
//      summed across the block.
// Variants (`mxu`, the JAX name):
//   - cast (0): q in f32 from bf16, int8 channels converted to float,
//     f32 accumulation;
//   - all-int8 (1), the numerics of _decode_stacked_q8_mxu_kernel: q
//     quantized per query row (q_s = max|q| / 127, round half to even, clip
//     +-127); scores as int8 x int8 dots in int32 (__dp4a over 4 packed
//     channels), s = s32 * (q_s * scale) * ks; pw requantized per query row
//     over the rows of one split (p_s = max(max pw, 1e-20) / 127); p.V as an
//     int32 multiply-accumulate scaled back by p_s.  The TPU kernel
//     requantizes over its block_k rows, this one over one split's rows
//     (<= 64, DECODE_ROWS_PER_SPLIT in ops/flash_attention.py).  Its
//     block-diagonal q only lets one MXU dot serve every head; here each
//     head's dot is its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_combine.cuh"

namespace {

constexpr int kQ8Warps = 4;
constexpr int kQ8MaxRows = 64;   // rows per split at most

// signed byte j of a packed word, as float
__device__ __forceinline__ float i8_at(int w, int j) {
  return static_cast<float>((w << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ int i8_word(int w, int j) {
  return (w << (24 - 8 * j)) >> 24;
}

template <int D, int G, bool MXU>
__global__ void __launch_bounds__(kQ8Warps * 32)
decode_q8_partial_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ layer,
                         const int* __restrict__ valid_len, int vl_stride,
                         float* __restrict__ part_m, float* __restrict__ part_l,
                         float* __restrict__ part_acc, int B, int Hq, int Hkv,
                         int L, int S, int rows_per_split, float scale) {
  constexpr int kLanesPerRow = D / 16;               // 16 int8 per lane
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kSub = kQ8Warps * kRowsPerWarp;      // rows in flight
  __shared__ float sm_s[G][kQ8MaxRows];   // scores, then pw = p * vs
  __shared__ int sm_pq[G][kQ8MaxRows];    // all-int8: requantized pw
  __shared__ float sm_m[G], sm_l[G], sm_ps[G];
  __shared__ float sm_acc[kQ8Warps][G][D];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub_in_warp = lane / kLanesPerRow;
  const int chunk = lane % kLanesPerRow;

  int li = *layer;
  li = li < 0 ? 0 : (li >= L ? L - 1 : li);
  int valid = valid_len[b * vl_stride];
  valid = valid < 0 ? 0 : (valid > S ? S : valid);
  const int start = split * rows_per_split;
  const int end = min(start + rows_per_split, valid);
  const size_t hq0 = (size_t)b * Hq + (size_t)h * G;

  if (end <= start) {    // block-uniform: an empty partial
    for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
      const size_t row = (hq0 + idx / D) * nsplit + split;
      part_acc[row * D + idx % D] = 0.f;
      if (idx % D == 0) {
        part_m[row] = kNegInf;
        part_l[row] = 0.f;
      }
    }
    return;
  }

  // this lane's 16 channels of each query head of the group
  float qf[G][16];
  int qpack[G][4];
  float q_s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4* src = reinterpret_cast<const uint4*>(
        q + (hq0 + g) * D + chunk * 16);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 u = src[half];
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(p2[i]);
        qf[g][half * 8 + 2 * i] = x.x;
        qf[g][half * 8 + 2 * i + 1] = x.y;
      }
    }
    if (MXU) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(qf[g][i]));
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      q_s[g] = fmaxf(amax, 1e-20f) / 127.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int w = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float r = fminf(fmaxf(rintf(qf[g][4 * j + c] / q_s[g]), -127.f),
                                127.f);
          w |= (static_cast<int>(r) & 0xff) << (8 * c);
        }
        qpack[g][j] = w;
      }
    }
  }

  const size_t HD = (size_t)Hkv * D;
  const size_t kv_base = (((size_t)li * B + b) * S) * HD + (size_t)h * D + chunk * 16;
  const size_t sc_base = (((size_t)li * B + b) * S) * Hkv + h;

  // 1. scores.  The loop bound is warp-uniform (the sub-warps of a warp
  // step together), so the shuffles never run under divergence.
  for (int r0 = start + warp * kRowsPerWarp; r0 < end; r0 += kSub) {
    const int r = r0 + sub_in_warp;
    const bool live = r < end;
    const int4 kr = live ? *reinterpret_cast<const int4*>(k + kv_base + (size_t)r * HD)
                         : make_int4(0, 0, 0, 0);
    const float ksc = live ? ks[sc_base + (size_t)r * Hkv] : 0.f;
    const int kw[4] = {kr.x, kr.y, kr.z, kr.w};
    float kf[16];
    if (!MXU) {
#pragma unroll
      for (int i = 0; i < 16; ++i) kf[i] = i8_at(kw[i / 4], i % 4);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s;
      if (MXU) {
        int acc = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc = __dp4a(kw[j], qpack[g][j], acc);
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        s = static_cast<float>(acc) * (q_s[g] * scale) * ksc;
      } else {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc = fmaf(qf[g][i], kf[i], acc);
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        s = acc * scale * ksc;
      }
      if (live && chunk == 0) sm_s[g][r - start] = s;
    }
  }
  __syncthreads();

  // 2. softmax over the split's rows, one warp per query head
  const int n = end - start;
  for (int g = warp; g < G; g += kQ8Warps) {
    float m = kNegInf;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sm_s[g][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f, pmax = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sm_s[g][i] - m);
      const float pw = p * vs[sc_base + (size_t)(start + i) * Hkv];
      l += p;
      pmax = fmaxf(pmax, pw);
      sm_s[g][i] = pw;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
      pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    }
    const float p_s = fmaxf(pmax, 1e-20f) / 127.f;
    if (MXU) {
      for (int i = lane; i < n; i += 32)
        sm_pq[g][i] = static_cast<int>(
            fminf(fmaxf(rintf(sm_s[g][i] / p_s), -127.f), 127.f));
    }
    if (lane == 0) {
      sm_m[g] = m;
      sm_l[g] = l;
      sm_ps[g] = p_s;
    }
  }
  __syncthreads();

  // 3. p.V, per lane over its rows, then across the sub-warps of each warp
  float accf[G][16];
  int acci[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      accf[g][i] = 0.f;
      acci[g][i] = 0;
    }
  for (int r0 = start + warp * kRowsPerWarp; r0 < end; r0 += kSub) {
    const int r = r0 + sub_in_warp;
    if (r < end) {
      const int4 vr = *reinterpret_cast<const int4*>(v + kv_base + (size_t)r * HD);
      const int vw[4] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (MXU) {
          const int pq = sm_pq[g][r - start];
#pragma unroll
          for (int i = 0; i < 16; ++i) acci[g][i] += pq * i8_word(vw[i / 4], i % 4);
        } else {
          const float pw = sm_s[g][r - start];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            accf[g][i] = fmaf(pw, i8_at(vw[i / 4], i % 4), accf[g][i]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // integer sums are exact; a split's |sum| <= 64 * 127 * 127 < 2^24,
      // so the float partials below are exact too
      float a = MXU ? static_cast<float>(acci[g][i]) : accf[g][i];
#pragma unroll
      for (int off = kLanesPerRow; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (sub_in_warp == 0) sm_acc[warp][g][chunk * 16 + i] = a;
    }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kQ8Warps; ++w) A += sm_acc[w][g][d];
    if (MXU) A *= sm_ps[g];
    const size_t row = (hq0 + g) * nsplit + split;
    part_acc[row * D + d] = A;
    if (d == 0) {
      part_m[row] = sm_m[g];
      part_l[row] = sm_l[g];
    }
  }
}

struct Q8Args {
  const void *q, *k, *v, *ks, *vs, *layer, *valid_len;
  int vl_stride;
  void *part_m, *part_l, *part_acc;
  int B, Hq, Hkv, L, S, rows;
  float scale;
};

template <int D, int G, bool MXU>
void launch_q8(dim3 grid, cudaStream_t st, const Q8Args& a) {
  decode_q8_partial_kernel<D, G, MXU><<<grid, kQ8Warps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const int8_t*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.valid_len), a.vl_stride,
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
      static_cast<float*>(a.part_acc), a.B, a.Hq, a.Hkv, a.L, a.S, a.rows,
      a.scale);
}

template <int D, bool MXU>
bool launch_q8_for_group(int G, dim3 grid, cudaStream_t st, const Q8Args& a) {
  switch (G) {
    case 1: launch_q8<D, 1, MXU>(grid, st, a); return true;
    case 2: launch_q8<D, 2, MXU>(grid, st, a); return true;
    case 3: launch_q8<D, 3, MXU>(grid, st, a); return true;
    case 4: launch_q8<D, 4, MXU>(grid, st, a); return true;
    case 5: launch_q8<D, 5, MXU>(grid, st, a); return true;
    case 6: launch_q8<D, 6, MXU>(grid, st, a); return true;
    case 7: launch_q8<D, 7, MXU>(grid, st, a); return true;
    case 8: launch_q8<D, 8, MXU>(grid, st, a); return true;
    default: return false;
  }
}

template <int D>
bool launch_q8_for_variant(int G, int mxu, dim3 grid, cudaStream_t st,
                           const Q8Args& a) {
  return mxu ? launch_q8_for_group<D, true>(G, grid, st, a)
             : launch_q8_for_group<D, false>(G, grid, st, a);
}

}  // namespace

// part_m/part_l: (B, Hq, nsplit) f32 scratch; part_acc: (B, Hq, nsplit, D).
// Supported: D in {64, 128}, G = Hq / Hkv from 1 to 8, at most 64 rows
// per split (nsplit >= ceil(S / 64)).
extern "C" int aha_decode_attention_q8(const void* q, const void* k,
                                       const void* v, const void* k_scale,
                                       const void* v_scale, const void* layer,
                                       const void* valid_len, int vl_stride,
                                       void* part_m, void* part_l,
                                       void* part_acc, void* out, int B, int Hq,
                                       int Hkv, int D, int L, int S, int nsplit,
                                       float scale, int mxu, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (S + nsplit - 1) / nsplit;
  if (rows > kQ8MaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Q8Args a{q, k, v, k_scale, v_scale, layer, valid_len, vl_stride,
                 part_m, part_l, part_acc, B, Hq, Hkv, L, S, rows, scale};
  const dim3 grid(nsplit, Hkv, B);
  bool ok = false;
  switch (D) {
    case 64: ok = launch_q8_for_variant<64>(G, mxu, grid, st, a); break;
    case 128: ok = launch_q8_for_variant<128>(G, mxu, grid, st, a); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_decode_combine(part_m, part_l, part_acc, out, B, Hq, D, nsplit,
                               st);
}
