// Blockwise online-softmax attention for prefill, causal or not, GQA.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_attention (Pallas body
// _flash_kernel).
//
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16, addressed through strides
//   (the channel axis must be contiguous; no transposes) → o (B, Sq, Hq, D).
//   q-head h reads kv-head h / (Hq / Hkv).  Sq, Skv multiples of 64;
//   D in {64, 128}.  Causal: key j is visible to query i iff j <= i.
//
// Bound: tensor-core FLOPs at S >= 2048 — 4 * Sq * Skv * D * Hq, halved
// when causal.  Design: one block of 4 warps per (64-row q tile, q-head,
// batch row); each warp owns 16 query rows and keeps its Q fragments and
// its f32 output accumulator in registers.  The block walks 64-row K/V
// tiles through shared memory (rows padded by 16 B so the fragment reads
// are bank-conflict free), computes S = Q K^T and O += P V with
// mma.sync.m16n8k16 bf16 → f32, and runs the online softmax on the S
// fragments in registers — the (Sq, Skv) scores never leave the SM.  K/V
// tiles wholly above the diagonal are not visited.  wgmma/TMA and
// multi-stage loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPad = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(const __nv_bfloat16& lo,
                                              const __nv_bfloat16& hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, Strides st, int Skv, int G,
                     int causal, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockK][D + kPad];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int row0 = qt * kBlockQ + warp * 16 + g;  // rows row0, row0 + 8

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + (h / G) * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + (h / G) * st.vh;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = ld32(qp + row0 * st.qs + c);
    qa[kk][1] = ld32(qp + (row0 + 8) * st.qs + c);
    qa[kk][2] = ld32(qp + row0 * st.qs + c + 8);
    qa[kk][3] = ld32(qp + (row0 + 8) * st.qs + c + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int n_tiles = Skv / kBlockK;
  if (causal) n_tiles = min(n_tiles, (qt * kBlockQ + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBlockK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const long long kr = (long long)(kt * kBlockK + r);
      *reinterpret_cast<uint4*>(&Ks[r][c]) =
          *reinterpret_cast<const uint4*>(kp + kr * st.ks + c);
      *reinterpret_cast<uint4*>(&Vs[r][c]) =
          *reinterpret_cast<const uint4*>(vp + kr * st.vs + c);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[n], qa[kk], ld32(&Ks[n * 8 + g][kk * 16 + t * 2]),
                 ld32(&Ks[n * 8 + g][kk * 16 + 8 + t * 2]));
    }

    // scale (log2 domain), causal mask, running max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + (j >= 2 ? 8 : 0);
        const int key = kt * kBlockK + n * 8 + t * 2 + (j & 1);
        float x = s[n][j] * scale_log2;
        if (causal && key > row) x = -INFINITY;
        s[n][j] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 is visible to every row, so after tile 0 the max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;   // per-thread partial row sums; reduced at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // O += P V: the S accumulator fragments of two adjacent key n-tiles are
    // exactly the A fragment of a 16-key step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + t * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = n * 8 + g;
        mma_bf16(acc[n], pa, pack_pair(Vs[key][d], Vs[key + 1][d]),
                 pack_pair(Vs[key + 8][d], Vs[key + 9][d]));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(op + row0 * st.os + c) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(op + (row0 + 8) * st.os + c) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, o in order.
extern "C" int aha_flash_prefill(const void* q, const void* k, const void* v,
                                 void* o, long long qb, long long qs,
                                 long long qh, long long kb, long long ks,
                                 long long kh, long long vb, long long vs,
                                 long long vh, long long ob, long long os,
                                 long long oh, int B, int Sq, int Skv, int Hq,
                                 int Hkv, int D, int causal, float scale,
                                 void* stream) {
  if (Sq % kBlockQ != 0 || Skv % kBlockK != 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const dim3 grid(Sq / kBlockQ, Hq, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  switch (D) {
    case 64:
      flash_prefill_kernel<64><<<grid, kThreads, 0, s>>>(
          qq, kk, vv, oo, st, Skv, Hq / Hkv, causal, scale_log2);
      break;
    case 128:
      flash_prefill_kernel<128><<<grid, kThreads, 0, s>>>(
          qq, kk, vv, oo, st, Skv, Hq / Hkv, causal, scale_log2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
