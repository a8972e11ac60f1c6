// Segment-masked flash attention: row i attends row j iff seg[i] == seg[j]
// >= 0.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_attention_segmented (Pallas
// body _flash_seg_kernel) — the windowed and full-attention blocks of the
// Qwen2.5-VL vision tower.
//
//   q (B, S, Hq, D), k/v (B, S, Hkv, D) bf16, addressed through strides (the
//   channel axis contiguous; a strided view such as one third of a fused
//   qkv product is read in place) → o (B, S, Hq, D); seg (S,) int32 shared
//   by the batch; q-head h reads kv-head h / (Hq / Hkv).  Any S; D in
//   {64, 80, 128}.  Rows with seg < 0 are padding: they match no row and
//   their output is 0 (a patch bucket's tail, which no caller reads).
//
// Bound: the window blocks by bytes (q, k, v read once, o written once);
// the full-attention blocks by tensor-core FLOPs, 4 * Hq * D * (pairs with
// equal seg).  Design: one block of 4 warps per (64-row q tile, q-head,
// batch row), the flash_prefill.cu tile: each warp owns 16 query rows, keeps
// its Q fragments and f32 accumulator in registers, and walks 64-row K/V
// tiles through shared memory with mma.sync.m16n8k16 bf16 → f32 and the
// online softmax on the score fragments.  The TPU kernel skips k blocks by
// scalar-prefetched per-block seg ranges; here the block finds its own
// tiles: it reduces its q rows' range of non-negative segs, then every
// thread tests a k tile's 64 seg values against it and the passing tiles
// are listed, in order, in shared memory.  Only listed tiles are loaded and
// computed: 2-3 per q tile in a window block, none in a tile of pad rows
// (the TPU kernel lets pad rows attend each other, which in a bucket's
// 1,500-row tail is most of a window block's work).  Masked scores are
// -inf and the softmax base of a row with no match yet is 0, so a masked
// entry adds exactly 0 whatever order the tiles come in (the TPU kernel's
// finite NEG_INF adds exp(0) and wipes it later).
// wgmma/TMA and multi-stage loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPad = 8;
constexpr int kThreads = 128;
constexpr int kMaxTiles = 1024;   // S <= 65536

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

// Does k tile `kt` hold a seg inside [lo, hi]?  An empty range has
// lo > hi.
__device__ __forceinline__ bool tile_overlaps(const int* __restrict__ seg,
                                              int S, int kt, int lo,
                                              int hi) {
  const int j0 = kt * kBlockK;
  const int n = min(kBlockK, S - j0);
  bool hit = false;
  if (n == kBlockK) {       // seg is 16-byte aligned (the wrapper's check)
    const int4* p = reinterpret_cast<const int4*>(seg + j0);
#pragma unroll
    for (int i = 0; i < kBlockK / 4; ++i) {
      const int4 s = __ldg(p + i);
      const int v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hit |= v[e] >= lo && v[e] <= hi;
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int v = __ldg(seg + j0 + i);
      hit |= v >= lo && v <= hi;
    }
  }
  return hit;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
segment_flash_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ o,
                     Strides st, int S, int G, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockK][D + kPad];
  __shared__ int segq_s[kBlockQ];
  __shared__ int segk_s[kBlockK];
  __shared__ int range_s[2];          // lo, hi of the q rows' segs >= 0
  __shared__ int tiles_s[kMaxTiles];
  __shared__ int warp_n[kThreads / 32];
  __shared__ int n_tiles_s;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int row0 = qt * kBlockQ + warp * 16 + g;  // rows row0, row0 + 8

  // -- this tile's q segs and the range of its non-negative ones
  if (threadIdx.x == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
    n_tiles_s = 0;
  }
  __syncthreads();
  if (threadIdx.x < kBlockQ) {
    const int r = qt * kBlockQ + threadIdx.x;
    // a row past S matches nothing (keys past S carry INT_MIN)
    const int s = r < S ? seg[r] : INT_MAX;
    segq_s[threadIdx.x] = s;
    if (r < S && s >= 0) {
      atomicMin(&range_s[0], s);
      atomicMax(&range_s[1], s);
    }
  }
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];

  // -- list the k tiles that can match, in ascending order (none for a
  // tile of pad rows)
  const int nkt = lo <= hi ? (S + kBlockK - 1) / kBlockK : 0;
  for (int c = 0; c < nkt; c += kThreads) {
    const int kt = c + threadIdx.x;
    const bool hit = kt < nkt &&
                     tile_overlaps(seg, S, kt, lo, hi);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int base = n_tiles_s;
    for (int w = 0; w < warp; ++w) base += warp_n[w];
    if (hit) tiles_s[base + __popc(ballot & ((1u << lane) - 1u))] = kt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_n[w];
      n_tiles_s += total;
    }
    __syncthreads();
  }
  const int n_tiles = n_tiles_s;

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + (h / G) * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + (h / G) * st.vh;

  const bool in0 = row0 < S, in1 = row0 + 8 < S;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = in0 ? ld32(qp + row0 * st.qs + c) : 0u;
    qa[kk][1] = in1 ? ld32(qp + (row0 + 8) * st.qs + c) : 0u;
    qa[kk][2] = in0 ? ld32(qp + row0 * st.qs + c + 8) : 0u;
    qa[kk][3] = in1 ? ld32(qp + (row0 + 8) * st.qs + c + 8) : 0u;
  }
  const int sq0 = segq_s[warp * 16 + g], sq1 = segq_s[warp * 16 + g + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int kt = tiles_s[i];
    __syncthreads();   // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBlockK * D / 8; e += kThreads) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const long long kr = (long long)(kt * kBlockK + r);
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kr < S) {
        kv = *reinterpret_cast<const uint4*>(kp + kr * st.ks + c);
        vv = *reinterpret_cast<const uint4*>(vp + kr * st.vs + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r][c]) = vv;
    }
    if (threadIdx.x < kBlockK) {
      const int j = kt * kBlockK + threadIdx.x;
      segk_s[threadIdx.x] = j < S ? seg[j] : INT_MIN;
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

    // scale (log2 domain), segment mask (a pad key matches no row),
    // running max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sk = segk_s[n * 8 + t * 2 + (j & 1)];
        const bool keep = (j >= 2 ? sq1 : sq0) == sk && sk >= 0;
        s[n][j] = keep ? s[n][j] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with no match so far keeps m = -inf and takes base 0: every
    // masked entry then gives exp2(-inf) = 0 and alpha = 0 on zero sums,
    // and a row that never matches (a pad row) ends with acc = 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float b0 = mn0 == -INFINITY ? 0.f : mn0;
    const float b1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = exp2f(m0 - b0), a1 = exp2f(m1 - b1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - b0);
      s[n][1] = exp2f(s[n][1] - b0);
      s[n][2] = exp2f(s[n][2] - b1);
      s[n][3] = exp2f(s[n][3] - b1);
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
    if (in0)
      *reinterpret_cast<uint32_t*>(op + row0 * st.os + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (in1)
      *reinterpret_cast<uint32_t*>(op + (row0 + 8) * st.os + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
void launch(dim3 grid, cudaStream_t s, const void* q, const void* k,
            const void* v, const int* seg, void* o, const Strides& st, int S,
            int G, float scale_log2) {
  segment_flash_kernel<D><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg,
      static_cast<__nv_bfloat16*>(o), st, S, G, scale_log2);
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, o in order.
extern "C" int aha_segment_flash(const void* q, const void* k, const void* v,
                                 const void* seg, void* o, long long qb,
                                 long long qs, long long qh, long long kb,
                                 long long ks, long long kh, long long vb,
                                 long long vs, long long vh, long long ob,
                                 long long os, long long oh, int B, int S,
                                 int Hq, int Hkv, int D, float scale,
                                 void* stream) {
  if (S < 1 || (S + kBlockK - 1) / kBlockK > kMaxTiles || Hkv < 1 ||
      Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const int G = Hq / Hkv;
  switch (D) {
    case 64: launch<64>(grid, s, q, k, v, sg, o, st, S, G, scale_log2); break;
    case 80: launch<80>(grid, s, q, k, v, sg, o, st, S, G, scale_log2); break;
    case 128: launch<128>(grid, s, q, k, v, sg, o, st, S, G, scale_log2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
