// One launch per decoder layer that streams all of the layer's weights: the
// study of scripts/exp_fused_layer.py on the card.
//
// Replaces scripts/exp_fused_layer.py:make_fused (body fused_layer_kernel):
// the weight stream of one Qwen3-0.6B layer at M = 8 rows, bf16 —
//   1. qkv = x . Wqkv (1024 x 4096), f32;
//   2. a = tanh(qkv[:, :2048]) in f32, the stand-in for attention;
//   3. o = a . Wo (2048 x 1024);
//   4. h = x . Wgu (1024 x 6144), f32;
//   5. act = SiLU(g) * u in f32 (g, u the halves of h);
//   6. down = act . Wdn (3072 x 1024);
// the (8, 1024) bf16 output accumulated in bf16 after each 1024-row chunk,
// in the order o chunk 0, o chunk 1, down chunks 0-2 (out = bf16(part0),
// then out = bf16(out + part_i)).  The TPU streams the four matrices through
// `nbuf` rotating VMEM stages by manual DMA inside one sequential kernel.
//
// Bound: bytes, 31.46 MB of weights a layer (BYTES_PER_LAYER of the
// script): 0.00939 ms at 3.35 TB/s, 0.263 ms for 28 layers, whose 881 MB
// stream from HBM (the L2 holds 50 MB).  126 M MACs a layer, twice that
// padded to the tensor cores' 16 rows, are ~0.0005 ms of their bf16 rate.
//
// Design: one cooperative launch, one 256-thread block per SM.
// - The layer is cut into units of 64 columns (128-byte row pieces): phase 1
//   the 10,240 columns of [Wqkv | Wgu] in four K quarters of 256 rows (640
//   units, they depend only on x); phase 2 the 1,024 columns of [Wo ; Wdn]
//   in 40 row tiles of 128 rows (640 units; eight row tiles a 1024-row
//   chunk).
//   Each block takes a contiguous range of 4-5 units of each phase, so every
//   block streams about as much and its phase-2 units share one or two row
//   tiles.
// - Each block walks its stages (TR rows x 64 columns of one unit) through
//   NBUF shared-memory slots with cp.async: NBUF - 1 stages are in flight
//   while one is multiplied, and the loads run on across units and across
//   the phases — phase 2's first weights are on their way during the grid
//   barrier.  TR (32, 64 or 128 rows: 4, 8 or 16 KB stages) and NBUF (2-4)
//   are template parameters: the H100 form of the script's chunk width and
//   nbuf sweep.
// - A stage is multiplied on the tensor cores: warp w takes the stage's
//   columns 8w..8w+7, B by ldmatrix.trans from the row-major tile, A the 8
//   activation rows (M padded to 16 in registers only) in
//   mma.sync.m16n8k16 with f32 accumulation, so a warp's accumulator is its
//   8 columns' whole sum over the unit's rows, stored as the unit's partial
//   (f32, in L2).  Phase 1's A is x itself (bf16); phase 2's activations are
//   f32, carried as a bf16 hi + lo pair in two products (error ~2^-17 of a
//   value).  (8 f32 FMAs a weight on the CUDA cores, the first design, bound
//   the kernel by issue at ~900 GB/s whatever NBUF was.)
// - One grid barrier (cooperative.cuh) between the phases.  A block stages
//   the 128 activation rows of each phase-2 row tile it meets from the
//   phase-1 partials (all loads issued before any is used): tanh of the
//   summed q columns, or SiLU(g) * u of the summed gate and up columns.
// - The last of a column tile's 40 phase-2 units to finish — an atomic
//   ticket it resets to 0 — folds the tile's partials (all 40 loads of an
//   output issued together): each chunk's eight
//   row tiles summed in order, then the five chunks in the TPU kernel's
//   order with a bf16 rounding after each.  Deterministic, whichever block
//   comes last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kM = 8;
constexpr int kH = 1024, kNqkv = 4096, kNo = 2048, kNi = 3072;
constexpr int kN1 = kNqkv + 2 * kNi;       // phase-1 columns, [qkv | gate | up]
constexpr int kK2 = kNo + kNi;             // phase-2 rows, [o ; down]
constexpr int kTC = 64;                    // columns of a unit
constexpr int kU1Rows = 256, kU2Rows = 128;
constexpr int kCT1 = kN1 / kTC;            // 160 column tiles
constexpr int kU1 = kCT1 * (kH / kU1Rows); // 640 units
constexpr int kCT2 = kH / kTC;             // 16 column tiles
constexpr int kRT2 = kK2 / kU2Rows;        // 40 row tiles
constexpr int kU2 = kCT2 * kRT2;           // 640 units
constexpr int kChunkTiles = kH / kU2Rows;  // 8 row tiles a 1024-row chunk
static_assert(kWarps * 8 == kTC, "a warp multiplies 8 of a unit's columns");

struct Args {
  const __nv_bfloat16 *x, *wqkv, *wo, *wgu, *wdn;
  const int* layer;
  float* p1;      // (4, 8, kN1): phase-1 partials by K quarter
  float* p2;      // (kRT2, 8, kH): phase-2 partials by row tile
  int* tickets;   // (kCT2,) zero before and after
  __nv_bfloat16* out;
  int L;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int TR>
struct Plan {
  static constexpr int kS1 = kU1Rows / TR, kS2 = kU2Rows / TR;   // stages a unit
  int li, first1, n1, first2, n2;     // this block's unit ranges
  __device__ Plan(int layer) : li(layer) {
    const int b = blockIdx.x, g = gridDim.x;
    first1 = b * kU1 / g;
    n1 = (b + 1) * kU1 / g - first1;
    first2 = b * kU2 / g;
    n2 = (b + 1) * kU2 / g - first2;
  }
  __device__ int stages() const { return n1 * kS1 + n2 * kS2; }
  __device__ bool phase2(int s) const { return s >= n1 * kS1; }
  // the unit of stage s and the stage's place in it
  __device__ int unit(int s) const {
    return phase2(s) ? first2 + (s - n1 * kS1) / kS2 : first1 + s / kS1;
  }
  __device__ int step(int s) const { return phase2(s) ? (s - n1 * kS1) % kS2 : s % kS1; }
  __device__ int last_step(int s) const { return phase2(s) ? kS2 - 1 : kS1 - 1; }
  // row 0 of stage s's tile, and the matrix's row length
  __device__ const __nv_bfloat16* tile(const Args& a, int s, int& ld) const {
    const int u = unit(s), r = step(s) * TR;
    if (!phase2(s)) {
      const int ct = u % kCT1, row = (u / kCT1) * kU1Rows + r, col = ct * kTC;
      if (col < kNqkv) {
        ld = kNqkv;
        return a.wqkv + ((size_t)li * kH + row) * kNqkv + col;
      }
      ld = 2 * kNi;
      return a.wgu + ((size_t)li * kH + row) * (2 * kNi) + (col - kNqkv);
    }
    const int ct = u % kCT2, row = (u / kCT2) * kU2Rows + r;
    ld = kH;
    if (row < kNo) return a.wo + ((size_t)li * kNo + row) * kH + ct * kTC;
    return a.wdn + ((size_t)li * kNi + row - kNo) * kH + ct * kTC;
  }
};

// shared-memory row strides (bf16): 8 elements of padding put the rows
// that one ldmatrix or one A-fragment load reads in different banks
constexpr int kLd = kTC + 8;              // a stage row
constexpr int kXLd = kH + 8;              // a row of x
constexpr int kALd = kU2Rows + 8;         // a row of a phase-2 row tile's activations

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16 x 8 f32) += a (16 x 16 bf16, rows 8-15 zero) . b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int TR, int NBUF>
__global__ void __launch_bounds__(kThreads, 1) fused_layer_stream_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // [kM][kXLd]: x
  __nv_bfloat16* ahi = xs + kM * kXLd;    // [kM][kALd]: a row tile's activations,
  __nv_bfloat16* alo = ahi + kM * kALd;   // split hi + lo (two bf16 carry f32)
  __nv_bfloat16* stage = alo + kM * kALd; // [NBUF][TR][kLd]
  __shared__ int s_last;

  int li = *a.layer;
  li = li < 0 ? 0 : (li >= a.L ? a.L - 1 : li);
  const Plan<TR> plan(li);
  const int ns = plan.stages();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // the mma fragment's row and pair

  auto issue = [&](int s) {
    if (s < ns) {
      int ld;
      const __nv_bfloat16* src = plan.tile(a, s, ld);
      __nv_bfloat16* dst = stage + (size_t)(s % NBUF) * TR * kLd;
#pragma unroll
      for (int j = 0; j < TR * kTC / 8 / kThreads; ++j) {
        const int i = threadIdx.x + j * kThreads, r = i / (kTC / 8), c = (i % (kTC / 8)) * 8;
        cp_async16(dst + r * kLd + c, src + (size_t)r * ld + c);
      }
    }
    cp_commit();       // an empty group past the end keeps the count uniform
  };

  for (int s = 0; s < NBUF; ++s) issue(s);
  {
    // x (kM, kH) bf16 into xs: every thread's 16-byte loads at once
    constexpr int kLoads = kM * kH / 8 / kThreads;
    uint4 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      v[j] = __ldg(reinterpret_cast<const uint4*>(a.x) + threadIdx.x + j * kThreads);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads, m = i / (kH / 8), k0 = (i % (kH / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + m * kXLd + k0) = v[j];
    }
  }

  float c[4] = {0.f, 0.f, 0.f, 0.f};      // rows g (c[0], c[1]) and g + 8 (the pad)
  bool barrier_done = false;
  int staged_rt = -1;                     // the phase-2 row tile in ahi / alo
  for (int s = 0; s < ns; ++s) {
    const bool p2 = plan.phase2(s);
    const int step = plan.step(s), u = plan.unit(s);
    if (p2 && !barrier_done) {
      __threadfence();
      aha_coop::grid_barrier();           // every phase-1 partial is written
      barrier_done = true;
    }
    if (p2 && u / kCT2 != staged_rt) {
      // the row tile's 128 activation rows from the phase-1 partials; a
      // tile is all o rows or all down rows
      staged_rt = u / kCT2;
      const int row0 = staged_rt * kU2Rows;
      constexpr int kPer = kU2Rows * kM / kThreads, kQ = kH / kU1Rows;
      float v[kPer];
      if (row0 < kNo) {
        float q[kPer][kQ];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = threadIdx.x + j * kThreads, m = i / kU2Rows, r = i % kU2Rows;
#pragma unroll
          for (int kq = 0; kq < kQ; ++kq)
            q[j][kq] = __ldcg(a.p1 + ((size_t)kq * kM + m) * kN1 + row0 + r);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float sum = 0.f;
#pragma unroll
          for (int kq = 0; kq < kQ; ++kq) sum += q[j][kq];
          v[j] = tanhf(sum);
        }
      } else {
        float gu[kPer][2][kQ];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = threadIdx.x + j * kThreads, m = i / kU2Rows, r = i % kU2Rows;
          const int col = kNqkv + row0 - kNo + r;
#pragma unroll
          for (int kq = 0; kq < kQ; ++kq) {
            gu[j][0][kq] = __ldcg(a.p1 + ((size_t)kq * kM + m) * kN1 + col);
            gu[j][1][kq] = __ldcg(a.p1 + ((size_t)kq * kM + m) * kN1 + col + kNi);
          }
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float gt = 0.f, up = 0.f;
#pragma unroll
          for (int kq = 0; kq < kQ; ++kq) {
            gt += gu[j][0][kq];
            up += gu[j][1][kq];
          }
          v[j] = gt * (1.f / (1.f + expf(-gt))) * up;
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = threadIdx.x + j * kThreads, m = i / kU2Rows, r = i % kU2Rows;
        const __nv_bfloat16 hi = __float2bfloat16_rn(v[j]);
        ahi[m * kALd + r] = hi;
        alo[m * kALd + r] = __float2bfloat16_rn(v[j] - __bfloat162float(hi));
      }
    }
    if (step == 0) c[0] = c[1] = c[2] = c[3] = 0.f;
    cp_wait<NBUF - 1>();
    __syncthreads();                       // stage s landed; activations staged

    // warp w multiplies the stage's 8 columns 8w..8w+7: per 32 rows one
    // ldmatrix (two k steps of B) and one mma per k step (two in phase 2:
    // the activations' hi and lo halves)
    const __nv_bfloat16* st = stage + (size_t)(s % NBUF) * TR * kLd + 8 * warp;
    // the row of the activations that stage row 0 meets
    const __nv_bfloat16* arow = p2 ? ahi + g * kALd + step * TR
                                   : xs + g * kXLd + (u / kCT1) * kU1Rows + step * TR;
#pragma unroll
    for (int k0 = 0; k0 < TR; k0 += 32) {
      unsigned b[4];
      ldsm_x4_trans(b, st + (k0 + lane) * kLd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k0 + 16 * h + 2 * t;
        mma_bf16(c, ld32(arow + kk), ld32(arow + kk + 8), b[2 * h], b[2 * h + 1]);
        if (p2) {
          const __nv_bfloat16* lo = arow + (alo - ahi);
          mma_bf16(c, ld32(lo + kk), ld32(lo + kk + 8), b[2 * h], b[2 * h + 1]);
        }
      }
    }

    if (step == plan.last_step(s)) {
      // c[0], c[1]: row g, columns 8w + 2t, 8w + 2t + 1 of the unit's 64
      const float2 v = make_float2(c[0], c[1]);
      if (!p2) {
        __stcg(reinterpret_cast<float2*>(a.p1 + ((size_t)(u / kCT1) * kM + g) * kN1 +
                                         (u % kCT1) * kTC + 8 * warp + 2 * t), v);
      } else {
        __stcg(reinterpret_cast<float2*>(a.p2 + ((size_t)(u / kCT2) * kM + g) * kH +
                                         (u % kCT2) * kTC + 8 * warp + 2 * t), v);
        // the last of the column tile's row tiles folds the tile
        __threadfence();
        __syncthreads();
        const int ct = u % kCT2;
        if (threadIdx.x == 0) {
          const int ticket = atomicAdd(a.tickets + ct, 1);
          s_last = ticket == kRT2 - 1;
          if (s_last) a.tickets[ct] = 0;   // ready for the next launch
        }
        __syncthreads();
        if (s_last) {
          __threadfence();
          static_assert(kM * kTC % kThreads == 0, "whole outputs a thread");
#pragma unroll
          for (int i0 = 0; i0 < kM * kTC; i0 += kThreads) {
            const int i = i0 + threadIdx.x, m = i / kTC, col = ct * kTC + i % kTC;
            float pv[kRT2];                 // all 40 partials in flight at once
#pragma unroll
            for (int r = 0; r < kRT2; ++r)
              pv[r] = __ldcg(a.p2 + ((size_t)r * kM + m) * kH + col);
            __nv_bfloat16 o = __float2bfloat16_rn(0.f);
#pragma unroll
            for (int ch = 0; ch < kK2 / kH; ++ch) {
              float part = 0.f;
#pragma unroll
              for (int j = 0; j < kChunkTiles; ++j) part += pv[ch * kChunkTiles + j];
              o = __float2bfloat16_rn(ch == 0 ? part : __bfloat162float(o) + part);
            }
            a.out[(size_t)m * kH + col] = o;
          }
        }
      }
    }
    __syncthreads();                       // slot s % NBUF and the activations free
    issue(s + NBUF);
  }
  if (!barrier_done) aha_coop::grid_barrier();   // a block with no phase-2 unit
}

template <int TR, int NBUF>
int launch(const Args& a, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (size_t)(kM * kXLd + 2 * kM * kALd + NBUF * TR * kLd) * sizeof(__nv_bfloat16);
  return aha_coop::launch(fused_layer_stream_kernel<TR, NBUF>, a, sms, kThreads, smem, st);
}

}  // namespace

// x (8, 1024) bf16; wqkv (L, 1024, 4096), wo (L, 2048, 1024), wgu (L, 1024,
// 6144), wdn (L, 3072, 1024) bf16 row-major; layer an int32 on the device;
// p1 (4, 8, 10240) and p2 (40, 8, 1024) f32 scratch; tickets (16,) int32,
// zero before the launch and left zero; out (8, 1024) bf16.
// tile (TR) in {32, 64, 128}, nbuf in {2, 3, 4}.
extern "C" int aha_study_fused_layer(const void* x, const void* wqkv, const void* wo,
                                     const void* wgu, const void* wdn, const void* layer,
                                     void* p1, void* p2, void* tickets, void* out, int L,
                                     int tile, int nbuf, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wqkv),
               static_cast<const __nv_bfloat16*>(wo), static_cast<const __nv_bfloat16*>(wgu),
               static_cast<const __nv_bfloat16*>(wdn), static_cast<const int*>(layer),
               static_cast<float*>(p1), static_cast<float*>(p2), static_cast<int*>(tickets),
               static_cast<__nv_bfloat16*>(out), L};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile * 10 + nbuf) {
    case 1282: return launch<128, 2>(a, st);
    case 1283: return launch<128, 3>(a, st);
    case 1284: return launch<128, 4>(a, st);
    case 322: return launch<32, 2>(a, st);
    case 323: return launch<32, 3>(a, st);
    case 324: return launch<32, 4>(a, st);
    case 642: return launch<64, 2>(a, st);
    case 643: return launch<64, 3>(a, st);
    case 644: return launch<64, 4>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
