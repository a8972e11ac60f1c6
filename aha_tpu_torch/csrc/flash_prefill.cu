// Blockwise online-softmax attention for prefill, causal or not, GQA, on
// Hopper's warpgroup MMA, TMA and mbarriers.
//
// Replaces aha_tpu/ops/flash_attention.py:flash_attention (Pallas body
// _flash_kernel).
//
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16, addressed through strides
//   (the channel axis must be contiguous; no transposes) → o (B, Sq, Hq, D).
//   q-head h reads kv-head h / (Hq / Hkv), any whole group.  Sq, Skv
//   multiples of 64; D in {64, 128, 192, 256}; q/k/v bases and their batch,
//   sequence and head strides 16-byte aligned, as TMA needs.  Causal: key j
//   is visible to query i iff j <= i.
//
// Bound: tensor-core FLOPs at S >= 2048 — 4 * Sq * Skv * D * Hq, halved
// when causal.  Design (FlashAttention-3's shape, without its inter-warpgroup
// ping-pong):
//
// - one block of three warpgroups per (128-row q tile, q-head, batch row):
//   warpgroups 0 and 1 consume 64 rows each; warpgroup 2 is the producer,
//   whose one thread issues TMA copies (cp.async.bulk.tensor, tensor maps
//   encoded on the host through cudaGetDriverEntryPointByVersion, so no
//   libcuda link) of the Q tile once and of 128-row K and V tiles into a
//   3-stage ring, 128-byte swizzled, each completing on its own mbarrier
//   (past D 128, 64-row K and V tiles, so the wider accumulators still fit
//   the registers, and at D 256 a 2-stage ring, so the tiles fit the
//   shared memory);
//   consumers hand a stage back on an "empty" mbarrier.  setmaxnreg moves
//   registers from the producer to the consumers.
// - consumers: S = Q·Kᵀ by wgmma.m64n128k16 (n64 past D 128) with both
//   operands in shared memory (K-major), the online softmax on the S accumulators in registers
//   (exp2, scale folded in), O += P·V by wgmma with P from registers and V
//   from shared memory (MN-major); the (Sq, Skv) scores never leave the SM.
//   Each tile's S is issued together with the previous tile's P·V, and its
//   softmax runs while that P·V finishes (two P buffers in turn; the
//   operands pinned in registers, so no wgmma is serialized).
// - causal: K/V tiles above the diagonal are never loaded, the mask runs
//   only on the diagonal tile (and on a tile past Skv, whose rows TMA fills
//   with zeros); q tiles are scheduled heaviest first (the grid's slower
//   dimension walks them from the last), and the q-heads sharing a kv-head
//   are neighbours in launch order, so their K/V tiles meet in L2.
// The mbarrier, TMA and wgmma helpers are hopper_tma.cuh, shared with the
// segment-masked kernel (segment_flash.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

using namespace aha_hopper;

constexpr int kBlockQ = 128;
constexpr int kThreads = 384;

template <int D>
struct Layout {
  static constexpr int kBlockK = D <= 128 ? 128 : 64;   // K/V rows a tile
  static constexpr int kStages = D <= 192 ? 3 : 2;
  static constexpr int NH = D / 64;                 // 64-column boxes a row
  static constexpr int kQTile = NH * kBoxBytes;     // 128 rows
  static constexpr int kKVBox = kBlockK * 128;      // one box of a K or V tile
  static constexpr int kKVTile = NH * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  static constexpr int kBytes = kBar + 128 + 1024;  // barriers, alignment slack
};

// S (64 x N, f32) (+)= Q (64 x 16) · K (N x 16)ᵀ, both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, accumulate);
  else
    wgmma_ss_n64(d, da, db, accumulate);
}

struct OutStrides {
  long long ob, os, oh;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                           OutStrides st, int Sq, int Skv, int Hq, int G, int causal,
                           float scale_log2) {
  using Lay = Layout<D>;
  constexpr int kBlockK = Lay::kBlockK, kStages = Lay::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;          // swizzle atoms: 1024-aligned
  const uint32_t sQ = base + Lay::kQ, sK = base + Lay::kK, sV = base + Lay::kV;
  const uint32_t bar = base + Lay::kBar;
  const uint32_t qbar = bar, fullk = bar + 8, fullv = bar + 8 + 8 * kStages,
                 empty = bar + 8 + 16 * kStages;

  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBlockQ;
  int n_tiles = (Skv + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockQ, Sq) - 1) / kBlockK + 1);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fullk + 8 * s, 1);
      mbar_init(fullv + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);                      // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int hk = h / G;
      mbar_expect_tx(qbar, Lay::kQTile);
      for (int c = 0; c < Lay::NH; ++c) tma_load(sQ + c * kBoxBytes, &tq, qbar, c * 64, q0, h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(fullk + 8 * s, Lay::kKVTile);
        for (int c = 0; c < Lay::NH; ++c)
          tma_load(sK + s * Lay::kKVTile + c * Lay::kKVBox, &tk, fullk + 8 * s, c * 64,
                   kt * kBlockK, hk, b);
        mbar_expect_tx(fullv + 8 * s, Lay::kKVTile);
        for (int c = 0; c < Lay::NH; ++c)
          tma_load(sV + s * Lay::kKVTile + c * Lay::kKVBox, &tv, fullv + 8 * s, c * 64,
                   kt * kBlockK, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wtid = threadIdx.x % 128, wi = wtid / 32, lane = wtid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * 64 + wi * 16 + g;      // rows row0, row0 + 8
    const int wg_row0 = q0 + wg * 64;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    constexpr int KK = kBlockK / 16;   // k16 steps of P·V, P fragments a tile
    uint32_t pa[KK][4];               // P of the tile whose P·V is next
    float sc[kBlockK / 2];
    mbar_wait(qbar, 0);

    // S = Q·K_kt into sc, issued (not waited for)
    auto issue_s = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(fullk + 8 * s, (kt / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * Lay::kKVBox + (kk % 4) * 32;
        wgmma_qk<kBlockK>(sc, desc_k_major(sQ + qoff + wg * 64 * 128),
                          desc_k_major(sK + s * Lay::kKVTile + koff), kk > 0);
      }
      wgmma_commit();
    };
    // acc += P·V_kt, issued
    auto issue_pv_from = [&](int kt, const uint32_t (&p)[KK][4]) {
      const int s = kt % kStages;
      mbar_wait(fullv + 8 * s, (kt / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_pv<D>(acc, p[kk],
                    desc_mn_major(sV + s * Lay::kKVTile + kk * 16 * 128, Lay::kKVBox));
      wgmma_commit();
    };
    // the online softmax of sc (tile kt) into pn; a0/a1 get the rescale of
    // the rows' output and running sums
    auto softmax = [&](int kt, uint32_t (&pn)[KK][4], float& a0, float& a1) {
      const int key0 = kt * kBlockK;
      const bool masked = (causal && key0 + kBlockK - 1 > wg_row0) || key0 + kBlockK > Skv;
      // sc stays read-only here: it is the accumulator of a wgmma whose
      // pipeline stage is still open, and writing it would serialize them
      auto score = [&](int j, int e) {
        float x = sc[j * 4 + e] * scale_log2;
        if (masked) {
          const int row = row0 + (e >= 2 ? 8 : 0);
          const int key = key0 + j * 8 + t * 2 + (e & 1);
          if (key >= Skv || (causal && key > row)) x = -INFINITY;
        }
        return x;
      };
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(score(j, 0), score(j, 1)));
        mx1 = fmaxf(mx1, fmaxf(score(j, 2), score(j, 3)));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // key 0 is visible to every row and tile 0 comes first: after it the
      // running max is finite (rows past Sq see key 0 too: they compute on
      // zero-filled q and are never written)
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = exp2f(m0 - mn0);
      a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const float p0 = exp2f(score(j, 0) - m0), p1 = exp2f(score(j, 1) - m0);
        const float p2 = exp2f(score(j, 2) - m1), p3 = exp2f(score(j, 3) - m1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        pn[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pn[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
    };

    // pin the wgmma operands where they stand, so the compiler moves no
    // definition of them into an open wgmma pipeline stage
    auto pin_acc = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    };
    auto pin_p = [&](uint32_t (&p)[KK][4]) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[kk][e])::"memory");
    };
    // one tile: S = Q·K_kt and P_{kt-1}·V_{kt-1} on the tensor cores
    // together, the softmax of S_kt into pout while the P·V finishes
    uint32_t pb[KK][4];
    float a0, a1;
    auto step = [&](int kt, uint32_t (&pin)[KK][4], uint32_t (&pout)[KK][4]) {
      pin_acc();
      pin_p(pin);
      wgmma_fence();
      issue_s(kt);
      issue_pv_from(kt - 1, pin);
      wgmma_wait1();                                                     // S done
      softmax(kt, pout, a0, a1);
      pin_p(pout);
      wgmma_wait0();                                                     // P·V done
      pin_acc();
      if (wtid == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j * 4] *= a0;
        acc[j * 4 + 1] *= a0;
        acc[j * 4 + 2] *= a1;
        acc[j * 4 + 3] *= a1;
      }
    };
    auto last_pv = [&](uint32_t (&p)[KK][4]) {
      pin_acc();
      pin_p(p);
      wgmma_fence();
      issue_pv_from(n_tiles - 1, p);
      wgmma_wait0();
      pin_acc();
      if (wtid == 0) mbar_arrive(empty + 8 * ((n_tiles - 1) % kStages));
    };
    wgmma_fence();
    issue_s(0);
    wgmma_wait0();
    softmax(0, pa, a0, a1);
    int kt = 1;
    for (; kt + 1 < n_tiles; kt += 2) {
      step(kt, pa, pb);
      step(kt + 1, pb, pa);
    }
    if (kt < n_tiles) {
      step(kt, pa, pb);
      last_pv(pb);
    } else {
      last_pv(pa);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = o + b * st.ob + h * st.oh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + t * 2;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(op + row0 * st.os + c) =
            pack_bf16(acc[j * 4] * inv0, acc[j * 4 + 1] * inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(op + (row0 + 8) * st.os + c) =
            pack_bf16(acc[j * 4 + 2] * inv1, acc[j * 4 + 3] * inv1);
    }
  }
}

template <int D>
int launch(dim3 grid, cudaStream_t s, const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, __nv_bfloat16* o, OutStrides st, int Sq, int Skv, int Hq,
           int G, int causal, float scale_log2) {
  const int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_kernel<D><<<grid, kThreads, smem, s>>>(tq, tk, tv, o, st, Sq, Skv, Hq, G,
                                                             causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, o in order.
extern "C" int aha_flash_prefill(const void* q, const void* k, const void* v, void* o,
                                       long long qb, long long qs, long long qh, long long kb,
                                       long long ks, long long kh, long long vb, long long vs,
                                       long long vh, long long ob, long long os, long long oh,
                                       int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                       int causal, float scale, void* stream) {
  if (Sq % 64 != 0 || Skv % 64 != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      (D != 64 && D != 128 && D != 192 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_rows = D <= 128 ? Layout<128>::kBlockK : Layout<256>::kBlockK;   // K/V box
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, Hq, B, qb, qs, qh) ||
      !make_map(&tk, k, D, Skv, Hkv, B, kb, ks, kh, 64, kv_rows) ||
      !make_map(&tv, v, D, Skv, Hkv, B, vb, vs, vh, 64, kv_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hq * B, (Sq + kBlockQ - 1) / kBlockQ);
  const OutStrides st{ob, os, oh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  const int G = Hq / Hkv;
  switch (D) {
    case 64: return launch<64>(grid, s, tq, tk, tv, oo, st, Sq, Skv, Hq, G, causal, scale_log2);
    case 128: return launch<128>(grid, s, tq, tk, tv, oo, st, Sq, Skv, Hq, G, causal, scale_log2);
    case 192: return launch<192>(grid, s, tq, tk, tv, oo, st, Sq, Skv, Hq, G, causal, scale_log2);
    default: return launch<256>(grid, s, tq, tk, tv, oo, st, Sq, Skv, Hq, G, causal, scale_log2);
  }
}
