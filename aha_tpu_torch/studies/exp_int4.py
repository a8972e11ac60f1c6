"""int4-weight study on the card (the port of scripts/exp_int4.py): can 4-bit
weights stream at the M = 8 quantized head's geometry faster than the
int8 and bf16 paths, and which of its layouts carries them best on the
tensor cores?

    python -m aha_tpu_torch.studies.exp_int4 [--quick]

One function, three kernels (csrc/study_int4.cu), at M = 8, K = 1024,
N = 151936: each row of x (8, K) bf16 quantized to int8 by absmax / 127
(sx = max|x| / 127, xq = round_half_even(x / (sx or 1)), true divisions),
times int4 weights W (K, N), int32 accumulation, × sx → bf16 (8, N); no
weight scales.  All three read 4 bits a weight (77.8 MB) and agree bit for
bit with the plain version and each other:

- `i4_upcast` ← f_i4_pl (k_i4), over the k8 words: a persistent grid of
  column tiles (`packed_k_plan`), x quantized once a block straight into
  mma.sync B fragments, the words by TMA (boxes of 64 rows × 32 words,
  128-byte swizzled) into a ring a producer warp keeps full across tile
  ends, each nibble "upcast" to the top of an s8 byte in registers for
  mma.sync.m16n8k32 s8 (W's columns as A's rows, x's 8 rows as B's
  columns); K up to UPCAST_K_MAX;
- `i4_tensorcore` ← f_i4n_pl (k_i4n): the nibbles sign-extended into the
  s8 fragments of mma.sync.m16n8k32 (Hopper has no s8 × s4 product), M
  padded to 16 in registers only — "hand the narrow weight to the matrix
  unit";
- `i4_packed_k` ← f_pk (k_pk): the script's own layout, nibbles packed two
  per byte along K, (K/2, N), row 2i the low nibble and 2i+1 the high one,
  sign-extended with shifts; the bytes by TMA into mma.sync.m16n8k32 s8 on
  the same persistent grid, x quantized once a block; K up to
  PACKED_K_MAX.

Rows 20-21 read "k8 words" (`pack_k8`): W as (K/8, N) int32, word [q, n]
holding W[8q + j, n] in bits 4j..4j+3 — on the TPU they read jnp.int4
arrays, which are stored packed, so every kernel here reads 4 bits a
weight.  No single PyTorch call computes this function (library_ms is
null); the study prints `torch.matmul` of bf16 weights (the script's
candidate a) beside the kernels.  The TPU grids (N // 2048) leave the last
384 output columns unwritten; these kernels cover all N.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.launches import count
from aha_tpu_torch.ops.quant_matmul import _true_div
from aha_tpu_torch.studies import (bound, card_line, device_ms, rel_err,
                                   report, require_card)
from aha_tpu_torch.studies.exp_gemv import gemv_plan
from aha_tpu_torch.utils.device import sm_count

M, K, N = 8, 1024, 151936
VARIANTS = {"i4_upcast": 0, "i4_tensorcore": 1, "i4_packed_k": 2}
#: i4_packed_k's K at most: its fragments of xq, and xq while they are
#: built, beside a ring of two 256-column stages fill the shared memory
#: (csrc/study_int4.cu; 12,032 where its tiles are 128 columns)
PACKED_K_MAX = 9984
#: i4_upcast's K at most: its fragments of xq (8·K bytes) beside a ring of
#: two 256-column stages (128 KB) fill the shared memory (csrc/study_int4.cu)
UPCAST_K_MAX = 12288


# -- layouts -------------------------------------------------------------------


def pack_k8(w4: np.ndarray | torch.Tensor) -> torch.Tensor:
    """int4 values held in int8 (K, N), K % 8 == 0 → the k8 words (K/8, N)
    int32: word [q, n] = Σ_j (W[8q + j, n] & 0xF) << 4j."""
    w = torch.as_tensor(w4).to(torch.int64) & 0xF
    Kw, Nw = w.shape
    w = w.reshape(Kw // 8, 8, Nw)
    words = torch.zeros((Kw // 8, Nw), dtype=torch.int64, device=w.device)
    for j in range(8):
        words |= w[:, j] << (4 * j)
    return words.to(torch.int32)      # the top nibble's bits wrap to the sign


def unpack_k8(words: torch.Tensor) -> torch.Tensor:
    """The k8 words (K/8, N) int32 → the int4 values (K, N) int8."""
    nib = torch.stack([(words >> (4 * j)) & 0xF for j in range(8)], 1)
    nib = torch.where(nib >= 8, nib - 16, nib)
    return nib.reshape(-1, words.shape[1]).to(torch.int8)


def pack_k(w4: np.ndarray | torch.Tensor) -> torch.Tensor:
    """The script's (K/2, N) int8 nibble pairs: row 2i in the low nibble,
    2i + 1 in the high one."""
    w = torch.as_tensor(w4).to(torch.int32)
    return ((w[0::2] & 0x0F) | ((w[1::2] & 0x0F) << 4)).to(torch.uint8) \
        .view(torch.int8)


def unpack_k(packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) int8 nibble pairs → (K, N) int8, as k_pk sign-extends them:
    lo = (p << 4) >> 4, hi = p >> 4."""
    lo = torch.bitwise_left_shift(packed, 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], 1).reshape(-1, packed.shape[1])


# -- the function --------------------------------------------------------------


def quantize_acts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xq (M, K) int8, sx (M, 1) f32) as the TPU kernels quantize x: true
    divisions (a tensor divisor: on the card a Python-scalar divisor
    multiplies by the reciprocal)."""
    xf = x.float()
    sx = _true_div(xf.abs().amax(1, keepdim=True), 127.0)
    d = torch.where(sx == 0, torch.ones_like(sx), sx)
    return torch.round(xf / d).to(torch.int8), sx


def int4_matmul_plain(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16, w4 (K, N) int4 values in int8 → (M, N) bf16.  The
    f32 product of the integer matrices is exact (|sum| ≤ K·127·8 < 2^24),
    so it equals the int32 one."""
    xq, sx = quantize_acts(x)
    acc = xq.float() @ w4.float()
    return (acc * sx).to(torch.bfloat16)


def i4_upcast_plain(x: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The plain version of both kernels on the k8 words."""
    return int4_matmul_plain(x, unpack_k8(words))


i4_tensorcore_plain = i4_upcast_plain


def i4_packed_k_plain(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    return int4_matmul_plain(x, unpack_k(packed))


def packed_k_plan(n: int, sms: int) -> tuple[int, int]:
    """(tile, grid) of i4_packed_k and i4_upcast over N columns on `sms`
    SMs: exp_gemv.gemv_plan's, with a tile of 64 columns widened to 128 —
    i4_packed_k's TMA boxes are 128 columns, so a narrower tile would read
    every byte twice; i4_upcast's tiles are four or eight of its 32-word
    boxes — and the grid no larger than the tiles."""
    tile, grid = gemv_plan(n, sms)
    if tile < 128:
        tile, grid = 128, min(-(-n // 128), sms)
    return tile, grid


def _launch(x: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    require(x.device == w.device, "x and w on one device")
    require(x.dtype == torch.bfloat16 and x.ndim == 2 and x.shape[0] == M,
            f"{variant} takes x ({M}, K) bf16")
    Kx = x.shape[1]
    if variant == "i4_packed_k":
        require(w.dtype == torch.int8 and w.shape[0] * 2 == Kx,
                "i4_packed_k takes (K/2, N) int8 nibble pairs")
        require(Kx <= PACKED_K_MAX, f"i4_packed_k takes K ≤ {PACKED_K_MAX}")
    else:
        require(w.dtype == torch.int32 and w.shape[0] * 8 == Kx,
                f"{variant} takes the (K/8, N) int32 k8 words")
    if variant == "i4_upcast":
        require(Kx <= UPCAST_K_MAX, f"i4_upcast takes K ≤ {UPCAST_K_MAX}")
    Nw = w.shape[1]
    require(Kx % 32 == 0 and Nw % 8 == 0, "K a multiple of 32, N of 8")
    require(x.is_contiguous() and w.is_contiguous() and w.data_ptr() % 16 == 0
            and x.data_ptr() % 16 == 0, "contiguous, 16-byte aligned inputs")
    # i4_packed_k's and i4_upcast's persistent grid of column tiles;
    # i4_tensorcore's grid is its own
    tile, grid = ((0, 0) if variant == "i4_tensorcore"
                  else packed_k_plan(Nw, sm_count(w.device)))
    out = torch.empty((M, Nw), dtype=torch.bfloat16, device=w.device)
    rc = kernels.lib().aha_study_int4(x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), Kx, Nw,
                                      VARIANTS[variant], tile, grid,
                                      kernels.stream_handle(w))
    kernels.check(rc, "aha_study_int4")
    return out


def i4_upcast(x: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """x (8, K) bf16, the k8 words (K/8, N) → (8, N) bf16 (TMA ring,
    mma.sync s8), on packed_k_plan's grid for the card's SMs."""
    if not words.is_cuda:
        return i4_upcast_plain(x, words)
    out = _launch(x, words, "i4_upcast")
    count(i4_upcast)
    return out


def i4_tensorcore(x: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """x (8, K) bf16, the k8 words (K/8, N) → (8, N) bf16 (mma.sync)."""
    if not words.is_cuda:
        return i4_tensorcore_plain(x, words)
    out = _launch(x, words, "i4_tensorcore")
    count(i4_tensorcore)
    return out


def i4_packed_k(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """x (8, K) bf16, the (K/2, N) nibble pairs → (8, N) bf16 (TMA ring,
    mma.sync s8), on packed_k_plan's grid for the card's SMs."""
    if not packed.is_cuda:
        return i4_packed_k_plain(x, packed)
    out = _launch(x, packed, "i4_packed_k")
    count(i4_packed_k)
    return out


i4_upcast.launches = 0
i4_tensorcore.launches = 0
i4_packed_k.launches = 0


# -- the study -----------------------------------------------------------------


def inputs(device, seed: int = 0):
    """x (8, K) bf16 N(0, 1), the int4 values (K, N) int8 in [-8, 7], and
    their two layouts."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
    w4 = torch.randint(-8, 8, (K, N), generator=g, device=device,
                       dtype=torch.int8)
    return x, w4, pack_k8(w4), pack_k(w4)


def measure(quick: bool = False, iters: int = 30) -> list[dict]:
    dev = require_card()
    x, w4, words, packed = inputs(dev)
    ref = int4_matmul_plain(x, w4)
    nbytes = K * N // 2 + M * K * 2 + M * N * 2
    b = bound(nbytes, 2 * M * K * N, "int8")
    runs = {"i4_upcast": (i4_upcast, i4_upcast_plain, words),
            "i4_tensorcore": (i4_tensorcore, i4_tensorcore_plain, words),
            "i4_packed_k": (i4_packed_k, i4_packed_k_plain, packed)}
    rows = []
    for name, (fn, plain, w) in runs.items():
        got = fn(x, w)
        require(torch.equal(got, ref), f"{name} differs from the plain "
                f"version: {rel_err(got, ref)}")
        require(torch.equal(got, plain(x, w)), f"{name}: plain layouts")
        ms = device_ms(lambda: fn(x, w), iters)
        plain_ms = device_ms(lambda: plain(x, w), 5)
        rows.append(dict(name=name, variant="", ms=ms, gbps=nbytes / ms / 1e6,
                         bound_ms=b[0], bound_by=b[1], plain_ms=plain_ms,
                         library_ms=None, library=None, max_abs_err=0.0))
    if not quick:
        # the script's candidate a: the same product from bf16 weights
        wbf = w4.to(torch.bfloat16)
        ms = device_ms(lambda: torch.matmul(x, wbf), iters)
        print(f"[baseline] torch.matmul bf16 (8, {K}) x ({K}, {N}): {ms:.4f} "
              f"ms, {(K * N * 2) / ms / 1e6:.1f} GB/s of bf16 weights",
              flush=True)
    return rows


def main(argv: list[str] | None = None) -> dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the three kernels without the bf16 baseline")
    args = ap.parse_args(argv)
    require_card()
    print(card_line(), flush=True)
    rows = measure(args.quick)
    report(rows)
    return {r["name"]: r for r in rows}


if __name__ == "__main__":
    main()
