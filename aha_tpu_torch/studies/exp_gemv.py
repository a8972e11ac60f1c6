"""Decode GEMV study on the card (the port of scripts/exp_gemv.py): what HBM
read rate the Qwen3 head's weights stream at, how an M = 8 bf16 GEMV's
block width moves it, and a GEMV with the argmax fused in.

    python -m aha_tpu_torch.studies.exp_gemv [--quick]

At the script's geometry, K = 1024, N = 151936 (the Qwen3 head, 311.2 MB
bf16), seeded weights, csrc/study_gemv.cu:

- `stream_sum` ← mk_sum (sum_kernel): x[0, 0] plus, per bn-wide column
  block, the K-sums of its first 128 columns, (1, 128) f32 — and the f32
  sum of every element read, so no load can be dropped.  The read ceiling,
  timed beside `torch.sum(w, dtype=torch.float32)`.
- `gemv_m8` ← mk_gemv (gemv_kernel): xp (8, K) bf16 · W (K, N) bf16 → (8, N)
  f32; the block width swept over the script's 1024-8192 and two narrower
  ones, beside `torch.matmul(xp, w)` (the script's "a2. XLA bf16 M=8").
- `gemv_argmax` ← mk_head (head_kernel): row 0's GEMV reduced to (max f32,
  first index int32); x is (1, K), not the TPU's 8-row pad.  Beside
  `torch.matmul` of the GEMV alone.  `head_once` ← head_once: the same
  kernel at bn 2048, checked against torch.argmax as the script checks it.

The TPU grids are N // bn and skip the last N % bn columns (384 at bn 2048
and 4096, 4480 at 8192); these kernels and their plain versions cover all
N.
"""

from __future__ import annotations

import argparse

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.flash_attention import ticket_counters
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.studies import (bound, card_line, device_ms, rel_err,
                                   report, require_card)

K, N = 1024, 151936
#: the script's block-sum widths
SUM_BNS = (2048, 4096, 8192)
#: columns per block: the script's 1024-8192 and two narrower widths
GEMV_BNS = (256, 512, 1024, 2048, 4096, 8192)
#: the widths that read fastest on an H100 (the sweep of PERF.md §6)
GEMV_BN = 256
HEAD_BN = 256
ONCE_BN = 2048
#: csrc/study_gemv.cu's stream_sum grid: threads a block, K row slices
SUM_THREADS, SUM_SLICES = 256, 8
#: kernel vs plain, relative to max |ref| (f32 sums in another order)
TOL_REL = 1e-5


# -- stream_sum ----------------------------------------------------------------


def stream_sum_plain(x: torch.Tensor, w: torch.Tensor, bn: int = 2048
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (1, 128) f32, total (1,) f32): out[0, c] = [c == 0]·x[0, 0] +
    Σ over column blocks b of Σ_k w[k, b·bn + c] (a short last block
    counts its columns), total = Σ w."""
    Kw, Nw = w.shape
    wf = w.float()
    nb = -(-Nw // bn)
    pad = torch.zeros((Kw, nb * bn), dtype=torch.float32, device=w.device)
    pad[:, :Nw] = wf
    out = pad.reshape(Kw, nb, bn)[:, :, :128].sum((0, 1)).reshape(1, 128)
    out[0, 0] += x.reshape(-1)[0].float()
    return out, wf.sum().reshape(1)


def stream_sum(x: torch.Tensor, w: torch.Tensor, bn: int = 2048
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (1, K) bf16 (x[0, 0] is read), w (K, N) bf16 → (out, total) as
    stream_sum_plain."""
    if not w.is_cuda:
        return stream_sum_plain(x, w, bn)
    Kw, Nw = _check(x, w, 1, "stream_sum")
    require(bn >= 128 and bn % 128 == 0, "bn a multiple of 128")
    nb = -(-Nw // bn)
    nblocks = -(-(Nw // 8) // SUM_THREADS)
    f32 = dict(dtype=torch.float32, device=w.device)
    head = torch.empty((SUM_SLICES, nb, 128), **f32)
    tot = torch.empty((SUM_SLICES, nblocks), **f32)
    out, total = torch.empty((1, 128), **f32), torch.empty(1, **f32)
    rc = kernels.lib().aha_study_stream_sum(
        x.data_ptr(), w.data_ptr(), head.data_ptr(), tot.data_ptr(),
        out.data_ptr(), total.data_ptr(), Kw, Nw, bn,
        kernels.stream_handle(w))
    kernels.check(rc, "aha_study_stream_sum")
    stream_sum.launches += 1
    return out, total


# -- gemv_m8 -------------------------------------------------------------------


def gemv_m8_plain(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return xp.float() @ w.float()


def gemv_m8(xp: torch.Tensor, w: torch.Tensor, bn: int = GEMV_BN
            ) -> torch.Tensor:
    """xp (8, K) bf16 · w (K, N) bf16 → (8, N) f32, f32 accumulation; `bn`
    columns per block."""
    if not w.is_cuda:
        return gemv_m8_plain(xp, w)
    Kw, Nw = _check(xp, w, 8, "gemv_m8")
    require(bn in GEMV_BNS, f"bn one of {GEMV_BNS}")
    out = torch.empty((8, Nw), dtype=torch.float32, device=w.device)
    rc = kernels.lib().aha_study_gemv(
        xp.data_ptr(), w.data_ptr(), out.data_ptr(), None, None, None, 8, Kw,
        Nw, bn, 0, kernels.stream_handle(w))
    kernels.check(rc, "aha_study_gemv")
    gemv_m8.launches += 1
    return out


# -- gemv_argmax / head_once -------------------------------------------------


def gemv_argmax_plain(x: torch.Tensor, w: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, first index) of row 0 of x · w: 0-dim f32 and int32."""
    y = (x.reshape(1, -1).float() @ w.float())[0]
    i = torch.argmax(y)
    return y[i], i.to(torch.int32)


def _argmax(x: torch.Tensor, w: torch.Tensor, bn: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    Kw, Nw = _check(x, w, 1, "gemv_argmax")
    require(bn in GEMV_BNS, f"bn one of {GEMV_BNS}")
    grid = -(-Nw // bn)
    val = torch.empty((grid + 1,), dtype=torch.float32, device=w.device)
    idx = torch.empty((grid + 1,), dtype=torch.int32, device=w.device)
    stream = kernels.stream_handle(w)
    ticket = ticket_counters(w.device, stream, 1)
    out = torch.empty((1,), dtype=torch.float32, device=w.device)
    rc = kernels.lib().aha_study_gemv(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), val.data_ptr(),
        idx.data_ptr(), ticket.data_ptr(), 1, Kw, Nw, bn, 1, stream)
    kernels.check(rc, "aha_study_gemv")
    return out[0], idx[grid]


def gemv_argmax(x: torch.Tensor, w: torch.Tensor, bn: int = HEAD_BN
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (1, K) bf16, w (K, N) bf16 → (max, first index) of x · w, without
    storing the N logits; ties go to the smallest index."""
    if not w.is_cuda:
        return gemv_argmax_plain(x, w)
    out = _argmax(x, w, bn)
    gemv_argmax.launches += 1
    return out


def head_once(x: torch.Tensor, w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's un-scanned check call: gemv_argmax's kernel at bn
    2048."""
    if not w.is_cuda:
        return gemv_argmax_plain(x, w)
    out = _argmax(x, w, ONCE_BN)
    head_once.launches += 1
    return out


stream_sum.launches = 0
gemv_m8.launches = 0
gemv_argmax.launches = 0
head_once.launches = 0


def _check(x: torch.Tensor, w: torch.Tensor, rows: int, what: str
           ) -> tuple[int, int]:
    require(w.ndim == 2 and x.ndim == 2 and x.shape == (rows, w.shape[0]),
            f"{what} takes x ({rows}, K) and w (K, N)")
    require(x.device == w.device, "x and w on one device")
    require(x.dtype == w.dtype == torch.bfloat16, f"{what} takes bf16")
    require(x.is_contiguous() and w.is_contiguous()
            and w.data_ptr() % 16 == 0, "contiguous, 16-byte aligned w")
    require(w.shape[1] % 8 == 0, "N a multiple of 8")
    return w.shape[0], w.shape[1]


def argmax_agrees(got: tuple, x: torch.Tensor, w: torch.Tensor) -> bool:
    """The kernel's index is the plain one, or its logit ties the max
    within TOL_REL (the sums are taken in another order)."""
    val, idx = got
    pv, pi = gemv_argmax_plain(x, w)
    if int(idx) == int(pi):
        return abs(float(val) - float(pv)) <= TOL_REL * abs(float(pv))
    y = float((x.float() @ w[:, int(idx)].float().reshape(-1, 1)).item())
    return abs(y - float(pv)) <= TOL_REL * abs(float(pv))


# -- the study -----------------------------------------------------------------


def inputs(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (1, K) and the head w (K, N), bf16 N(0, 1) from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=device).to(torch.bfloat16)
    x = torch.randn((1, K), generator=g, device=device).to(torch.bfloat16)
    return x, w


def measure(quick: bool = False, iters: int = 30) -> list[dict]:
    """Every candidate once against its plain version, then timed; rows of
    results (the default variant of each kernel first)."""
    dev = require_card()
    x, w = inputs(dev)
    xp = x.expand(8, K).contiguous()
    wbytes = K * N * 2
    rows = []

    def row(name, variant, ms, nbytes, b, err, plain_ms=None, library_ms=None,
            library=None):
        rows.append(dict(name=name, variant=variant, ms=ms,
                         gbps=nbytes / ms / 1e6, bound_ms=b[0], bound_by=b[1],
                         plain_ms=plain_ms, library_ms=library_ms,
                         library=library, max_abs_err=err))

    # the read ceiling
    lib_sum = device_ms(lambda: torch.sum(w, dtype=torch.float32), iters)
    abs_sum = float(w.float().abs().sum())
    for i, bn in enumerate(SUM_BNS[:1] if quick else SUM_BNS):
        out, total = stream_sum(x, w, bn)
        ref, ref_total = stream_sum_plain(x, w, bn)
        e1, r1 = rel_err(out, ref)
        e2 = abs(float(total) - float(ref_total))
        r2 = e2 / abs_sum          # the total's terms cancel: held to Σ|w|
        require(max(r1, r2) <= TOL_REL, f"stream_sum bn={bn}: {r1} of max "
                f"|ref|, total {r2} of Σ|w| (tol {TOL_REL})")
        ms = device_ms(lambda: stream_sum(x, w, bn), iters)
        plain_ms = device_ms(lambda: stream_sum_plain(x, w, bn), 5) \
            if i == 0 else None
        row("stream_sum", f"bn={bn}", ms, wbytes, bound(wbytes + 2 + 516,
            K * N, "f32"), max(e1, e2), plain_ms, lib_sum,
            "torch.sum(w, dtype=torch.float32)")

    # the M = 8 GEMV, block width swept (the default first)
    lib_mm = device_ms(lambda: torch.matmul(xp, w), iters)
    ref = gemv_m8_plain(xp, w)
    plain_ms = device_ms(lambda: gemv_m8_plain(xp, w), 5)
    nbytes = wbytes + 8 * K * 2 + 8 * N * 4
    widths = (GEMV_BN,) + tuple(b for b in GEMV_BNS if b != GEMV_BN)
    for bn in widths[:1] if quick else widths:
        e, r = rel_err(gemv_m8(xp, w, bn), ref)
        require(r <= TOL_REL, f"gemv_m8 bn={bn}: {r} of max |ref|")
        ms = device_ms(lambda: gemv_m8(xp, w, bn), iters)
        row("gemv_m8", f"bn={bn}", ms, nbytes,
            bound(nbytes, 2 * 8 * K * N), e, plain_ms if bn == GEMV_BN
            else None, lib_mm, "torch.matmul(xp, w) (bf16, M = 8)")
    del ref

    # the argmax head and the script's one-shot check
    lib_gemv = device_ms(lambda: torch.matmul(x, w), iters)
    plain_ms = device_ms(lambda: gemv_argmax_plain(x, w), 5)
    nbytes = wbytes + K * 2 + 8
    pv, _ = gemv_argmax_plain(x, w)
    widths = (HEAD_BN,) + tuple(b for b in GEMV_BNS if b != HEAD_BN)
    for bn in widths[:1] if quick else widths:
        got = gemv_argmax(x, w, bn)
        require(argmax_agrees(got, x, w), f"gemv_argmax bn={bn}: {got}")
        ms = device_ms(lambda: gemv_argmax(x, w, bn), iters)
        row("gemv_argmax", f"bn={bn}", ms, nbytes,
            bound(nbytes, 2 * K * N), abs(float(got[0]) - float(pv)),
            plain_ms if bn == HEAD_BN else None, lib_gemv,
            "torch.matmul(x, w) (the GEMV alone)")
    got = head_once(x, w)
    want = int(torch.argmax((x.float() @ w.float())[0]))
    require(argmax_agrees(got, x, w), f"head_once: {int(got[1])} vs {want}")
    print(f"[head_once] argmax match: {int(got[1]) == want} ({int(got[1])} "
          f"vs {want})", flush=True)
    ms = device_ms(lambda: head_once(x, w), iters)
    row("head_once", f"bn={ONCE_BN}", ms, nbytes, bound(nbytes, 2 * K * N),
        abs(float(got[0]) - float(pv)), plain_ms, lib_gemv,
        "torch.matmul(x, w) (the GEMV alone)")
    return rows


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Print the card line and the study's rows; return the first row of
    each kernel by name."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="each kernel's default variant only")
    args = ap.parse_args(argv)
    require_card()
    print(card_line(), flush=True)
    rows = measure(args.quick)
    report(rows)
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    return first


if __name__ == "__main__":
    main()
