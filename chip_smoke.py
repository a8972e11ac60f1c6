#!/usr/bin/env python3
"""Drive aha_tpu_torch's Qwen3 chat paths once on one CUDA card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:

1. device — the card's name, power limit, torch/CUDA/nvcc versions;
2. build — nvcc compiles aha_tpu_torch/csrc/*.cu (set-up time);
3. kernels — each CUDA kernel against its plain PyTorch version at the
   shapes the paths give it (bf16 q, bf16 or int8 caches), with error and
   device time per call (profiler) of both; the batched decode also bit
   for bit against one-slot launches;
4. engine — Qwen3-0.6B's published geometry (28 layers, hidden 1024, vocab
   151936, tied head) with seeded random bf16 weights on the card, through
   TextEngine: plain and kernel prefill, prefix-cache restore, greedy and
   sampled decode through the fused decode stack (≤ 2048 live rows), and
   a 2100-token prompt whose decode runs the per-op chain; the kernels'
   launch counters must all rise; then 8 teacher-forced steps of each
   decode path against the plain path (float32, on the CPU);
5. batch — the same weights through the continuous-batching BatchEngine
   (8 slots, 12 concurrent requests, one of them sampled, chunked
   admission) over a bf16 and an int8 cache, and an int8 TextEngine; each
   path with the launch counters
   zeroed before it and read after it; then 8 teacher-forced steps of 4
   slots against the f32 plain path on the CPU over the same cache;
6. HTTP — the same weights saved as a checkpoint (embedding rows past the
   test tokenizer's vocabulary zeroed, so replies decode to text) and
   served by `python -m aha_tpu_torch serv` in a child process:
   non-stream, stream and a prefix-cache repeat of /v1/chat/completions;
   then a `--batch-slots 4` server answering 4 chats at once.

Then one JSON line of per-kernel results, the card line, and the last
line {"ok": true, "device": {...}}.  Imports nothing of JAX or aha_tpu.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_ATTN = 2e-2          # abs, bf16 kernel vs f32 plain on the same inputs
TOL_HEAD_REL = 1e-3      # a differing index must tie within 1e-3·|max|
TOL_HIDDEN_REL = 5e-2    # bf16 28-layer stack vs f32, relative to max |ref|
TOL_FUSED_REL = 2e-2     # fused stack kernel vs its f32 plain version, same
                         # bf16 inputs, relative to max |ref|
# q8 decode vs its f32 plain version (the dequantizing fallback), max abs
# error relative to max |ref|, by variant (mxu False: cast, True: all-int8,
# which adds the requantization noise of q and p).  The inputs make the
# outputs O(1) (peaked scores), so a zero or unscaled output is off by ≥ 1.
# Measured on an H100 at these inputs: cast ≤ 2.8e-3 (the bf16 rounding of
# the output), all-int8 ≤ 4.1e-2 (1000 live rows; 1.5e-2 at 16000)
TOL_Q8_REL = {False: 6e-3, True: 8e-2}

KERNELS = {
    "flash_decode_at_layer_flat": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:413"),
    "head_argmax": dict(
        source="aha_tpu_torch/csrc/head_argmax.cu",
        replaces="aha_tpu/ops/lm_head.py:105"),
    "flash_attention": dict(
        source="aha_tpu_torch/csrc/flash_prefill.cu",
        replaces="aha_tpu/ops/flash_attention.py:1264"),
    "fused_decode_stack": dict(
        source="aha_tpu_torch/csrc/fused_decode_stack.cu",
        replaces="aha_tpu/ops/fused_layer.py:396"),
    "flash_decode_at_layer_flat_batched": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:542"),
    "flash_decode_at_layer_q8": dict(
        source="aha_tpu_torch/csrc/decode_attention_q8.cu",
        replaces="aha_tpu/ops/flash_attention.py:775"),
    "flash_decode_at_layer_q8_batched": dict(
        source="aha_tpu_torch/csrc/decode_attention_q8.cu",
        replaces="aha_tpu/ops/flash_attention.py:1013"),
}
RESULTS: dict[str, dict] = {k: {"max_abs_err": 0.0} for k in KERNELS}


def log(*a):
    print(*a, flush=True)


def require(cond: bool, what) -> None:
    """A check of the run (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(str(what))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time per call: the summed profiler time of the CUDA kernels
    `fn` launches."""
    from aha_tpu_torch.utils.profile_decode import device_ms_per_kernel

    ms = sum(device_ms_per_kernel(fn, iters, warmup).values())
    require(ms > 0, "profiler saw no device time")
    return ms


def wrappers():
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops.fused_layer import fused_decode_stack
    from aha_tpu_torch.ops.lm_head import head_argmax

    return {"flash_decode_at_layer_flat": fa.flash_decode_at_layer_flat,
            "head_argmax": head_argmax, "flash_attention": fa.flash_attention,
            "fused_decode_stack": fused_decode_stack,
            "flash_decode_at_layer_flat_batched":
                fa.flash_decode_at_layer_flat_batched,
            "flash_decode_at_layer_q8": fa.flash_decode_at_layer_q8,
            "flash_decode_at_layer_q8_batched":
                fa.flash_decode_at_layer_q8_batched}


def zero_counts() -> dict:
    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
    return wr


def read_counts(wr: dict, path: str, must: tuple[str, ...]) -> dict:
    """The counts of one path's run; each kernel in `must` launched, and
    its count recorded as the kernel's main-path launches."""
    launches = {name: fn.launches for name, fn in wr.items()}
    for name in must:
        require(launches[name] > 0,
                f"{name} was not launched on the {path} path")
        RESULTS[name]["launches"] = launches[name]
    log(f"[{path}] launches: {json.dumps(launches)}")
    return launches


# -- 1. device ----------------------------------------------------------------


def phase_device() -> None:
    require(torch.cuda.get_device_capability(0) == (9, 0),
            f"needs a Hopper card, got {torch.cuda.get_device_capability(0)}")
    from aha_tpu_torch.ops import kernels

    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {card_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{nvcc[-1]}")
    # f32 references below are true f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- 2. build -----------------------------------------------------------------


def phase_build() -> None:
    from aha_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] {kernels.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# -- 3. kernels vs plain ------------------------------------------------------


def _record(name: str, err: float, ms: float | None = None,
            plain_ms: float | None = None) -> None:
    r = RESULTS[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if ms is not None:
        r["ms"], r["plain_ms"] = ms, plain_ms


def check_decode(S: int, valid: int, timed: bool) -> None:
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_flat, flash_decode_at_layer_flat_plain)

    L, Hq, Hkv, D = 28, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(S)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, 1, Hq, D), generator=g, **bf)
    k = torch.randn((L, 1, S, Hkv * D), generator=g, **bf)
    v = torch.randn((L, 1, S, Hkv * D), generator=g, **bf)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    err = 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = flash_decode_at_layer_flat(q, k, v, lt, vl)
        ref = flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                               v.float(), lt, vl)
        torch.cuda.synchronize()
        err = max(err, (got.float() - ref).abs().max().item())
    require(err <= TOL_ATTN,
            f"decode S={S} valid={valid}: err {err}")
    # time across all 28 layers in turn, as one decode step reads them:
    # 28 layers of live rows are far past the 50 MB L2, so each call reads
    # HBM
    layer = _layer_cycle(L)
    ms = device_ms(lambda: flash_decode_at_layer_flat(
        q, k, v, layer(), vl), iters=56)
    plain_ms = device_ms(lambda: flash_decode_at_layer_flat_plain(
        q, k, v, layer(), vl), iters=56)
    nbytes = valid * Hkv * D * 2 * 2                 # bf16 K and V rows
    log(f"[kernels] decode L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}:"
        f" max_abs_err {err:.3e} (tol {TOL_ATTN}); device ms/call kernel"
        f" {ms:.4f} plain {plain_ms:.4f}; {nbytes / ms / 1e6:.1f} GB/s of"
        f" live rows")
    del k, v
    torch.cuda.empty_cache()
    _record("flash_decode_at_layer_flat", err, *((ms, plain_ms) if timed
                                                 else ()))


def check_head() -> None:
    from aha_tpu_torch.ops.lm_head import head_argmax, head_argmax_plain

    K, V = 1024, 151936
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((V, K), generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    worst, mismatches = 0.0, 0
    for trial in range(4):
        h = torch.randn((1, 1, K), generator=g, **bf)
        got = int(head_argmax(w, h))
        ref = int(head_argmax_plain(w, h))
        if got != ref:
            logits = h.reshape(1, K).float() @ w.float().t()
            gap = abs(logits[0, got] - logits[0, ref]).item()
            top = logits.abs().max().item()
            require(gap <= TOL_HEAD_REL * top,
                    f"head_argmax {got} vs plain {ref}: logit gap {gap}")
            worst = max(worst, gap)
            mismatches += 1
    # planted tie across vocab tiles: the smaller index must win
    wt = torch.zeros((V, K), **bf)
    wt[70000, 0] = 1.0
    wt[37, 0] = 1.0
    e0 = torch.zeros((1, K), **bf)
    e0[0, 0] = 1.0
    require(int(head_argmax(wt, e0)) == 37 == int(head_argmax_plain(wt, e0)),
            "planted tie did not go to the smaller index")
    # a NaN hidden state: the plain fast_argmax rule, index V - 1
    hn = torch.full((1, K), float("nan"), **bf)
    require(int(head_argmax(w, hn)) == V - 1 == int(head_argmax_plain(w, hn)),
            "a NaN row did not give V - 1")
    h = torch.randn((1, 1, K), generator=g, **bf)
    ms = device_ms(lambda: head_argmax(w, h))
    plain_ms = device_ms(lambda: head_argmax_plain(w, h))
    log(f"[kernels] head_argmax K={K} V={V}: {mismatches} index mismatches "
        f"in 4 random rows (worst logit gap {worst:.3e}), planted tie and NaN "
        f"row agree; device ms/call kernel {ms:.4f} plain {plain_ms:.4f}")
    # the kernel returns an index: its "error" is the logit gap between its
    # index and the plain one (0 when they agree)
    _record("head_argmax", worst, ms, plain_ms)
    RESULTS["head_argmax"].update(
        index_mismatches=mismatches,
        max_abs_err_of="logit gap between kernel and plain argmax")


def check_prefill(S: int, causal: bool, timed: bool) -> None:
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    Hq, Hkv, D = 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(S + causal)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, S, Hq, D), generator=g, **bf)
    k = torch.randn((1, S, Hkv, D), generator=g, **bf)
    v = torch.randn((1, S, Hkv, D), generator=g, **bf)
    got = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    require(err <= TOL_ATTN,
            f"prefill S={S} causal={causal}: err {err}")
    ms = device_ms(lambda: flash_attention(q, k, v, causal=causal))
    plain_ms = device_ms(lambda: flash_attention_plain(q, k, v, causal=causal))
    log(f"[kernels] prefill S={S} causal={causal} Hq={Hq} Hkv={Hkv} D={D}: "
        f"max_abs_err {err:.3e} (tol {TOL_ATTN}); device ms/call kernel "
        f"{ms:.4f} plain {plain_ms:.4f}")
    _record("flash_attention", err, *((ms, plain_ms) if timed else ()))


def check_fused(pos: int, n_layers: int, timed: bool) -> None:
    """The fused stack over `n_layers` of Qwen3-0.6B's layers (seeded
    weights as the engine phase makes them), a 2048-row cache with random
    rows, the token at `pos`: hidden state and the written cache rows
    against the plain version in f32 on the same bf16 inputs."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops.fused_layer import (fused_decode_stack,
                                               fused_decode_stack_plain)

    cfg = Qwen3Config(num_hidden_layers=n_layers)
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11 + pos)
    lyr = fuse_decode_params(model.init_random(g, dtype=torch.bfloat16))[
        "layers"]
    S, HD = 2048, cfg.num_key_value_heads * cfg.head_dim
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn((1, 1, cfg.hidden_size), generator=g, **bf)
    k = torch.randn((n_layers, 1, S, HD), generator=g, **bf)
    v = torch.randn((n_layers, 1, S, HD), generator=g, **bf)
    kp, vp = k.clone(), v.clone()
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    cos = torch.cat([model.cos[pos], model.cos[pos]])[None]
    sin = torch.cat([model.sin[pos], model.sin[pos]])[None]
    eps = cfg.rms_norm_eps
    got = fused_decode_stack(x, lyr, p, cos, sin, k, v, eps)
    ref = fused_decode_stack_plain(x, lyr, p, cos, sin, kp, vp, eps)
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    err_x = rel(got, ref)
    err_kv = max(rel(k[:, 0, pos], kp[:, 0, pos]),
                 rel(v[:, 0, pos], vp[:, 0, pos]))
    keep = torch.arange(S, device="cuda") != pos
    require(torch.equal(k[:, :, keep], kp[:, :, keep])
            and torch.equal(v[:, :, keep], vp[:, :, keep]),
            "fused stack touched cache rows other than pos")
    require(err_x <= TOL_FUSED_REL and err_kv <= TOL_FUSED_REL,
            f"fused stack L={n_layers} pos={pos}: hidden err {err_x}, "
            f"cache-row err {err_kv} of max |ref|")
    abs_err = (got.float() - ref.float()).abs().max().item()
    line = (f"[kernels] fused_decode_stack L={n_layers} H={cfg.hidden_size} "
            f"pos={pos} (cache 2048): hidden err {err_x:.3e}, cache-row err "
            f"{err_kv:.3e} of max |ref| (tol {TOL_FUSED_REL}); max_abs_err "
            f"{abs_err:.3e}")
    if timed:
        ms = device_ms(lambda: fused_decode_stack(x, lyr, p, cos, sin, k, v,
                                                  eps), iters=20)
        plain_ms = device_ms(lambda: fused_decode_stack_plain(
            x, lyr, p, cos, sin, kp, vp, eps), iters=3, warmup=1)
        line += f"; device ms/call kernel {ms:.4f} plain {plain_ms:.4f}"
        _record("fused_decode_stack", abs_err, ms, plain_ms)
    else:
        _record("fused_decode_stack", abs_err)
    log(line)
    del lyr, k, v, kp, vp
    torch.cuda.empty_cache()


def _q8_cache(g, L: int, B: int, S: int):
    """Seeded int8 K/V rows and f32 scales at Qwen3-0.6B's widths.  q is
    drawn 4× wider than N(0, 1), so scores spread over ~2 nats and a few
    dozen rows carry most of the weight: outputs of O(1), not the ~1e-2 of
    a flat average over thousands of random rows."""
    Hq, Hkv, D = 16, 8, 128
    i8 = dict(generator=g, device="cuda", dtype=torch.int8)
    q = (torch.randn((B, 1, Hq, D), generator=g, device="cuda") * 4).to(
        torch.bfloat16)
    k = torch.randint(-127, 128, (L, B, S, Hkv * D), **i8)
    v = torch.randint(-127, 128, (L, B, S, Hkv * D), **i8)
    ks = torch.rand((L, B, S, Hkv), generator=g, device="cuda") * 0.01 + 2e-3
    vs = torch.rand((L, B, S, Hkv), generator=g, device="cuda") * 0.01 + 2e-3
    return q, k, v, ks, vs


def _q8_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def _q8_err(got: torch.Tensor, ref: torch.Tensor, mxu: bool, what: str,
            rel: dict) -> float:
    """Holds `got` to TOL_Q8_REL[mxu]; keeps the worst relative error per
    variant in `rel`; returns the max abs error."""
    r = _q8_rel(got, ref)
    require(r <= TOL_Q8_REL[mxu],
            f"{what} mxu={mxu}: err {r} of max |ref| (tol {TOL_Q8_REL[mxu]})")
    rel[mxu] = max(rel.get(mxu, 0.0), r)
    return (got.float() - ref).abs().max().item()


def _layer_cycle(L: int):
    layers = [torch.tensor(i, dtype=torch.int32, device="cuda")
              for i in range(L)]
    it = iter(range(10 ** 9))
    return lambda: layers[next(it) % L]


def check_q8(S: int, valid: int, timed: bool) -> None:
    """Both q8 variants at B = 1 against the plain version; device time of
    each over the 28 layers in turn, and the bytes/s of the live rows."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_q8, flash_decode_at_layer_q8_plain)

    L, Hkv, D = 28, 8, 128
    g = torch.Generator(device="cuda").manual_seed(S + 1)
    q, k, v, ks, vs = _q8_cache(g, L, 1, S)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    layer = _layer_cycle(L)
    err, ms, rel = 0.0, {}, {}
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, lt, vl)
        for mxu in (False, True):
            got = flash_decode_at_layer_q8(q, k, v, ks, vs, lt, vl, mxu=mxu)
            torch.cuda.synchronize()
            err = max(err, _q8_err(got, ref, mxu, f"q8 S={S} valid={valid}",
                                   rel))
    # the bound tells a wrong output from a right one: zeros, and the
    # output of a kernel that forgot the v scales, both fail it
    unscaled = flash_decode_at_layer_q8_plain(
        q.float(), k, v, ks, torch.ones_like(vs), lt, vl)
    bad = {"zeros": _q8_rel(torch.zeros_like(ref), ref),
           "v unscaled": _q8_rel(unscaled, ref)}
    require(min(bad.values()) > max(TOL_Q8_REL.values()),
            f"q8 bound does not reject a wrong output: {bad}")
    for mxu in (False, True):
        ms[mxu] = device_ms(lambda: flash_decode_at_layer_q8(
            q, k, v, ks, vs, layer(), vl, mxu=mxu), iters=56)
    plain_ms = device_ms(lambda: flash_decode_at_layer_q8_plain(
        q, k, v, ks, vs, layer(), vl), iters=28)
    nbytes = valid * Hkv * (D + 4) * 2          # int8 rows + f32 scales
    log(f"[kernels] q8 decode L={L} S={S} valid={valid} Hq=16 Hkv={Hkv} "
        f"D={D}: err of max |ref| cast {rel[False]:.3e} int8 "
        f"{rel[True]:.3e} (tol {TOL_Q8_REL[False]}/{TOL_Q8_REL[True]}; "
        f"zeros {bad['zeros']:.3g}, v unscaled {bad['v unscaled']:.3g}), "
        f"max_abs_err {err:.3e}; device ms/call cast "
        f"{ms[False]:.4f} int8 {ms[True]:.4f} plain {plain_ms:.4f}; "
        f"{nbytes / ms[True] / 1e6:.1f} GB/s (int8) of live rows")
    _record("flash_decode_at_layer_q8", err,
            *((ms[True], plain_ms) if timed else ()))
    if timed:
        RESULTS["flash_decode_at_layer_q8"]["ms_cast_variant"] = ms[False]
    del k, v, ks, vs
    torch.cuda.empty_cache()


def check_batched(timed: bool) -> None:
    """The batched bf16 and q8 decode at the BatchEngine's shapes: 8 slots
    of a 4096-row cache, ragged lengths (a parked slot of 1, the split
    boundaries 64 and 128, the full 4096); bf16 bit-equal to eight B = 1
    launches; errors and device times against the plain versions."""
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.utils.profile_decode import RAGGED

    L, B, S, Hkv, D = 28, 8, 4096, 8, 128
    g = torch.Generator(device="cuda").manual_seed(8)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, 1, 16, D), generator=g, **bf)
    k = torch.randn((L, B, S, Hkv * D), generator=g, **bf)
    v = torch.randn((L, B, S, Hkv * D), generator=g, **bf)
    vl = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    layer = _layer_cycle(L)
    err = 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fa.flash_decode_at_layer_flat_batched(q, k, v, lt, vl)
        ref = fa.flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                                  v.float(), lt, vl)
        err = max(err, (got.float() - ref).abs().max().item())
        for b in range(B):
            one = fa.flash_decode_at_layer_flat(
                q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                v[:, b:b + 1].contiguous(), lt, vl[b:b + 1].contiguous())
            require(torch.equal(one, got[b:b + 1]),
                    f"batched decode slot {b} differs from a B = 1 launch")
    require(err <= TOL_ATTN, f"batched decode err {err}")
    ms = device_ms(lambda: fa.flash_decode_at_layer_flat_batched(
        q, k, v, layer(), vl), iters=56)
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_flat_plain(
        q, k, v, layer(), vl), iters=28)
    log(f"[kernels] batched decode L={L} B={B} S={S} lengths {RAGGED}: "
        f"max_abs_err {err:.3e} (tol {TOL_ATTN}), each slot bit-equal to a "
        f"B = 1 launch; device ms/call kernel {ms:.4f} plain {plain_ms:.4f}")
    _record("flash_decode_at_layer_flat_batched", err,
            *((ms, plain_ms) if timed else ()))
    del k, v
    torch.cuda.empty_cache()

    q, k, v, ks, vs = _q8_cache(g, L, B, S)
    err, rel = 0.0, {}
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = fa.flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, lt,
                                                vl)
        for mxu in (False, True):
            got = fa.flash_decode_at_layer_q8_batched(q, k, v, ks, vs, lt, vl,
                                                      mxu=mxu)
            torch.cuda.synchronize()
            err = max(err, _q8_err(got, ref, mxu, "q8 batched", rel))
    ms = {mxu: device_ms(lambda: fa.flash_decode_at_layer_q8_batched(
        q, k, v, ks, vs, layer(), vl, mxu=mxu), iters=56)
        for mxu in (False, True)}
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_q8_plain(
        q, k, v, ks, vs, layer(), vl), iters=28)
    log(f"[kernels] q8 batched decode L={L} B={B} S={S} lengths {RAGGED}: "
        f"err of max |ref| cast {rel[False]:.3e} int8 {rel[True]:.3e} (tol "
        f"{TOL_Q8_REL[False]}/{TOL_Q8_REL[True]}), max_abs_err {err:.3e}; "
        f"device ms/call cast {ms[False]:.4f} "
        f"int8 {ms[True]:.4f} plain {plain_ms:.4f}")
    _record("flash_decode_at_layer_q8_batched", err,
            *((ms[True], plain_ms) if timed else ()))
    if timed:
        RESULTS["flash_decode_at_layer_q8_batched"]["ms_cast_variant"] = \
            ms[False]
    del k, v, ks, vs
    torch.cuda.empty_cache()


def phase_kernels() -> None:
    check_fused(1000, 1, timed=False)
    check_fused(1000, 28, timed=True)
    check_fused(2047, 28, timed=False)
    check_decode(2048, 1000, timed=True)
    check_decode(4096, 4000, timed=False)
    check_head()
    check_prefill(256, True, timed=False)
    check_prefill(256, False, timed=False)
    check_prefill(2048, True, timed=True)
    check_q8(2048, 1000, timed=True)
    check_q8(16384, 16000, timed=False)
    check_decode(16384, 16000, timed=False)
    check_batched(timed=True)
    torch.cuda.synchronize()


# -- 4. engine main path ------------------------------------------------------


def _prompt(rng, n: int, vocab: int) -> list[int]:
    return [int(x) for x in rng.integers(0, vocab, n)]


def teacher_forced_hidden(model, params, ids: list[int], forced: list[int],
                          device, window: int | None = None
                          ) -> tuple[torch.Tensor, list[int]]:
    """Prefill `ids`, then feed `forced` one token per step (with `window`,
    through the fused decode stack); returns the stacked final hidden
    states (1 + len(forced), H) in f32 and the greedy token at each
    position."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import bucket_for

    cache = model.init_cache(1, 512, params["embed"]["w"].dtype)
    x = torch.zeros((1, bucket_for(len(ids))), dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    hs = [model.backbone(params, x.to(device), cache)[0, len(ids) - 1]]
    kv.advance(cache, len(ids))
    for t in forced:
        tok = torch.tensor([[t]], device=device)
        hs.append(model.backbone(params, tok, cache, window=window)[0, 0])
        kv.advance(cache, 1)
    hid = torch.stack(hs)
    greedy = [int(model.greedy_token(params, h)) for h in hs]
    return hid.float().cpu(), greedy


def phase_engine(cfg, device: str = "cuda") -> dict:
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen3 import Qwen3Model

    V = cfg.vocab_size
    model = Qwen3Model(cfg, max_rope_len=8192, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_random(gen, dtype=torch.bfloat16)
    _sync(device)
    n_params = (params["embed"]["w"].numel()
                + sum(t.numel() for t in _leaves(params["layers"]))
                + params["norm"]["w"].numel())
    log(f"[engine] Qwen3 L={cfg.num_hidden_layers} H="
        f"{cfg.hidden_size} V={V} tied: {n_params / 1e6:.1f} M bf16 params "
        f"seeded on the card in {time.perf_counter() - t0:.1f} s (set-up)")
    rng = np.random.default_rng(0)
    greedy = SamplingConfig()
    sampled = SamplingConfig(temperature=0.7, top_k=20, top_p=0.9, seed=1234)

    # warm-up of the same shapes on a cache-less engine (cuBLAS heuristics,
    # allocator), not counted
    warm = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    warm.generate_tokens(_prompt(rng, 300, V), greedy, max_tokens=32)
    warm.generate_tokens(_prompt(rng, 20, V), sampled, max_tokens=16)
    del warm

    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     prefix_cache_entries=4)
    a_ids, b_ids = _prompt(rng, 20, V), _prompt(rng, 300, V)
    c_ids = b_ids + _prompt(rng, 40, V)
    e_ids = _prompt(rng, 2100, V)
    wr = zero_counts()
    _sync(device)
    out_a = eng.generate_tokens(a_ids, greedy, max_tokens=64)
    out_b = eng.generate_tokens(b_ids, greedy, max_tokens=128)
    tb = eng.last_timing
    out_c = eng.generate_tokens(c_ids, greedy, max_tokens=32)
    stored = len(eng._prefix_entries)
    out_d = eng.generate_tokens(a_ids, sampled, max_tokens=32)
    n_fused = wr["fused_decode_stack"].launches
    out_e = eng.generate_tokens(e_ids, greedy, max_tokens=32)
    te = eng.last_timing
    _sync(device)
    read_counts(wr, "engine", ("flash_decode_at_layer_flat", "head_argmax",
                               "flash_attention", "fused_decode_stack"))
    # (a)-(d) run 4 + 8 + 2 + 2 decode blocks of 16 steps, each step one
    # fused launch; (e), past 2048 rows, none
    require(n_fused == 16 * (4 + 8 + 2 + 2)
            and wr["fused_decode_stack"].launches == n_fused,
            f"fused stack launches {n_fused}, "
            f"{wr['fused_decode_stack'].launches}")
    for name, out, n in (("a", out_a, 64), ("b", out_b, 128),
                         ("c", out_c, 32), ("d", out_d, 32),
                         ("e", out_e, 32)):
        require(len(out) == n and all(0 <= t < V for t in out),
                f"request {name}: {len(out)} tokens, range bad")
    require(stored == 2,
            f"prefix store holds {stored} entries, expected 2")
    require(len(set(out_d)) > 1,
            f"sampled request drew one token: {out_d}")
    log(f"[engine] (a) 20-token prompt, bucket 32 plain prefill: 64 greedy")
    log(f"[engine] (b) 300-token prompt, bucket 512 kernel prefill: 128 "
        f"greedy")
    log(f"[engine] (c) (b)+40 tokens, prefix restore + suffix prefill: 32 "
        f"greedy; store holds {stored}")
    log(f"[engine] (d) sampled T=0.7 top_k=20 top_p=0.9: 32 tokens, "
        f"{len(set(out_d))} distinct")
    log(f"[engine] (e) 2100-token prompt, bucket 4096 kernel prefill: 32 "
        f"greedy, decode past 2048 rows on the per-op chain")
    card = card_line() if device == "cuda" else "cpu"

    def rate(t):
        return (t.completion_tokens - 1) / t.completion_secs

    log(f"[engine] (b) prefill {tb.prompt_secs * 1e3:.2f} ms for 300 tokens "
        f"(bucket 512, incl. first token read), decode {rate(tb):.1f} tok/s "
        f"at batch 1 (fused stack) | {card}")
    log(f"[engine] (e) prefill {te.prompt_secs * 1e3:.2f} ms for 2100 tokens "
        f"(bucket 4096), decode {rate(te):.1f} tok/s at batch 1 (per-op "
        f"chain, 2100+ rows) | {card}")
    # (b) once more with the fused stack switched off, outside the counted
    # main path: the per-op chain's rate on the same request
    os.environ["AHA_FUSED_LAYER"] = "0"
    try:
        plain_eng = TextEngine(model, params, eos_token_ids=[],
                               max_seq_len=8192)
        out_b0 = plain_eng.generate_tokens(b_ids, greedy, max_tokens=128)
        tb0 = plain_eng.last_timing
    finally:
        del os.environ["AHA_FUSED_LAYER"]
    same = next((i for i, (x, y) in enumerate(zip(out_b, out_b0)) if x != y),
                len(out_b))
    log(f"[engine] (b) per-op chain: decode {rate(tb0):.1f} tok/s at batch 1 "
        f"| {card}; greedy streams equal for the first {same}/128 tokens")

    # 8 teacher-forced steps of (b) through each decode path on the card vs
    # the plain path (float32 on the CPU: there every wrapper runs its
    # plain version and the fused gate, bf16 only, stays shut)
    forced = out_b[:8]
    cpu_model = Qwen3Model(cfg, max_rope_len=8192, device="cpu")
    cpu_params = _tree_to(params, "cpu", torch.float32)
    cpu_params["lm_head"] = {"w": cpu_params["embed"]["w"]}
    hp, gp = teacher_forced_hidden(cpu_model, cpu_params, b_ids, forced,
                                   "cpu")
    for path, window in (("fused stack", 512), ("per-op chain", None)):
        hk, gk = teacher_forced_hidden(model, eng.params, b_ids, forced,
                                       device, window)
        rel = ((hk - hp).abs().max() / hp.abs().max()).item()
        rel_dec = ((hk[1:] - hp[1:]).abs().max() / hp.abs().max()).item()
        agree = sum(x == y for x, y in zip(gk, gp))
        log(f"[engine] teacher-forced (b), {path}, 9 positions: hidden max "
            f"err {rel:.3e} of max |ref| ({rel_dec:.3e} over the 8 decode "
            f"steps; tol {TOL_HIDDEN_REL}); greedy agreement "
            f"{agree}/{len(gk)}")
        require(rel <= TOL_HIDDEN_REL,
                f"{path} hidden off by {rel}")
    return {"model": model, "params": params}


# -- 5. continuous batching and the int8 cache --------------------------------

#: the request of the (f)/(g) mix that samples (a 420-token prompt)
SAMPLED = 5

def _batch_path(model, params, device: str, cache_dtype, name: str,
                must: str, slots: int = 8) -> None:
    """(f)/(g): a BatchEngine of `slots` slots, max_seq_len 4096, the 12
    requests of BATCH_PROMPTS, 64 tokens each, from threads at once; one
    of them sampled (temperature, top-k, top-p, repeat penalty), so the
    steps it shares run the batched sampler with per-slot generators."""
    from aha_tpu_torch.core.batch_engine import BatchEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.utils.profile_decode import (BATCH_PROMPTS,
                                                    drive_concurrent)

    V = model.config.vocab_size
    rng = np.random.default_rng(len(name))
    eng = BatchEngine(model, params, eos_token_ids=[], slots=slots,
                      cache_dtype=cache_dtype, max_seq_len=4096)
    greedy = SamplingConfig()
    sampled = SamplingConfig(temperature=0.7, top_k=20, top_p=0.9,
                             repeat_penalty=1.1, seed=1234)
    cfgs = [greedy] * len(BATCH_PROMPTS)
    cfgs[SAMPLED] = sampled
    try:
        # warm-up of the step and prefill shapes, not counted
        drive_concurrent(eng, [_prompt(rng, 40, V), _prompt(rng, 600, V)],
                         [greedy, sampled], 8)
        prompts = [_prompt(rng, n, V) for n in BATCH_PROMPTS]
        wr = zero_counts()
        _sync(device)
        outs, ttft, wall, peak = drive_concurrent(eng, prompts, cfgs, 64,
                                                  monitor=True)
        _sync(device)
        read_counts(wr, name, (must,))
    finally:
        eng.shutdown()
    for i, out in enumerate(outs):
        require(out is not None and len(out) == 64
                and all(0 <= t < V for t in out),
                f"{name} request {i}: {out and len(out)} tokens")
    require(peak == slots, f"{name}: peak occupied slots {peak} of {slots}")
    n_distinct = len(set(outs[SAMPLED]))
    require(n_distinct > 1,
            f"{name}: the sampled request drew one token: {outs[SAMPLED]}")
    card = card_line() if device == "cuda" else "cpu"
    log(f"[{name}] {len(prompts)} requests of {len(prompts[0])}-"
        f"{len(prompts[-1])} prompt tokens, 64 tokens each (11 greedy, 1 "
        f"sampled T=0.7 top_k=20 top_p=0.9 penalty 1.1: {n_distinct} "
        f"distinct), {slots} slots "
        f"({str(cache_dtype).replace('torch.', '')} cache): "
        f"all finished, peak {peak} slots busy; aggregate "
        f"{len(prompts) * 64 / wall:.1f} tok/s over {wall:.2f} s; time to "
        f"first token mean {np.mean(ttft) * 1e3:.1f} ms, max "
        f"{max(ttft) * 1e3:.1f} ms | {card}")


def _int8_text_path(model, params, device: str) -> None:
    """(h): an int8 TextEngine, a 300-token prompt and 128 greedy tokens."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    V = model.config.vocab_size
    rng = np.random.default_rng(300)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     cache_dtype=torch.int8)
    eng.generate_tokens(_prompt(rng, 300, V), SamplingConfig(), 16)  # warm
    ids = _prompt(rng, 300, V)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=128)
    _sync(device)
    read_counts(wr, "int8-text", ("flash_decode_at_layer_q8",))
    require(len(out) == 128 and all(0 <= t < V for t in out),
            f"int8 TextEngine: {len(out)} tokens")
    t = eng.last_timing
    card = card_line() if device == "cuda" else "cpu"
    log(f"[int8-text] (h) 300-token prompt, int8 cache: 128 greedy tokens, "
        f"prefill {t.prompt_secs * 1e3:.2f} ms, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at "
        f"batch 1 (per-op chain) | {card}")


def teacher_forced_slots(model, params, prompts: list[list[int]],
                         forced: torch.Tensor, device, cache_dtype,
                         cache: dict | None = None):
    """Decode `forced` (B, n) one column per step through a per-slot cache
    of B slots; with no `cache`, first prefill each prompt at batch 1 into
    its slot.  Returns the (n, B, H) f32 hidden states on the CPU and the
    cache as it stood before the first step (on the CPU)."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import bucket_for

    B = len(prompts)
    if cache is None:
        cache = model.init_cache(B, 1024, cache_dtype, per_slot_pos=True)
        for b, ids in enumerate(prompts):
            small = model.init_cache(1, bucket_for(len(ids)), cache_dtype)
            x = torch.zeros((1, bucket_for(len(ids))), dtype=torch.int64)
            x[0, :len(ids)] = torch.tensor(ids)
            model.backbone(params, x.to(device), small)
            for name in kv.ROW_KEYS:
                if name in small:
                    cache[name][:, b, :len(ids)] = small[name][:, 0, :len(ids)]
            cache["pos"][b] = len(ids)
    before = {k: v.to("cpu", copy=True) for k, v in cache.items()}
    hs = []
    for step in range(forced.shape[1]):
        tok = forced[:, step:step + 1].to(device)
        hs.append(model.backbone(params, tok, cache)[:, 0])
        kv.advance(cache, 1)
    return torch.stack(hs).float().cpu(), before


def phase_batch(model, params, device: str = "cuda") -> None:
    _batch_path(model, params, device, torch.bfloat16, "batch-bf16",
                "flash_decode_at_layer_flat_batched")
    _batch_path(model, params, device, torch.int8, "batch-int8",
                "flash_decode_at_layer_q8_batched")
    _int8_text_path(model, params, device)

    # (i) 8 teacher-forced steps of 4 slots on the card against the f32
    # plain path on the CPU, from the same cache contents
    from aha_tpu_torch.models.qwen3 import Qwen3Model

    V, cfg = model.config.vocab_size, model.config
    rng = np.random.default_rng(9)
    prompts = [_prompt(rng, n, V) for n in (50, 120, 300, 700)]
    forced = torch.tensor(rng.integers(0, V, (4, 8)))
    cpu_model = Qwen3Model(cfg, max_rope_len=8192, device="cpu")
    cpu_params = _tree_to(params, "cpu", torch.float32)
    cpu_params["lm_head"] = {"w": cpu_params["embed"]["w"]}
    for dtype in (torch.bfloat16, torch.int8):
        hk, before = teacher_forced_slots(model, params, prompts, forced,
                                          device, dtype)
        if dtype != torch.int8:
            before = {k: (v.float() if v.is_floating_point() else v)
                      for k, v in before.items()}
        hp, _ = teacher_forced_slots(cpu_model, cpu_params, prompts, forced,
                                     "cpu", None, cache=before)
        rel = ((hk - hp).abs().max() / hp.abs().max()).item()
        log(f"[batch] teacher-forced 4 slots x 8 steps, "
            f"{str(dtype).replace('torch.', '')} cache: hidden max err "
            f"{rel:.3e} of max |ref| (tol {TOL_HIDDEN_REL})")
        require(rel <= TOL_HIDDEN_REL,
                f"batched {dtype} hidden off by {rel}")


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


# -- 6. HTTP ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict) -> tuple[int, str]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


def phase_http(config, params: dict) -> None:
    with tempfile.TemporaryDirectory(prefix="aha_torch_smoke_") as tmp:
        _write_checkpoint(tmp, config, params)
        with _server(tmp) as base:
            _ask(base)
        with _server(tmp, "--batch-slots", "4") as base:
            _ask_concurrent(base, 4)


def _write_checkpoint(tmp: str, config, params: dict) -> None:
    """A servable model directory: the test tokenizer and chat template,
    the config, and the seeded weights as safetensors."""
    from aha_tpu_torch.io.weights import save_hf_qwen3

    # tests/fixtures.py by path: a `tests` package elsewhere on sys.path
    # must not shadow it
    spec = importlib.util.spec_from_file_location(
        "aha_test_fixtures", os.path.join(ROOT, "tests", "fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)

    tok = fixtures.build_tokenizer(tmp)
    eos = tok.token_to_id("<|im_end|>")
    # the seeded model samples from all 151936 ids, the test tokenizer
    # knows ~400: zero the (tied) embedding rows past them, so their
    # logits are 0 and greedy replies are text the tokenizer decodes
    params["embed"]["w"][tok.get_vocab_size(with_added_tokens=True):] = 0
    cfg = {**config.__dict__, "architectures": ["Qwen3ForCausalLM"],
           "torch_dtype": "bfloat16", "eos_token_id": eos}
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tmp, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(tmp, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": fixtures.CHAT_TEMPLATE}, f)
    t0 = time.perf_counter()
    save_hf_qwen3(params, tmp)
    log(f"[http] full-width checkpoint written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")


@contextlib.contextmanager
def _server(tmp: str, *extra: str):
    """`python -m aha_tpu_torch serv tmp` in a child process, up and
    answering /health; the child is always stopped."""
    port = _free_port()
    logf = open(os.path.join(tmp, f"server_{port}.log"), "w")
    env = {**os.environ, "AHA_NO_COMPILE_CACHE": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "aha_tpu_torch", "serv", tmp, "--port",
         str(port), "--max-seq-len", "2048", *extra], cwd=ROOT, env=env,
        stdout=logf, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                with open(logf.name) as f:
                    raise RuntimeError("server exited:\n" + f.read()[-4000:])
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            require(time.perf_counter() - t0 < 300,
                    "server did not come up")
            time.sleep(1)
        log(f"[http] server {' '.join(extra) or '(single stream)'} up in "
            f"{time.perf_counter() - t0:.1f} s")
        yield base
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logf.close()


def _chat_body(text: str) -> dict:
    return {"model": "Qwen/Qwen3-0.6B", "max_tokens": 24, "temperature": 0.0,
            "messages": [{"role": "user", "content": text}]}


def _ask(base: str) -> None:
    """Non-stream, stream and a prefix-cache repeat."""
    body = _chat_body("the quick brown fox jumps over the lazy dog " * 3)
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": False})
    resp = json.loads(text)
    u = resp["usage"]
    require(status == 200 and u["prompt_tokens"] >= 32
            and u["completion_tokens"] >= 1, resp)
    log(f"[http] non-stream 200: usage prompt {u['prompt_tokens']} "
        f"completion {u['completion_tokens']}")
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": True})
    events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    require(status == 200 and events[-1] == "[DONE]",
            text[-500:])
    chunks = [json.loads(e) for e in events[:-1]]
    usage = chunks[-1]["usage"]
    n_text = sum(1 for c in chunks for ch in c.get("choices") or []
                 if (ch.get("delta") or {}).get("content")
                 or (ch.get("delta") or {}).get("reasoning_content"))
    require(usage["completion_tokens"] >= 1 and n_text >= 1,
            f"usage {usage}, {n_text} text chunks")
    log(f"[http] stream 200: {len(chunks)} chunks, {n_text} with text, "
        f"usage completion {usage['completion_tokens']}")
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": False})
    u = json.loads(text)["usage"]
    require(status == 200 and u["completion_tokens"] >= 1, text)
    log(f"[http] prefix-cache repeat 200: usage prompt "
        f"{u['prompt_tokens']} completion {u['completion_tokens']}")


def _ask_concurrent(base: str, n: int) -> None:
    """n chats at once: every one 200 with content."""
    from concurrent.futures import ThreadPoolExecutor

    texts = [f"request {i}: the quick brown fox jumps over the lazy dog "
             * (2 + i) for i in range(n)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(n) as pool:
        replies = list(pool.map(
            lambda t: _post(base + "/v1/chat/completions",
                            {**_chat_body(t), "stream": False}), texts))
    wall = time.perf_counter() - t0
    for status, text in replies:
        resp = json.loads(text)
        msg = resp["choices"][0]["message"]
        require(status == 200 and (msg.get("content")
                                   or msg.get("reasoning_content"))
                and resp["usage"]["completion_tokens"] >= 1, text[-500:])
    log(f"[http] {n} concurrent chats to --batch-slots {n}: all 200 with "
        f"content in {wall:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    phase_device()
    phase_build()
    phase_kernels()
    from aha_tpu_torch.models.qwen3 import Qwen3Config

    state = phase_engine(Qwen3Config())
    phase_batch(state["model"], state["params"])
    phase_http(state["model"].config, state["params"])
    require("jax" not in sys.modules and not any(
        m == "aha_tpu" or m.startswith("aha_tpu.") for m in sys.modules),
        "jax or aha_tpu was imported")
    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": RESULTS[name]["launches"],
                "max_abs_err": RESULTS[name]["max_abs_err"],
                "ms": RESULTS[name]["ms"],
                "plain_ms": RESULTS[name]["plain_ms"],
                **{k: RESULTS[name][k] for k in ("index_mismatches",
                                                 "max_abs_err_of")
                   if k in RESULTS[name]}} for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
