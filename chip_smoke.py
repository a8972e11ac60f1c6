#!/usr/bin/env python3
"""Drive aha_tpu_torch's Qwen3 chat and Qwen2.5-VL image-chat paths once on
one CUDA card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:

1. device — the card's name, power limit, torch/CUDA/nvcc versions;
2. build — nvcc compiles aha_tpu_torch/csrc/*.cu (set-up time);
3. kernels — each CUDA kernel against its plain PyTorch version at the
   shapes the paths give it (bf16 q, bf16 or int8 caches), with error and
   device time per call (profiler) of both; the batched decode also bit
   for bit against one-slot launches; the prefill kernel at Qwen3's 16/8
   heads (S 2048 and 4096) and at Qwen2.5-VL's 16/2 (S 512, 2048), each
   timed beside sdpa; the segment and stacked-decode kernels held relative
   to max |ref| beside a planted fault their bound rejects; decode at
   Qwen2.5-VL-7B's group (28 query heads over 4, G 7), bf16 and int8; the
   one-layer fused decode block, which no path runs, at Qwen3-0.6B's
   widths, alone and as 28 chained launches against the fused stack's
   plain version;
3b. studies — the H100 design studies (aha_tpu_torch/studies/, the port of
   the TPU studies under scripts/), each through its entry point
   `main(["--quick"])` at the scripts' full geometry: the HBM read ceiling
   (stream_sum), the M = 8 GEMV and the argmax head over the (1024,
   151936) Qwen3 head, the three int4 kernels, and the one-launch layer
   over 28 layers; every kernel held to its plain version and timed beside
   it, its bound and its library yardstick;
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
6. quant — the same weights packed on the GGUF grids on the card
   (models/qwen3.pack_params, the head too): (j) a q8 and (k) a q4
   TextEngine, whose decode runs the quantized fused stack and whose short
   prompt's prefill runs the quant-matmul and fused-SwiGLU kernels, each
   also timed on the per-op chain; (l) a q4 BatchEngine of 8 slots under
   the (f) request mix; then (m) a Qwen3 GGUF file at full width and 4
   layers, written with the port's writer (token_embd Q8_0 tied, attention
   and gate/up Q4_K, ffn_down Q6_K), loaded with load_qwen3_gguf, 32 greedy
   tokens, and 8 teacher-forced steps through each decode path against the
   same steps on the CPU through the kernels' plain versions (the witness)
   and through the exact dequantized path; each path with the counters
   zeroed before it and its kernels launched;
7. HTTP — the bf16 weights saved as a checkpoint (embedding rows past the
   test tokenizer's vocabulary zeroed, so replies decode to text) and
   served by `python -m aha_tpu_torch serv` in a child process:
   non-stream, stream and a prefix-cache repeat of /v1/chat/completions;
   then a `--batch-slots 4` server answering 4 chats at once; the child
   runs under `-X importtime`, whose log must name no module of jax or
   aha_tpu;
8. vl — (n) Qwen2.5-VL-3B-Instruct's published geometry (vision tower 32
   blocks at hidden 1280, text decoder 36 layers at hidden 2048, vocab
   151936, tied) with seeded bf16 weights on the card, through TextEngine
   with the prefix store: (n1) a 448 x 448 image (1,024 patches, 256 image
   tokens) and (n2) a 980 x 980 one (4,900 patches in the 6,400 bucket,
   1,225 image tokens), 32 greedy tokens each, and (n3) a follow-up turn on
   (n2)'s image that restores its rows and rope_delta from the prefix
   store; the segment-flash, prefill and stacked-decode launch counters
   must rise 32 per image, 36 per prefill of ≥ 128 rows and 36 per decode
   step; then 8 teacher-forced steps at full width and reduced depth (8
   vision blocks, one of them full-attention, 4 text layers) against the
   f32 plain path on the CPU;
9. vl-http — that reduced-depth model saved as an HF-named checkpoint with
   the test tokenizer and the four vision special tokens, served by
   `python -m aha_tpu_torch serv` in a child process under `-X
   importtime` (no jax or aha_tpu module): one chat with a PNG data-URL
   image and one text-only chat.

Every serving path's run must leave the one-layer block's launch count at
0 (no model calls it, as in the JAX package), and the study kernels'
(their path is the studies phase).  Every kernel check also reads the
least time the card could take for the
same work (`bound_ms`: the larger of the bytes it must move over 3.35 TB/s
and its operations over the H100's peak for their type) and, where one
PyTorch call computes the same function, that call's time (`library_ms`;
timed here only, never called by the port).  Then one JSON line of
per-kernel results, the card line, and the last line {"ok": true,
"device": {...}}.  Imports nothing of JAX or aha_tpu.
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
# the quantized stack against its plain version at 28 layers, relative to max
# |ref| (one layer is held to TOL_FUSED_REL).  Its attention output differs
# from the plain one in f32 rounding (exp, split order), and so does the
# 4-bit dot, whose large n·s·sx·Σxq and xsum·b terms cancel: a value that
# lands across a .5 boundary requantizes one step apart and moves every
# column of the next product, and 28 layers of seeded random weights amplify
# that.  Measured on an H100: int8 at pos 0 bit-equal, at pos 1000 2.5e-2;
# with 4-bit grids ≤ 7.9e-2 (≤ 7.3e-3 at one layer); zeroed down scales
# are off by ≥ 0.58
TOL_FUSED_Q8_DEEP_REL = {"q8": 5e-2, "q4": 1.2e-1, "gguf": 1.2e-1}
# q8 decode vs its f32 plain version (the dequantizing fallback), max abs
# error relative to max |ref|, by variant (mxu False: cast, True: all-int8,
# which adds the requantization noise of q and p).  The inputs make the
# outputs O(1) (peaked scores), so a zero or unscaled output is off by ≥ 1.
# Measured on an H100 at these inputs: cast ≤ 2.8e-3 (the bf16 rounding of
# the output), all-int8 ≤ 4.1e-2 (1000 live rows; 1.5e-2 at 16000)
TOL_Q8_REL = {False: 6e-3, True: 8e-2}
# GGUF-grid kernels vs their f32 plain versions on the same bf16 inputs,
# relative to max |ref|: the matmuls round their output to bf16 (≤ 2^-8);
# the fused MLP also requantizes a = SiLU(g)·u, where an f32 rounding can
# move a rare value across a .5 boundary, one step of max|a_g|/127 · |w|
TOL_QMM_REL = 5e-3
TOL_SWIGLU_REL = 1e-2
# (m): the GGUF model's hidden states through the kernels on the card,
# relative to max |ref|, against (a) the witness: the same steps on the CPU
# in bf16 through the kernels' plain versions (the same activation
# quantization), which differs from the card by bf16 rounding and the rare
# activation a summation order moves across a .5 boundary; and (b) the
# exact path: f32 on the CPU with exactly dequantized weights, which
# differs by the activation quantization the kernels do (5.5e-2 and 6.5e-2
# of max |ref| measured over 4 layers on an H100 on the per-op chain)
TOL_GGUF_WITNESS_REL = 1e-1
TOL_GGUF_REL = 1e-1
# (n)'s teacher-forced steps (8 vision blocks, one full-attention, 4 text
# layers at full width): bf16 on the card through the kernels against f32
# on the CPU through the plain versions, max abs error of the hidden states
# relative to max |ref| (the bf16 rounding of every activation through 12
# blocks; the Qwen3 28-layer stack is held to TOL_HIDDEN_REL)
TOL_VL_HIDDEN_REL = 5e-2
# the segment kernel and the stacked-cache decode against their f32 plain
# versions on the same bf16 inputs, max abs error relative to max |ref|.
# The inputs make the outputs O(1) — q drawn 4x wide for the segment
# kernel, so each row's weight sits on a few keys; a planted key per kv
# head at the last live decode row carrying ~0.1-0.9 of every query head's
# weight — so the error is bf16 rounding (≤ 2^-8 of a value, of the output
# and, in the segment kernel, of the probabilities), while a k tile left
# off a block's list or a live length off by one moves some row by most of
# max |ref| (0.7-1.6 in the plain versions; each check plants that fault
# and requires its bound to reject it)
TOL_SEG_REL = 2e-2
TOL_DECODE_REL = 1e-2
# 28 chained launches of the one-layer kernel (each layer's rows written by
# the caller) against the fused stack's plain version, relative to max
# |ref|: the layer rounds its residual to bf16 twice per layer where the
# stack carries f32, 56 roundings of ≤ 2^-9 of a value through 28 layers
# of seeded random weights (each layer alone is held to TOL_FUSED_REL)
TOL_CHAIN_REL = 5e-2
# the study kernels (aha_tpu_torch/studies/) against their plain versions,
# each study's main() holding them as it runs: the block sum and the GEMVs
# within 1e-5 of max |ref| (f32 sums in another order; the block sum's total
# of every element within 1e-5 of Σ|w|), the argmax's index equal (or tied
# within 1e-5), the three int4 kernels bit-equal, the one-launch layer
# within 2^-7 of max |ref| (the bf16 roundings of its five folds)
TOL_STUDY = {"stream_sum": 1e-5, "gemv_m8": 1e-5, "gemv_argmax": 1e-5,
             "head_once": 1e-5, "i4_upcast": 0.0, "i4_tensorcore": 0.0,
             "i4_packed_k": 0.0, "fused_layer_stream": 2.0 ** -7}
#: the H100 SXM's published rates (NVIDIA data sheet, dense): HBM bytes/s,
#: operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

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
    "quant_matmul": dict(
        source="aha_tpu_torch/csrc/quant_matmul.cu",
        replaces="aha_tpu/ops/quant_matmul.py:262"),
    "quant_matmul_q4": dict(
        source="aha_tpu_torch/csrc/quant_matmul.cu",
        replaces="aha_tpu/ops/quant_matmul.py:341"),
    "quant_swiglu": dict(
        source="aha_tpu_torch/csrc/quant_swiglu.cu",
        replaces="aha_tpu/ops/quant_matmul.py:478"),
    "head_argmax_q8": dict(
        source="aha_tpu_torch/csrc/head_argmax.cu",
        replaces="aha_tpu/ops/lm_head.py:76"),
    "head_argmax_q4": dict(
        source="aha_tpu_torch/csrc/head_argmax.cu",
        replaces="aha_tpu/ops/lm_head.py:87"),
    "fused_decode_stack_q8": dict(
        source="aha_tpu_torch/csrc/fused_decode_stack_q8.cu",
        replaces="aha_tpu/ops/fused_layer.py:728"),
    "flash_attention_segmented": dict(
        source="aha_tpu_torch/csrc/segment_flash.cu",
        replaces="aha_tpu/ops/flash_attention.py:1171"),
    "flash_decode_at_layer": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:235"),
    "flash_decode": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:166"),
    "fused_decode_layer": dict(
        source="aha_tpu_torch/csrc/fused_decode_layer.cu",
        replaces="aha_tpu/ops/fused_layer.py:856"),
    # the TPU design studies under scripts/, ported as H100 studies
    "stream_sum": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:89"),
    "gemv_m8": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:132"),
    "gemv_argmax": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:188"),
    "head_once": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:220"),
    "i4_upcast": dict(
        source="aha_tpu_torch/csrc/study_int4.cu",
        replaces="scripts/exp_int4.py:101"),
    "i4_tensorcore": dict(
        source="aha_tpu_torch/csrc/study_int4.cu",
        replaces="scripts/exp_int4.py:128"),
    "i4_packed_k": dict(
        source="aha_tpu_torch/csrc/study_int4.cu",
        replaces="scripts/exp_int4.py:163"),
    "fused_layer_stream": dict(
        source="aha_tpu_torch/csrc/study_fused_layer.cu",
        replaces="scripts/exp_fused_layer.py:140"),
}
#: the study kernels: their path is the studies' own entry points
STUDY_KERNELS = tuple(TOL_STUDY)
#: kernels no model path runs (as in the JAX package): each serving path's
#: run must leave their counts at 0; the study kernels' main-path count is
#: the studies phase's
OFF_PATH = ("fused_decode_layer",) + STUDY_KERNELS
RESULTS: dict[str, dict] = {k: {"max_abs_err": 0.0, "library_ms": None}
                            for k in KERNELS}


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
    from aha_tpu_torch.ops import lm_head
    from aha_tpu_torch.ops import quant_matmul as qm
    from aha_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                               fused_decode_stack,
                                               fused_decode_stack_q8)
    from aha_tpu_torch.studies import exp_fused_layer, exp_gemv, exp_int4

    return {"flash_decode_at_layer_flat": fa.flash_decode_at_layer_flat,
            "head_argmax": lm_head.head_argmax,
            "flash_attention": fa.flash_attention,
            "fused_decode_stack": fused_decode_stack,
            "flash_decode_at_layer_flat_batched":
                fa.flash_decode_at_layer_flat_batched,
            "flash_decode_at_layer_q8": fa.flash_decode_at_layer_q8,
            "flash_decode_at_layer_q8_batched":
                fa.flash_decode_at_layer_q8_batched,
            "quant_matmul": qm.quant_matmul,
            "quant_matmul_q4": qm.quant_matmul_q4,
            "quant_swiglu": qm.quant_swiglu,
            "head_argmax_q8": lm_head.head_argmax_q8,
            "head_argmax_q4": lm_head.head_argmax_q4,
            "fused_decode_stack_q8": fused_decode_stack_q8,
            "flash_attention_segmented": fa.flash_attention_segmented,
            "flash_decode_at_layer": fa.flash_decode_at_layer,
            "flash_decode": fa.flash_decode,
            "fused_decode_layer": fused_decode_layer,
            "stream_sum": exp_gemv.stream_sum,
            "gemv_m8": exp_gemv.gemv_m8,
            "gemv_argmax": exp_gemv.gemv_argmax,
            "head_once": exp_gemv.head_once,
            "i4_upcast": exp_int4.i4_upcast,
            "i4_tensorcore": exp_int4.i4_tensorcore,
            "i4_packed_k": exp_int4.i4_packed_k,
            "fused_layer_stream": exp_fused_layer.fused_layer_stream}


def zero_counts() -> dict:
    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
    return wr


def read_counts(wr: dict, path: str, must: tuple[str, ...]) -> dict:
    """The counts of one path's run; each kernel in `must` launched, and
    its count recorded as the kernel's main-path launches."""
    launches = {name: fn.launches for name, fn in wr.items()}
    for name in OFF_PATH:
        if name in must:
            continue
        require(launches[name] == 0, f"{name} ran on the {path} path")
        RESULTS[name].setdefault("launches", 0)
        RESULTS[name].setdefault("launches_by_path", {})[path] = 0
    for name in must:
        require(launches[name] > 0,
                f"{name} was not launched on the {path} path")
        RESULTS[name]["launches"] = launches[name]
        RESULTS[name].setdefault("launches_by_path", {})[path] = \
            launches[name]
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


def bound(nbytes: float, ops: float = 0.0, kind: str = "bf16"
          ) -> tuple[float, str]:
    """The least time (ms) the card could take: the bytes the function
    must move (each input read once, each output written once) over the
    HBM rate, or its operations over the peak for their type, the larger;
    and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name: str, err: float, ms: float | None = None,
            plain_ms: float | None = None,
            bound_of: tuple[float, str] | None = None,
            library_ms: float | None = None, library: str | None = None,
            shape: str | None = None) -> None:
    """Keep the worst error of every check of `name`; a timed check also
    sets its times, its bound (bound_ms, bound_by) and the library call's
    time, all at the shape it names."""
    r = RESULTS[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if ms is not None:
        r["ms"], r["plain_ms"] = ms, plain_ms
        r["bound_ms"], r["bound_by"] = bound_of
        r["library_ms"] = library_ms
        if library is not None:
            r["library"] = library
        r["timed_at"] = shape


def _sdpa(q, k, v, **kw):
    """F.scaled_dot_product_attention on (B, H, S, D) tensors: the
    library yardstick of the attention kernels (the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


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
    b = bound(nbytes + 2 * Hq * D * 2, 4 * Hq * valid * D)
    lib_ms = None
    if timed:
        # the library call on the live rows of every layer, laid out
        # (B, H, S, D) beforehand
        kv = [(k[li, :, :valid].reshape(1, valid, Hkv, D).transpose(1, 2)
               .contiguous(), v[li, :, :valid].reshape(1, valid, Hkv, D)
               .transpose(1, 2).contiguous()) for li in range(L)]
        qt = q.transpose(1, 2).contiguous()
        it = iter(range(10 ** 9))
        lib_ms = device_ms(lambda: _sdpa(qt, *kv[next(it) % L]), iters=56)
        del kv
    log(f"[kernels] decode L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}:"
        f" max_abs_err {err:.3e} (tol {TOL_ATTN}); device ms/call kernel"
        f" {ms:.4f} plain {plain_ms:.4f}"
        + (f" sdpa {lib_ms:.4f}" if lib_ms else "")
        + f"; bound {b[0]:.4f} ({b[1]}); {nbytes / ms / 1e6:.1f} GB/s of"
        f" live rows")
    del k, v
    torch.cuda.empty_cache()
    if timed:
        _record("flash_decode_at_layer_flat", err, ms, plain_ms, b, lib_ms,
                "F.scaled_dot_product_attention over the live rows",
                f"L={L} S={S} valid={valid}")
    else:
        _record("flash_decode_at_layer_flat", err)


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
        got = int(head_argmax({"w": w}, h))
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
    require(int(head_argmax({"w": wt}, e0)) == 37
            == int(head_argmax_plain(wt, e0)),
            "planted tie did not go to the smaller index")
    # a NaN hidden state: the plain fast_argmax rule, index V - 1
    hn = torch.full((1, K), float("nan"), **bf)
    require(int(head_argmax({"w": w}, hn)) == V - 1
            == int(head_argmax_plain(w, hn)),
            "a NaN row did not give V - 1")
    h = torch.randn((1, 1, K), generator=g, **bf)
    ms = device_ms(lambda: head_argmax({"w": w}, h))
    plain_ms = device_ms(lambda: head_argmax_plain(w, h))
    hv = h.reshape(K)
    lib_ms = device_ms(lambda: torch.matmul(w, hv))
    b = bound(V * K * 2 + K * 2, 2 * V * K)
    log(f"[kernels] head_argmax K={K} V={V}: {mismatches} index mismatches "
        f"in 4 random rows (worst logit gap {worst:.3e}), planted tie and NaN "
        f"row agree; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
        f"torch.matmul GEMV alone {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
    # the kernel returns an index: its "error" is the logit gap between its
    # index and the plain one (0 when they agree)
    _record("head_argmax", worst, ms, plain_ms, b, lib_ms,
            "torch.matmul GEMV alone (the logits, no argmax)",
            f"K={K} V={V}")
    RESULTS["head_argmax"].update(
        index_mismatches=mismatches,
        max_abs_err_of="logit gap between kernel and plain argmax")


def check_prefill(S: int, causal: bool, timed: bool, Hkv: int = 8,
                  record: bool = False) -> None:
    """The prefill kernel against its f32 plain version: Hkv 8 is
    Qwen3-0.6B's 16/8 heads, Hkv 2 Qwen2.5-VL-3B's 16/2 (G = 8).  Timed:
    device time of kernel, plain and sdpa; `record` makes it the kernel's
    row of the JSON line, other timed shapes go to its `also_timed`."""
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    Hq, D = 16, 128
    g = torch.Generator(device="cuda").manual_seed(S + causal + Hkv)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, S, Hq, D), generator=g, **bf)
    k = torch.randn((1, S, Hkv, D), generator=g, **bf)
    v = torch.randn((1, S, Hkv, D), generator=g, **bf)
    got = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    del ref
    require(err <= TOL_ATTN,
            f"prefill S={S} causal={causal} Hkv={Hkv}: err {err}")
    line = (f"[kernels] prefill S={S} causal={causal} Hq={Hq} Hkv={Hkv} "
            f"D={D}: max_abs_err {err:.3e} (tol {TOL_ATTN})")
    _record("flash_attention", err)
    if timed:
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal))
        plain_ms = device_ms(lambda: flash_attention_plain(q, k, v,
                                                           causal=causal),
                             iters=10)
        pairs = S * (S + 1) // 2 if causal else S * S
        b = bound(S * (2 * Hq + 2 * Hkv) * D * 2, 4 * Hq * pairs * D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, is_causal=causal))
        line += (f"; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
                 f"sdpa {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
                 f"{4 * Hq * pairs * D / ms / 1e9:.1f} TFLOP/s")
        shape = f"S={S} causal={causal} Hq={Hq} Hkv={Hkv}"
        if record:
            _record("flash_attention", err, ms, plain_ms, b, lib_ms,
                    "F.scaled_dot_product_attention", shape)
        else:
            RESULTS["flash_attention"].setdefault("also_timed", []).append(
                {"at": shape, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b[0], "library_ms": lib_ms})
    log(line)


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


def _q8_err(got: torch.Tensor, ref: torch.Tensor, mxu: bool, what: str,
            rel: dict) -> float:
    """Holds `got` to TOL_Q8_REL[mxu]; keeps the worst relative error per
    variant in `rel`; returns the max abs error."""
    r = _rel(got, ref)
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
    """Both q8 variants at B = 1 against the plain version, a repeat
    bit-equal; device time of each over the 28 layers in turn, its bound,
    and the bytes/s of the live rows."""
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
            again = flash_decode_at_layer_q8(q, k, v, ks, vs, lt, vl,
                                             mxu=mxu)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"q8 S={S} valid={valid} mxu={mxu}: a repeat differs")
            err = max(err, _q8_err(got, ref, mxu, f"q8 S={S} valid={valid}",
                                   rel))
    # the bound tells a wrong output from a right one: zeros, and the
    # output of a kernel that forgot the v scales, both fail it
    unscaled = flash_decode_at_layer_q8_plain(
        q.float(), k, v, ks, torch.ones_like(vs), lt, vl)
    bad = {"zeros": _rel(torch.zeros_like(ref), ref),
           "v unscaled": _rel(unscaled, ref)}
    require(min(bad.values()) > max(TOL_Q8_REL.values()),
            f"q8 bound does not reject a wrong output: {bad}")
    for mxu in (False, True):
        ms[mxu] = device_ms(lambda: flash_decode_at_layer_q8(
            q, k, v, ks, vs, layer(), vl, mxu=mxu), iters=56)
    plain_ms = device_ms(lambda: flash_decode_at_layer_q8_plain(
        q, k, v, ks, vs, layer(), vl), iters=28)
    nbytes = valid * Hkv * (D + 4) * 2          # int8 rows + f32 scales
    b = bound(nbytes + 2 * 16 * D * 2, 4 * 16 * valid * D)
    log(f"[kernels] q8 decode L={L} S={S} valid={valid} Hq=16 Hkv={Hkv} "
        f"D={D}: err of max |ref| cast {rel[False]:.3e} int8 "
        f"{rel[True]:.3e} (tol {TOL_Q8_REL[False]}/{TOL_Q8_REL[True]}; "
        f"zeros {bad['zeros']:.3g}, v unscaled {bad['v unscaled']:.3g}), "
        f"max_abs_err {err:.3e}, a repeat bit-equal; device ms/call cast "
        f"{ms[False]:.4f} int8 {ms[True]:.4f} plain {plain_ms:.4f}; bound "
        f"{b[0]:.4f} ({b[1]}); {nbytes / ms[True] / 1e6:.1f} GB/s (int8) of "
        f"live rows")
    if timed:
        _record("flash_decode_at_layer_q8", err, ms[True], plain_ms, b, None,
                None, f"L={L} S={S} valid={valid} all-int8")
        RESULTS["flash_decode_at_layer_q8"]["ms_cast_variant"] = ms[False]
    else:
        _record("flash_decode_at_layer_q8", err)
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
    live = sum(RAGGED)
    b = bound(live * Hkv * D * 2 * 2 + 2 * B * 16 * D * 2,
              4 * 16 * live * D)
    # the library call: one masked attention over each slot's whole cache
    mask = (torch.arange(S, device="cuda")[None, :]
            < vl[:, None]).reshape(B, 1, 1, S)
    qt = q.transpose(1, 2).contiguous()
    kv = [(k[li].reshape(B, S, Hkv, D).transpose(1, 2).contiguous(),
           v[li].reshape(B, S, Hkv, D).transpose(1, 2).contiguous())
          for li in range(L)]
    it = iter(range(10 ** 9))
    lib_ms = device_ms(lambda: _sdpa(qt, *kv[next(it) % L], attn_mask=mask),
                       iters=56)
    del kv
    log(f"[kernels] batched decode L={L} B={B} S={S} lengths {RAGGED}: "
        f"max_abs_err {err:.3e} (tol {TOL_ATTN}), each slot bit-equal to a "
        f"B = 1 launch; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
        f"masked sdpa {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
    if timed:
        _record("flash_decode_at_layer_flat_batched", err, ms, plain_ms, b,
                lib_ms, "F.scaled_dot_product_attention, a per-slot length "
                "mask over the whole cache", f"L={L} B={B} S={S} ragged")
    else:
        _record("flash_decode_at_layer_flat_batched", err)
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
            again = fa.flash_decode_at_layer_q8_batched(q, k, v, ks, vs, lt,
                                                        vl, mxu=mxu)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"q8 batched mxu={mxu}: a repeat differs")
            err = max(err, _q8_err(got, ref, mxu, "q8 batched", rel))
            for b in range(B):
                one = fa.flash_decode_at_layer_q8(
                    q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                    v[:, b:b + 1].contiguous(), ks[:, b:b + 1].contiguous(),
                    vs[:, b:b + 1].contiguous(), lt,
                    vl[b:b + 1].contiguous(), mxu=mxu)
                require(torch.equal(one, got[b:b + 1]),
                        f"q8 batched mxu={mxu}: slot {b} differs from a "
                        "B = 1 launch")
    ms = {mxu: device_ms(lambda: fa.flash_decode_at_layer_q8_batched(
        q, k, v, ks, vs, layer(), vl, mxu=mxu), iters=56)
        for mxu in (False, True)}
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_q8_plain(
        q, k, v, ks, vs, layer(), vl), iters=28)
    b8 = bound(live * Hkv * (D + 4) * 2 + 2 * B * 16 * D * 2,
               4 * 16 * live * D)
    log(f"[kernels] q8 batched decode L={L} B={B} S={S} lengths {RAGGED}: "
        f"err of max |ref| cast {rel[False]:.3e} int8 {rel[True]:.3e} (tol "
        f"{TOL_Q8_REL[False]}/{TOL_Q8_REL[True]}), max_abs_err {err:.3e}, "
        f"each slot bit-equal to a B = 1 launch and to a repeat; "
        f"device ms/call cast {ms[False]:.4f} "
        f"int8 {ms[True]:.4f} plain {plain_ms:.4f}; bound {b8[0]:.4f} "
        f"({b8[1]})")
    if timed:
        _record("flash_decode_at_layer_q8_batched", err, ms[True], plain_ms,
                b8, None, None,
                f"L={L} B={B} S={S} ragged all-int8")
    else:
        _record("flash_decode_at_layer_q8_batched", err)
    if timed:
        RESULTS["flash_decode_at_layer_q8_batched"]["ms_cast_variant"] = \
            ms[False]
    del k, v, ks, vs
    torch.cuda.empty_cache()


#: Qwen3-0.6B's fused decode projections (in, out): q|k|v, o, gate|up, down
PROJECTIONS = {"qkv": (1024, 4096), "o": (2048, 1024),
               "gateup": (1024, 6144), "down": (3072, 1024)}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _pack(g, n: int, k: int, grid: str, scale: float = 0.02) -> dict:
    from aha_tpu_torch.ops.quant_matmul import pack_rows

    w = torch.randn((n, k), generator=g, device="cuda") * scale
    if grid == "q4":
        w += 0.25 * scale        # the 4-bit grid's min term matters
    return pack_rows(w, grid == "q4")


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def check_quant_matmul(grid: str) -> None:
    """The int8 or 4-bit matmul at the four projections of Qwen3-0.6B (M =
    1, 8, 64) and the head logits of BatchEngine's step (M = 8, N =
    151936), each against the f32 plain version on the same bf16 inputs
    within TOL_QMM_REL of max |ref|; zeroed scales (q8) or a dropped
    xsum·b term (q4) fail that bound; a repeat bit-equal, and each row of
    the M = 8 launch bit-equal to an M = 1 launch of that row alone.
    Device time of kernel and plain at M = 1 and 8 of each projection and
    at the head (M = 8); `quant_matmul[_q4]_timings` keeps them all."""
    from aha_tpu_torch.ops import quant_matmul as qm

    name = "quant_matmul_q4" if grid == "q4" else "quant_matmul"
    fn = getattr(qm, name)
    plain = getattr(qm, name + "_plain")
    keys = qm.GRID_KEYS[grid]
    g = torch.Generator(device="cuda").manual_seed(21 + len(grid))
    shapes = [(proj, k, n, m) for proj, (k, n) in PROJECTIONS.items()
              for m in (1, 8, 64)] + [("head", 1024, 151936, 8)]
    worst, worst_bad = 0.0, float("inf")
    timings = RESULTS[name].setdefault("timings", {})
    for proj, K, N, M in shapes:
        p = _pack(g, N, K, grid)
        args = [p[k] for k in keys]
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        got = fn(x, *args)
        again = fn(x, *args)
        ref = plain(x.float(), *args)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"{name} {proj} M={M}: a repeat "
                f"is not bit-equal")
        if M == 8:
            for r in range(M):
                require(torch.equal(got[r], fn(x[r:r + 1], *args)[0]),
                        f"{name} {proj}: row {r} of M=8 differs from M=1")
        err = _rel(got, ref)
        require(err <= TOL_QMM_REL, f"{name} {proj} M={M}: err {err} of "
                f"max |ref| (tol {TOL_QMM_REL})")
        worst = max(worst, err)
        _record(name, (got.float() - ref).abs().max().item())
        if grid == "q8":
            bad = plain(x.float(), args[0], torch.zeros_like(args[1]))
        else:
            bad = plain(x.float(), *args[:2], torch.zeros_like(args[2]))
        worst_bad = min(worst_bad, _rel(bad, ref))
        if M in (1, 8):
            wbytes = _nbytes(p)
            ms = device_ms(lambda: fn(x, *args))
            plain_ms = device_ms(lambda: plain(x, *args), iters=5)
            b = bound(wbytes + M * K * 2 + M * N * 2, 2 * M * N * K, "int8")
            log(f"[kernels] {name} {proj} M={M} K={K} N={N}: err {err:.3e} "
                f"of max |ref|; device ms/call kernel {ms:.4f} plain "
                f"{plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
                f"{wbytes / ms / 1e6:.1f} GB/s of weights")
            timings[f"{proj} M={M}"] = {"ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": b[0]}
            if proj == "qkv" and M == 1:
                _record(name, 0.0, ms, plain_ms, b, None, None,
                        f"q|k|v M=1 K={K} N={N}")
        del p, args
    require(worst_bad > TOL_QMM_REL, f"{name}: the bound does not reject "
            f"{'zeroed scales' if grid == 'q8' else 'a dropped xsum*b'}")
    log(f"[kernels] {name}: {len(shapes)} shapes within {worst:.3e} of max "
        f"|ref| (tol {TOL_QMM_REL}), repeats and M=8 rows against M=1 "
        f"bit-equal; "
        f"{'zeroed scales' if grid == 'q8' else 'dropped xsum*b term'} off "
        f"by ≥ {worst_bad:.3g}")
    torch.cuda.empty_cache()


def check_quant_swiglu() -> None:
    """The fused quantized MLP at Qwen3-0.6B's widths (H 1024, I 3072) in
    all four grid pairs at M = 1 and 8, against the f32 plain version
    within TOL_SWIGLU_REL of max |ref|; zeroed down scales fail the bound;
    a repeat bit-equal, and each row of M = 8 bit-equal to M = 1 of that
    row alone.  Device time at M = 1 of each pair and at M = 8 of q8/q8
    and q4/q4 (`quant_swiglu_timings`)."""
    from aha_tpu_torch.ops import quant_matmul as qm

    H, I = 1024, 3072
    g = torch.Generator(device="cuda").manual_seed(31)
    worst, worst_bad = 0.0, float("inf")
    timings = RESULTS["quant_swiglu"].setdefault("timings", {})
    for gu_fmt in ("q8", "q4"):
        for dn_fmt in ("q8", "q4"):
            gu = _pack(g, 2 * I, H, gu_fmt)
            dn = _pack(g, H, I, dn_fmt)
            for M in (1, 8):
                x = torch.randn((1, M, H), generator=g, device="cuda").to(
                    torch.bfloat16)
                got = qm.quant_swiglu(gu, dn, x)
                again = qm.quant_swiglu(gu, dn, x)
                ref = qm.quant_swiglu_plain(gu, dn, x.reshape(M, H).float())
                torch.cuda.synchronize()
                require(torch.equal(got, again), f"quant_swiglu {gu_fmt}/"
                        f"{dn_fmt} M={M}: a repeat is not bit-equal")
                for r in range(M if M > 1 else 0):
                    one = qm.quant_swiglu(gu, dn, x[:, r:r + 1].contiguous())
                    require(torch.equal(got[0, r], one[0, 0]),
                            f"quant_swiglu {gu_fmt}/{dn_fmt}: row {r} of "
                            f"M=8 differs from M=1")
                err = _rel(got.reshape(M, H), ref)
                require(err <= TOL_SWIGLU_REL, f"quant_swiglu {gu_fmt}/"
                        f"{dn_fmt} M={M}: err {err} (tol {TOL_SWIGLU_REL})")
                worst = max(worst, err)
                _record("quant_swiglu", (got.reshape(M, H).float() - ref)
                        .abs().max().item())
                zeroed = {k: torch.zeros_like(v) if k in ("st", "s4") else v
                          for k, v in dn.items()}
                worst_bad = min(worst_bad, _rel(qm.quant_swiglu_plain(
                    gu, zeroed, x.reshape(M, H).float()), ref))
            for M in ((1, 8) if gu_fmt == dn_fmt else (1,)):
                x = torch.randn((1, M, H), generator=g, device="cuda").to(
                    torch.bfloat16)
                ms = device_ms(lambda: qm.quant_swiglu(gu, dn, x))
                plain_ms = device_ms(lambda: qm.quant_swiglu_plain(
                    gu, dn, x.reshape(M, H)), iters=5)
                wbytes = _nbytes(gu) + _nbytes(dn)
                b = bound(wbytes + 2 * M * H * 2,
                          2 * M * (2 * I * H + H * I), "int8")
                log(f"[kernels] quant_swiglu {gu_fmt}/{dn_fmt} M={M} H={H} "
                    f"I={I}: device ms/call kernel {ms:.4f} plain "
                    f"{plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
                    f"{wbytes / ms / 1e6:.1f} GB/s of weights")
                timings[f"{gu_fmt}/{dn_fmt} M={M}"] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0]}
                if gu_fmt == dn_fmt == "q8" and M == 1:
                    _record("quant_swiglu", 0.0, ms, plain_ms, b, None, None,
                            f"q8/q8 M=1 H={H} I={I}")
    require(worst_bad > TOL_SWIGLU_REL,
            "quant_swiglu: the bound does not reject zeroed down scales")
    log(f"[kernels] quant_swiglu: 4 grid pairs x M in (1, 8) within "
        f"{worst:.3e} of max |ref| (tol {TOL_SWIGLU_REL}), repeats and M=8 "
        f"rows against M=1 bit-equal; zeroed down "
        f"scales off by ≥ {worst_bad:.3g}")
    torch.cuda.empty_cache()


def check_quant_heads() -> None:
    """The int8 and 4-bit greedy heads at Qwen3-0.6B's vocabulary: each
    random row's index equal to the plain version's or tied with it within
    TOL_HEAD_REL of max |logit|; a tie planted across blocks goes to the
    smaller index; a NaN row gives V − 1; zeroed scales change the index."""
    from aha_tpu_torch.ops import lm_head
    from aha_tpu_torch.ops.quant_matmul import pack_rows, qdot, quant_acts

    K, V = 1024, 151936
    g = torch.Generator(device="cuda").manual_seed(41)
    for grid in ("q8", "q4"):
        name = f"head_argmax_{grid}"
        p = _pack(g, V, K, grid)
        worst, mismatches, moved = 0.0, 0, 0
        for _ in range(4):
            h = torch.randn((1, 1, K), generator=g, device="cuda").to(
                torch.bfloat16)
            got = int(lm_head.head_argmax(p, h))
            ref = int(lm_head.quant_head_plain(p, h))
            if got != ref:
                logits = qdot(p, *quant_acts(h.reshape(1, K).float(), K))[0]
                gap = abs(logits[got] - logits[ref]).item()
                require(gap <= TOL_HEAD_REL * logits.abs().max().item(),
                        f"{name} {got} vs plain {ref}: logit gap {gap}")
                worst = max(worst, gap)
                mismatches += 1
            zeroed = {k: torch.zeros_like(v) if k in ("st", "s4", "b4") else v
                      for k, v in p.items()}
            moved += int(lm_head.quant_head_plain(zeroed, h)) != ref
        require(moved > 0, f"{name}: zeroed scales kept every index")
        wt = torch.zeros((V, K), device="cuda")
        wt[70000, :4] = wt[37, :4] = 1.0
        wt[5000, :4] = 0.5
        e0 = torch.zeros((1, K), dtype=torch.bfloat16, device="cuda")
        e0[0, :4] = 1.0
        pt = pack_rows(wt, grid == "q4")
        require(int(lm_head.head_argmax(pt, e0)) == 37
                == int(lm_head.quant_head_plain(pt, e0)),
                f"{name}: planted tie did not go to the smaller index")
        hn = torch.full((1, K), float("nan"), dtype=torch.bfloat16,
                        device="cuda")
        require(int(lm_head.head_argmax(p, hn)) == V - 1
                == int(lm_head.quant_head_plain(p, hn)),
                f"{name}: a NaN row did not give V - 1")
        h = torch.randn((1, 1, K), generator=g, device="cuda").to(
            torch.bfloat16)
        ms = device_ms(lambda: lm_head.head_argmax(p, h))
        plain_ms = device_ms(lambda: lm_head.quant_head_plain(p, h), iters=5)
        wbytes = _nbytes(p)
        b = bound(wbytes + K * 2, 2 * V * K, "int8")
        log(f"[kernels] {name} K={K} V={V}: {mismatches} index mismatches in "
            f"4 random rows (worst logit gap {worst:.3e}), zeroed scales moved "
            f"{moved}/4, planted tie and NaN row agree; device ms/call kernel "
            f"{ms:.4f} plain {plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
            f"{wbytes / ms / 1e6:.1f} GB/s of weights")
        _record(name, worst, ms, plain_ms, b, None, None, f"K={K} V={V}")
        RESULTS[name].update(
            index_mismatches=mismatches,
            max_abs_err_of="logit gap between kernel and plain argmax")
        del p
    torch.cuda.empty_cache()


#: the grids of (q|k|v, o, gate|up, down) the quantized stack is checked on:
#: one grid throughout, and the mix of a Q4_K file (Q6_K ffn_down → int8)
STACK_GRIDS = {"q8": ("q8",) * 4, "q4": ("q4",) * 4,
               "gguf": ("q4", "q4", "q4", "q8")}


def check_stack(pos: int, n_layers: int, grids: str, timed: bool) -> None:
    """A fused decode stack over `n_layers` of Qwen3-0.6B's layers (seeded
    bf16 weights as the engine phase makes them; with `grids` in
    STACK_GRIDS packed on those grids for the quantized stack, with "bf16"
    left dense for the bf16 one), a 2048-row cache with random rows, the
    token at `pos`: hidden state and the written cache rows against the
    plain version (f32, the same bf16 inputs); rows other than `pos`
    untouched; a repeat bit-equal; on the grids, zeroed down scales fail
    the bound.  Timed: device ms, the bound and GB/s of weights."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops import fused_layer
    from aha_tpu_torch.studies.stack_parts import pack_layers

    quant = grids != "bf16"
    name = "fused_decode_stack_q8" if quant else "fused_decode_stack"
    kernel = getattr(fused_layer, name)
    plain = getattr(fused_layer, name + "_plain")
    cfg = Qwen3Config(num_hidden_layers=n_layers)
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(
        (13 if quant else 11) + pos)
    lyr = fuse_decode_params(model.init_random(g, dtype=torch.bfloat16))[
        "layers"]
    if quant:
        lyr = pack_layers(lyr, STACK_GRIDS[grids])
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
    got = kernel(x, lyr, p, cos, sin, k, v, eps)
    again = kernel(x, lyr, p, cos, sin, k, v, eps)     # rewrites row pos alike
    ref = plain(x, lyr, p, cos, sin, kp, vp, eps)
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{name} {grids} L={n_layers} pos={pos}: "
            "a repeat is not bit-equal")
    err_x = _rel(got, ref)
    err_kv = max(_rel(k[:, 0, pos], kp[:, 0, pos]),
                 _rel(v[:, 0, pos], vp[:, 0, pos]))
    keep = torch.arange(S, device="cuda") != pos
    require(torch.equal(k[:, :, keep], kp[:, :, keep])
            and torch.equal(v[:, :, keep], vp[:, :, keep]),
            f"{name} touched cache rows other than pos")
    tol = (TOL_FUSED_REL if not quant or n_layers == 1
           else TOL_FUSED_Q8_DEEP_REL[grids])
    require(err_x <= tol and err_kv <= tol,
            f"{name} {grids} L={n_layers} pos={pos}: hidden err {err_x}, "
            f"cache-row err {err_kv} of max |ref| (tol {tol})")
    abs_err = (got.float() - ref.float()).abs().max().item()
    line = (f"[kernels] {name} {grids} L={n_layers} H={cfg.hidden_size} "
            f"pos={pos} (cache 2048): hidden err {err_x:.3e}, cache-row err "
            f"{err_kv:.3e} of max |ref| (tol {tol}); max_abs_err "
            f"{abs_err:.3e}; a repeat bit-equal")
    if quant:
        dn = lyr["mlp"]["down"]
        zeroed = {**lyr, "mlp": {**lyr["mlp"], "down": {
            key: torch.zeros_like(t) if key in ("st", "s4") else t
            for key, t in dn.items()}}}
        err_bad = _rel(plain(x, zeroed, p, cos, sin, kp.clone(), vp.clone(),
                             eps), ref)
        require(err_bad > tol, f"{name}: zeroed down scales pass ({err_bad})")
        line += f"; {STACK_GRIDS[grids]}, zeroed down scales {err_bad:.3g}"
    if timed:
        ms = device_ms(lambda: kernel(x, lyr, p, cos, sin, k, v, eps),
                       iters=20)
        plain_ms = device_ms(lambda: plain(x, lyr, p, cos, sin, kp, vp, eps),
                             iters=3, warmup=1)
        wbytes = _nbytes(lyr)
        live = pos * n_layers * HD * 2 * 2          # K and V rows read
        attn_ops = 4 * cfg.num_attention_heads * pos * cfg.head_dim * n_layers
        if quant:
            weights = sum(t.numel() * (2 if t.dtype == torch.uint8 else 1)
                          for t in _leaves(lyr) if not t.is_floating_point())
            b = bound(wbytes + live, 2 * weights + attn_ops, "int8")
        else:
            b = bound(wbytes + live,
                      2 * sum(t.numel() for t in _leaves(lyr)) + attn_ops)
        line += (f"; device ms/call kernel {ms:.4f} plain {plain_ms:.4f}; "
                 f"bound {b[0]:.4f} ({b[1]}); {wbytes / ms / 1e6:.1f} GB/s "
                 f"of weights")
        if grids in ("bf16", "q8"):
            _record(name, abs_err, ms, plain_ms, b, None, None,
                    f"{grids} L={n_layers} pos={pos}")
            RESULTS[name]["weight_gb_s"] = wbytes / ms / 1e6
    _record(name, abs_err)
    log(line)
    del lyr, k, v, kp, vp
    torch.cuda.empty_cache()

def check_fused_layer() -> None:
    """The one-layer fused decode block (no model path runs it) at
    Qwen3-0.6B's widths, 28 stacked layers of seeded bf16 weights, a
    2048-row cache, pos 1000, window 2048: layers 0 and 27 against the
    plain version (x_out, k_row, v_row within TOL_FUSED_REL of max |ref|),
    the caches untouched; then 28 chained launches, the caller writing each
    layer's rows, against the fused stack's plain version (TOL_CHAIN_REL).
    Device time per call over the 28 layers in turn (one layer's 31.5 MB of
    weights fits the 50 MB L2; cycling reads HBM as a step would)."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                               fused_decode_layer_plain,
                                               fused_decode_stack_plain)

    L, pos, window, S = 28, 1000, 2048, 2048
    cfg = Qwen3Config(num_hidden_layers=L)
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(56)
    lyr = fuse_decode_params(model.init_random(g, dtype=torch.bfloat16))[
        "layers"]
    H, D = cfg.hidden_size, cfg.head_dim
    HD = cfg.num_key_value_heads * D
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn((1, 1, H), generator=g, **bf)
    k = torch.randn((L, 1, S, HD), generator=g, **bf)
    v = torch.randn((L, 1, S, HD), generator=g, **bf)
    k0, v0 = k.clone(), v.clone()
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    cos = torch.cat([model.cos[pos], model.cos[pos]])[None]
    sin = torch.cat([model.sin[pos], model.sin[pos]])[None]
    eps = cfg.rms_norm_eps
    rel, err = 0.0, 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fused_decode_layer(x, lyr, lt, p, cos, sin, k, v, window, eps)
        ref = fused_decode_layer_plain(x, lyr, lt, p, cos, sin, k, v, window,
                                       eps)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            rel = max(rel, _rel(a, b))
            err = max(err, (a.float() - b.float()).abs().max().item())
    require(rel <= TOL_FUSED_REL, f"fused_decode_layer: err {rel} of max "
            f"|ref| (tol {TOL_FUSED_REL})")
    require(torch.equal(k, k0) and torch.equal(v, v0),
            "fused_decode_layer wrote the cache")
    # the chain: L launches, the caller writing each layer's rows at pos
    layers = [torch.tensor(i, dtype=torch.int32, device="cuda")
              for i in range(L)]
    h = x
    for li in range(L):
        h, kr, vr = fused_decode_layer(h, lyr, layers[li], p, cos, sin, k0,
                                       v0, window, eps)
        k0[li, 0, pos] = kr.reshape(HD)
        v0[li, 0, pos] = vr.reshape(HD)
    want = fused_decode_stack_plain(x, lyr, p, cos, sin, k, v, eps)
    torch.cuda.synchronize()
    rel_chain = _rel(h, want)
    rel_rows = max(_rel(k0[:, 0, pos], k[:, 0, pos]),
                   _rel(v0[:, 0, pos], v[:, 0, pos]))
    require(rel_chain <= TOL_CHAIN_REL and rel_rows <= TOL_CHAIN_REL,
            f"28 chained fused_decode_layer launches vs the stack: hidden "
            f"{rel_chain}, rows {rel_rows} of max |ref| (tol {TOL_CHAIN_REL})")
    del k0, v0
    layer = _layer_cycle(L)
    ms = device_ms(lambda: fused_decode_layer(x, lyr, layer(), p, cos, sin,
                                              k, v, window, eps), iters=56)
    plain_ms = device_ms(lambda: fused_decode_layer_plain(
        x, lyr, layer(), p, cos, sin, k, v, window, eps), iters=28)
    rows = min(pos, window)
    wbytes = _nbytes(lyr) // L
    b = bound(wbytes + rows * HD * 2 * 2 + 2 * H * 2 + 2 * HD * 2,
              2 * sum(t.numel() for t in _leaves(lyr)) // L
              + 4 * cfg.num_attention_heads * rows * D)
    log(f"[kernels] fused_decode_layer L={L} H={H} pos={pos} window={window}"
        f": err {rel:.3e} of max |ref| (tol {TOL_FUSED_REL}), max_abs_err "
        f"{err:.3e}, caches untouched; 28 chained launches vs the stack's "
        f"plain version: hidden {rel_chain:.3e}, rows {rel_rows:.3e} (tol "
        f"{TOL_CHAIN_REL}); device ms/call kernel {ms:.4f} plain "
        f"{plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
        f"{wbytes / ms / 1e6:.1f} GB/s of weights")
    _record("fused_decode_layer", err, ms, plain_ms, b, None, None,
            f"one of L={L} layers, pos={pos} window={window}")
    RESULTS["fused_decode_layer"].update(rel_err=rel, chain_rel_err=rel_chain)
    del lyr, k, v
    torch.cuda.empty_cache()


#: (n2)'s patch bucket: 4,900 patches of a 980 x 980 image, 1,500 pad rows
VL_BUCKET, VL_GRID, VL_REAL = 6400, (1, 70, 70), 4900


def vl_segments() -> dict[str, np.ndarray]:
    """The window and full-image seg ids of (n2)'s bucket (the published
    tower's 112-pixel windows over 70 x 70 patches), pad rows −1."""
    from aha_tpu_torch.models.qwen2_5vl import VisionConfig, vision_geometry

    geo = vision_geometry([VL_GRID], VisionConfig())
    pad = -np.ones(VL_BUCKET - VL_REAL, np.int32)
    return {"window": np.concatenate([geo["window_seg"], pad]),
            "full": np.concatenate([geo["full_seg"], pad])}


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, the same relative to max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.abs().max().item()


def check_segmented() -> None:
    """The segment kernel at (n2)'s shape (S 6400, H 16, D 80), q/k/v the
    strided thirds of one fused qkv product as the tower hands them, once
    with the window segments and once with the full-image one: error
    against the f32 plain version on every row (pad rows give 0), within
    TOL_SEG_REL of max |ref|; a planted fault — the k tile of rows
    2816-2879, which a window straddles, hidden from every other row, as a
    block that left it off its list would — must break that bound; a
    repeat is bit-equal.  Then device time of kernel and
    plain, the bound, and F.scaled_dot_product_attention with the boolean
    (S, S) mask (timed only)."""
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops.attention import segment_mask

    S, H, D, R = VL_BUCKET, 16, 80, VL_REAL
    g = torch.Generator(device="cuda").manual_seed(80)
    qkv = torch.randn((1, S, 3, H, D), generator=g, device="cuda")
    qkv[:, :, 0] *= 4                       # peaked scores: O(1) outputs
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t0 = 44 * 64
    outside = torch.ones(S, dtype=torch.bool, device="cuda")
    outside[t0:t0 + 64] = False
    for kind, seg_np in vl_segments().items():
        seg = torch.from_numpy(seg_np).cuda()
        got = fa.flash_attention_segmented(q, k, v, seg)
        again = fa.flash_attention_segmented(q, k, v, seg)
        ref = fa.flash_attention_segmented_plain(q.float(), k.float(),
                                                 v.float(), seg)
        hidden = seg.clone()
        hidden[t0:t0 + 64] = 1 << 30        # a seg no other row has
        bad = fa.flash_attention_segmented(q, k, v, hidden)
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"segmented {kind}: a repeat is not bit-equal")
        err, rel = _rel_err(got, ref)
        _, rel_bad = _rel_err(bad[:, outside], ref[:, outside])
        require(rel <= TOL_SEG_REL,
                f"segmented {kind}: err {rel} of max |ref|")
        require(rel_bad > TOL_SEG_REL, f"segmented {kind}: a hidden k tile "
                f"stays within the bound ({rel_bad} of max |ref|)")
        ms = device_ms(lambda: fa.flash_attention_segmented(q, k, v, seg))
        # the real rows alone: a bucket's pad tail should cost ~nothing
        real = [t[:, :R] for t in (q, k, v)] + [seg[:R]]
        ms_real = device_ms(lambda: fa.flash_attention_segmented(*real))
        plain_ms = device_ms(lambda: fa.flash_attention_segmented_plain(
            q, k, v, seg), iters=5, warmup=1)
        mask = segment_mask(seg, seg.device)
        lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, attn_mask=mask))
        # real rows' q, k, v read once, every output row written once; the
        # pairs with equal seg ≥ 0
        pairs = int((np.bincount(seg_np[seg_np >= 0]).astype(np.int64) ** 2
                     ).sum())
        b = bound((3 * R + S) * H * D * 2, 4 * H * D * pairs)
        log(f"[kernels] segmented {kind} S={S} ({R} real + {S - R} pad) "
            f"H={H} D={D}, strided qkv: max_abs_err {err:.3e}, {rel:.3e} of "
            f"max |ref| (tol {TOL_SEG_REL}; a hidden k tile {rel_bad:.3e}), "
            f"a repeat bit-equal; {pairs} pairs; device ms/call kernel {ms:.4f} (the {R} real rows "
            f"alone {ms_real:.4f}) plain {plain_ms:.4f} masked sdpa "
            f"{lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
        if kind == "window":
            _record("flash_attention_segmented", err, ms, plain_ms, b, lib_ms,
                    "F.scaled_dot_product_attention, boolean (S, S) mask",
                    f"window segments S={S} H={H} D={D} (28 of 32 blocks)")
        else:
            _record("flash_attention_segmented", err)
            RESULTS["flash_attention_segmented"]["full_image"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib_ms,
                "real_rows_ms": ms_real,
                "timed_at": f"full-image segment S={S} (4 of 32 blocks)"}
        r = RESULTS["flash_attention_segmented"]
        r["rel_err"] = max(r.get("rel_err", 0.0), rel)
        if kind == "window":
            r["real_rows_ms"] = ms_real
        del ref, got, bad, mask
    del qkv, qt, kt, vt
    torch.cuda.empty_cache()


def _planted_decode_cache(g, L: int, S: int, Hq: int, Hkv: int, D: int,
                          valid: int):
    """q and a (L, 1, S, Hkv, D) bf16 cache at N(0, 1), with one key per kv
    head planted at the last live row along its query heads' summed
    direction — scored ~7 against the ~7.4 log-sum of the other 999 rows,
    so it carries ~0.1-0.9 of each query head's weight — and a dead row at
    `valid` planted three times stronger, which would swamp a read past
    the live length."""
    G = Hq // Hkv
    q = torch.randn((1, 1, Hq, D), generator=g, device="cuda")
    k = torch.randn((L, 1, S, Hkv, D), generator=g, device="cuda")
    v = torch.randn((L, 1, S, Hkv, D), generator=g, device="cuda")
    u = q.reshape(Hkv, G, D).sum(1)
    u = u / u.norm(dim=-1, keepdim=True)
    k[:, 0, valid - 1] = 21 * u
    k[:, 0, valid] = 63 * u
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def check_stacked_decode() -> None:
    """flash_decode_at_layer over the 5-D cache at Qwen2.5-VL-3B's decoder
    (L 36, S 4096, Hq 16 over Hkv 2, D 128, 1000 live rows) and flash_decode
    over one (B, S, Hkv, D) layer of it: errors against the plain versions,
    within TOL_DECODE_REL of max |ref|, and the live length off by one
    either way must break that bound; device time over the 36 layers in
    turn (past the L2, as a step reads them), the bound, and sdpa over the
    live rows (timed only)."""
    from aha_tpu_torch.ops import flash_attention as fa

    L, S, Hq, Hkv, D, valid = 36, 4096, 16, 2, 128, 1000
    g = torch.Generator(device="cuda").manual_seed(36)
    q, k, v = _planted_decode_cache(g, L, S, Hq, Hkv, D, valid)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    err = {"flash_decode_at_layer": 0.0, "flash_decode": 0.0}
    rel = dict(err)
    rel_bad = float("inf")
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             lt, vl)
        runs = {"flash_decode_at_layer": lambda n: fa.flash_decode_at_layer(
                    q, k, v, lt, vl + n),
                "flash_decode": lambda n: fa.flash_decode(q, k[li], v[li],
                                                          vl + n)}
        for name, run in runs.items():
            e, r = _rel_err(run(0), ref)
            err[name], rel[name] = max(err[name], e), max(rel[name], r)
            for off in (-1, 1):
                rel_bad = min(rel_bad, _rel_err(run(off), ref)[1])
    require(max(rel.values()) <= TOL_DECODE_REL,
            f"stacked decode errors {rel} of max |ref|")
    require(rel_bad > TOL_DECODE_REL, f"stacked decode: a live length off "
            f"by one stays within the bound ({rel_bad} of max |ref|)")
    layer = _layer_cycle(L)
    it = iter(range(10 ** 9))

    def cycle() -> int:
        return next(it) % L

    def _on_layer(fn, li: int):
        return fn(q, k[li], v[li], vl)
    runs = {
        "flash_decode_at_layer": (
            lambda: fa.flash_decode_at_layer(q, k, v, layer(), vl),
            lambda: fa.flash_decode_at_layer_plain(q, k, v, layer(), vl)),
        "flash_decode": (
            lambda: _on_layer(fa.flash_decode, cycle()),
            lambda: _on_layer(fa.flash_decode_plain, cycle())),
    }
    kv_live = [(k[li, :, :valid].transpose(1, 2).contiguous(),
                v[li, :, :valid].transpose(1, 2).contiguous())
               for li in range(L)]
    qt = q.transpose(1, 2).contiguous()
    lib_ms = device_ms(lambda: _sdpa(qt, *kv_live[cycle()]), iters=72)
    b = bound(valid * Hkv * D * 2 * 2 + 2 * Hq * D * 2, 4 * Hq * valid * D)
    for name, (kernel, plain) in runs.items():
        ms = device_ms(kernel, iters=72)
        plain_ms = device_ms(plain, iters=72)
        log(f"[kernels] {name} L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} "
            f"D={D}: max_abs_err {err[name]:.3e}, {rel[name]:.3e} of max "
            f"|ref| (tol {TOL_DECODE_REL}; live length ±1 ≥ {rel_bad:.3e}); "
            f"device ms/call kernel {ms:.4f} plain {plain_ms:.4f} sdpa "
            f"{lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
        _record(name, err[name], ms, plain_ms, b, lib_ms,
                "F.scaled_dot_product_attention over the live rows",
                f"L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv}"
                if name == "flash_decode_at_layer" else
                f"one (1, {S}, {Hkv}, {D}) layer, valid={valid}")
        RESULTS[name]["rel_err"] = rel[name]
    del k, v, kv_live
    torch.cuda.empty_cache()


def check_decode_g7() -> None:
    """Decode at Qwen2.5-VL-7B's group (Hq 28 over Hkv 4: G 7, D 128), 1000
    of 4096 live rows over 28 layers: flash_decode_at_layer on the 5-D
    cache and both int8 variants on its quantized rows, against their plain
    versions (TOL_DECODE_REL / TOL_Q8_REL of max |ref|), a repeat bit-equal;
    the bf16 kernel's device time over the 28 layers in turn."""
    from aha_tpu_torch.ops import attention
    from aha_tpu_torch.ops import flash_attention as fa

    L, S, Hq, Hkv, D, valid = 28, 4096, 28, 4, 128, 1000
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = _planted_decode_cache(g, L, S, Hq, Hkv, D, valid)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    rel, err = 0.0, 0.0
    kq, ks = attention.quantize_kv_rows(k.reshape(L, 1, S, Hkv, D))
    vq, vs = attention.quantize_kv_rows(v.reshape(L, 1, S, Hkv, D))
    kq, vq = kq.reshape(L, 1, S, Hkv * D), vq.reshape(L, 1, S, Hkv * D)
    rel8 = {False: 0.0, True: 0.0}
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fa.flash_decode_at_layer(q, k, v, lt, vl)
        again = fa.flash_decode_at_layer(q, k, v, lt, vl)
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             lt, vl)
        e, r = _rel_err(got, ref)
        err, rel = max(err, e), max(rel, r)
        require(torch.equal(got, again), "G 7 decode: a repeat differs")
        ref8 = fa.flash_decode_at_layer_q8_plain(q.float(), kq, vq, ks, vs,
                                                 lt, vl)
        for mxu in (False, True):
            got8 = fa.flash_decode_at_layer_q8(q, kq, vq, ks, vs, lt, vl,
                                               mxu=mxu)
            rel8[mxu] = max(rel8[mxu], _rel_err(got8, ref8)[1])
    require(rel <= TOL_DECODE_REL, f"G 7 decode: {rel} of max |ref| (tol "
            f"{TOL_DECODE_REL})")
    for mxu, r in rel8.items():
        require(r <= TOL_Q8_REL[mxu], f"G 7 int8 decode mxu={mxu}: {r} of "
                f"max |ref| (tol {TOL_Q8_REL[mxu]})")
    layer = _layer_cycle(L)
    ms = device_ms(lambda: fa.flash_decode_at_layer(q, k, v, layer(), vl),
                   iters=56)
    b = bound(valid * Hkv * D * 2 * 2 + 2 * Hq * D * 2, 4 * Hq * valid * D)
    log(f"[kernels] decode G 7 (Qwen2.5-VL-7B: L={L} S={S} valid={valid} "
        f"Hq={Hq} Hkv={Hkv} D={D}): {rel:.3e} of max |ref| (tol "
        f"{TOL_DECODE_REL}), repeat bit-equal; int8 cast {rel8[False]:.3e}, "
        f"all-int8 {rel8[True]:.3e}; device ms/call {ms:.4f}; bound "
        f"{b[0]:.4f} ({b[1]})")
    _record("flash_decode_at_layer", err)
    RESULTS["flash_decode_at_layer"]["g7"] = dict(
        ms=ms, rel_err=rel, bound_ms=b[0], int8_rel_err=rel8[False],
        int8_mxu_rel_err=rel8[True],
        shape=f"L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}")
    del q, k, v, kq, vq, ks, vs
    torch.cuda.empty_cache()


def phase_kernels() -> None:
    check_stack(1000, 1, "bf16", timed=False)
    check_stack(1000, 28, "bf16", timed=True)
    check_stack(2047, 28, "bf16", timed=False)
    check_decode(2048, 1000, timed=True)
    check_decode(4096, 4000, timed=False)
    check_head()
    check_prefill(256, True, timed=False)
    check_prefill(192, False, timed=False)
    check_prefill(2048, True, timed=True, record=True)
    check_prefill(512, True, timed=True, Hkv=2)     # (n1)'s prompt bucket
    check_prefill(2048, True, timed=True, Hkv=2)    # (n2)'s
    check_prefill(4096, True, timed=True)
    check_q8(2048, 1000, timed=True)
    check_q8(16384, 16000, timed=False)
    check_decode(16384, 16000, timed=False)
    check_batched(timed=True)
    check_quant_matmul("q8")
    check_quant_matmul("q4")
    check_quant_swiglu()
    check_quant_heads()
    for grids in STACK_GRIDS:
        check_stack(0, 1, grids, timed=False)
        check_stack(1000, 1, grids, timed=False)
    check_stack(1000, 28, "q8", timed=True)
    check_stack(1000, 28, "q4", timed=True)
    check_stack(2047, 28, "gguf", timed=True)
    check_segmented()
    check_stacked_decode()
    check_decode_g7()
    check_fused_layer()
    torch.cuda.synchronize()


# -- 3b. the H100 design studies ----------------------------------------------


def phase_studies() -> None:
    """The studies' main path: each study's `main(["--quick"])` (the
    entry point of `python -m aha_tpu_torch.studies.<name> --quick`) at the
    scripts' full geometry — K 1024, N 151936; 28 layers of Qwen3-0.6B
    widths at M = 8 — with the counts zeroed before and read after (path
    "studies").  Each main holds every kernel to its plain version (raising
    past TOL_STUDY) and times it, its plain version and its library
    yardstick by profiler device time; those readings are the JSON line's."""
    from aha_tpu_torch.studies import exp_fused_layer, exp_gemv, exp_int4

    wr = zero_counts()
    results = {}
    for mod in (exp_gemv, exp_int4, exp_fused_layer):
        results.update(mod.main(["--quick"]))
    read_counts(wr, "studies", STUDY_KERNELS)
    for name in STUDY_KERNELS:
        r = results[name]
        if TOL_STUDY[name] == 0.0:
            require(r["max_abs_err"] == 0.0, f"{name} is not bit-equal")
        _record(name, r["max_abs_err"], r["ms"], r["plain_ms"],
                (r["bound_ms"], r["bound_by"]), r["library_ms"], r["library"],
                f"{r['variant'] or 'the one variant'} at the script's "
                f"geometry")
        RESULTS[name]["gbps"] = r["gbps"]
        RESULTS[name]["tol"] = TOL_STUDY[name]
    torch.cuda.empty_cache()


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
                must: tuple[str, ...], slots: int = 8) -> None:
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
        launches = read_counts(wr, name, must)
    finally:
        eng.shutdown()
    for i, out in enumerate(outs):
        require(out is not None and len(out) == 64
                and all(0 <= t < V for t in out),
                f"{name} request {i}: {out and len(out)} tokens")
    require(peak == slots, f"{name}: peak occupied slots {peak} of {slots}")
    require(launches["fused_decode_stack"] == 0
            and launches["fused_decode_stack_q8"] == 0,
            f"{name}: a fused stack ran on a batched path")
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
                ("flash_decode_at_layer_flat_batched",))
    _batch_path(model, params, device, torch.int8, "batch-int8",
                ("flash_decode_at_layer_q8_batched",))
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


# -- 6. GGUF-quantized paths ---------------------------------------------------

#: the GGUF file of (m): its depth, cut from Qwen3-0.6B's 28 layers (the
#: widths stay the published ones)
GGUF_LAYERS = 4


def _quant_text_path(model, params, grid: str, device: str) -> None:
    """(j)/(k): a TextEngine over the bf16 weights packed on one grid, the
    head too: a 20-token prompt (its 32-row prefill bucket runs the
    quant-matmul and fused-SwiGLU kernels) and 16 greedy tokens, then a
    300-token prompt and 128 greedy tokens; every decode step is one launch
    of the quantized fused stack.  Then the 300-token request once more on
    the per-op chain (AHA_FUSED_LAYER=0), outside the counted path."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    V = model.config.vocab_size
    rng = np.random.default_rng(400 + len(grid))
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    eng.generate_tokens(_prompt(rng, 300, V), SamplingConfig(), 16)  # warm
    short, ids = _prompt(rng, 20, V), _prompt(rng, 300, V)
    wr = zero_counts()
    _sync(device)
    out_s = eng.generate_tokens(short, SamplingConfig(), max_tokens=16)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=128)
    t = eng.last_timing
    _sync(device)
    mm = "quant_matmul_q4" if grid == "q4" else "quant_matmul"
    launches = read_counts(wr, f"{grid}-text",
                           (mm, "quant_swiglu", f"head_argmax_{grid}",
                            "fused_decode_stack_q8"))
    # 1 + 8 decode blocks of 16 steps, each step one fused launch
    require(launches["fused_decode_stack"] == 0
            and launches["fused_decode_stack_q8"] == 16 * 9,
            f"{grid} TextEngine: fused launches {launches}")
    require(len(out_s) == 16 and len(out) == 128
            and all(0 <= t < V for t in out_s + out),
            f"{grid} TextEngine: {len(out_s)} + {len(out)} tokens")
    os.environ["AHA_FUSED_LAYER"] = "0"
    try:
        plain_eng = TextEngine(model, params, eos_token_ids=[],
                               max_seq_len=8192)
        out0 = plain_eng.generate_tokens(ids, SamplingConfig(),
                                         max_tokens=128)
        t0 = plain_eng.last_timing
    finally:
        del os.environ["AHA_FUSED_LAYER"]
    same = next((i for i, (x, y) in enumerate(zip(out, out0)) if x != y),
                len(out))
    card = card_line() if device == "cuda" else "cpu"
    label = {"q8": "(j)", "q4": "(k)"}[grid]

    def rate(t):
        return (t.completion_tokens - 1) / t.completion_secs

    log(f"[{grid}-text] {label} 300-token prompt, {grid} weights and head: "
        f"128 greedy tokens, prefill {t.prompt_secs * 1e3:.2f} ms, decode "
        f"{rate(t):.1f} tok/s at batch 1 (quantized fused stack) | {card}")
    log(f"[{grid}-text] {label} per-op chain: decode {rate(t0):.1f} tok/s at "
        f"batch 1 | {card}; greedy streams equal for the first {same}/128 "
        f"tokens")


def _write_gguf_model(path: str, cfg, n_layers: int, seed: int) -> None:
    """A Qwen3 GGUF at cfg's widths and n_layers, seeded numpy weights
    (0.02 scale, unit norms), written with the port's writer: token_embd
    Q8_0 (tied, so the head is quantized), attention and ffn_gate/up Q4_K,
    ffn_down Q6_K in every layer."""
    from aha_tpu_torch.io import gguf as G

    rng = np.random.default_rng(seed)
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    NQ, NKV = cfg.num_attention_heads * D, cfg.num_key_value_heads * D

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def ones(n):
        return (np.ones(n, np.float32), G.GGML_F32)

    tensors = {"token_embd.weight": (w(cfg.vocab_size, H), G.GGML_Q8_0),
               "output_norm.weight": ones(H)}
    for i in range(n_layers):
        b = f"blk.{i}."
        tensors.update({
            b + "attn_norm.weight": ones(H), b + "ffn_norm.weight": ones(H),
            b + "attn_q_norm.weight": ones(D),
            b + "attn_k_norm.weight": ones(D),
            b + "attn_q.weight": (w(NQ, H), G.GGML_Q4_K),
            b + "attn_k.weight": (w(NKV, H), G.GGML_Q4_K),
            b + "attn_v.weight": (w(NKV, H), G.GGML_Q4_K),
            b + "attn_output.weight": (w(H, NQ), G.GGML_Q4_K),
            b + "ffn_gate.weight": (w(I, H), G.GGML_Q4_K),
            b + "ffn_up.weight": (w(I, H), G.GGML_Q4_K),
            b + "ffn_down.weight": (w(H, I), G.GGML_Q6_K),
        })
    G.write_gguf(path, {
        "general.architecture": "qwen3",
        "qwen3.block_count": n_layers,
        "qwen3.embedding_length": H,
        "qwen3.feed_forward_length": I,
        "qwen3.attention.head_count": cfg.num_attention_heads,
        "qwen3.attention.head_count_kv": cfg.num_key_value_heads,
        "qwen3.attention.key_length": D,
        "qwen3.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
        "qwen3.rope.freq_base": cfg.rope_theta,
        "qwen3.context_length": cfg.max_position_embeddings,
    }, tensors)


def _zero_scales(tree):
    if isinstance(tree, dict):
        return {k: (torch.zeros_like(v) if k in ("st", "s4")
                    else _zero_scales(v)) for k, v in tree.items()}
    return tree


@contextlib.contextmanager
def card_routes_on_cpu():
    """On the CPU, quantized linears of ≤ MAX_KERNEL_M rows and the fused
    quantized MLP go through the kernels' plain versions (activation
    quantization), as they go through the kernels on the card, instead of
    the dequantize path the CPU takes otherwise."""
    from aha_tpu_torch.core import nn
    from aha_tpu_torch.ops import quant_matmul as qm

    linear, mlp = nn.quant_linear, nn.swiglu_mlp

    def quant_linear(p, x):
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[0] > qm.MAX_KERNEL_M:
            return linear(p, x)
        grid = "q4" if "q4" in p else "q8"
        fn = qm.quant_matmul_q4 if grid == "q4" else qm.quant_matmul
        y = fn(x2, *[p[k] for k in qm.GRID_KEYS[grid]])
        return (y + p["b"] if "b" in p else y).reshape(*x.shape[:-1], -1)

    def swiglu_mlp(p, x):
        if "gateup" in p and qm.swiglu_fusable(
                p["gateup"], p["down"], x.numel() // x.shape[-1]):
            return qm.quant_swiglu(p["gateup"], p["down"], x)
        return mlp(p, x)

    nn.quant_linear, nn.swiglu_mlp = quant_linear, swiglu_mlp
    try:
        yield
    finally:
        nn.quant_linear, nn.swiglu_mlp = linear, mlp


def _nudge_scales(tree):
    """Every grid scale times (1 + 2**-23): each quantized product moves by
    about one f32 rounding, the size of the card's own differences from the
    plain versions."""
    if isinstance(tree, dict):
        return {k: (v * (1 + 2 ** -23) if k in ("st", "s4")
                    else _nudge_scales(v)) for k, v in tree.items()}
    return tree


def _gguf_path(cfg, device: str) -> None:
    """(m): a GGUF Qwen3 written, loaded with the port's load_qwen3_gguf on
    the card, 32 greedy tokens (decode through the quantized fused stack);
    then 8 teacher-forced steps through each decode path against the same
    steps on the CPU through the kernels' plain versions (the witness) and
    through the exact dequantized path, and the same steps with every
    grid's scales zeroed, which must fail both bounds."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.io.gguf_models import load_qwen3_gguf
    from aha_tpu_torch.models.qwen3 import fuse_decode_params

    with tempfile.TemporaryDirectory(prefix="aha_torch_gguf_") as tmp:
        path = os.path.join(tmp, "qwen3-0.6b-width.gguf")
        t0 = time.perf_counter()
        _write_gguf_model(path, cfg, GGUF_LAYERS, seed=5)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        model, params, _ = load_qwen3_gguf(path, max_rope_len=4096)
        _sync(device)
        t2 = time.perf_counter()
    require(model.device.type == device
            and params["embed"]["w"].dtype == torch.bfloat16,
            f"load_qwen3_gguf defaults: {model.device}, "
            f"{params['embed']['w'].dtype}")
    c = model.config
    lay = fuse_decode_params(params)["layers"]
    grids = {name: "q4" if "q4" in p else "q8" for name, p in
             (("qkv", lay["qkv"]), ("o", lay["o"]),
              ("gateup", lay["mlp"]["gateup"]), ("down", lay["mlp"]["down"]),
              ("head", params["lm_head"]))}
    require(grids == {"qkv": "q4", "o": "q4", "gateup": "q4", "down": "q8",
                      "head": "q8"}, f"GGUF grids {grids}")
    log(f"[gguf] (m) Qwen3 GGUF, H={c.hidden_size} I={c.intermediate_size} "
        f"V={c.vocab_size}, {c.num_hidden_layers} layers (depth cut from "
        f"28): {size / 1e6:.1f} MB written in {t1 - t0:.1f} s, loaded onto "
        f"the card in {t2 - t1:.1f} s (set-up, the default device and "
        f"dtype); grids {grids}")
    V = c.vocab_size
    rng = np.random.default_rng(600)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=4096)
    eng.generate_tokens(_prompt(rng, 64, V), SamplingConfig(), 16)    # warm
    ids = _prompt(rng, 64, V)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=32)
    _sync(device)
    launches = read_counts(wr, "gguf", ("quant_matmul_q4", "quant_swiglu",
                                        "head_argmax_q8",
                                        "fused_decode_stack_q8"))
    require(launches["fused_decode_stack"] == 0,
            "the GGUF path ran the bf16 fused stack")
    require(len(out) == 32 and all(0 <= t < V for t in out),
            f"GGUF TextEngine: {len(out)} tokens")
    t = eng.last_timing
    card = card_line() if device == "cuda" else "cpu"
    log(f"[gguf] 64-token prompt: 32 greedy tokens, prefill "
        f"{t.prompt_secs * 1e3:.2f} ms, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at batch "
        f"1 (quantized fused stack) | {card}")

    # teacher-forced, through each decode path on the card
    forced = out[:8]
    cpu_model = type(model)(c, max_rope_len=4096, device="cpu")
    exact_params = _tree_to(eng.params, "cpu", torch.float32)
    witness_params = _tree_to(eng.params, "cpu", None)
    hx, _ = teacher_forced_hidden(cpu_model, exact_params, ids, forced, "cpu")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    for path, window in (("fused stack", 512), ("per-op chain", None)):
        hk, gk = teacher_forced_hidden(model, eng.params, ids, forced, device,
                                       window)
        with card_routes_on_cpu():
            hw, gw = teacher_forced_hidden(cpu_model, witness_params, ids,
                                           forced, "cpu", window)
            hn, _ = teacher_forced_hidden(cpu_model,
                                          _nudge_scales(witness_params), ids,
                                          forced, "cpu", window)
        bad, _ = teacher_forced_hidden(model, _zero_scales(eng.params), ids,
                                       forced, device, window)
        rel_w, rel_x = rel(hk, hw), rel(hk, hx)
        by_pos = " ".join(f"{rel(hk[i], hw[i]):.1e}" for i in range(len(hk)))
        agree = sum(x == y for x, y in zip(gk, gw))
        log(f"[gguf] teacher-forced 9 positions (prefill + 8 steps), {path}: "
            f"hidden max err vs the witness (CPU, bf16, the plain versions) "
            f"{rel_w:.3e} of max |ref| (tol {TOL_GGUF_WITNESS_REL}; by "
            f"position {by_pos}); the witness with every scale nudged by one "
            f"f32 ulp {rel(hn, hw):.3e} from it; vs the exact path (CPU, f32, "
            f"dequantized) {rel_x:.3e} (tol {TOL_GGUF_REL}), the witness "
            f"itself {rel(hw, hx):.3e}; zeroed scales {rel(bad, hw):.3g} / "
            f"{rel(bad, hx):.3g}; greedy agreement with the witness "
            f"{agree}/{len(gk)}")
        require(rel_w <= TOL_GGUF_WITNESS_REL,
                f"GGUF {path} off the witness by {rel_w}")
        require(rel_x <= TOL_GGUF_REL, f"GGUF {path} off exact by {rel_x}")
        require(rel(bad, hw) > TOL_GGUF_WITNESS_REL
                and rel(bad, hx) > TOL_GGUF_REL,
                "zeroed scales pass the GGUF bounds")


def phase_quant(model, params, device: str = "cuda") -> None:
    """(j)-(m): the GGUF grids on the card."""
    from aha_tpu_torch.models.qwen3 import pack_params

    for grid in ("q8", "q4"):
        t0 = time.perf_counter()
        packed = pack_params(params, grid)
        _sync(device)
        log(f"[{grid}-text] weights and head packed {grid} on the card in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")
        _quant_text_path(model, packed, grid, device)
        if grid == "q4":
            _batch_path(model, packed, device, torch.bfloat16, "batch-q4",
                        ("quant_matmul_q4", "quant_swiglu"))
        del packed
        if device == "cuda":
            torch.cuda.empty_cache()
    _gguf_path(model.config, device)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device, dtype):
    """The tree on `device`, its float tensors in `dtype` (the grids'
    integer tensors keep theirs)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype if tree.is_floating_point()
                   else tree.dtype)


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
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "aha_tpu_torch", "serv",
         tmp, "--port", str(port), "--max-seq-len", "2048", *extra],
        cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
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
    # -X importtime logged every module the child imported, requests
    # served included
    with open(logf.name) as f:
        mods = [ln.rsplit("|", 1)[-1].strip() for ln in f
                if ln.startswith("import time:")]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "aha_tpu")]
    require(len(mods) > 100 and not bad,
            f"served child imported {bad or 'nothing logged'}")
    log(f"[http] served child imported {len(mods)} modules, none of jax or "
        f"aha_tpu")


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

# -- 8. Qwen2.5-VL image chat ---------------------------------------------------

#: Qwen2.5-VL-3B-Instruct's special tokens: vision start / end, image pad
VL_VSTART, VL_VEND, VL_IMAGE = 151652, 151653, 151655
#: the reduced depth of the teacher-forced check and the served checkpoint:
#: 8 vision blocks (block 7 full-attention, as in the published 32) and 4
#: text layers, at the published widths
VL_CUT = dict(depth=8, layers=4, fullatt=(7,))


def _vl_cut(params: dict, depth: int, layers: int) -> dict:
    """The first `depth` vision blocks and `layers` text layers of a
    parameter tree, as views (the tied head stays the embedding)."""
    text = params["text"]
    lay = {k: _tree_map(lambda t: t[:layers], v)
           for k, v in text["layers"].items()}
    return {"visual": {**params["visual"],
                       "blocks": params["visual"]["blocks"][:depth]},
            "text": {**text, "layers": lay}}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _vl_image(side: int, seed: int):
    """(patches, grid) of a seeded random side x side RGB image through the
    port's Qwen-VL processing: Pillow decode and resize where it is
    installed, else (said on a line) numpy frames straight into
    patchify_qwen_vl, the same patches a side that is a multiple of 28
    gives without resizing."""
    from aha_tpu_torch.utils import image

    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        return image.preprocess_image_qwen_vl(Image.fromarray(pixels))
    log("[vl] Pillow is not installed: patches from numpy frames through "
        "patchify_qwen_vl")
    arr = (pixels.astype(np.float32) / 255.0 - image.OPENAI_CLIP_MEAN) \
        / image.OPENAI_CLIP_STD
    return image.patchify_qwen_vl(arr.transpose(2, 0, 1)[None])


def _vl_request(cfg, side: int, seed: int, n_pre: int = 12, n_post: int = 20):
    """Prompt ids with one image of `side` pixels, its host inputs (numpy)
    and its content digest."""
    from aha_tpu_torch.models.qwen2_5vl_served import build_mm, mm_digest

    patches, grid = _vl_image(side, seed)
    rng = np.random.default_rng(seed)
    n_units = grid[0] * grid[1] * grid[2] // 4
    ids = (_prompt(rng, n_pre, 151643) + [VL_VSTART] + [VL_IMAGE] * n_units
           + [VL_VEND] + _prompt(rng, n_post, 151643))
    return (ids, build_mm([patches], [grid], ids, cfg), patches, grid,
            mm_digest([patches], [grid]))


def teacher_forced_vl(model, params, ids, mm, forced, device):
    """Prefill `ids` with the image inputs `mm`, then feed `forced` one
    token per step; the (1 + len(forced), H) final hidden states in f32 on
    the CPU."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import bucket_for

    cache = model.init_cache(1, 1024, embed_dtype(params))
    x = torch.zeros((1, bucket_for(len(ids))), dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    hs = [model.backbone(params, x.to(device), cache, mm=mm)[0, len(ids) - 1]]
    kv.advance(cache, len(ids))
    for t in forced:
        hs.append(model.backbone(params, torch.tensor([[t]], device=device),
                                 cache)[0, 0])
        kv.advance(cache, 1)
    return torch.stack(hs).float().cpu()


def embed_dtype(params: dict) -> torch.dtype:
    return params["text"]["embed"]["w"].dtype


def phase_vl(device: str = "cuda") -> dict:
    """(n1)-(n3) at the published geometry, then the teacher-forced check
    at reduced depth; returns the model and parameters."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLModel, mm_to,
                                                qwen2_5vl_3b)

    cfg = qwen2_5vl_3b()
    model = Qwen2_5VLModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(3),
                               dtype=torch.bfloat16)
    fused = model.fuse_params(params)
    _sync(device)
    n_vis = sum(t.numel() for t in _leaves(params["visual"]))
    n_text = sum(t.numel() for name, t in params["text"].items()
                 if name != "lm_head" for t in _leaves(t))
    log(f"[vl] Qwen2.5-VL-3B geometry: vision {cfg.vision.depth} blocks H="
        f"{cfg.vision.hidden_size}, text {cfg.text.num_hidden_layers} layers "
        f"H={cfg.text.hidden_size} V={cfg.text.vocab_size} tied: "
        f"{n_vis / 1e6:.1f} M + {n_text / 1e6:.1f} M bf16 params seeded on "
        f"the card in {time.perf_counter() - t0:.1f} s (set-up)")
    greedy = SamplingConfig()
    reqs = {"n1": _vl_request(cfg, 448, 1), "n2": _vl_request(cfg, 980, 2)}
    for name, side, patches in (("n1", 448, 1024), ("n2", 980, 4900)):
        ids, mm_np, pat, grid, _ = reqs[name]
        require(pat.shape[0] == patches and ids.count(VL_IMAGE) == patches // 4,
                f"({name}) {side} px: {pat.shape[0]} patches, grid {grid}")
    mms = {name: mm_to(r[1], torch.device(device)) for name, r in reqs.items()}

    # warm-up of both patch buckets and prompt buckets, not counted; then
    # the vision tower alone per image
    warm = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    for name, r in reqs.items():
        warm.generate_tokens(r[0], greedy, max_tokens=4, mm=mms[name])
    del warm
    vision_ms = {}
    with torch.no_grad():
        for name in reqs:
            _sync(device)
            t0 = time.perf_counter()
            model.encode_vision(params["visual"], mms[name])
            _sync(device)
            vision_ms[name] = (time.perf_counter() - t0) * 1e3

    eng = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                     prefix_cache_entries=4)
    outs, timing = {}, {}
    steps = 32                  # 2 decode blocks of 16 for 32 tokens
    for name in ("n1", "n2"):
        ids, _, _, _, key = reqs[name]
        wr = zero_counts()
        _sync(device)
        outs[name] = eng.generate_tokens(ids, greedy, max_tokens=32,
                                         mm=mms[name], mm_key=key,
                                         mm_token_ids=(VL_IMAGE,))
        _sync(device)
        timing[name] = eng.last_timing
        got = read_counts(wr, f"vl-{name}", ("flash_attention_segmented",
                                             "flash_attention",
                                             "flash_decode_at_layer"))
        require(got["flash_attention_segmented"] == 32
                and got["flash_attention"] == 36
                and got["flash_decode_at_layer"] == 36 * steps,
                f"({name}) launches {got}")
        RESULTS["flash_decode"]["launches"] = got["flash_decode"]
    # (n3): a follow-up turn on (n2)'s image — the stored prompt and more
    # text: the prefix store restores its rows and rope_delta, the suffix
    # is prefilled at its offset and no vision block runs
    ids2, _, pat2, grid2, key2 = reqs["n2"]
    rng = np.random.default_rng(33)
    ids3 = ids2 + _prompt(rng, 24, 151643)
    from aha_tpu_torch.models.qwen2_5vl_served import build_mm

    mm3 = mm_to(build_mm([pat2], [grid2], ids3, cfg), torch.device(device))
    wr = zero_counts()
    _sync(device)
    outs["n3"] = eng.generate_tokens(ids3, greedy, max_tokens=32, mm=mm3,
                                     mm_key=key2, mm_token_ids=(VL_IMAGE,))
    _sync(device)
    timing["n3"] = eng.last_timing
    got = read_counts(wr, "vl-n3", ("flash_decode_at_layer",))
    require(got["flash_attention_segmented"] == 0
            and got["flash_attention"] == 0
            and got["flash_decode_at_layer"] == 36 * steps,
            f"(n3) was not a prefix-store hit: launches {got}")
    for name, out in outs.items():
        require(len(out) == 32 and all(0 <= t < cfg.text.vocab_size
                                       for t in out),
                f"({name}): {len(out)} tokens")
    card = card_line() if device == "cuda" else "cpu"
    for name, what in (("n1", "448 x 448 image, 1024 patches (bucket 1024)"),
                       ("n2", "980 x 980 image, 4900 patches (bucket 6400)"),
                       ("n3", "follow-up on (n2), prefix-store hit")):
        t = timing[name]
        vis = (f"; vision tower alone {vision_ms[name]:.2f} ms"
               if name in vision_ms else "")
        log(f"[vl] ({name}) {what}: {t.prompt_tokens}-token prompt, prefill "
            f"(vision + text, first token read) {t.prompt_secs * 1e3:.2f} ms"
            f"{vis}; 32 greedy tokens, decode "
            f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at "
            f"batch 1 (per-op chain) | {card}")
    cold = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    out3_cold = cold.generate_tokens(ids3, greedy, max_tokens=32, mm=mm3)
    same = next((i for i, (x, y) in enumerate(zip(outs["n3"], out3_cold))
                 if x != y), 32)
    log(f"[vl] (n3) against a cold engine's full prefill of the same prompt "
        f"(kernel prefill vs the plain suffix prefill over restored rows): "
        f"greedy streams equal for the first {same}/32 tokens")
    del cold, eng, fused
    if device == "cuda":
        torch.cuda.empty_cache()

    # 8 teacher-forced steps at reduced depth: the card through the kernels
    # against the CPU in f32 through the plain versions
    cut = qwen2_5vl_3b(**VL_CUT)
    small = Qwen2_5VLModel(cut, max_rope_len=8192, device=device)
    sp = _vl_cut(params, VL_CUT["depth"], VL_CUT["layers"])
    ids1, mm1_np = reqs["n1"][0], reqs["n1"][1]
    forced = outs["n1"][:8]
    wr = zero_counts()
    hk = teacher_forced_vl(small, sp, ids1, mms["n1"], forced, device)
    launches = {n: fn.launches for n, fn in wr.items()}
    require(launches["flash_attention_segmented"] == VL_CUT["depth"]
            and launches["flash_decode_at_layer"] == 8 * VL_CUT["layers"],
            f"teacher-forced launches {launches}")
    cpu_model = Qwen2_5VLModel(cut, max_rope_len=8192, device="cpu")
    cpu_params = _tree_to({"visual": sp["visual"],
                           "text": {k: v for k, v in sp["text"].items()
                                    if k != "lm_head"}}, "cpu", torch.float32)
    cpu_params["text"]["lm_head"] = {"w": cpu_params["text"]["embed"]["w"]}
    hp = teacher_forced_vl(cpu_model, cpu_params, ids1,
                           mm_to(mm1_np, torch.device("cpu")), forced, "cpu")
    rel = ((hk - hp).abs().max() / hp.abs().max()).item()
    by_pos = " ".join(f"{((hk[i] - hp[i]).abs().max() / hp.abs().max()).item():.1e}"
                      for i in range(len(hk)))
    log(f"[vl] teacher-forced (n1) at full width, {VL_CUT['depth']} vision "
        f"blocks (block 7 full-attention) and {VL_CUT['layers']} text "
        f"layers, 9 positions: hidden max err {rel:.3e} of max |ref| (tol "
        f"{TOL_VL_HIDDEN_REL}; by position {by_pos})")
    require(rel <= TOL_VL_HIDDEN_REL, f"VL hidden off by {rel}")
    del cpu_params, cpu_model
    return {"model": model, "params": params}


def phase_http_vl(params: dict) -> None:
    """The reduced-depth model (VL_CUT) saved as a checkpoint and served by
    `python -m aha_tpu_torch serv <dir>` (model type read from its
    config.json): one chat with a PNG data-URL image, one text-only."""
    with tempfile.TemporaryDirectory(prefix="aha_torch_vl_") as tmp:
        _write_vl_checkpoint(tmp, params)
        with _server(tmp) as base:
            _ask_vl(base)


def _write_vl_checkpoint(tmp: str, params: dict) -> None:
    """A servable Qwen2.5-VL directory: the test tokenizer with the four
    vision special tokens and an image-aware chat template, an HF-style
    config at the published widths and VL_CUT's depth whose image token is
    that tokenizer's, and the seeded weights (embedding rows past the
    tokenizer zeroed, so replies decode to text)."""
    from tokenizers import AddedToken

    from aha_tpu_torch.io.weights import save_hf_qwen2_5vl

    spec = importlib.util.spec_from_file_location(
        "aha_test_fixtures", os.path.join(ROOT, "tests", "fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    tok = fixtures.build_tokenizer(tmp)
    tok.add_special_tokens([AddedToken(t, special=True) for t in
                            ("<|vision_start|>", "<|image_pad|>",
                             "<|vision_end|>", "<|video_pad|>")])
    tok.save(os.path.join(tmp, "tokenizer.json"))
    eos = tok.token_to_id("<|im_end|>")
    cut = _vl_cut(params, VL_CUT["depth"], VL_CUT["layers"])
    embed = cut["text"]["embed"]["w"].clone()
    embed[tok.get_vocab_size(with_added_tokens=True):] = 0
    cut["text"] = {**cut["text"], "embed": {"w": embed},
                   "lm_head": {"w": embed}}
    from aha_tpu_torch.models.qwen2_5vl import qwen2_5vl_3b

    model_cfg = qwen2_5vl_3b(**VL_CUT)
    v = model_cfg.vision
    cfg = {**model_cfg.text.__dict__,
           "architectures": ["Qwen2_5_VLForConditionalGeneration"],
           "model_type": "qwen2_5_vl", "torch_dtype": "bfloat16",
           "rope_scaling": {"type": "mrope", "mrope_section":
                            list(model_cfg.mrope_section)},
           "vision_config": {**v.__dict__, "fullatt_block_indexes":
                             list(v.fullatt_block_indexes)},
           "image_token_id": tok.token_to_id("<|image_pad|>"),
           "video_token_id": tok.token_to_id("<|video_pad|>"),
           "vision_start_token_id": tok.token_to_id("<|vision_start|>"),
           "vision_end_token_id": tok.token_to_id("<|vision_end|>"),
           "eos_token_id": eos}
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tmp, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    tpl = fixtures.CHAT_TEMPLATE.replace(
        "{{ message.content }}",
        "{% if message.content is string %}{{ message.content }}"
        "{% else %}{% for part in message.content %}"
        "{% if part.type == 'text' %}{{ part.text }}"
        "{% elif part.type == 'image_url' %}"
        "<|vision_start|><|image_pad|><|vision_end|>{% endif %}"
        "{% endfor %}{% endif %}")
    with open(os.path.join(tmp, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": tpl}, f)
    t0 = time.perf_counter()
    save_hf_qwen2_5vl(cut, tmp)
    log(f"[vl-http] full-width checkpoint ({VL_CUT['depth']} vision blocks, "
        f"{VL_CUT['layers']} text layers) written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")


def _png_data_url(side: int, seed: int) -> str:
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (side, side, 3),
                                 dtype=np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _ask_vl(base: str) -> None:
    """A 224 x 224 PNG image chat (256 patches, 64 image tokens) and a
    text-only chat: 200, the image's tokens in the prompt count, a reply."""
    body = {"model": "Qwen/Qwen2.5-VL-3B-Instruct", "max_tokens": 16,
            "temperature": 0.0, "stream": False}
    image = [{"type": "text", "text": "describe the image "},
             {"type": "image_url", "image_url": {"url": _png_data_url(224, 7)}}]
    status, text = _post(base + "/v1/chat/completions", {
        **body, "messages": [{"role": "user", "content": image}]})
    u = json.loads(text)["usage"]
    require(status == 200 and u["prompt_tokens"] > 64
            and u["completion_tokens"] >= 1, text[-500:])
    log(f"[vl-http] image chat 200: usage prompt {u['prompt_tokens']} "
        f"(64 image tokens) completion {u['completion_tokens']}")
    status, text = _post(base + "/v1/chat/completions", {
        **body, "messages": [{"role": "user",
                              "content": "hello world how are you today"}]})
    u = json.loads(text)["usage"]
    require(status == 200 and u["completion_tokens"] >= 1, text[-500:])
    log(f"[vl-http] text-only chat 200: usage prompt {u['prompt_tokens']} "
        f"completion {u['completion_tokens']}")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    timed("kernels", phase_kernels)
    timed("studies", phase_studies)
    from aha_tpu_torch.models.qwen3 import Qwen3Config

    state = timed("engine", phase_engine, Qwen3Config())
    timed("batch", phase_batch, state["model"], state["params"])
    timed("quant", phase_quant, state["model"], state["params"])
    timed("http", phase_http, state["model"].config, state["params"])
    del state
    torch.cuda.empty_cache()
    vl = timed("vl", phase_vl)
    timed("vl-http", phase_http_vl, vl["params"])
    log(f"[smoke] {time.perf_counter() - t_start:.1f} s in all; by phase "
        f"{json.dumps(secs)}")
    require("jax" not in sys.modules and not any(
        m == "aha_tpu" or m.startswith("aha_tpu.") for m in sys.modules),
        "jax or aha_tpu was imported")
    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                **{k: RESULTS[name][k] for k in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                **{k: RESULTS[name][k] for k in (
                    "library", "timed_at", "launches_by_path",
                    "index_mismatches", "max_abs_err_of", "ms_cast_variant",
                    "also_timed", "full_image", "real_rows_ms", "weight_gb_s",
                    "g7", "gbps", "tol", "timings")
                   if k in RESULTS[name]}} for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
