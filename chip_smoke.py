#!/usr/bin/env python3
"""Drive aha_tpu_torch's Qwen3 chat path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:

1. device — the card's name, power limit, torch/CUDA/nvcc versions;
2. build — nvcc compiles aha_tpu_torch/csrc/*.cu (set-up time);
3. kernels — each CUDA kernel against its plain PyTorch version at the
   shapes the main path gives it, bf16 inputs, with error and device time
   per call (profiler) of both;
4. engine — Qwen3-0.6B's published geometry (28 layers, hidden 1024, vocab
   151936, tied head) with seeded random bf16 weights on the card, through
   TextEngine: plain and kernel prefill, prefix-cache restore, greedy and
   sampled decode through the fused decode stack (≤ 2048 live rows), and
   a 2100-token prompt whose decode runs the per-op chain; the kernels'
   launch counters must all rise; then 8 teacher-forced steps of each
   decode path against the plain path (float32, on the CPU);
5. HTTP — the same weights saved as a checkpoint (embedding rows past the
   test tokenizer's vocabulary zeroed, so replies decode to text) and
   served by `python -m aha_tpu_torch serv` in a child process:
   non-stream, stream and a prefix-cache repeat of /v1/chat/completions.

Then one JSON line of per-kernel results, the card line, and the last
line {"ok": true, "device": {...}}.  Imports nothing of JAX or aha_tpu.
"""

from __future__ import annotations

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
    """Device time per call: the summed duration of the CUDA kernels `fn`
    launches, from the profiler's trace of `iters` calls.  (CUDA events
    around a loop would time the host's per-call Python work instead,
    which exceeds a µs-scale kernel.)"""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    require(us > 0,
            "profiler saw no device time")
    return us / 1e3 / iters


def wrappers():
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_decode_at_layer_flat)
    from aha_tpu_torch.ops.fused_layer import fused_decode_stack
    from aha_tpu_torch.ops.lm_head import head_argmax

    return {"flash_decode_at_layer_flat": flash_decode_at_layer_flat,
            "head_argmax": head_argmax, "flash_attention": flash_attention,
            "fused_decode_stack": fused_decode_stack}


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
    layers = [torch.tensor(i, dtype=torch.int32, device="cuda")
              for i in range(L)]
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    err = 0.0
    for li in (0, L - 1):
        got = flash_decode_at_layer_flat(q, k, v, layers[li], vl)
        ref = flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                               v.float(), layers[li], vl)
        torch.cuda.synchronize()
        err = max(err, (got.float() - ref).abs().max().item())
    require(err <= TOL_ATTN,
            f"decode S={S} valid={valid}: err {err}")
    # time across all 28 layers in turn, as one decode step reads them:
    # 28 layers of live rows are far past the 50 MB L2, so each call reads
    # HBM
    it = iter(range(10 ** 9))
    ms = device_ms(lambda: flash_decode_at_layer_flat(
        q, k, v, layers[next(it) % L], vl), iters=56)
    plain_ms = device_ms(lambda: flash_decode_at_layer_flat_plain(
        q, k, v, layers[next(it) % L], vl), iters=56)
    log(f"[kernels] decode L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}:"
        f" max_abs_err {err:.3e} (tol {TOL_ATTN}); device ms/call kernel"
        f" {ms:.4f} plain {plain_ms:.4f}")
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
    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in wr.items()}
    for name, n in launches.items():
        require(n > 0,
                f"{name} was not launched on the main path")
        RESULTS[name]["launches"] = n
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
    log(f"[engine] launches on the main path: {json.dumps(launches)}")
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


# -- 5. HTTP ------------------------------------------------------------------


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
        _serve_and_ask(tmp)


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


def _serve_and_ask(tmp: str) -> None:
    """`python -m aha_tpu_torch serv tmp` in a child process; three chat
    requests; the child is always stopped."""
    port = _free_port()
    logf = open(os.path.join(tmp, "server.log"), "w")
    env = {**os.environ, "AHA_NO_COMPILE_CACHE": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "aha_tpu_torch", "serv", tmp, "--port",
         str(port), "--max-seq-len", "2048"], cwd=ROOT, env=env,
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
        log(f"[http] server up in {time.perf_counter() - t0:.1f} s")
        msgs = [{"role": "user", "content":
                 "the quick brown fox jumps over the lazy dog " * 3}]
        body = {"model": "Qwen/Qwen3-0.6B", "messages": msgs,
                "max_tokens": 24, "temperature": 0.0}
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
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logf.close()


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
