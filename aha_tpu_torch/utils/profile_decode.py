"""Where a decode step's time goes, on one CUDA card.

    python -m aha_tpu_torch.utils.profile_decode [--prompt 300] [--steps 16]
    python -m aha_tpu_torch.utils.profile_decode --quant q8|q4
    python -m aha_tpu_torch.utils.profile_decode --batch-slots 8 [--kv-int8]
    python -m aha_tpu_torch.utils.profile_decode --model qwen2_5vl|qwen3vl
    python -m aha_tpu_torch.utils.profile_decode --model paddleocr_vl|lfm2vl
    python -m aha_tpu_torch.utils.profile_decode --model deepseek_ocr
    python -m aha_tpu_torch.utils.profile_decode --spec-tokens 8 [--no-drafts]
    ... [--eager]

Builds Qwen3-0.6B's published geometry with seeded random bf16 weights,
prefills a random prompt through TextEngine, and reads one decode block of
`--steps` greedy steps twice per configuration — the fused decode stack
(AHA_FUSED_LAYER=1, the default) and the per-op chain (AHA_FUSED_LAYER=0),
each through an engine of its own.  A block is the engines' captured CUDA
graph, replayed (its capture is part of the warm-up); `--eager` reads the
same blocks through engines built with `cuda_graphs=False`, the eager loop.
Every reading's JSON line names which (`"graphs"`: the engine's graph
count and capture seconds, null when eager):

- wall ms: host clock from the block's first launch to a synchronize after
  its last, WITHOUT the profiler (its own overhead would inflate it);
- device busy ms: the summed device time of every kernel, copy and memset
  in a torch.profiler trace of the same block (one stream: they do not
  overlap);
- idle share: 1 − busy / wall;
- device ops per step, and the largest ops by device time.

The same is read for the prompt's prefill.  `--quant q8|q4` packs the
seeded weights and the head on that GGUF grid (models/qwen3.pack_params):
the fused step is then the quantized stack (fused_decode_stack_q8), the
per-op step the quant-matmul, fused quantized SwiGLU and quantized head
kernels.  With `--batch-slots N` the
block is instead N slots of the continuous-batching engine stepping
together (BatchEngine._decode_n, every slot live at `--prompt` rows, bf16
or `--kv-int8` cache).  One JSON line per configuration goes to stdout,
after the readable lines.  Two more readings:

    python -m aha_tpu_torch.utils.profile_decode --batch-slots 8 --engine \
        --cache 4096 [--kv-int8]
    python -m aha_tpu_torch.utils.profile_decode --passes

- `--engine`: the running BatchEngine under BATCH_PROMPTS (12 requests
  from client threads at once, ENGINE_TOKENS greedy tokens each): wall,
  aggregate tok/s, mean time to first token, decode steps run, and the
  host seconds the scheduler thread spends in decode dispatches,
  admission chunks and token fetches (timers around those methods);
- `--passes`: device ms per call of the decode-attention kernels (each
  one launch, its fold inside) over 28 layers in turn, bf16 and
  both int8 variants, at S = 2048 / 1000 live rows, S = 16384 / 16000
  and 8 slots of S = 4096 with ragged lengths.

`--spec-tokens N [--no-drafts]` reads speculative decoding instead: a
TextEngine with N drafts a round over a `--prompt`-token prompt made of a
48-token cycle (drafts the greedy targets accept), one dispatch of the
engine's `spec_rounds` rounds from the prefilled prompt (the replay of its
graph, or the rounds run eagerly with `--eager`): wall, device busy, idle
share, ms per emitted token, tokens emitted and each round's accepted
count; then a whole request of SPEC_TOKENS greedy tokens through the
speculative engine and through a plain one, ms per emitted token each.
`--no-drafts` builds the engine with spec_no_drafts (every round verifies
its token alone: the draftless floor).

`--model minicpm4` reads MiniCPM4-0.5B's geometry (models/llama.py
minicpm4_0_5b, seeded bf16 weights) on the same readings: the per-op
decode block of the llama decoder (no fused stack) and its prefill, or
with `--batch-slots N` its N-slot step.

`--model lfm2` / `--model qwen3_5` read the hybrid decoders the same way
(LFM2-1.2B's published geometry, models/lfm2.py lfm2_1_2b; the reference's
default Qwen3.5 text config, models/qwen3_5.py qwen3_5_text_default;
seeded bf16 weights): the per-op decode block with its conv window roll
and recurrent state update, the prefill, or the N-slot step.

`--model qwen2_5vl` reads Qwen2.5-VL-3B-Instruct's geometry instead
(seeded bf16 weights; a seeded --image-px square image, 980 by default:
4,900 patches in the 6,400 bucket): the vision tower alone, the image
prompt's prefill (tower + text decoder) and a decode block of the
llama-family text decoder's per-op chain over the 5-D cache.
`--model qwen3vl` reads Qwen3-VL-8B-Instruct's geometry the same way
(models/qwen3vl.py qwen3vl_8b: the 27-block deepstack tower, 36 Qwen3
layers at hidden 4096; --image-px a multiple of 32, 1024 by default:
4,096 patches): the tower, the image
prefill and a decode block of the per-op Qwen3 layers over the flat cache
with the greedy head kernel.  `--model paddleocr_vl` reads
PaddleOCR-VL-0.9B (models/paddleocr_vl.py paddleocr_vl_0_9b: the 27-block
SigLIP tower at D 72, ERNIE-4.5-0.3B's 18 layers) on an A4 page at 150
dpi by default (11,088 patches in the 16,384 bucket), `--model lfm2vl`
LFM2-VL-1.6B (models/lfm2vl.py lfm2vl_1_6b: the 26-block SigLIP2 tower
with plain masked sdpa, LFM2-1.2B's decoder) on a 1,536 x 1,024 image cut
into 3 x 2 tiles and a thumbnail: the same three readings.  `--model
deepseek_ocr` reads DeepSeek-OCR (models/deepseek_ocr.py
DeepseekOCRConfig(): SAM + CLIP towers, the 12-layer DeepSeek-V2 MoE
decoder) on a 1024 x 1024 image at base 1024 (273 image tokens): the same
three readings, and one decode step's 11 MoE layers alone (plain; their
share of the step's device time).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

#: prompt lengths of the continuous-batching request mix: 12 requests for
#: 8 slots, five above the 512-token admission chunk
BATCH_PROMPTS = (40, 90, 150, 230, 300, 420, 510, 700, 900, 1100, 1300, 1500)
ENGINE_TOKENS = 64
#: tokens of the speculative reading's whole request, and the period of its
#: cyclic prompt
SPEC_TOKENS = 192
SPEC_CYCLE = 48
#: per-slot lengths of the batched decode reading: a parked slot (1), the
#: split boundaries 64 and 128, and the full 4096-row cache
RAGGED = (1, 64, 128, 300, 1000, 1500, 2048, 4096)


def drive_concurrent(eng, prompts: list[list[int]], cfg, max_tokens: int,
                     monitor: bool = False, timeout: float = 300.0):
    """Every prompt through `eng.stream_tokens` from its own thread at
    once; `cfg` is one sampling config for all, or a list of one per
    prompt.  Returns the outputs, each request's time to first token from
    its submission, the wall time, and (with `monitor`) the peak number of
    occupied slots, polled every 2 ms; a client's error is raised."""
    n = len(prompts)
    outs, ttft, errs = [None] * n, [None] * n, []
    peak, done = [0], threading.Event()

    def client(i):
        try:
            t0 = time.perf_counter()
            toks = []
            c = cfg[i] if isinstance(cfg, list) else cfg
            for tok in eng.stream_tokens(prompts[i], c, max_tokens):
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(tok)
            outs[i] = toks
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)

    def poll():
        while not done.is_set():
            peak[0] = max(peak[0], sum(r is not None for r in eng._slot_req))
            time.sleep(0.002)

    mon = threading.Thread(target=poll, daemon=True) if monitor else None
    if mon is not None:
        mon.start()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive():
            raise RuntimeError("a batched request did not finish")
    wall = time.perf_counter() - t0
    done.set()
    if mon is not None:
        mon.join()
    if errs:
        raise errs[0]
    return outs, ttft, wall, peak[0] if monitor else None


#: the --model choices profile_vl reads
VL_MODELS = ("qwen2_5vl", "qwen3vl", "paddleocr_vl", "lfm2vl",
             "deepseek_ocr")


def _how(args) -> str:
    return " eager" if args.eager else " graphed"


def _graphs(eng) -> dict | None:
    return eng.graphs.stats() if eng.graphs is not None else None


@contextlib.contextmanager
def _fused(on: bool):
    old = os.environ.get("AHA_FUSED_LAYER")
    os.environ["AHA_FUSED_LAYER"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("AHA_FUSED_LAYER")
        else:
            os.environ["AHA_FUSED_LAYER"] = old


def _device_events(prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _read(fn, n_steps: int) -> dict:
    """Wall time of fn unprofiled, then device time of fn profiled."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = _device_events(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    by_op: Counter = Counter()
    for e in evs:
        by_op[e.name[:60]] += e.time_range.elapsed_us()
    top = [{"op": k, "share": round(v / busy_us, 4)}
           for k, v in by_op.most_common(6)] if busy_us else []
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms if wall_ms else None,
            "device_ops_per_step": len(evs) / n_steps, "top_ops": top}


def _print_block(name: str, d: dict, steps: int) -> None:
    print(f"[{name}] decode block: wall {d['wall_ms']:.2f} ms "
          f"({d['wall_ms'] / steps:.3f} ms/step), device busy "
          f"{d['device_busy_ms']:.2f} ms, idle share "
          f"{d['idle_share']:.3f}, {d['device_ops_per_step']:.1f} "
          f"device ops/step; top {d['top_ops'][:3]}")


def profile_batch(model, params, args, card: str) -> None:
    """N slots of BatchEngine stepping together, each at --prompt live rows
    (the scheduler is not started: the block is _decode_n itself)."""
    from aha_tpu_torch.core.batch_engine import BatchEngine

    n = args.batch_slots
    dtype = torch.int8 if args.kv_int8 else torch.bfloat16
    eng = BatchEngine(model, params, eos_token_ids=[], slots=n,
                      cache_dtype=dtype, max_seq_len=max(args.cache, 512),
                      cuda_graphs=not args.eager)
    eng._refresh_step_inputs([True] * n)

    def block():
        eng._cache["pos"].fill_(args.prompt)
        eng._decode_n(args.steps)

    name = (f"batch {n} {str(dtype).replace('torch.', '')}"
            + (f" {args.quant}" if args.quant else "")
            + (f" {args.model}" if args.model != "qwen3" else "")
            + _how(args))
    with torch.no_grad():
        for _ in range(2):                  # warm-up: allocator, cuBLAS
            block()
        d = _read(block, args.steps)
    _print_block(name, d, args.steps)
    print(f"[{name}] {n * args.steps / d['wall_ms'] * 1e3:.1f} tok/s "
          f"aggregate over the block")
    print(json.dumps({"config": name, "card": card, "prompt": args.prompt,
                      "cache": args.cache, "steps": args.steps,
                      "graphs": _graphs(eng), "decode_block": d}))


def _timed_methods(obj, names: tuple[str, ...]) -> dict:
    """Wrap obj's methods `names` (as instance attributes) with host-clock
    timers; returns {name: [calls, seconds]}, filled as they run."""
    acc = {n: [0, 0.0] for n in names}

    def wrap(name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[name][0] += 1
                acc[name][1] += time.perf_counter() - t0
        return timed

    for n in names:
        setattr(obj, n, wrap(n, getattr(obj, n)))
    return acc


def profile_engine(model, params, args, card: str) -> None:
    """The running BatchEngine under BATCH_PROMPTS, with the scheduler
    thread's host time split by what it was doing."""
    from aha_tpu_torch.core.batch_engine import BatchEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    dtype = torch.int8 if args.kv_int8 else torch.bfloat16
    V = model.config.vocab_size
    rng = np.random.default_rng(1)

    def prompt(n):
        return [int(t) for t in rng.integers(0, V, n)]

    greedy = SamplingConfig()
    eng = BatchEngine(model, params, eos_token_ids=[], slots=args.batch_slots,
                      cache_dtype=dtype, max_seq_len=args.cache,
                      cuda_graphs=not args.eager)
    try:
        # warm-up of the step and prefill shapes, not counted
        drive_concurrent(eng, [prompt(40), prompt(600)], greedy, 8)
        prompts = [prompt(n) for n in BATCH_PROMPTS]
        secs = _timed_methods(eng, ("_decode_n", "_advance_admission",
                                    "_fetch"))
        _, ttft, wall, _ = drive_concurrent(eng, prompts, greedy,
                                            ENGINE_TOKENS)
    finally:
        eng.shutdown()
    tokens = len(prompts) * ENGINE_TOKENS
    steps = secs["_decode_n"][0] * eng.decode_block
    name = (f"engine {args.batch_slots} {str(dtype).replace('torch.', '')}"
            + _how(args))
    print(f"[{name}] {len(prompts)} requests x {ENGINE_TOKENS} tokens: wall "
          f"{wall:.3f} s, {tokens / wall:.1f} tok/s aggregate, time to first "
          f"token mean {np.mean(ttft) * 1e3:.1f} ms; {steps} decode steps "
          f"(work for {tokens // args.batch_slots}); scheduler host s "
          f"{ {k: round(v[1], 3) for k, v in secs.items()} } | {card}")
    print(json.dumps({"config": name, "card": card, "cache": args.cache,
                      "requests": len(prompts), "tokens": ENGINE_TOKENS,
                      "runahead": eng.runahead, "wall_s": wall,
                      "tok_s": tokens / wall,
                      "ttft_mean_ms": float(np.mean(ttft)) * 1e3,
                      "decode_steps": steps, "graphs": _graphs(eng),
                      "host_s": {k: {"calls": v[0], "s": v[1]}
                                 for k, v in secs.items()}}))


#: traces taken before device_ms_per_kernel gives up: now and then the
#: profiler's CUDA trace comes back empty, or holds fewer kernels than
#: calls (on an H100 with torch 2.11, an sdpa timing of chip_smoke.py read
#: 0 and, in another run, 0.0005 ms where the same call read 0.008), and a
#: fresh trace of the same calls reads normally.  On some machines every
#: trace came back empty for a while (two runs of chip_smoke.py on an H100
#: failed so, in different phases): then the calls are timed with CUDA
#: events instead
TRACE_ATTEMPTS = 3


def device_ms_per_kernel(fn, iters: int = 56, warmup: int = 3) -> dict:
    """Device ms per call of each CUDA kernel `fn` launches, from the
    profiler's trace of `iters` calls (each of which launches at least one
    kernel); a trace with fewer kernel launches than calls is incomplete
    and is taken again, up to TRACE_ATTEMPTS times.  Only then are the
    calls timed with CUDA events, under one key: events around a loop
    time the host's per-call Python work too, which exceeds a µs-scale
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = {e.key: e.self_device_time_total / 1e3 / iters for e in kernels}
        if sum(e.count for e in kernels) >= iters and sum(ms.values()) > 0:
            return ms
    # CUDA events around the calls: the stream's time, which also takes
    # in any gap the host leaves between launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    print(f"[profile] the profiler's trace stayed empty {TRACE_ATTEMPTS} "
          f"times: CUDA events instead", file=sys.stderr, flush=True)
    return {"(CUDA events)": start.elapsed_time(end) / iters}


def profile_passes(card: str) -> None:
    """The device time of each decode-attention kernel (one launch each) at
    Qwen3-0.6B's widths (Hq 16, Hkv 8, D 128), 28 layers in turn so every
    call reads HBM."""
    from aha_tpu_torch.ops import flash_attention as fa

    L, Hq, Hkv, D = 28, 16, 8, 128
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(0)
    layers = [torch.tensor(i, dtype=torch.int32, device="cuda")
              for i in range(L)]
    it = iter(range(10 ** 9))

    def layer():
        return layers[next(it) % L]

    def show(what, ms, live_bytes):
        total = sum(ms.values())
        print(f"[passes] {what}: {total:.4f} ms/call "
              f"({live_bytes / total / 1e6:.1f} GB/s of live rows); "
              + ", ".join(f"{k[:48]} {v:.4f}" for k, v in ms.items()))
        print(json.dumps({"config": what, "card": card, "ms": ms,
                          "live_bytes": live_bytes}))

    for S, lengths in ((2048, (1000,)), (16384, (16000,)), (4096, RAGGED)):
        B = len(lengths)
        vl = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, Hq, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        rows = sum(lengths) * Hkv
        kv = [torch.randn((L, B, S, Hkv * D), generator=g, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2)]
        show(f"bf16 B={B} S={S}", device_ms_per_kernel(
            lambda: fa._decode_dense(q, *kv, layer(), vl, scale)),
            rows * D * 2 * 2)
        kv = [torch.randint(-127, 128, (L, B, S, Hkv * D), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2)]
        kv += [torch.rand((L, B, S, Hkv), generator=g, device="cuda") * 0.01
               + 2e-3 for _ in range(2)]
        for mxu in (False, True):
            show(f"q8 {'all-int8' if mxu else 'cast'} B={B} S={S}",
                 device_ms_per_kernel(lambda: fa._decode_q8(
                     q, *kv, layer(), vl, scale, mxu)),
                 rows * (D + 4) * 2)
        del kv
        torch.cuda.empty_cache()


def profile_spec(model, params, args, card: str) -> None:
    """One dispatch of speculative rounds from a prefilled cyclic prompt,
    then a whole request, speculative and plain."""
    from aha_tpu_torch.core.engine import TextEngine, bucket_for, fused_params
    from aha_tpu_torch.core.sampling import SamplingConfig

    rng = np.random.default_rng(0)
    cycle = [int(t) for t in rng.integers(0, model.config.vocab_size,
                                          SPEC_CYCLE)]
    ids = [cycle[i % SPEC_CYCLE] for i in range(args.prompt)]
    greedy = SamplingConfig()
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     spec_tokens=args.spec_tokens,
                     spec_no_drafts=args.no_drafts,
                     cuda_graphs=not args.eager)
    G1, R, P = args.spec_tokens + 1, eng.spec_rounds, len(ids)
    name = (f"spec {args.spec_tokens}" + (" no-drafts" if args.no_drafts
                                          else "")
            + (f" {args.quant}" if args.quant else "") + _how(args))
    with torch.no_grad():
        st = eng._take(args.cache)
        first = int(eng._prefill(ids, bucket_for(P), st.cache,
                                 from_cache=False)[0].argmax())
        eng._spec_history(st, G1, ids + [first])
        hist0 = st.hist.clone()
        out = []

        def dispatch():
            st.cache["pos"].fill_(P)
            st.hist.copy_(hist0)
            st.hl.fill_(P + 1)
            st.token.fill_(first)
            out.append(eng._spec_rounds(st, G1, R, P))

        for _ in range(2):      # warm-up: allocator, cuBLAS, the capture
            dispatch()
        d = _read(dispatch, R)
        eng._return(st)
        a = [row[-1] for row in out[-1].tolist()]
        emitted = sum(x + 1 for x in a)
        spec_run = eng.generate_tokens(ids, greedy, SPEC_TOKENS)
        t_spec, req_a = eng.last_timing, list(eng.last_spec_a)
        plain = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                           cuda_graphs=not args.eager)
        plain.generate_tokens(ids, greedy, SPEC_TOKENS)       # warm-up
        plain_run = plain.generate_tokens(ids, greedy, SPEC_TOKENS)
        t_plain = plain.last_timing

    def per_token(t):
        return t.completion_secs / max(t.completion_tokens - 1, 1) * 1e3

    same = next((i for i, (x, y) in enumerate(zip(spec_run, plain_run))
                 if x != y), len(spec_run))
    print(f"[{name}] dispatch of {R} rounds of {G1} rows: wall "
          f"{d['wall_ms']:.3f} ms, device busy {d['device_busy_ms']:.3f} ms, "
          f"idle share {d['idle_share']:.3f}; {emitted} tokens, "
          f"{d['wall_ms'] / emitted:.3f} ms/token; a {a} | {card}")
    print(f"[{name}] request of {SPEC_TOKENS} tokens: {per_token(t_spec):.3f}"
          f" ms/token in {len(req_a)} rounds (mean a "
          f"{np.mean(req_a) if req_a else 0:.2f}); plain "
          f"{per_token(t_plain):.3f} ms/token; streams equal for the first "
          f"{same}/{len(spec_run)} tokens")
    print(json.dumps({"config": name, "card": card, "prompt": P,
                      "cache": args.cache, "rounds": R, "G1": G1,
                      "graphs": _graphs(eng), "dispatch": d,
                      "dispatch_a": a, "dispatch_tokens": emitted,
                      "dispatch_ms_per_token": d["wall_ms"] / emitted,
                      "request_ms_per_token": per_token(t_spec),
                      "request_rounds": len(req_a),
                      "request_mean_a": float(np.mean(req_a)) if req_a
                      else 0.0,
                      "plain_ms_per_token": per_token(t_plain),
                      "streams_equal_for": same}))


def _vl_request(args, rng):
    """(name, model, params, ids, host mm, vision(params, mm), real
    patches) of the VL geometry --model names, seeded bf16 weights and a
    seeded image."""
    from aha_tpu_torch.utils.image import patchify_qwen_vl, to_normalized_array

    gen = torch.Generator(device="cuda").manual_seed(0)

    def text(n):
        return [int(t) for t in rng.integers(0, 100000, n)]

    if args.model == "paddleocr_vl":
        from aha_tpu_torch.models.paddleocr_vl import (PaddleOCRVLModel,
                                                       paddleocr_vl_0_9b)
        from aha_tpu_torch.models.paddleocr_vl_served import build_mm
        from aha_tpu_torch.utils.image import patchify_siglip

        cfg = paddleocr_vl_0_9b()
        model = PaddleOCRVLModel(cfg, max_rope_len=8192, device="cuda")
        params = model.init_random(gen, dtype=torch.bfloat16)
        # an A4 page at 150 dpi by default: 1,240 x 1,754 px resized to the
        # factor-28 grid, 126 x 88 patches
        h, w = ((args.image_px, args.image_px) if args.image_px
                else (1764, 1232))
        pixels = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
        patches, grid = patchify_siglip(
            ((pixels / 255.0 - 0.5) / 0.5).transpose(2, 0, 1)[None], 14)
        ids = (text(12) + [cfg.vision_start_token_id]
               + [cfg.image_token_id] * (patches.shape[0] // 4) + text(8))
        return ("PaddleOCR-VL-0.9B", model, params, ids,
                build_mm([patches], [grid], ids, cfg),
                lambda p, mm: model.encode_vision(p["visual"], mm),
                patches.shape[0])
    if args.model == "deepseek_ocr":
        from PIL import Image

        from aha_tpu_torch.models.deepseek_ocr import (DeepseekOCRConfig,
                                                       DeepseekOCRModel)
        from aha_tpu_torch.models.deepseek_ocr_served import (build_mm,
                                                              image_views)

        cfg = DeepseekOCRConfig()
        model = DeepseekOCRModel(cfg, max_rope_len=8192, device="cuda")
        params = model.init_random(gen, dtype=torch.bfloat16)
        # a 1024 x 1024 image at base = image = 1024 by default (273 image
        # tokens); --image-px N: an N x N image, its view at 1024
        side = args.image_px or 1024
        img = Image.fromarray(rng.integers(0, 255, (side, side, 3),
                                           dtype=np.uint8))
        view = image_views(img, 1, 1024, 1024, False)
        ids = ([cfg.language.bos_token_id] + text(8)
               + [cfg.image_token_id] * view[3] + text(8))
        return ("DeepSeek-OCR", model, params, ids, build_mm([view], 1),
                model.assemble_vision, view[3])
    if args.model == "lfm2vl":
        from PIL import Image

        from aha_tpu_torch.models.lfm2vl import Lfm2VLModel, lfm2vl_1_6b
        from aha_tpu_torch.models.lfm2vl_served import (build_mm,
                                                        resize_and_split)

        cfg = lfm2vl_1_6b()
        model = Lfm2VLModel(cfg, max_rope_len=8192, device="cuda")
        params = model.init_random(gen, dtype=torch.bfloat16)
        # 1,536 x 1,024 by default: 3 x 2 tiles of 512 and a thumbnail
        w, h = ((args.image_px, args.image_px) if args.image_px
                else (1536, 1024))
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3),
                                           dtype=np.uint8))
        entries, _, _, _ = resize_and_split(img, cfg, {})
        per = [p for p, _ in entries]
        shapes = [s for _, s in entries]
        units = sum((a // 2) * (b // 2) for a, b in shapes)
        # text ids within LFM2's vocabulary and past its image id (396)
        ids = ([int(t) for t in rng.integers(400, 60000, 12)]
               + [cfg.image_token_id] * units
               + [int(t) for t in rng.integers(400, 60000, 8)])
        table = params["visual"]["pos_table"].float().cpu().numpy()
        return ("LFM2-VL-1.6B", model, params, ids,
                build_mm(per, shapes, table, cfg), model.encode_vision,
                sum(len(p) for p in per))
    side = args.image_px or (1024 if args.model == "qwen3vl" else 980)
    if args.model == "qwen3vl":
        from aha_tpu_torch.models.qwen3vl import Qwen3VLModel, qwen3vl_8b
        from aha_tpu_torch.models.qwen3vl_served import build_mm

        cfg, name = qwen3vl_8b(), "Qwen3-VL-8B"
        model = Qwen3VLModel(cfg, max_rope_len=8192, device="cuda")
    else:
        from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLModel,
                                                    qwen2_5vl_3b)
        from aha_tpu_torch.models.qwen2_5vl_served import build_mm

        cfg, name = qwen2_5vl_3b(), "Qwen2.5-VL-3B"
        model = Qwen2_5VLModel(cfg, max_rope_len=8192, device="cuda")
    params = model.init_random(gen, dtype=torch.bfloat16)
    pixels = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    patches, grid = patchify_qwen_vl(to_normalized_array(pixels)[None],
                                     patch_size=cfg.vision.patch_size)
    n_img = patches.shape[0] // 4
    ids = ([int(t) for t in rng.integers(0, 151643, 12)]
           + [cfg.vision_start_token_id] + [cfg.image_token_id] * n_img
           + [int(t) for t in rng.integers(0, 151643, 20)])
    return (name, model, params, ids, build_mm([patches], [grid], ids, cfg),
            lambda p, mm: model.encode_vision(p["visual"], mm),
            patches.shape[0])


def profile_vl(args, card: str) -> None:
    """Qwen2.5-VL-3B, Qwen3-VL-8B, PaddleOCR-VL-0.9B or LFM2-VL-1.6B: the
    tower, the image prefill and a decode block."""
    from aha_tpu_torch.core.engine import CACHE_BUCKETS, TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    rng = np.random.default_rng(0)
    name, model, params, ids, mm_np, encode, n_patches = _vl_request(args,
                                                                     rng)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     cuda_graphs=not args.eager)
    mm = mm_to(mm_np, torch.device("cuda"))
    side = args.image_px
    bucket = bucket_for(len(ids))
    cache_len = max(args.cache, bucket_for(len(ids) + args.steps + 1,
                                           CACHE_BUCKETS))
    greedy = SamplingConfig()
    print(f"profile_decode: {name}, image of {n_patches} real patches "
          f"(--image-px {side or 'default'}), prompt {len(ids)} (bucket "
          f"{bucket}), cache {cache_len}, {args.steps}-step block | {card}")
    with torch.no_grad():
        st = eng._take(cache_len)

        def vision():
            encode(eng.params, mm)

        def prefill():
            st.cache["pos"].zero_()
            return eng._prefill(ids, bucket, st.cache, from_cache=False,
                                mm=mm)

        def block():
            st.cache["pos"].fill_(len(ids))
            eng._decode_block(st, greedy, args.steps,
                              len(ids) + 1 + args.steps)

        for _ in range(2):       # warm-up: allocator, cuBLAS, the capture
            prefill()
            block()
        out = {"config": f"{args.model} per-op" + _how(args), "card": card,
               "image_px": side, "patches": n_patches, "prompt": len(ids),
               "cache": cache_len,
               "steps": args.steps, "graphs": _graphs(eng),
               "vision": _read(vision, 1), "prefill": _read(prefill, 1),
               "decode_block": _read(block, args.steps)}
        eng._return(st)
        if args.model == "deepseek_ocr":
            # one decode step's MoE layers alone, read the same way
            h = torch.randn((1, 1, model.config.language.hidden_size),
                            device="cuda", dtype=torch.bfloat16)

            def moe_step():
                for lp in params["layers"]:
                    if "moe" in lp:
                        model.mlp(lp, h)

            moe_step()
            out["moe_step"] = _read(moe_step, 1)
            out["moe_share_of_step"] = (out["moe_step"]["device_busy_ms"]
                                        / (out["decode_block"]
                                           ["device_busy_ms"] / args.steps))
    _print_block(out["config"], out["decode_block"], args.steps)
    for part in ("vision", "prefill", "moe_step"):
        if part not in out:
            continue
        p = out[part]
        print(f"[{out['config']}] {part}: wall {p['wall_ms']:.2f} ms, device "
              f"busy {p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f}, {p['device_ops_per_step']:.0f} device "
              f"ops; top {p['top_ops'][:3]}")
    if "moe_share_of_step" in out:
        print(f"[{out['config']}] the MoE layers' share of a decode step's "
              f"device time: {out['moe_share_of_step']:.3f}")
    print(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache", type=int, default=512)
    ap.add_argument("--batch-slots", type=int, default=1,
                    help="profile N BatchEngine slots stepping together")
    ap.add_argument("--kv-int8", action="store_true",
                    help="with --batch-slots: an int8 KV cache")
    ap.add_argument("--engine", action="store_true",
                    help="with --batch-slots: the running engine under the "
                         "BATCH_PROMPTS request mix")
    ap.add_argument("--passes", action="store_true",
                    help="device time of each decode-attention pass")
    ap.add_argument("--quant", choices=("q8", "q4"),
                    help="pack the weights and head on this GGUF grid")
    ap.add_argument("--model", choices=("qwen3", "minicpm4", "lfm2",
                                        "qwen3_5") + VL_MODELS,
                    default="qwen3",
                    help="minicpm4: MiniCPM4-0.5B's llama decoder; lfm2 / "
                         "qwen3_5: the hybrid decoders; qwen2_5vl / "
                         "qwen3vl / paddleocr_vl / lfm2vl: Qwen2.5-VL-3B's "
                         "/ Qwen3-VL-8B's / PaddleOCR-VL-0.9B's / "
                         "LFM2-VL-1.6B's tower, image prefill and text "
                         "decode; deepseek_ocr: DeepSeek-OCR's towers, "
                         "image prefill, MoE decode and its MoE share")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode blocks eagerly (engines built with "
                         "cuda_graphs=False) instead of replaying graphs")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="read speculative rounds of N drafts instead")
    ap.add_argument("--no-drafts", action="store_true",
                    help="with --spec-tokens: every round draftless")
    ap.add_argument("--image-px", type=int, default=None,
                    help="with a VL --model: a square image's side, a "
                         "multiple of 28 / 32 for qwen2_5vl / qwen3vl (980 "
                         "/ 1024 by default); by default paddleocr_vl reads "
                         "an A4 page at 150 dpi (1232 x 1764 after resize) "
                         "and lfm2vl a 1536 x 1024 image (3 x 2 tiles and "
                         "a thumbnail)")
    args = ap.parse_args(argv)
    need = max(BATCH_PROMPTS) + ENGINE_TOKENS
    if args.engine and (args.batch_slots < 2 or args.cache < need):
        ap.error(f"--engine needs --batch-slots >= 2 and --cache >= {need}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: torch sees no CUDA device")
    from aha_tpu_torch.core.engine import TextEngine, bucket_for, fused_params
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if args.passes:
        profile_passes(card)
        return 0
    if args.model in VL_MODELS:
        profile_vl(args, card)
        return 0
    if args.model != "qwen3" and (args.quant or args.spec_tokens > 0):
        ap.error(f"--model {args.model} reads bf16 decode (no --quant, "
                 "--spec-tokens)")
    if args.model == "minicpm4":
        from aha_tpu_torch.models.llama import LlamaModel, minicpm4_0_5b

        cfg = minicpm4_0_5b()
        model = LlamaModel(cfg, max_rope_len=8192, device="cuda")
    elif args.model == "lfm2":
        from aha_tpu_torch.models.lfm2 import Lfm2Model, lfm2_1_2b

        cfg = lfm2_1_2b()
        model = Lfm2Model(cfg, max_rope_len=8192, device="cuda")
    elif args.model == "qwen3_5":
        from aha_tpu_torch.models.qwen3_5 import (Qwen3_5Model,
                                                  qwen3_5_text_default)

        cfg = qwen3_5_text_default()
        model = Qwen3_5Model(cfg, max_rope_len=8192, device="cuda")
    else:
        cfg = Qwen3Config()
        model = Qwen3Model(cfg, max_rope_len=8192, device="cuda")
    params = model.init_random(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
    if args.model != "qwen3":
        params = fused_params(model, params)
    if args.quant:
        from aha_tpu_torch.models.qwen3 import pack_params

        params = pack_params(params, args.quant)
    if args.spec_tokens > 0:
        profile_spec(model, params, args, card)
        return 0
    if args.batch_slots > 1:
        (profile_engine if args.engine else profile_batch)(model, params,
                                                           args, card)
        return 0
    ids = [int(t) for t in
           np.random.default_rng(0).integers(0, cfg.vocab_size, args.prompt)]
    greedy = SamplingConfig()
    bucket = bucket_for(len(ids))
    print(f"profile_decode: prompt {len(ids)} (bucket {bucket}), cache "
          f"{args.cache}, {args.steps}-step block, "
          f"{args.quant or 'bf16'} weights,{_how(args)} | {card}")
    # the llama decoder has no fused stack: one reading, its per-op chain
    routes = (True, False) if args.model == "qwen3" else (False,)
    with torch.no_grad():
        for fused in routes:
            with _fused(fused):
                # an engine per route: its graphs are captured on the route
                eng = TextEngine(model, params, eos_token_ids=[],
                                 max_seq_len=8192, cuda_graphs=not args.eager)
                st = eng._take(args.cache)

                def prefill():
                    st.cache["pos"].zero_()
                    return eng._prefill(ids, bucket, st.cache,
                                        from_cache=False)

                def block():
                    st.cache["pos"].fill_(len(ids))
                    eng._decode_block(st, greedy, args.steps,
                                      len(ids) + 1 + args.steps)

                for _ in range(2):   # warm-up: allocator, cuBLAS, the capture
                    prefill()
                    block()
                out = {"config": ("fused" if fused else "per-op")
                           + (f" {args.quant}" if args.quant else "")
                           + (f" {args.model}" if args.model != "qwen3"
                              else "")
                           + _how(args),
                       "card": card, "prompt": len(ids),
                       "cache": args.cache, "steps": args.steps,
                       "graphs": _graphs(eng),
                       "prefill": _read(prefill, 1),
                       "decode_block": _read(block, args.steps)}
                eng._return(st)
            d, p = out["decode_block"], out["prefill"]
            _print_block(out["config"], d, args.steps)
            print(f"[{out['config']}] prefill: wall {p['wall_ms']:.2f} ms, "
                  f"device busy {p['device_busy_ms']:.2f} ms, idle share "
                  f"{p['idle_share']:.3f}")
            print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
