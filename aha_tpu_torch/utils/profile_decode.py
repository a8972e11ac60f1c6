"""Where a decode step's time goes, on one CUDA card.

    python -m aha_tpu_torch.utils.profile_decode [--prompt 300] [--steps 16]
    python -m aha_tpu_torch.utils.profile_decode --quant q8|q4
    python -m aha_tpu_torch.utils.profile_decode --batch-slots 8 [--kv-int8]
    python -m aha_tpu_torch.utils.profile_decode --model qwen2_5vl

Builds Qwen3-0.6B's published geometry with seeded random bf16 weights,
prefills a random prompt through TextEngine, and reads one decode block of
`--steps` greedy steps twice per configuration — the fused decode stack
(AHA_FUSED_LAYER=1, the default) and the per-op chain (AHA_FUSED_LAYER=0):

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
- `--passes`: device ms per call of each pass of the decode-attention
  kernels (the int8 kernels' split-KV and combine passes; the bf16 kernel
  is one launch) over 28 layers in turn, bf16 and
  both int8 variants, at S = 2048 / 1000 live rows, S = 16384 / 16000
  and 8 slots of S = 4096 with ragged lengths.

`--model qwen2_5vl` reads Qwen2.5-VL-3B-Instruct's geometry instead
(seeded bf16 weights; a seeded --image-px square image, 980 by default:
4,900 patches in the 6,400 bucket): the vision tower alone, the image
prompt's prefill (tower + text decoder) and a decode block of the
llama-family text decoder's per-op chain over the 5-D cache.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import threading
import time
from collections import Counter

import numpy as np
import torch

#: prompt lengths of the continuous-batching request mix: 12 requests for
#: 8 slots, five above the 512-token admission chunk
BATCH_PROMPTS = (40, 90, 150, 230, 300, 420, 510, 700, 900, 1100, 1300, 1500)
ENGINE_TOKENS = 64
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
                      cache_dtype=dtype, max_seq_len=max(args.cache, 512))
    eng._refresh_step_inputs([True] * n)

    def block():
        eng._cache["pos"].fill_(args.prompt)
        eng._decode_n(args.steps)

    name = (f"batch {n} {str(dtype).replace('torch.', '')}"
            + (f" {args.quant}" if args.quant else ""))
    with torch.no_grad():
        for _ in range(2):                  # warm-up: allocator, cuBLAS
            block()
        d = _read(block, args.steps)
    _print_block(name, d, args.steps)
    print(f"[{name}] {n * args.steps / d['wall_ms'] * 1e3:.1f} tok/s "
          f"aggregate over the block")
    print(json.dumps({"config": name, "card": card, "prompt": args.prompt,
                      "cache": args.cache, "steps": args.steps,
                      "decode_block": d}))


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
                      cache_dtype=dtype, max_seq_len=args.cache)
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
    name = f"engine {args.batch_slots} {str(dtype).replace('torch.', '')}"
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
                      "decode_steps": steps,
                      "host_s": {k: {"calls": v[0], "s": v[1]}
                                 for k, v in secs.items()}}))


#: traces taken before device_ms_per_kernel gives up: now and then the
#: profiler's CUDA trace comes back empty, or holds fewer kernels than
#: calls (on an H100 with torch 2.11, an sdpa timing of chip_smoke.py read
#: 0 and, in another run, 0.0005 ms where the same call read 0.008), and a
#: fresh trace of the same calls reads normally
TRACE_ATTEMPTS = 3


def device_ms_per_kernel(fn, iters: int = 56, warmup: int = 3) -> dict:
    """Device ms per call of each CUDA kernel `fn` launches, from the
    profiler's trace of `iters` calls (each of which launches at least one
    kernel); a trace with fewer kernel launches than calls is incomplete
    and is taken again, up to TRACE_ATTEMPTS times.  (CUDA events around a
    loop would time the host's per-call Python work instead, which exceeds
    a µs-scale kernel.)"""
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
    return ms


def profile_passes(card: str) -> None:
    """The passes of each decode-attention kernel (one for bf16) at
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
            lambda: fa._decode_bf16(q, *kv, layer(), vl, scale)),
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


def profile_vl(args, card: str) -> None:
    """Qwen2.5-VL-3B: the tower, the image prefill and a decode block."""
    from aha_tpu_torch.core.engine import CACHE_BUCKETS, TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLModel, mm_to,
                                                qwen2_5vl_3b)
    from aha_tpu_torch.models.qwen2_5vl_served import build_mm
    from aha_tpu_torch.utils.image import patchify_qwen_vl, to_normalized_array

    cfg = qwen2_5vl_3b()
    model = Qwen2_5VLModel(cfg, max_rope_len=8192, device="cuda")
    params = model.init_random(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    rng = np.random.default_rng(0)
    side = args.image_px
    pixels = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    patches, grid = patchify_qwen_vl(to_normalized_array(pixels)[None])
    n_img = patches.shape[0] // 4
    ids = ([int(t) for t in rng.integers(0, 151643, 12)]
           + [cfg.vision_start_token_id] + [cfg.image_token_id] * n_img
           + [int(t) for t in rng.integers(0, 151643, 20)])
    mm = mm_to(build_mm([patches], [grid], ids, cfg), torch.device("cuda"))
    bucket = bucket_for(len(ids))
    cache_len = max(args.cache, bucket_for(len(ids) + args.steps + 1,
                                           CACHE_BUCKETS))
    greedy = SamplingConfig()
    ring = torch.zeros((64,), dtype=torch.int32, device="cuda")
    print(f"profile_decode: Qwen2.5-VL-3B, {side} px image ({patches.shape[0]}"
          f" patches, bucket {mm['patches'].shape[0]}), prompt {len(ids)} "
          f"(bucket {bucket}), cache {cache_len}, {args.steps}-step block "
          f"| {card}")
    with torch.no_grad():
        cache = eng._take_cache(cache_len)

        def vision():
            model.encode_vision(eng.params["visual"], mm)

        def prefill():
            cache["pos"].zero_()
            return eng._prefill(ids, bucket, cache, from_cache=False, mm=mm)

        def block():
            cache["pos"].fill_(len(ids))
            tok = torch.zeros((), dtype=torch.int32, device="cuda")
            eng._decode_block(tok, cache, greedy, None, ring, 1, args.steps,
                              len(ids) + 1 + args.steps)

        for _ in range(2):                  # warm-up: allocator, cuBLAS
            prefill()
            block()
        out = {"config": "qwen2_5vl per-op", "card": card,
               "image_px": side, "prompt": len(ids), "cache": cache_len,
               "steps": args.steps, "vision": _read(vision, 1),
               "prefill": _read(prefill, 1),
               "decode_block": _read(block, args.steps)}
        eng._return_cache(cache)
    _print_block(out["config"], out["decode_block"], args.steps)
    for part in ("vision", "prefill"):
        p = out[part]
        print(f"[{out['config']}] {part}: wall {p['wall_ms']:.2f} ms, device "
              f"busy {p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f}, {p['device_ops_per_step']:.0f} device "
              f"ops; top {p['top_ops'][:3]}")
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
    ap.add_argument("--model", choices=("qwen3", "qwen2_5vl"),
                    default="qwen3",
                    help="qwen2_5vl: Qwen2.5-VL-3B's tower, image prefill "
                         "and text decode")
    ap.add_argument("--image-px", type=int, default=980,
                    help="with --model qwen2_5vl: the image's side, a "
                         "multiple of 28")
    args = ap.parse_args(argv)
    need = max(BATCH_PROMPTS) + ENGINE_TOKENS
    if args.engine and (args.batch_slots < 2 or args.cache < need):
        ap.error(f"--engine needs --batch-slots >= 2 and --cache >= {need}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: torch sees no CUDA device")
    from aha_tpu_torch.core.engine import TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if args.passes:
        profile_passes(card)
        return 0
    if args.model == "qwen2_5vl":
        profile_vl(args, card)
        return 0
    cfg = Qwen3Config()
    model = Qwen3Model(cfg, max_rope_len=8192, device="cuda")
    params = model.init_random(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
    if args.quant:
        from aha_tpu_torch.models.qwen3 import pack_params

        params = pack_params(params, args.quant)
    if args.batch_slots > 1:
        (profile_engine if args.engine else profile_batch)(model, params,
                                                           args, card)
        return 0
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    ids = [int(t) for t in
           np.random.default_rng(0).integers(0, cfg.vocab_size, args.prompt)]
    greedy = SamplingConfig()
    ring = torch.zeros((64,), dtype=torch.int32, device="cuda")
    bucket = bucket_for(len(ids))
    print(f"profile_decode: prompt {len(ids)} (bucket {bucket}), cache "
          f"{args.cache}, {args.steps}-step block, "
          f"{args.quant or 'bf16'} weights | {card}")
    with torch.no_grad():
        for fused in (True, False):
            with _fused(fused):
                cache = eng._take_cache(args.cache)

                def prefill():
                    cache["pos"].zero_()
                    return eng._prefill(ids, bucket, cache, from_cache=False)

                def block():
                    cache["pos"].fill_(len(ids))
                    tok = torch.zeros((), dtype=torch.int32, device="cuda")
                    eng._decode_block(tok, cache, greedy, None, ring, 1,
                                      args.steps,
                                      len(ids) + 1 + args.steps)

                for _ in range(2):          # warm-up: allocator, cuBLAS
                    prefill()
                    block()
                out = {"config": ("fused" if fused else "per-op")
                           + (f" {args.quant}" if args.quant else ""),
                       "card": card, "prompt": len(ids),
                       "cache": args.cache, "steps": args.steps,
                       "prefill": _read(prefill, 1),
                       "decode_block": _read(block, args.steps)}
                eng._return_cache(cache)
            d, p = out["decode_block"], out["prefill"]
            _print_block(out["config"], d, args.steps)
            print(f"[{out['config']}] prefill: wall {p['wall_ms']:.2f} ms, "
                  f"device busy {p['device_busy_ms']:.2f} ms, idle share "
                  f"{p['idle_share']:.3f}")
            print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
