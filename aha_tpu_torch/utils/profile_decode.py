"""Where a batch-1 decode step's time goes, on one CUDA card.

    python -m aha_tpu_torch.utils.profile_decode [--prompt 300] [--steps 16]

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

The same is read for the prompt's prefill.  One JSON line per
configuration goes to stdout, after the readable lines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from collections import Counter

import numpy as np
import torch


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: torch sees no CUDA device")
    from aha_tpu_torch.core.engine import TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    cfg = Qwen3Config()
    model = Qwen3Model(cfg, max_rope_len=8192, device="cuda")
    params = model.init_random(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    ids = [int(t) for t in
           np.random.default_rng(0).integers(0, cfg.vocab_size, args.prompt)]
    greedy = SamplingConfig()
    ring = torch.zeros((64,), dtype=torch.int32, device="cuda")
    bucket = bucket_for(len(ids))
    print(f"profile_decode: prompt {len(ids)} (bucket {bucket}), cache "
          f"{args.cache}, {args.steps}-step block | {card}")
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
                out = {"config": "fused" if fused else "per-op",
                       "card": card, "prompt": len(ids),
                       "cache": args.cache, "steps": args.steps,
                       "prefill": _read(prefill, 1),
                       "decode_block": _read(block, args.steps)}
                eng._return_cache(cache)
            d, p = out["decode_block"], out["prefill"]
            print(f"[{out['config']}] decode block: wall {d['wall_ms']:.2f} ms "
                  f"({d['wall_ms'] / args.steps:.3f} ms/step), device busy "
                  f"{d['device_busy_ms']:.2f} ms, idle share "
                  f"{d['idle_share']:.3f}, {d['device_ops_per_step']:.1f} "
                  f"device ops/step; top {d['top_ops'][:3]}")
            print(f"[{out['config']}] prefill: wall {p['wall_ms']:.2f} ms, "
                  f"device busy {p['device_busy_ms']:.2f} ms, idle share "
                  f"{p['idle_share']:.3f}")
            print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
