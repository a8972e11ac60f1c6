"""Device time of the per-op GGUF kernels on one CUDA card.

    python -m aha_tpu_torch.utils.profile_quant

Times `ops/quant_matmul.quant_matmul` and `quant_matmul_q4` at Qwen3-0.6B's
four decode projections (q|k|v, o, gate|up, down) at M = 1 and 8 and at the
head logits of an 8-slot step (K 1024 x N 151936, M = 8), and
`quant_swiglu` (H 1024, I 3072) in all four grid pairs at M = 1 and 8, on
seeded weights packed on each grid: device ms a call, the summed profiler
time of the kernels a call launches (`profile_decode.device_ms_per_kernel`).
Prints the card's name and power limit, then one JSON line of
{"card", "ms": {shape: ms}}.  It uses only the package's public functions,
so the same file copied into another checkout of the port times that
checkout's kernels: compare two versions inside one call, in turns.
"""

from __future__ import annotations

import json
import subprocess

import torch

from aha_tpu_torch.ops import quant_matmul as qm
from aha_tpu_torch.utils.profile_decode import device_ms_per_kernel

#: Qwen3-0.6B's decode projections and the head: (K, N) and the M timed
SHAPES = {"qkv": (1024, 4096, (1, 8)), "o": (2048, 1024, (1, 8)),
          "gateup": (1024, 6144, (1, 8)), "down": (3072, 1024, (1, 8)),
          "head": (1024, 151936, (8,))}
H, INTER = 1024, 3072


def _pack(g, n: int, k: int, grid: str) -> dict:
    w = torch.randn((n, k), generator=g, device="cuda") * 0.02
    if grid == "q4":
        w += 0.005
    return qm.pack_rows(w, grid == "q4")


def _ms(fn) -> float:
    return sum(device_ms_per_kernel(fn, 40, 5).values())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_quant needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for grid in ("q8", "q4"):
        fn = qm.quant_matmul_q4 if grid == "q4" else qm.quant_matmul
        for proj, (K, N, ms_) in SHAPES.items():
            p = _pack(g, N, K, grid)
            args = [p[k] for k in qm.GRID_KEYS[grid]]
            for M in ms_:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                out[f"{grid} {proj} M={M}"] = _ms(lambda: fn(x, *args))
            del p, args
    for gf, df in (("q8", "q8"), ("q4", "q4"), ("q4", "q8"), ("q8", "q4")):
        gu, dn = _pack(g, 2 * INTER, H, gf), _pack(g, H, INTER, df)
        for M in (1, 8):
            x = torch.randn((1, M, H), generator=g, device="cuda").to(
                torch.bfloat16)
            out[f"swiglu {gf}/{df} M={M}"] = _ms(
                lambda: qm.quant_swiglu(gu, dn, x))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
