"""Where a fused decode stack's time goes: three readings of one
Qwen3-0.6B decode step on the card (28 layers, cache row 1000 of 2048,
seeded weights), over bf16 weights or packed on a GGUF grid.

    python -m aha_tpu_torch.studies.stack_parts [--grids bf16|q8|q4]

(a) an otherwise empty cooperative kernel of one 512-thread block per SM
    doing the stack's grid barriers (counted in its source,
    csrc/fused_decode_stack.cu or, on a grid, csrc/fused_decode_stack_q8.cu:
    its barriers a layer times 28, less any the last layer skips);
(b) the stack with its grid barriers and attention calls taken out of the
    source: the GEMV phases' weight stream alone (a wrong answer, timing
    only), built from a copy of the sources under the build directory;
(c) the stack as it is (`ops/fused_layer.fused_decode_stack`, or
    `fused_decode_stack_q8` with every projection on the grid).

(c) − (b) is what the barriers and the attention cost on top of the
stream; (a) is the barriers' own floor.  Prints the card line first and a
JSON line of the readings last.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.studies import card_line, device_ms, require_card

L, POS, S = 28, 1000, 2048
#: each stack's source, by the grid of its weights
STACK_SOURCES = {"bf16": "fused_decode_stack.cu",
                 "q8": "fused_decode_stack_q8.cu",
                 "q4": "fused_decode_stack_q8.cu"}
BARRIER = "aha_coop::grid_barrier();"
#: calls taken out of the stack's source for reading (b)
DROPPED = (BARRIER, "attention_phase<")

BARRIER_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(512, 1) barriers(int n) {
  for (int i = 0; i < n; ++i) cooperative_groups::this_grid().sync();
}
extern "C" int aha_barriers(int n, int grid, void* stream) {
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)barriers, dim3(grid),
                                              dim3(512), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""


def barriers_per_step(src: str) -> int:
    """The stack's grid barriers a step: those of its layer loop times L,
    less the last layer's where one is skipped (`if (!last)`)."""
    return src.count(BARRIER) * L - src.count("if (!last) " + BARRIER)


def drop_calls(src: str, starts: tuple[str, ...]) -> str:
    """`src` with every statement that begins with one of `starts` (through
    its balanced parentheses and the closing semicolon) made empty."""
    out, i = [], 0
    pattern = re.compile("|".join(re.escape(s) for s in starts))
    while (m := pattern.search(src, i)) is not None:
        out.append(src[i:m.start()] + ";")
        j, depth = m.start(), 0
        while True:
            c = src[j]
            depth += c == "("
            depth -= c == ")"
            j += 1
            if c == ";" and depth == 0:
                break
        i = j
    out.append(src[i:])
    return "".join(out)


def _barrier_lib(where) -> object:
    import ctypes

    cu = where / "barriers.cu"
    so = where / "libbarriers.so"
    cu.write_text(BARRIER_CU)
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.aha_barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def pack_layers(lyr: dict, grids: tuple[str, str, str, str]) -> dict:
    """The fused bf16 layers with q|k|v, o, gate|up and down packed on
    their `grids` ("q8" or "q4" each), norms left bf16."""
    from aha_tpu_torch.ops.quant_matmul import pack_rows

    def pack(p, grid):
        return pack_rows(p["w"].transpose(-1, -2), grid == "q4")

    g_qkv, g_o, g_gu, g_dn = grids
    return {**lyr, "qkv": pack(lyr["qkv"], g_qkv), "o": pack(lyr["o"], g_o),
            "mlp": {"gateup": pack(lyr["mlp"]["gateup"], g_gu),
                    "down": pack(lyr["mlp"]["down"], g_dn)}}


def main(argv=None) -> int:
    import argparse

    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops import fused_layer

    ap = argparse.ArgumentParser(prog="stack_parts")
    ap.add_argument("--grids", choices=tuple(STACK_SOURCES), default="bf16",
                    help="the weights: bf16, or every projection on the "
                    "int8 or 4-bit GGUF grid")
    args = ap.parse_args(argv)
    dev = require_card()
    print(f"[stack_parts] {card_line()}", flush=True)
    cfg = Qwen3Config(num_hidden_layers=L)
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    lyr = fuse_decode_params(model.init_random(g, dtype=torch.bfloat16))[
        "layers"]
    stack = fused_layer.fused_decode_stack
    if args.grids != "bf16":
        lyr = pack_layers(lyr, (args.grids,) * 4)
        stack = fused_layer.fused_decode_stack_q8
    HD = cfg.num_key_value_heads * cfg.head_dim
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn((1, 1, cfg.hidden_size), generator=g, **bf)
    k = torch.randn((L, 1, S, HD), generator=g, **bf)
    v = torch.randn((L, 1, S, HD), generator=g, **bf)
    p = torch.tensor(POS, dtype=torch.int32, device="cuda")
    cos = torch.cat([model.cos[POS], model.cos[POS]])[None]
    sin = torch.cat([model.sin[POS], model.sin[POS]])[None]
    # the four projections' weights (and on a grid their scales and mins)
    wbytes = sum(t.numel() * t.element_size()
                 for p_ in (lyr["qkv"], lyr["o"], lyr["mlp"]["gateup"],
                            lyr["mlp"]["down"]) for t in p_.values())

    def step():
        return stack(x, lyr, p, cos, sin, k, v, cfg.rms_norm_eps)

    kernels.lib()
    c_ms = device_ms(step, iters=20)

    source = STACK_SOURCES[args.grids]
    src = (kernels.CSRC / source).read_text()
    n_bar = barriers_per_step(src)
    work = kernels.build_dir() / "stack_parts"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    blib = _barrier_lib(work)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    def barriers():
        kernels.check(blib.aha_barriers(n_bar, grid, stream), "aha_barriers")

    a_ms = device_ms(barriers, iters=20)

    # (b): the same wrapper over a library built from the edited copy
    csrc = work / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    (csrc / source).write_text(drop_calls(src, DROPPED))
    saved = kernels.CSRC, kernels._lib
    try:
        kernels.CSRC, kernels._lib = csrc, None
        kernels.lib()
        b_ms = device_ms(step, iters=20)
    finally:
        kernels.CSRC, kernels._lib = saved
        # the edited kernel's folds may leave tickets behind
        fa.ticket_counters(dev, stream, 1).zero_()
    torch.cuda.synchronize()
    rows = {"card": card_line(), "grids": args.grids, "layers": L,
            "pos": POS,
            "barriers_per_step": n_bar, "a_barriers_ms": a_ms,
            "b_stream_ms": b_ms, "c_stack_ms": c_ms,
            "weight_bytes": wbytes,
            "b_gb_s": wbytes / b_ms / 1e6, "c_gb_s": wbytes / c_ms / 1e6}
    print(f"[stack_parts] {args.grids}: (a) {n_bar} grid barriers "
          f"{a_ms:.4f} ms; (b) the "
          f"GEMV phases alone {b_ms:.4f} ms ({rows['b_gb_s']:.1f} GB/s); (c) "
          f"the stack {c_ms:.4f} ms ({rows['c_gb_s']:.1f} GB/s)", flush=True)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
