"""One launch per decoder layer on the card (the port of
scripts/exp_fused_layer.py): what weight-stream rate does a kernel reach
that streams all of a Qwen3-0.6B layer's weights in one launch, with 2-4
stages in flight?

    python -m aha_tpu_torch.studies.exp_fused_layer [--quick]

`fused_layer_stream` ← make_fused (fused_layer_kernel),
csrc/study_fused_layer.cu: the matmul chain of one layer at M = 8 rows,
bf16 — qkv (1024 × 4096), tanh of qkv's first 2048 f32 columns as the
stand-in for attention, o (2048 × 1024), gate|up (1024 × 6144), SiLU(g)·u
in f32, down (3072 × 1024) — the (8, 1024) bf16 output accumulated in bf16
after each 1024-row chunk (o 0, o 1, down 0-2).  31.46 MB of weights a
layer (BYTES_PER_LAYER), L = 28 layers (881 MB, past the 50 MB L2), seeded
N(0, 0.02²) weights as the script's.  A step is 28 chained launches with
the script's carried c ← c + 1e-6·out.  Variants: (tile rows, NBUF) — the
stage tile of each cp.async ring slot and the number of slots, the H100
form of the script's (cn, nbuf) sweep.  The baseline is the script's
`make_xla` chain (four torch.matmul, tanh, SiLU) per layer; no single
PyTorch call computes the layer (library_ms is null).
"""

from __future__ import annotations

import argparse

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.flash_attention import ticket_counters
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.studies import (bound, card_line, device_ms, rel_err,
                                   report, require_card)

L = 28
H = 1024          # hidden
NQKV = 4096       # q (2048) | k (1024) | v (1024)
NO = 2048         # o projection input (attention output)
NI = 3072         # intermediate
M = 8             # decode rows
BYTES_PER_LAYER = 2 * (H * NQKV + NO * H + H * 2 * NI + NI * H)
#: (tile rows, NBUF) the kernel is built for; the first, the fastest on an
#: H100 (PERF.md §6, row 23), is the default
VARIANTS = ((128, 3), (128, 4), (128, 2), (64, 4), (64, 3), (64, 2),
            (32, 4), (32, 3), (32, 2))
STEPS = 4
#: kernel vs plain, relative to max |ref|: the bf16 roundings of the folds
TOL_REL = 2.0 ** -7
#: csrc/study_fused_layer.cu's scratch: K quarters of phase 1, row tiles
#: of phase 2, column tiles of phase 2
P1_SLICES, P2_TILES, P2_COLUMN_TILES = 4, 40, 16


def fused_layer_stream_plain(x, wqkv, wo, wgu, wdn, layer) -> torch.Tensor:
    """The TPU kernel's numerics: f32 products of the bf16 weights, the
    output rounded to bf16 after each 1024-row chunk."""
    li = layer.reshape(1).long()
    pick = [t.index_select(0, li)[0].float() for t in (wqkv, wo, wgu, wdn)]
    qkv_w, o_w, gu_w, dn_w = pick
    xf = x.float()
    attn = torch.tanh((xf @ qkv_w)[:, :NO])
    h = xf @ gu_w
    g, u = h[:, :NI], h[:, NI:]
    act = g * (1.0 / (1.0 + torch.exp(-g))) * u
    parts = [attn[:, j * H:(j + 1) * H] @ o_w[j * H:(j + 1) * H]
             for j in range(NO // H)]
    parts += [act[:, j * H:(j + 1) * H] @ dn_w[j * H:(j + 1) * H]
              for j in range(NI // H)]
    out = parts[0].to(torch.bfloat16)
    for part in parts[1:]:
        out = (out.float() + part).to(torch.bfloat16)
    return out


def fused_layer_stream(x, wqkv, wo, wgu, wdn, layer, tile: int = 128,
                       nbuf: int = 3) -> torch.Tensor:
    """x (8, 1024) bf16; the stacked weights wqkv (L, 1024, 4096), wo (L,
    2048, 1024), wgu (L, 1024, 6144), wdn (L, 3072, 1024) bf16; layer an
    int32 scalar on x's device → (8, 1024) bf16 for that layer."""
    if not x.is_cuda:
        return fused_layer_stream_plain(x, wqkv, wo, wgu, wdn, layer)
    Ln = wqkv.shape[0]
    shapes = {"wqkv": (wqkv, (Ln, H, NQKV)), "wo": (wo, (Ln, NO, H)),
              "wgu": (wgu, (Ln, H, 2 * NI)), "wdn": (wdn, (Ln, NI, H))}
    for what, (t, shape) in shapes.items():
        require(tuple(t.shape) == shape and t.dtype == torch.bfloat16
                and t.is_contiguous() and t.device == x.device
                and t.data_ptr() % 16 == 0,
                f"{what} must be {shape} bf16, contiguous, aligned")
    require(tuple(x.shape) == (M, H) and x.dtype == torch.bfloat16
            and x.is_contiguous() and x.data_ptr() % 16 == 0,
            f"x must be ({M}, {H}) bf16, contiguous, aligned")
    require(layer.dtype == torch.int32 and layer.numel() == 1
            and layer.device == x.device, "layer is an int32 scalar")
    require((tile, nbuf) in VARIANTS, f"(tile, nbuf) one of {VARIANTS}")
    f32 = dict(dtype=torch.float32, device=x.device)
    p1 = torch.empty((P1_SLICES, M, NQKV + 2 * NI), **f32)
    p2 = torch.empty((P2_TILES, M, H), **f32)
    stream = kernels.stream_handle(x)
    tickets = ticket_counters(x.device, stream, P2_COLUMN_TILES)
    out = torch.empty((M, H), dtype=torch.bfloat16, device=x.device)
    rc = kernels.lib().aha_study_fused_layer(
        x.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), wgu.data_ptr(),
        wdn.data_ptr(), layer.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), Ln, tile, nbuf, stream)
    kernels.check(rc, "aha_study_fused_layer")
    fused_layer_stream.launches += 1
    return out


fused_layer_stream.launches = 0


def xla_chain_layer(x, wqkv, wo, wgu, wdn, layer) -> torch.Tensor:
    """The script's make_xla body in PyTorch (the baseline): bf16 matmuls,
    tanh and SiLU between them."""
    li = layer.reshape(1).long()
    qkv_w, o_w, gu_w, dn_w = (t.index_select(0, li)[0]
                              for t in (wqkv, wo, wgu, wdn))
    a = torch.tanh((x @ qkv_w)[:, :NO].float()).to(torch.bfloat16)
    o = (a @ o_w).float()
    h = (x @ gu_w).float()
    g, u = h[:, :NI], h[:, NI:]
    act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    return (o + (act @ dn_w).float()).to(torch.bfloat16)


def chain(layer_fn, x, ws, layers, steps: int) -> torch.Tensor:
    """`steps` passes over the layers, the script's carried c ← c +
    1e-6·out after each layer."""
    c = x
    for _ in range(steps):
        for lt in layers:
            c = c + 1e-6 * layer_fn(c, *ws, lt)
    return c


def weights(device, n_layers: int = L, seed: int = 0):
    """(wqkv, wo, wgu, wdn) at 0.02·N(0, 1) and x N(0, 1), bf16."""
    g = torch.Generator(device=device).manual_seed(seed)

    def w(*shape):
        return (0.02 * torch.randn(shape, generator=g, device=device)).to(
            torch.bfloat16)

    ws = (w(n_layers, H, NQKV), w(n_layers, NO, H), w(n_layers, H, 2 * NI),
          w(n_layers, NI, H))
    x = torch.randn((M, H), generator=g, device=device).to(torch.bfloat16)
    return ws, x


def measure(quick: bool = False, iters: int = 56) -> list[dict]:
    dev = require_card()
    ws, x = weights(dev)
    layers = [torch.tensor(i, dtype=torch.int32, device=dev) for i in range(L)]
    it = iter(range(10 ** 9))

    def layer():                    # the layers in turn: every call reads HBM
        return layers[next(it) % L]

    nbytes = BYTES_PER_LAYER + 2 * M * H * 2
    b = bound(nbytes, 2 * M * BYTES_PER_LAYER // 2)
    refs = {li: fused_layer_stream_plain(x, *ws, layers[li])
            for li in (0, L - 1)}
    plain_ms = device_ms(lambda: fused_layer_stream_plain(x, *ws, layer()),
                         28)
    xla_ms = device_ms(lambda: xla_chain_layer(x, *ws, layer()), iters)
    print(f"[baseline] the script's XLA chain in PyTorch: {xla_ms:.4f} ms a "
          f"layer, {BYTES_PER_LAYER / xla_ms / 1e6:.1f} GB/s of weights",
          flush=True)
    rows = []
    for tile, nbuf in VARIANTS[:1] if quick else VARIANTS:
        def fn(c, *a):
            return fused_layer_stream(c, *a, tile=tile, nbuf=nbuf)
        err = 0.0
        for li, ref in refs.items():
            e, r = rel_err(fn(x, *ws, layers[li]), ref)
            require(r <= TOL_REL, f"fused_layer_stream tile={tile} nbuf={nbuf}"
                    f" layer {li}: {r} of max |ref| (tol {TOL_REL})")
            again = fn(x, *ws, layers[li])
            require(torch.equal(again, fn(x, *ws, layers[li])),
                    "fused_layer_stream is not bit-equal on a repeat")
            err = max(err, e)
        ms = device_ms(lambda: fn(x, *ws, layer()), iters)
        # the script's step: 28 chained launches, carried c
        c = chain(fn, x, ws, layers, 1)
        want = chain(fused_layer_stream_plain, x, ws, layers, 1)
        require(rel_err(c, want)[1] <= TOL_REL, "the 28-layer chain")
        step_ms = device_ms(lambda: chain(fn, x, ws, layers, 1), 3 if quick
                            else STEPS, 1, key="fused_layer_stream")
        print(f"[chain tile={tile} nbuf={nbuf}] 28 chained launches: "
              f"{step_ms:.4f} ms of fused kernels a step, "
              f"{L * BYTES_PER_LAYER / step_ms / 1e6:.1f} GB/s", flush=True)
        rows.append(dict(name="fused_layer_stream",
                         variant=f"tile={tile} nbuf={nbuf}", ms=ms,
                         gbps=BYTES_PER_LAYER / ms / 1e6, bound_ms=b[0],
                         bound_by=b[1], plain_ms=plain_ms, library_ms=None,
                         library=None, max_abs_err=err, step_ms=step_ms,
                         xla_chain_ms=xla_ms))
    return rows


def main(argv: list[str] | None = None) -> dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the default (tile, NBUF) only")
    args = ap.parse_args(argv)
    require_card()
    print(card_line(), flush=True)
    rows = measure(args.quick)
    report(rows)
    return {rows[0]["name"]: rows[0]}


if __name__ == "__main__":
    main()
