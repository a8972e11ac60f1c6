"""Minimal functional layer library (counterpart of aha_tpu/core/nn.py).

Parameters are plain dicts of tensors; dense linear weights are stored
**(in, out)** as in the JAX package, so the forward is `x @ w`.  A GGUF
block-quantized dict ({"qt", "st"} or {"q4", "s4", "b4"}, the port's
column-major grids) goes to ops/quant_matmul.quant_linear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aha_tpu_torch.ops.quant_matmul import (is_quantized, quant_linear,
                                            quant_swiglu, swiglu_fusable)

Params = dict


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    if is_quantized(p):
        return quant_linear(p, x)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids.long()]


def swiglu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """gate/up/down MLP with SiLU; separate gate/up weights or one fused
    ``gateup`` matrix ([gate | up] on the output axis).  A quantized
    gateup + down pair at decode M runs the whole MLP as one fused kernel
    on the card (ops/quant_matmul.quant_swiglu), as the JAX package does on
    a TPU; elsewhere, and on the CPU, it is two quantized linears."""
    if "gateup" in p:
        gu, dn = p["gateup"], p["down"]
        m = x.numel() // x.shape[-1]
        if x.is_cuda and swiglu_fusable(gu, dn, m):
            return quant_swiglu(gu, dn, x)
        g, u = linear(gu, x).chunk(2, dim=-1)
        return linear(dn, F.silu(g) * u)
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))
