"""Minimal functional layer library (counterpart of aha_tpu/core/nn.py).

Parameters are plain dicts of tensors; linear weights are stored
**(in, out)** as in the JAX package, so the forward is `x @ w`.  The GGUF
quantized branch of `linear` is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids.long()]


def swiglu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """gate/up/down MLP with SiLU; separate gate/up weights or one fused
    ``gateup`` matrix ([gate | up] on the output axis)."""
    if "gateup" in p:
        g, u = linear(p["gateup"], x).chunk(2, dim=-1)
        return linear(p["down"], F.silu(g) * u)
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))
