"""Convolution helpers, NCHW / OIHW and NCH / OIH (counterpart of
aha_tpu/ops/conv.py; the 1-D form is GLM-ASR's encoder's
`conv_general_dilated`, aha_tpu/models/glm_asr_nano.py:104-112).

The JAX package runs its convolutions through XLA, not a Pallas kernel;
here they are `F.conv2d` / `F.conv1d`.  The weight is cast to the input's dtype, as
the reference casts it."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(p: dict, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x (B, C, H, W), p["w"] (O, I, kh, kw), optional p["b"] (O,)."""
    b = p.get("b")
    return F.conv2d(x, p["w"].to(x.dtype),
                    None if b is None else b.to(x.dtype), stride=stride,
                    padding=padding)


def conv1d(p: dict, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x (B, C, T), p["w"] (O, I, k), optional p["b"] (O,)."""
    b = p.get("b")
    return F.conv1d(x, p["w"].to(x.dtype),
                    None if b is None else b.to(x.dtype), stride=stride,
                    padding=padding)


def layer_norm_2d(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the channels of NCHW (SAM's neck), in x's dtype as
    the reference computes it."""
    u = x.mean(dim=1, keepdim=True)
    s = (x - u).square().mean(dim=1, keepdim=True)
    x = (x - u) * torch.rsqrt(s + eps)
    return x * p["w"][None, :, None, None] + p["b"][None, :, None, None]
