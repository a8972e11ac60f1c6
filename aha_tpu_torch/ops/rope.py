"""Rotary position embeddings, half-rotation form (counterpart of
aha_tpu/ops/rope.py; M-RoPE is not ported yet).  Tables are float32,
computed in float64 on the host once and gathered by position."""

from __future__ import annotations

import numpy as np
import torch


def rope_table(head_dim: int, max_len: int, theta: float = 10000.0,
               device: torch.device | str = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (max_len, head_dim // 2), float32."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k: (..., seq, heads, head_dim); cos/sin: (seq, head_dim // 2),
    broadcast over the heads axis."""
    cos2 = torch.cat([cos, cos], dim=-1)[..., :, None, :].to(q.dtype)
    sin2 = torch.cat([sin, sin], dim=-1)[..., :, None, :].to(q.dtype)
    return (q * cos2 + rotate_half(q) * sin2,
            k * cos2 + rotate_half(k) * sin2)


def gather_rope(cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token cos/sin rows for position ids (a device tensor: no host
    sync)."""
    positions = positions.long()
    return cos[positions], sin[positions]
