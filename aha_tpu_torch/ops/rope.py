"""Rotary position embeddings, half-rotation form (counterpart of
aha_tpu/ops/rope.py): the 1-D tables, M-RoPE's contiguous t/h/w sections
(Qwen2.5-VL's text decoder) and the interleaved ones (Qwen3-VL's, and
Qwen3.5's over its partial rotary table), the vision towers' 2-D (h, w)
rotary, and the partial rotation of GLM-ASR's audio encoder.  Tables are
float32, computed in float64 on the host once and gathered by position.
Not ported: the pairwise (GPT-NeoX) rotation."""

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


def apply_partial_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, rotary_dim: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate only the first `rotary_dim` channels (GLM-ASR's encoder,
    rope.rs:172/:245); the rest pass through.  cos/sin: (seq,
    rotary_dim // 2)."""
    q_rot, k_rot = apply_rope(q[..., :rotary_dim], k[..., :rotary_dim],
                              cos, sin)
    return (torch.cat([q_rot, q[..., rotary_dim:]], dim=-1),
            torch.cat([k_rot, k[..., rotary_dim:]], dim=-1))


def gather_rope(cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token cos/sin rows for position ids (a device tensor: no host
    sync)."""
    positions = positions.long()
    return cos[positions], sin[positions]


def mrope_sections(half: int, mrope_section: tuple[int, ...]) -> np.ndarray:
    """Which of t/h/w (0/1/2) owns each of the `half` frequency channels:
    contiguous sections, channels past them to t (aha_tpu/ops/rope.py
    mrope_cos_sin, interleaved=False)."""
    sec = np.zeros(half, np.int64)
    start = 0
    for i, width in enumerate(mrope_section):
        sec[start:start + width] = i
        start += width
    return sec


def mrope_interleaved_sections(half: int, mrope_section: tuple[int, ...]
                               ) -> np.ndarray:
    """Interleaved M-RoPE: channel c takes axis c % 3 (h at 1, 4, 7, ...
    below 3 · mrope_section[1], w at 2, 5, 8, ... below 3 ·
    mrope_section[2], each clipped at `half`), every other channel t (the
    JAX models' `_mrope_sel`)."""
    sec = np.zeros(half, np.int64)
    for axis in (1, 2):
        sec[np.arange(axis, min(mrope_section[axis] * 3, half), 3)] = axis
    return sec


def mrope_cos_sin(cos: torch.Tensor, sin: torch.Tensor,
                  position_ids: torch.Tensor, sections: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(3, S) t/h/w position ids → (S, half) cos/sin: channel c takes the
    row of its section, sections[c] (mrope_sections, a device tensor)."""
    cos3, sin3 = gather_rope(cos, sin, position_ids)      # (3, S, half)
    sel = sections[None, None, :].expand(1, *cos3.shape[1:])
    return (torch.take_along_dim(cos3, sel, dim=0)[0],
            torch.take_along_dim(sin3, sel, dim=0)[0])


def vision_inv_freq(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """The vision tower's rotary frequencies: head_dim / 4 of them, shared
    by the h and w halves."""
    quarter = head_dim // 4
    return 1.0 / (theta ** (np.arange(quarter) / quarter))


def vision_cos_sin(inv_freq: torch.Tensor, pos_hw: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) (h, w) patch coordinates → (N, head_dim / 2) cos/sin: the h
    frequencies, then the w ones (float32)."""
    f = pos_hw.float()
    freqs = torch.cat([f[:, 0:1] * inv_freq[None, :],
                       f[:, 1:2] * inv_freq[None, :]], dim=-1)
    return torch.cos(freqs), torch.sin(freqs)
