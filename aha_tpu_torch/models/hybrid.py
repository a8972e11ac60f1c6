"""What the hybrid decoders (models/lfm2.py, models/qwen3_5.py) share
besides their attention (models/cache_attention.py): the causal depthwise
conv with its rolling window.  The mixer layers own consecutive slots of
the rolling state `cache["conv"]` (and Qwen3.5's `cache["rec"]`,
core/cache.py STATE_KEYS), which every call rewrites in place through a
view, so a captured decode step keeps writing into the pooled cache it
was captured over.
"""

from __future__ import annotations

import torch


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor,
                prompt_len: int, from_cache: bool) -> torch.Tensor:
    """Causal depthwise conv of x (B, S, D) with taps w (L, D) over a
    rolling window `state` (B, L, D), a view of the cache rewritten in
    place: the last L inputs.  Prefill (S > 1) takes its left context from
    zeros, or with `from_cache` from the window's last L − 1 inputs (a
    chunk that continues a restored or earlier chunk's state), and leaves
    the window ending at the true length's last row (`prompt_len` − 1:
    padded rows never enter it).  A decode step rolls the window by one and
    convolves it.  The JAX models' _conv / _linear_attn window arithmetic
    (aha_tpu/models/lfm2.py:167-204, qwen3_5.py:394-410)."""
    B, S, D = x.shape
    L = w.shape[0]
    if S > 1:
        left = (state[:, 1:].to(x.dtype) if from_cache
                else x.new_zeros((B, L - 1, D)))
        padded = torch.cat([left, x], dim=1)
        out = sum(padded[:, i:i + S] * w[i] for i in range(L))
        start = max(prompt_len - 1, 0)
        state.copy_(padded[:, start:start + L])
        return out
    window = torch.cat([state[:, 1:].to(x.dtype), x], dim=1)
    state.copy_(window)
    # taps kept in float32 (a GGUF file's) promote the product, as in JAX
    dt = torch.promote_types(window.dtype, w.dtype)
    return torch.einsum("bld,ld->bd", window.to(dt), w.to(dt))[:, None]
