"""Fused LM-head GEMV + argmax for plain-greedy decode.

Replaces aha_tpu/ops/lm_head.py:head_argmax (bf16 dense head) with the
CUDA kernel of csrc/head_argmax.cu.  Bound: one read of the K·V·2 B head
(311 MB for Qwen3-0.6B); the 600 KB logits vector is never stored.

The head is stored vocab-major, (V, K) — for a tied head that is the
embedding table itself, with no transposed copy.  Ties go to the first
index, as jnp.argmax; any NaN logit gives V - 1, as fast_argmax.  On the
CPU the plain version (logits + fast_argmax) runs; on the card the kernel
runs or this raises.  `head_argmax.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from aha_tpu_torch.core.sampling import fast_argmax
from aha_tpu_torch.ops import kernels


def head_argmax_plain(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    logits = h.reshape(1, -1).float() @ w.float().t()
    return fast_argmax(logits.reshape(-1))


def head_argmax(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Greedy token for ONE hidden state.  w: (V, K) head; h: (..., K) with
    exactly one row.  Returns a 0-dim int32 tensor on h's device."""
    K = h.shape[-1]
    if h.numel() != K:
        raise ValueError(f"head_argmax takes one hidden row, got {tuple(h.shape)}")
    if w.ndim != 2 or w.shape[1] != K:
        raise ValueError(f"head must be (V, {K}), got {tuple(w.shape)}")
    if not h.is_cuda:
        return head_argmax_plain(w, h)
    V = w.shape[0]
    if w.device != h.device:
        raise ValueError("head and hidden state on different devices")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("head_argmax kernel takes bf16 head and hidden")
    if K % 8 or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("head rows must be contiguous, 16-byte aligned, "
                         "K a multiple of 8")
    x = h.reshape(K).contiguous()
    lib = kernels.lib()
    n = lib.aha_head_argmax_parts(V)
    part_val = torch.empty(n, dtype=torch.float32, device=h.device)
    part_idx = torch.empty(n, dtype=torch.int32, device=h.device)
    part_nan = torch.empty(n, dtype=torch.int32, device=h.device)
    out = torch.empty((), dtype=torch.int32, device=h.device)
    rc = lib.aha_head_argmax(x.data_ptr(), w.data_ptr(), part_val.data_ptr(),
                             part_idx.data_ptr(), part_nan.data_ptr(),
                             out.data_ptr(), K, V, kernels.stream_handle(h))
    kernels.check(rc, "aha_head_argmax")
    head_argmax.launches += 1
    return out


head_argmax.launches = 0
