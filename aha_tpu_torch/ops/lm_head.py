"""Fused LM-head GEMV + argmax for plain-greedy decode.

Replaces aha_tpu/ops/lm_head.py:head_argmax with the CUDA kernels of
csrc/head_argmax.cu: the bf16 dense head, and the int8 and 4-bit GGUF
grids (ops/quant_matmul.py layouts), whose bodies quantize the hidden state
per 128-group in the kernel as the Pallas bodies do.  Bound: one read of
the head — K·V·2 B bf16 (311 MB for Qwen3-0.6B), 160 MB int8, 87.5 MB
4-bit; the 600 KB logits vector is never stored.

`head_argmax(p, h)` takes the head dict, as the JAX function does: a dense
`w` goes to the bf16 kernel, {qt, st} to the int8 body, {q4, s4, b4} to the
4-bit body; a layout no body takes raises ValueError.  The dense head is
stored vocab-major, (V, K) — for a tied head that is the embedding table
itself, with no transposed copy — and the grids are vocab-major by their
layout.  Ties go to the first index, as jnp.argmax; any NaN logit gives
V − 1, as fast_argmax (the Pallas kernel returns 0 for an all-NaN row).  On
the CPU each body's plain version runs (logits + fast_argmax, the
quantized logits with the kernels' activation quantization); on the card
the kernel runs or this raises.  Launch counts: `head_argmax.launches`
(bf16), `head_argmax_q8.launches`, `head_argmax_q4.launches`.
"""

from __future__ import annotations

import torch

from aha_tpu_torch.core.sampling import fast_argmax
from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.quant_matmul import check_grid, grid_k, qdot, quant_acts


def head_argmax_plain(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    logits = h.reshape(1, -1).float() @ w.float().t()
    return fast_argmax(logits.reshape(-1))


def quant_head_plain(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Plain version of both quantized bodies: the logits with the kernels'
    activation quantization, then fast_argmax."""
    return fast_argmax(qdot(p, *quant_acts(h.reshape(1, -1), grid_k(p)))[0])


def _one_row(h: torch.Tensor) -> torch.Tensor:
    K = h.shape[-1]
    if h.numel() != K:
        raise ValueError(f"head_argmax takes one hidden row, got {tuple(h.shape)}")
    return h.reshape(K)


def _parts(V: int, device) -> tuple[torch.Tensor, ...]:
    n = kernels.lib().aha_head_argmax_parts(V)
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.int32, device=device))


def _bf16_head(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    x = _one_row(h)
    K = x.shape[0]
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
    x = x.contiguous()
    part_val, part_idx, part_nan, out = _parts(V, h.device)
    rc = kernels.lib().aha_head_argmax(
        x.data_ptr(), w.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        part_nan.data_ptr(), out.data_ptr(), K, V, kernels.stream_handle(h))
    kernels.check(rc, "aha_head_argmax")
    head_argmax.launches += 1
    return out


def _launch_quant(p: dict, h: torch.Tensor, what: str) -> torch.Tensor:
    x = _one_row(h)
    kernels.require(h.dtype == torch.bfloat16,
                    f"{what} kernel takes a bf16 hidden state")
    x = x.contiguous()
    K = x.shape[0]
    V, Kp = check_grid(p, h.device, K, what)
    part_val, part_idx, part_nan, out = _parts(V, h.device)
    q4 = "q4" in p
    rc = kernels.lib().aha_head_argmax_quant(
        x.data_ptr(), (p["q4"] if q4 else p["qt"]).data_ptr(),
        (p["s4"] if q4 else p["st"]).data_ptr(),
        p["b4"].data_ptr() if q4 else None, part_val.data_ptr(),
        part_idx.data_ptr(), part_nan.data_ptr(), out.data_ptr(), K, Kp, V,
        int(q4), kernels.stream_handle(h))
    kernels.check(rc, "aha_head_argmax_quant")
    return out


def head_argmax_q8(qt: torch.Tensor, st: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Greedy token over the int8-grid head (V, Kp) for ONE hidden row."""
    p = {"qt": qt, "st": st}
    if not h.is_cuda:
        return quant_head_plain(p, _one_row(h))
    out = _launch_quant(p, h, "head_argmax_q8")
    head_argmax_q8.launches += 1
    return out


def head_argmax_q4(q4: torch.Tensor, s4: torch.Tensor, b4: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Greedy token over the 4-bit-grid head (V, Kp/2) for ONE hidden row."""
    p = {"q4": q4, "s4": s4, "b4": b4}
    if not h.is_cuda:
        return quant_head_plain(p, _one_row(h))
    out = _launch_quant(p, h, "head_argmax_q4")
    head_argmax_q4.launches += 1
    return out


def head_argmax(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Greedy token for ONE hidden state over the head dict `p`; h: (..., K)
    with exactly one row.  Returns a 0-dim int32 tensor on h's device."""
    if "b" in p:
        raise ValueError("biased heads are not fused")
    if "w" in p:
        return _bf16_head(p["w"], h)
    if "qt" in p:
        return head_argmax_q8(p["qt"], p["st"], h)
    if "q4" in p:
        return head_argmax_q4(p["q4"], p["s4"], p["b4"], h)
    raise ValueError(f"unsupported head layout: {sorted(p)}")


head_argmax.launches = 0
head_argmax_q8.launches = 0
head_argmax_q4.launches = 0
