"""Attention ops (counterpart of aha_tpu/ops/attention.py).

Shape convention: q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D); GQA by head
groups (no repeated K/V).  `sdpa` is the plain reference — softmax in
float32, probabilities cast to v's dtype for the second product, as in
the JAX package.  On the card, prefill of bucketed prompts ≥ 128 rows and
every decode step go through the CUDA kernels of ops/flash_attention.py;
the gates are explicit shape conditions.
"""

from __future__ import annotations

import torch

_F32_MIN = torch.finfo(torch.float32).min


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None,
         scale: float | None = None) -> torch.Tensor:
    """mask: broadcastable to (B, Hq, Sq, Skv), additive or boolean (True =
    attend).  Returns (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if mask is not None:
        m = mask
        if m.dtype == torch.bool:
            m = torch.where(m, 0.0, _F32_MIN)
        if m.ndim == 4:   # (B|1, Hq|1, Sq, Skv) → insert the group axis
            if m.shape[1] == Hq and Hq > 1:
                m = m.reshape(m.shape[0], Hkv, G, Sq, m.shape[-1])
            else:
                m = m[:, :, None]
        scores = scores + m.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: torch.Tensor | int = 0,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Additive (1, 1, q_len, kv_len) mask, causal in absolute positions
    (`q_offset` may be a device tensor: no host sync)."""
    if isinstance(q_offset, torch.Tensor):
        device = q_offset.device
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return torch.where(k_pos <= q_pos, 0.0, _F32_MIN)[None, None]


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """Prefill over the fresh block: the flash kernel's wrapper for
    bucketed shapes (D % 64 == 0, Sq ≥ 128 — the JAX `_flash_eligible`
    gate; the wrapper picks the kernel or its plain version by device),
    plain sdpa otherwise."""
    if q.shape[3] % 64 == 0 and q.shape[1] >= 128:
        from aha_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    mask = causal_mask(q.shape[1], k.shape[1], device=q.device) \
        if causal else None
    return sdpa(q, k, v, mask, scale=scale)


def attention_decode_at(q: torch.Tensor, k_stack: torch.Tensor,
                        v_stack: torch.Tensor, layer: torch.Tensor,
                        valid_len: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Decode attention reading layer `layer` of the stacked flat cache
    (L, B, S, Hkv·D) over rows [0, valid_len) — valid_len is the JAX
    function's `pos + 1`, computed once per step by the caller.  One query
    row: the decode kernel's wrapper (kernel or plain version by
    device)."""
    from aha_tpu_torch.ops.flash_attention import flash_decode_at_layer_flat

    return flash_decode_at_layer_flat(q, k_stack, v_stack, layer, valid_len,
                                      scale=scale)


def attention_prefill_at(q: torch.Tensor, k_stack: torch.Tensor,
                         v_stack: torch.Tensor, layer: torch.Tensor,
                         start: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Prefill for a chunk written at cache offset `start` (a device
    scalar): row i attends cache rows [0, start + i] of layer `layer` —
    the prefix-cache suffix prefill.  Plain on every device, as in the JAX
    package."""
    B, _, _, D = q.shape
    li = layer.reshape(1).long()
    k_all = k_stack.index_select(0, li)[0]
    v_all = v_stack.index_select(0, li)[0]
    k_all = k_all.reshape(B, k_all.shape[1], -1, D)
    v_all = v_all.reshape(B, v_all.shape[1], -1, D)
    mask = causal_mask(q.shape[1], k_all.shape[1], q_offset=start)
    return sdpa(q, k_all, v_all, mask, scale=scale)
