"""Attention ops (counterpart of aha_tpu/ops/attention.py).

Shape convention: q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D); GQA by head
groups (no repeated K/V).  `sdpa` is the plain reference — softmax in
float32, probabilities cast to v's dtype for the second product, as in
the JAX package.  On the card, prefill of bucketed prompts ≥ 128 rows and
every decode step go through the CUDA kernels of ops/flash_attention.py;
the gates are explicit shape conditions.  The int8 cache layout
(core/cache.py) adds `quantize_kv_rows` and the `_q8` variants: decode
through the q8 kernels, chunk prefill plain (dequantize, then sdpa).
`attention_decode_at` reads the flat (L, B, S, Hkv·D) cache or the
stacked (L, B, S, Hkv, D) one of the llama-family decoders, routed by its
rank as the JAX function routes it; `segment_attention` is the vision
towers' window / full-image attention.
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
    bucketed shapes (D % 64 == 0, Sq ≥ 128, Sq and Skv multiples of 64 —
    the JAX `_flash_eligible` gate in the kernel's own tile terms; the
    wrapper picks the kernel or its plain version by device, and on the
    card takes D 64 to 256, `flash_attention.prefill_takes`, and raises
    past that), plain sdpa otherwise."""
    if (q.shape[3] % 64 == 0 and q.shape[1] >= 128
            and q.shape[1] % 64 == 0 and k.shape[1] % 64 == 0):
        from aha_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    mask = causal_mask(q.shape[1], k.shape[1], device=q.device) \
        if causal else None
    return sdpa(q, k, v, mask, scale=scale)


def attention_decode_at(q: torch.Tensor, k_stack: torch.Tensor,
                        v_stack: torch.Tensor, layer: torch.Tensor,
                        valid_len: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Decode attention reading layer `layer` of the stacked cache — flat
    (L, B, S, Hkv·D) or (L, B, S, Hkv, D) — over rows [0, valid_len):
    valid_len is the JAX function's `pos + 1`, (1,) or per slot (B,),
    computed once per step by the caller.  One query row: the decode
    kernel's wrapper (kernel or plain version by device; on the card the
    kernel takes D 64 to 256 and any G, `flash_attention.decode_takes`,
    and a wider head raises).  Five dimensions
    go to flash_decode_at_layer for any B; of the flat cache, B > 1 slots
    go to the batched wrapper, as the JAX function routes them."""
    from aha_tpu_torch.ops import flash_attention as fa

    if k_stack.ndim == 5:
        fn = fa.flash_decode_at_layer
    elif q.shape[0] > 1:
        fn = fa.flash_decode_at_layer_flat_batched
    else:
        fn = fa.flash_decode_at_layer_flat
    return fn(q, k_stack, v_stack, layer, valid_len, scale=scale)


def attention_decode(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, pos: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token decode over one (B, S, Hkv, D) cache; `pos` (0-dim or
    (B,) int32) is the row the new K/V was just written at, so rows
    [0, pos] are live: flash_decode's wrapper."""
    from aha_tpu_torch.ops.flash_attention import flash_decode

    return flash_decode(q, k_all, v_all, (pos + 1).reshape(-1).int(),
                        scale=scale)


def segment_mask(seg: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Boolean (1, 1, S, S): row i attends row j iff seg[i] == seg[j] ≥ 0
    (a pad row, seg < 0, attends nothing)."""
    seg = seg.to(device)
    return ((seg[:, None] == seg[None, :]) & (seg[None, :] >= 0))[None, None]


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seg: torch.Tensor,
                      scale: float | None = None) -> torch.Tensor:
    """Self-attention where row i attends row j iff seg[i] == seg[j]
    (vision-tower windows and whole images; a seg < 0 row is padding whose
    output is 0).  q/k/v (B, S, H, D); seg (S,) int32.  The segment
    kernel's wrapper at any S: the kernel on the card, its plain version
    on the CPU."""
    from aha_tpu_torch.ops.flash_attention import flash_attention_segmented

    return flash_attention_segmented(q, k, v, seg, scale=scale)


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each row over the head_dim axis:
    x (..., D) → int8 (..., D) and float32 scales (...), with
    s = max(absmax, 1e-8) / 127, round half to even, clip ±127 — the JAX
    function's arithmetic, so the int8 rows agree bit for bit."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    qx = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return qx, s


def dequantize_layer(stack: torch.Tensor, scales: torch.Tensor,
                     layer: torch.Tensor, D: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Layer `layer` of an int8 flat stack (L, B, S, Hkv·D) with scales
    (L, B, S, Hkv) → (B, S, Hkv, D) in `dtype` (the JAX fallback rounds
    the f32 product to the query's dtype)."""
    li = layer.reshape(1).long()
    x = stack.index_select(0, li)[0]
    B, S, _ = x.shape
    x = x.reshape(B, S, -1, D).float()
    sc = scales.index_select(0, li)[0]
    return (x * sc[..., None]).to(dtype)


def attention_decode_at_q8(q: torch.Tensor, k_stack: torch.Tensor,
                           v_stack: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, layer: torch.Tensor,
                           valid_len: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """attention_decode_at over the int8 cache layout: the q8 decode
    kernel's wrapper, the batched one for B > 1 slots."""
    from aha_tpu_torch.ops import flash_attention as fa

    fn = (fa.flash_decode_at_layer_q8_batched if q.shape[0] > 1
          else fa.flash_decode_at_layer_q8)
    return fn(q, k_stack, v_stack, k_scale, v_scale, layer, valid_len,
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


def attention_prefill_at_q8(q: torch.Tensor, k_stack: torch.Tensor,
                            v_stack: torch.Tensor, k_scale: torch.Tensor,
                            v_scale: torch.Tensor, layer: torch.Tensor,
                            start: torch.Tensor,
                            scale: float | None = None) -> torch.Tensor:
    """attention_prefill_at over the int8 cache layout: dequantize the
    addressed layer's rows, then the chunk-at-offset sdpa.  Plain on every
    device, as in the JAX package (one call per chunk, not per token)."""
    D = q.shape[3]
    k_all = dequantize_layer(k_stack, k_scale, layer, D, q.dtype)
    v_all = dequantize_layer(v_stack, v_scale, layer, D, q.dtype)
    mask = causal_mask(q.shape[1], k_all.shape[1], q_offset=start)
    return sdpa(q, k_all, v_all, mask, scale=scale)
