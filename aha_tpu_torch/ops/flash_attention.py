"""Attention kernels: prefill flash attention and stacked-cache decode.

Each wrapper launches its CUDA kernel (csrc/) for tensors on the card and
runs its plain PyTorch version, in the same module, for tensors on the
CPU — never a fallback on a CUDA tensor: the kernel runs or the wrapper
raises.  `<wrapper>.launches` counts kernel launches.

- `flash_attention` ← aha_tpu/ops/flash_attention.py:flash_attention
  (csrc/flash_prefill.cu): bound by tensor-core FLOPs at long prompts;
  mma.sync tiles with the online softmax in registers.
- `flash_decode_at_layer_flat` ← aha_tpu/ops/flash_attention.py:
  flash_decode_at_layer_flat (csrc/decode_attention.cu): bound by the
  bytes of the live cache rows; split-KV over 64-row chunks plus a combine
  pass, so a short batch-1 step still spreads over many SMs.
"""

from __future__ import annotations

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.attention import causal_mask, sdpa

#: cache rows per decode split (one pass-1 block per split and kv-head):
#: short splits keep many blocks in flight, each walking few serial rows
DECODE_ROWS_PER_SPLIT = 64


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


# -- decode ------------------------------------------------------------------


def flash_decode_at_layer_flat_plain(q, k_stack, v_stack, layer, valid_len,
                                     scale=None):
    """Plain version: slice the addressed layer, mask rows >= valid_len,
    softmax in float32."""
    B, _, Hq, D = q.shape
    _, _, S, HD = k_stack.shape
    li = layer.reshape(1).long()
    k = k_stack.index_select(0, li)[0].reshape(B, S, HD // D, D)
    v = v_stack.index_select(0, li)[0].reshape(B, S, HD // D, D)
    live = (torch.arange(S, device=q.device)[None, :]
            < valid_len.reshape(-1, 1))                  # (B | 1, S)
    mask = live[:, None, None, :]
    return sdpa(q.float(), k.float(), v.float(), mask, scale).to(q.dtype)


def flash_decode_at_layer_flat(q: torch.Tensor, k_stack: torch.Tensor,
                               v_stack: torch.Tensor, layer: torch.Tensor,
                               valid_len: torch.Tensor,
                               scale: float | None = None) -> torch.Tensor:
    """One-token attention for layer `layer` straight from the stacked flat
    cache.  q (B, 1, Hq, D); k/v (L, B, S, Hkv·D); layer an int32 device
    scalar; valid_len int32 (1,) or (B,) — rows [0, valid_len) are live.
    Returns (B, 1, Hq, D)."""
    B, Sq, Hq, D = q.shape
    require(Sq == 1, "decode attention takes one query row")
    require(k_stack.ndim == 4 and k_stack.shape == v_stack.shape,
            "k/v must be (L, B, S, Hkv*D)")
    L, Bk, S, HD = k_stack.shape
    require(Bk == B and HD % D == 0, "cache does not match q")
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        return flash_decode_at_layer_flat_plain(q, k_stack, v_stack, layer,
                                                valid_len, scale)
    Hkv = HD // D
    for t in (k_stack, v_stack, layer, valid_len):
        require(t.device == q.device, "all inputs on one device")
    require(q.dtype == k_stack.dtype == v_stack.dtype == torch.bfloat16,
            "decode kernel takes bf16 q/k/v")
    require(layer.dtype == valid_len.dtype == torch.int32,
            "layer/valid_len must be int32")
    require(layer.numel() == 1 and valid_len.numel() in (1, B),
            "layer is a scalar, valid_len (1,) or (B,)")
    require(D in (64, 128) and Hq % Hkv == 0
            and Hq // Hkv in (1, 2, 4, 8), f"unsupported D={D} G={Hq}/{Hkv}")
    require(q.is_contiguous() and k_stack.is_contiguous()
            and v_stack.is_contiguous() and valid_len.is_contiguous(),
            "decode kernel takes contiguous tensors")
    require(_aligned16(q) and _aligned16(k_stack) and _aligned16(v_stack),
            "decode kernel needs 16-byte aligned q/k/v")
    nsplit = max(1, -(-S // DECODE_ROWS_PER_SPLIT))
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, Hq, nsplit), **f32)
    part_l = torch.empty((B, Hq, nsplit), **f32)
    part_acc = torch.empty((B, Hq, nsplit, D), **f32)
    out = torch.empty_like(q)
    rc = kernels.lib().aha_decode_attention(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        layer.data_ptr(), valid_len.data_ptr(),
        0 if valid_len.numel() == 1 else 1, part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        D, L, S, nsplit, float(scale), kernels.stream_handle(q))
    kernels.check(rc, "aha_decode_attention")
    flash_decode_at_layer_flat.launches += 1
    return out


flash_decode_at_layer_flat.launches = 0


# -- prefill -----------------------------------------------------------------


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """Plain version: materialized scores, softmax in float32."""
    mask = causal_mask(q.shape[1], k.shape[1], device=q.device) \
        if causal else None
    return sdpa(q.float(), k.float(), v.float(), mask, scale).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D) → (B, Sq, Hq, D).  On the
    card Sq and Skv must be multiples of 64 (the engine's power-of-two
    prefill buckets ≥ 128 are) and D 64 or 128."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D
            and Hq % Hkv == 0, "q/k/v shapes do not match")
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, scale)
    require(k.device == q.device and v.device == q.device,
            "all inputs on one device")
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            "prefill kernel takes bf16 q/k/v")
    require(D in (64, 128), f"prefill kernel takes D 64 or 128, not {D}")
    require(Sq % 64 == 0 and Skv % 64 == 0,
            f"prefill kernel needs Sq, Skv multiples of 64 ({Sq}, {Skv})")
    require(all(t.stride(-1) == 1 for t in (q, k, v)),
            "prefill kernel needs a contiguous channel axis")
    # 4-byte fragment loads of q; 16-byte row loads of k/v
    require(q.data_ptr() % 4 == 0 and all(s % 2 == 0 for s in q.stride()[:3]),
            "q rows must be 4-byte aligned")
    require(all(_aligned16(t) and all(s % 8 == 0 for s in t.stride()[:3])
                for t in (k, v)), "k/v rows must be 16-byte aligned")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = kernels.lib().aha_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, Sq, Skv, Hq, Hkv, D, int(causal), float(scale),
        kernels.stream_handle(q))
    kernels.check(rc, "aha_flash_prefill")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
