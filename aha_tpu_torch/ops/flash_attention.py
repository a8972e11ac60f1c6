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
- `flash_decode_at_layer_flat_batched` ← flash_decode_at_layer_flat_batched
  (the same kernel at B slots): the TPU kernel folds the slots into one
  block only to spare the Pallas grid sequencer; here the grid is
  (split, kv-head, slot) with per-slot lengths, and a block past its
  slot's length exits at once.
- `flash_decode_at_layer_q8` / `flash_decode_at_layer_q8_batched` ←
  flash_decode_at_layer_q8 / _q8_batched (csrc/decode_attention_q8.cu):
  the int8 cache, half the bytes per row; the same split-KV grid, scales
  folded into the score and probability vectors.  `mxu` selects the
  all-int8 variant (q and p quantized per query row, int32 dot products).
"""

from __future__ import annotations

import os

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.attention import causal_mask, dequantize_layer, sdpa

#: cache rows per decode split (one pass-1 block per split and kv-head):
#: short splits keep many blocks in flight, each walking few serial rows.
#: The q8 kernel's all-int8 variant requantizes p over the rows of one
#: split, as the TPU kernel does over one block_k block.
DECODE_ROWS_PER_SPLIT = 64


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


# -- decode ------------------------------------------------------------------


def _live_mask(valid_len: torch.Tensor, S: int,
               device: torch.device) -> torch.Tensor:
    live = (torch.arange(S, device=device)[None, :]
            < valid_len.reshape(-1, 1))                  # (B | 1, S)
    return live[:, None, None, :]


def flash_decode_at_layer_flat_plain(q, k_stack, v_stack, layer, valid_len,
                                     scale=None):
    """Plain version: slice the addressed layer, mask rows >= valid_len,
    softmax in float32."""
    B, _, Hq, D = q.shape
    _, _, S, HD = k_stack.shape
    li = layer.reshape(1).long()
    k = k_stack.index_select(0, li)[0].reshape(B, S, HD // D, D)
    v = v_stack.index_select(0, li)[0].reshape(B, S, HD // D, D)
    mask = _live_mask(valid_len, S, q.device)
    return sdpa(q.float(), k.float(), v.float(), mask, scale).to(q.dtype)


def _check_decode(q, k_stack, v_stack, layer, valid_len, kv_dtype,
                  scales=()) -> tuple[int, int, int, int, int, int]:
    """The checks every decode kernel makes of its inputs on the card;
    returns (B, Hq, Hkv, D, L, S)."""
    B, _, Hq, D = q.shape
    L, _, S, HD = k_stack.shape
    Hkv = HD // D
    for t in (k_stack, v_stack, layer, valid_len, *scales):
        require(t.device == q.device, "all inputs on one device")
    require(q.dtype == torch.bfloat16 and k_stack.dtype == v_stack.dtype
            == kv_dtype, f"decode kernel takes bf16 q and {kv_dtype} k/v")
    require(layer.dtype == valid_len.dtype == torch.int32,
            "layer/valid_len must be int32")
    require(layer.numel() == 1 and valid_len.numel() in (1, B),
            "layer is a scalar, valid_len (1,) or (B,)")
    require(D in (64, 128) and Hq % Hkv == 0
            and Hq // Hkv in (1, 2, 4, 8), f"unsupported D={D} G={Hq}/{Hkv}")
    require(all(t.is_contiguous() for t in
                (q, k_stack, v_stack, valid_len, *scales)),
            "decode kernel takes contiguous tensors")
    require(_aligned16(q) and _aligned16(k_stack) and _aligned16(v_stack),
            "decode kernel needs 16-byte aligned q/k/v")
    return B, Hq, Hkv, D, L, S


def _decode_scratch(q: torch.Tensor, S: int):
    """nsplit and the (m, l, acc) partials of the split-KV pass."""
    B, _, Hq, D = q.shape
    nsplit = max(1, -(-S // DECODE_ROWS_PER_SPLIT))
    f32 = dict(dtype=torch.float32, device=q.device)
    return (nsplit, torch.empty((B, Hq, nsplit), **f32),
            torch.empty((B, Hq, nsplit), **f32),
            torch.empty((B, Hq, nsplit, D), **f32))


def _decode_bf16(q, k_stack, v_stack, layer, valid_len, scale):
    B, Hq, Hkv, D, L, S = _check_decode(q, k_stack, v_stack, layer,
                                        valid_len, torch.bfloat16)
    nsplit, part_m, part_l, part_acc = _decode_scratch(q, S)
    out = torch.empty_like(q)
    rc = kernels.lib().aha_decode_attention(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        layer.data_ptr(), valid_len.data_ptr(),
        0 if valid_len.numel() == 1 else 1, part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        D, L, S, nsplit, float(scale), kernels.stream_handle(q))
    kernels.check(rc, "aha_decode_attention")
    return out


def _check_shapes(q, k_stack, v_stack) -> None:
    B, Sq, Hq, D = q.shape
    require(Sq == 1, "decode attention takes one query row")
    require(k_stack.ndim == 4 and k_stack.shape == v_stack.shape,
            "k/v must be (L, B, S, Hkv*D)")
    require(k_stack.shape[1] == B and k_stack.shape[3] % D == 0,
            "cache does not match q")


def flash_decode_at_layer_q8_plain(q, k_stack, v_stack, k_scale, v_scale,
                                   layer, valid_len, scale=None):
    """Plain version of both q8 variants: the JAX fallback — dequantize the
    addressed layer to q's dtype, masked sdpa with a float32 softmax."""
    D = q.shape[3]
    k = dequantize_layer(k_stack, k_scale, layer, D, q.dtype)
    v = dequantize_layer(v_stack, v_scale, layer, D, q.dtype)
    mask = _live_mask(valid_len, k.shape[1], q.device)
    return sdpa(q, k, v, mask, scale)


def _decode_q8(q, k_stack, v_stack, k_scale, v_scale, layer, valid_len,
               scale, mxu):
    B, Hq, Hkv, D, L, S = _check_decode(q, k_stack, v_stack, layer,
                                        valid_len, torch.int8,
                                        (k_scale, v_scale))
    require(k_scale.shape == v_scale.shape == (L, B, S, Hkv)
            and k_scale.dtype == v_scale.dtype == torch.float32,
            "scales must be float32 (L, B, S, Hkv)")
    nsplit, part_m, part_l, part_acc = _decode_scratch(q, S)
    out = torch.empty_like(q)
    rc = kernels.lib().aha_decode_attention_q8(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), layer.data_ptr(),
        valid_len.data_ptr(), 0 if valid_len.numel() == 1 else 1,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, D, L, S, nsplit, float(scale), int(mxu),
        kernels.stream_handle(q))
    kernels.check(rc, "aha_decode_attention_q8")
    return out


def _q8_mxu_default(mxu: bool | None) -> bool:
    """The JAX default: the all-int8 variant unless AHA_Q8_MXU is set to
    something other than "1" (read at call time)."""
    return os.environ.get("AHA_Q8_MXU", "1") == "1" if mxu is None else mxu


def _bf16_decode_wrapper(name: str, doc: str):
    """A bf16 decode wrapper with its own `.launches` counter."""
    def wrapper(q: torch.Tensor, k_stack: torch.Tensor,
                v_stack: torch.Tensor, layer: torch.Tensor,
                valid_len: torch.Tensor,
                scale: float | None = None) -> torch.Tensor:
        _check_shapes(q, k_stack, v_stack)
        scale = scale if scale is not None else q.shape[3] ** -0.5
        if not q.is_cuda:
            return flash_decode_at_layer_flat_plain(q, k_stack, v_stack,
                                                    layer, valid_len, scale)
        out = _decode_bf16(q, k_stack, v_stack, layer, valid_len, scale)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


def _q8_decode_wrapper(name: str, doc: str):
    """An int8-cache decode wrapper with its own `.launches` counter."""
    def wrapper(q: torch.Tensor, k_stack: torch.Tensor,
                v_stack: torch.Tensor, k_scale: torch.Tensor,
                v_scale: torch.Tensor, layer: torch.Tensor,
                valid_len: torch.Tensor, scale: float | None = None,
                mxu: bool | None = None) -> torch.Tensor:
        _check_shapes(q, k_stack, v_stack)
        scale = scale if scale is not None else q.shape[3] ** -0.5
        if not q.is_cuda:
            return flash_decode_at_layer_q8_plain(q, k_stack, v_stack,
                                                  k_scale, v_scale, layer,
                                                  valid_len, scale)
        out = _decode_q8(q, k_stack, v_stack, k_scale, v_scale, layer,
                         valid_len, scale, _q8_mxu_default(mxu))
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


flash_decode_at_layer_flat = _bf16_decode_wrapper(
    "flash_decode_at_layer_flat",
    """One-token attention for layer `layer` straight from the stacked flat
    cache.  q (B, 1, Hq, D); k/v (L, B, S, Hkv·D); layer an int32 device
    scalar; valid_len int32 (1,) or (B,) — rows [0, valid_len) are live.
    Returns (B, 1, Hq, D).""")

flash_decode_at_layer_flat_batched = _bf16_decode_wrapper(
    "flash_decode_at_layer_flat_batched",
    """flash_decode_at_layer_flat for the continuous-batching step: every
    slot b of the (L, B, S, Hkv·D) cache with its own length valid_len[b]
    (ragged; a parked slot has length 1).  Its plain version is
    flash_decode_at_layer_flat_plain; each slot's result is bit-equal to
    a B = 1 launch of the same kernel on that slot alone.""")

flash_decode_at_layer_q8 = _q8_decode_wrapper(
    "flash_decode_at_layer_q8",
    """flash_decode_at_layer_flat over the int8 cache: k/v int8 (L, B, S,
    Hkv·D), k_scale/v_scale float32 (L, B, S, Hkv).  `mxu` (default
    AHA_Q8_MXU, on) picks the all-int8 variant on the card; the CPU runs
    the plain version for both.""")

flash_decode_at_layer_q8_batched = _q8_decode_wrapper(
    "flash_decode_at_layer_q8_batched",
    """flash_decode_at_layer_q8 for the continuous-batching step (ragged
    per-slot lengths); the same kernel and plain version.""")


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
