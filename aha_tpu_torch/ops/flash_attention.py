"""Attention kernels: prefill flash attention and stacked-cache decode.

Each wrapper launches its CUDA kernel (csrc/) for tensors on the card and
runs its plain PyTorch version, in the same module, for tensors on the
CPU — never a fallback on a CUDA tensor: the kernel runs or the wrapper
raises.  `<wrapper>.launches` counts kernel launches.

- `flash_attention` ← aha_tpu/ops/flash_attention.py:flash_attention
  (csrc/flash_prefill.cu): bound by tensor-core FLOPs at long prompts;
  wgmma on 128-row q tiles (two consumer warpgroups), K/V tiles fed by
  TMA from a producer warpgroup through mbarriers, the online softmax in
  registers, causal q tiles heaviest first.
- `flash_decode_at_layer_flat` ← aha_tpu/ops/flash_attention.py:
  flash_decode_at_layer_flat (csrc/decode_attention.cu): bound by the
  bytes of the live cache rows, and at short caches by latency; one launch
  spreads the LIVE rows over up to decode_splits(S, Hkv) splits per
  kv-head and the last split to finish folds them (an atomic ticket).
- `flash_decode_at_layer_flat_batched` ← flash_decode_at_layer_flat_batched
  (the same kernel at B slots): the TPU kernel folds the slots into one
  block only to spare the Pallas grid sequencer; here the grid is
  (split, kv-head, slot) with per-slot lengths, and a block past its
  slot's length exits at once.
- `flash_decode_at_layer_q8` / `flash_decode_at_layer_q8_batched` ←
  flash_decode_at_layer_q8 / _q8_batched (csrc/decode_attention_q8.cu):
  the int8 cache, half the bytes per row; the same one-launch design over
  the live rows (splits of at least Q8_MIN_ROWS = 64 live rows),
  scales folded into the score and probability vectors.  `mxu` selects
  the all-int8 variant (q quantized per query row and p per warp step of
  at most 64 rows, int32 dot products).
- `flash_decode_at_layer` / `flash_decode` ← flash_decode_at_layer /
  flash_decode (csrc/decode_attention.cu): the stacked (L, B, S, Hkv, D)
  cache of the llama-family decoders, and one unstacked (B, S, Hkv, D)
  cache.  Both are contiguous, so their bytes are exactly the flat rows
  (L, B, S, Hkv·D) (L = 1 for the unstacked one): the wrapper hands the
  split-KV kernel a view, no copy and no kernel of their own.
- The bf16 decode wrappers above also take a float32 q and cache (VoxCPM's
  MiniCPM stacks, which the reference serves in float32): the same kernel
  body instantiated for float32 (`aha_decode_attention_f32`), counted on
  the same `.launches`; any other dtype raises on the card.
- `flash_attention_segmented` ← flash_attention_segmented
  (csrc/segment_flash.cu): row i attends row j iff seg[i] == seg[j], the
  vision tower's window and full-image blocks; bound by bytes in window
  blocks, by tensor-core FLOPs in full ones; prefill's wgmma/TMA design in
  a persistent walk over (q tile, head) units, each unit listing the k
  tiles whose segs can match its rows and computing only those; a pad row
  (seg < 0) matches nothing, so a bucket's pad tail costs no tile visits.
"""

from __future__ import annotations

import os

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.attention import (causal_mask, dequantize_layer, sdpa,
                                         segment_mask)
from aha_tpu_torch.ops.launches import count

def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


# -- the kernels' own limits ---------------------------------------------------
# Read by the wrappers' checks on the card, where a shape outside them
# raises; ops/attention.py's routers send the wrappers every shape the
# reference's gates send its TPU kernels (D % 64 == 0), as they stand.

#: the head widths of the prefill and decode kernels, bf16 and int8
HEAD_DIMS = (64, 128, 192, 256)


def prefill_takes(D: int) -> bool:
    """The prefill kernel (csrc/flash_prefill.cu) takes head width D 64,
    128, 192 or 256."""
    return D in HEAD_DIMS


def decode_takes(D: int, Hq: int, Hkv: int) -> bool:
    """The decode kernels, bf16, float32 and int8
    (csrc/decode_attention*.cu), take head width D 64, 128, 192 or 256 and
    any whole group G = Hq / Hkv."""
    return D in HEAD_DIMS and 1 <= Hkv <= Hq and Hq % Hkv == 0


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
                  scales=(), q_dtype=torch.bfloat16
                  ) -> tuple[int, int, int, int, int, int]:
    """The checks every decode kernel makes of its inputs on the card;
    returns (B, Hq, Hkv, D, L, S)."""
    B, _, Hq, D = q.shape
    L, _, S, HD = k_stack.shape
    Hkv = HD // D
    for t in (k_stack, v_stack, layer, valid_len, *scales):
        require(t.device == q.device, "all inputs on one device")
    require(q.dtype == q_dtype and k_stack.dtype == v_stack.dtype
            == kv_dtype, f"decode kernel takes {q_dtype} q and {kv_dtype} "
            f"k/v, not {q.dtype} and {k_stack.dtype}")
    require(layer.dtype == valid_len.dtype == torch.int32,
            "layer/valid_len must be int32")
    require(layer.numel() == 1 and valid_len.numel() in (1, B),
            "layer is a scalar, valid_len (1,) or (B,)")
    require(decode_takes(D, Hq, Hkv), f"unsupported D={D} G={Hq}/{Hkv}")
    require(all(t.is_contiguous() for t in
                (q, k_stack, v_stack, valid_len, *scales)),
            "decode kernel takes contiguous tensors")
    require(_aligned16(q) and _aligned16(k_stack) and _aligned16(v_stack),
            "decode kernel needs 16-byte aligned q/k/v")
    return B, Hq, Hkv, D, L, S


#: the bf16 decode kernel's splits per (slot, kv-head): at least this many
#: live rows each, and at most DECODE_BLOCKS / Hkv of them, so Hkv 2 fills
#: the 132 SMs as well as Hkv 8 does; fixed by S and Hkv, never by B, so a
#: slot's result does not depend on the other slots
DECODE_MIN_ROWS = 32
DECODE_BLOCKS = 256
#: the int8 kernel's live rows per split at least (the bytes of the bf16
#: kernel's 32); its all-int8 variant requantizes p over at most this many
#: rows (the rows a warp holds at one step), as the TPU kernel does over its
#: block_k rows
Q8_MIN_ROWS = 64

_tickets: dict[tuple[int, int], torch.Tensor] = {}


def decode_splits(S: int, Hkv: int, min_rows: int = DECODE_MIN_ROWS) -> int:
    """The decode kernels' grid of splits per (slot, kv-head), at most 256;
    `min_rows` live rows a split at least."""
    return max(1, min(DECODE_BLOCKS // Hkv, -(-S // min_rows)))


def split_rows(valid: int, maxsplit: int, min_rows: int) -> list[range]:
    """The rows of each split a decode kernel gives a slot of `valid` live
    rows on a grid of `maxsplit` splits (csrc/decode_attention*.cu): at most
    ⌈valid / min_rows⌉ splits, each an equal share of the live rows; the
    splits past them exit at once.  Depends on the slot's own length and
    the grid only, so never on B."""
    n = max(1, min(maxsplit, -(-valid // min_rows)))
    rows = -(-valid // n)
    return [range(min(s * rows, valid), min(s * rows + rows, valid))
            for s in range(n)]


def ticket_counters(device: torch.device, stream: int, n: int):
    """(n,) int32 zeros for a ticketed kernel's counters (here one per slot
    and block share of a kv-head's query heads), kept per device and
    stream: every launch leaves them zero again, and launches on one stream
    run one after another, so every ticketed kernel shares them (the
    studies' argmax head and one-launch layer too)."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _split_scratch(q: torch.Tensor, nsplit: int):
    """The (m, l, acc) split partials of a decode launch, its ticket
    counters (one per slot and block share, at most B·Hq) and its stream."""
    B, _, Hq, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    stream = kernels.stream_handle(q)
    return (torch.empty((B, Hq, nsplit), **f32),
            torch.empty((B, Hq, nsplit), **f32),
            torch.empty((B, Hq, nsplit, D), **f32),
            ticket_counters(q.device, stream, B * Hq), stream)


#: the dense decode kernel's instances: the cache's dtype → its C entry
DENSE_DECODE_ENTRIES = {torch.bfloat16: "aha_decode_attention",
                        torch.float32: "aha_decode_attention_f32"}


def _decode_dense(q, k_stack, v_stack, layer, valid_len, scale):
    """The dense decode kernel over a bf16 or float32 cache (q of the
    cache's dtype); any other dtype raises."""
    entry = DENSE_DECODE_ENTRIES.get(k_stack.dtype)
    require(entry is not None, f"decode kernel takes a bf16 or float32 "
            f"cache, not {k_stack.dtype}")
    B, Hq, Hkv, D, L, S = _check_decode(q, k_stack, v_stack, layer,
                                        valid_len, k_stack.dtype,
                                        q_dtype=k_stack.dtype)
    nsplit = decode_splits(S, Hkv)
    part_m, part_l, part_acc, tickets, stream = _split_scratch(q, nsplit)
    out = torch.empty_like(q)
    rc = getattr(kernels.lib(), entry)(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        layer.data_ptr(), valid_len.data_ptr(),
        0 if valid_len.numel() == 1 else 1, part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, D, L, S, nsplit, float(scale), stream)
    kernels.check(rc, entry)
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
    nsplit = decode_splits(S, Hkv, Q8_MIN_ROWS)
    part_m, part_l, part_acc, tickets, stream = _split_scratch(q, nsplit)
    out = torch.empty_like(q)
    rc = kernels.lib().aha_decode_attention_q8(
        q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), layer.data_ptr(),
        valid_len.data_ptr(), 0 if valid_len.numel() == 1 else 1,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, L, S, nsplit,
        float(scale), int(mxu), stream)
    kernels.check(rc, "aha_decode_attention_q8")
    return out


def _q8_mxu_default(mxu: bool | None) -> bool:
    """The JAX default: the all-int8 variant unless AHA_Q8_MXU is set to
    something other than "1" (read at call time)."""
    return os.environ.get("AHA_Q8_MXU", "1") == "1" if mxu is None else mxu


def _launch_dense(counted, q, k_stack, v_stack, layer, valid_len, scale):
    """The decode over a flat (L, B, S, Hkv·D) bf16 or float32 cache: the
    kernel on the card, counted on `counted.launches`; the plain version on
    the CPU."""
    _check_shapes(q, k_stack, v_stack)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if not q.is_cuda:
        return flash_decode_at_layer_flat_plain(q, k_stack, v_stack, layer,
                                                valid_len, scale)
    out = _decode_dense(q, k_stack, v_stack, layer, valid_len, scale)
    count(counted)
    return out


def _dense_decode_wrapper(name: str, doc: str):
    """A bf16 / float32 decode wrapper with its own `.launches` counter."""
    def wrapper(q: torch.Tensor, k_stack: torch.Tensor,
                v_stack: torch.Tensor, layer: torch.Tensor,
                valid_len: torch.Tensor,
                scale: float | None = None) -> torch.Tensor:
        return _launch_dense(wrapper, q, k_stack, v_stack, layer, valid_len,
                             scale)

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
        count(wrapper)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


flash_decode_at_layer_flat = _dense_decode_wrapper(
    "flash_decode_at_layer_flat",
    """One-token attention for layer `layer` straight from the stacked flat
    cache.  q (B, 1, Hq, D); k/v (L, B, S, Hkv·D); layer an int32 device
    scalar; valid_len int32 (1,) or (B,) — rows [0, valid_len) are live.
    Returns (B, 1, Hq, D).""")

flash_decode_at_layer_flat_batched = _dense_decode_wrapper(
    "flash_decode_at_layer_flat_batched",
    """flash_decode_at_layer_flat for the continuous-batching step: every
    slot b of the (L, B, S, Hkv·D) cache with its own length valid_len[b]
    (ragged; a parked slot has length 1).  Its plain version is
    flash_decode_at_layer_flat_plain; each slot's result is bit-equal to
    a B = 1 launch of the same kernel on that slot alone.""")

def _flat_view(stack: torch.Tensor) -> torch.Tensor:
    """(L, B, S, Hkv, D) → (L, B, S, Hkv·D), a view of the same bytes."""
    require(stack.ndim == 5 and stack.is_contiguous(),
            "the stacked cache must be a contiguous (L, B, S, Hkv, D)")
    L, B, S, Hkv, D = stack.shape
    return stack.view(L, B, S, Hkv * D)


def flash_decode_at_layer_plain(q, k_stack, v_stack, layer, valid_len,
                                scale=None):
    """Plain version over the stacked (L, B, S, Hkv, D) cache: the flat
    cache's plain version on its view."""
    return flash_decode_at_layer_flat_plain(q, _flat_view(k_stack),
                                            _flat_view(v_stack), layer,
                                            valid_len, scale)


def flash_decode_at_layer(q: torch.Tensor, k_stack: torch.Tensor,
                          v_stack: torch.Tensor, layer: torch.Tensor,
                          valid_len: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """One-token attention for layer `layer` of the stacked cache k/v (L,
    B, S, Hkv, D); q (B, 1, Hq, D); layer an int32 device scalar;
    valid_len int32 (1,) or (B,), rows [0, valid_len[b]) live.  Returns
    (B, 1, Hq, D).  On the card: the split-KV decode kernel on the flat
    view of the same bytes, bf16 or float32 (q of the cache's dtype)."""
    return _launch_dense(flash_decode_at_layer, q, _flat_view(k_stack),
                        _flat_view(v_stack), layer, valid_len, scale)


flash_decode_at_layer.launches = 0


def _layer0(device: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def flash_decode_plain(q, k_all, v_all, valid_len, scale=None):
    """Plain version over one (B, S, Hkv, D) cache."""
    return flash_decode_at_layer_plain(q, k_all[None], v_all[None],
                                       _layer0(q.device), valid_len, scale)


def flash_decode(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 valid_len: torch.Tensor,
                 scale: float | None = None) -> torch.Tensor:
    """One-token attention over one unstacked cache k/v (B, S, Hkv, D),
    rows [0, valid_len[b]) live: flash_decode_at_layer at L = 1, layer 0
    (a view, no copy)."""
    require(k_all.ndim == 4, "k/v must be (B, S, Hkv, D)")
    return _launch_dense(flash_decode, q, _flat_view(k_all[None]),
                        _flat_view(v_all[None]), _layer0(q.device),
                        valid_len, scale)


flash_decode.launches = 0


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
    prefill buckets ≥ 128 are) and D 64, 128, 192 or 256."""
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
    require(prefill_takes(D), f"prefill kernel takes D in {HEAD_DIMS}, "
            f"not {D}")
    require(Sq % 64 == 0 and Skv % 64 == 0,
            f"prefill kernel needs Sq, Skv multiples of 64 ({Sq}, {Skv})")
    require(all(t.stride(-1) == 1 for t in (q, k, v)),
            "prefill kernel needs a contiguous channel axis")
    # TMA copies: 16-byte aligned bases and batch/sequence/head strides
    require(all(_aligned16(t) and all(s % 8 == 0 for s in t.stride()[:3])
                for t in (q, k, v)), "prefill kernel needs 16-byte aligned "
            "q/k/v rows (base and strides), as TMA does")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = kernels.lib().aha_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, Sq, Skv, Hq, Hkv, D, int(causal), float(scale),
        kernels.stream_handle(q))
    kernels.check(rc, "aha_flash_prefill")
    count(flash_attention)
    return out


flash_attention.launches = 0


# -- segment-masked attention (vision towers) ----------------------------------

#: the kernel lists up to 512 k tiles of 128 rows in shared memory
SEGMENT_MAX_S = 65536
#: the head widths the segment kernel is built for
SEGMENT_HEAD_DIMS = (64, 72, 80, 128)


def flash_attention_segmented_plain(q, k, v, seg, scale=None):
    """Plain version: masked sdpa in float32, row i attends row j iff
    seg[i] == seg[j] ≥ 0; a pad row's output is 0."""
    out = sdpa(q.float(), k.float(), v.float(), segment_mask(seg, q.device),
               scale)
    real = (seg.to(q.device) >= 0)[None, :, None, None]
    return torch.where(real, out, 0.0).to(q.dtype)


def flash_attention_segmented(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seg: torch.Tensor,
                              scale: float | None = None) -> torch.Tensor:
    """Non-causal attention where row i attends row j iff seg[i] == seg[j].
    q (B, S, Hq, D); k/v (B, S, Hkv, D); seg (S,) int32, shared by the
    batch; a row with seg < 0 is padding: it matches no row and its
    output is 0 (the JAX kernel lets pad rows attend each other; no caller
    reads them).  Returns (B, S, Hq, D).  On the card: any S ≤ 65536, D in
    SEGMENT_HEAD_DIMS (64, Qwen2.5-VL's 80, Qwen3-VL's 72, 128), bf16, and
    any other D raises; q/k/v may be
    strided views with a contiguous channel axis (one third of a fused qkv
    product is read in place)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    require(k.shape == v.shape and k.shape[:2] == (B, S) and k.shape[3] == D
            and Hq % Hkv == 0, "q/k/v shapes do not match")
    require(seg.shape == (S,), f"seg must be ({S},), got {tuple(seg.shape)}")
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        return flash_attention_segmented_plain(q, k, v, seg, scale)
    require(all(t.device == q.device for t in (k, v, seg)),
            "all inputs on one device")
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            "segment kernel takes bf16 q/k/v")
    require(seg.dtype == torch.int32 and seg.is_contiguous()
            and _aligned16(seg), "seg must be contiguous, 16-byte aligned "
            "int32")
    require(D in SEGMENT_HEAD_DIMS, f"segment kernel takes D in "
            f"{SEGMENT_HEAD_DIMS}, not {D}")
    require(S <= SEGMENT_MAX_S, f"segment kernel takes S ≤ {SEGMENT_MAX_S}")
    require(all(t.stride(-1) == 1 for t in (q, k, v)),
            "segment kernel needs a contiguous channel axis")
    # TMA copies: 16-byte aligned bases and batch/sequence/head strides
    require(all(_aligned16(t) and all(s % 8 == 0 for s in t.stride()[:3])
                for t in (q, k, v)), "segment kernel needs 16-byte aligned "
            "q/k/v rows (base and strides), as TMA does")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = kernels.lib().aha_segment_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), *strides, B, S, Hq, Hkv, D, float(scale),
        kernels.stream_handle(q))
    kernels.check(rc, "aha_segment_flash")
    count(flash_attention_segmented)
    return out


flash_attention_segmented.launches = 0
