"""KV cache (counterpart of aha_tpu/core/cache.py, flat layouts only).

The JAX package keeps the cache as functional state and relies on jit
donation to update it in place.  Here the cache tensors are preallocated
once per length bucket and written IN PLACE (`index_copy_` at device
positions); the write head `pos` is an int32 DEVICE tensor, read by the
kernels themselves, so a decode step never syncs the host.  `pos` is 0-dim
for one stream, or a (B,) vector with one write head per slot for the
continuous-batching engine (core/batch_engine.py).

Layouts:
- bf16/f32: k/v (L, B, S, Hkv·D) — the flat rows the decode kernel reads;
- int8 (`dtype=torch.int8`): k/v int8 (L, B, S, Hkv·D) plus float32
  scales `k_scale`/`v_scale` (L, B, S, Hkv), one per (row, kv-head).  The
  JAX package keeps its scales lane-oriented (L, B, Hkv, S), a Mosaic
  workaround; here a row's Hkv scales sit next to each other (32 bytes at
  Hkv = 8), one sector the decode kernel reads per row.
"""

from __future__ import annotations

from typing import Any

import torch

#: cache entries that hold per-row state (sliced by a prefix snapshot)
ROW_KEYS = ("k", "v", "k_scale", "v_scale")


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu",
                  per_slot_pos: bool = False) -> dict[str, Any]:
    shape = (n_layers, batch, max_len, n_kv_heads * head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,) if per_slot_pos else (),
                           dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        sc = (n_layers, batch, max_len, n_kv_heads)
        cache["k_scale"] = torch.zeros(sc, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(sc, dtype=torch.float32, device=device)
    return cache


def is_quantized(cache: dict[str, Any]) -> bool:
    return cache["k"].dtype == torch.int8


def cache_max_len(cache: dict[str, Any]) -> int:
    return cache["k"].shape[2]


def advance(cache: dict[str, Any], n: int | torch.Tensor) -> dict[str, Any]:
    cache["pos"].add_(n)
    return cache


def reset(cache: dict[str, Any]) -> dict[str, Any]:
    """Rewind the write head (every slot's, for a (B,) pos).  Rows past pos
    are never read (the kernels and the masks stop at pos), so the pooled
    K/V is NOT zeroed."""
    cache["pos"].zero_()
    return cache
