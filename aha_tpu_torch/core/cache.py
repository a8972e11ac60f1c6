"""KV cache (counterpart of aha_tpu/core/cache.py, flat bf16 layout only).

The JAX package keeps the cache as functional state and relies on jit
donation to update it in place.  Here the cache tensors are preallocated
once per length bucket and written IN PLACE (`index_copy_` at device
positions); the write head `pos` is a 0-dim int32 DEVICE tensor, read by
the kernels themselves, so a decode step never syncs the host.

Layout: k/v (L, B, S, Hkv·D) — the flat rows the decode kernel reads.
"""

from __future__ import annotations

from typing import Any

import torch


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu") -> dict[str, Any]:
    shape = (n_layers, batch, max_len, n_kv_heads * head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_max_len(cache: dict[str, Any]) -> int:
    return cache["k"].shape[2]


def advance(cache: dict[str, Any], n: int | torch.Tensor) -> dict[str, Any]:
    cache["pos"].add_(n)
    return cache


def reset(cache: dict[str, Any]) -> dict[str, Any]:
    """Rewind the write head.  Rows past pos are never read (the kernels
    and the masks stop at pos), so the pooled K/V is NOT zeroed."""
    cache["pos"].zero_()
    return cache
