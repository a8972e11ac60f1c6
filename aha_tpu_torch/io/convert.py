"""Parameters carried across from the JAX package.

`params_from_jax` takes aha_tpu's Qwen3 parameter tree as numpy arrays
(what `Qwen3Model.init_random` / `load_params` produce, fused or not) and
returns the port's tree: the same nesting and stacked (L, ...) layers, the
(in, out) linear layout kept, and the head turned from the JAX (K, V) to
the port's vocab-major (V, K).  A tied head — one equal to the transposed
embedding — shares the embedding's storage instead of being copied.
`cache_from_jax` carries a JAX KV cache across in the port's layout, so
tests compare caches directly.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree, dtype=np.float32)      # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def params_from_jax(tree: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    head_kv = np.asarray(tree["lm_head"]["w"])
    embed = np.asarray(tree["embed"]["w"])
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items()
           if k != "lm_head"}
    if head_kv.shape == embed.shape[::-1] and np.array_equal(head_kv.T, embed):
        out["lm_head"] = {"w": out["embed"]["w"]}
    else:
        out["lm_head"] = {"w": _to_torch(head_kv.T, device, dtype)}
    return out


def cache_from_jax(cache: dict, device: torch.device | str = "cpu") -> dict:
    """aha_tpu's KV cache (numpy arrays) → the port's layout (core/cache.py):
    k/v as flat (L, B, S, Hkv·D) rows (a 5-D (L, B, S, Hkv, D) cache is
    flattened), the int8 layout's lane-oriented (L, B, Hkv, S) scales
    transposed to (L, B, S, Hkv), pos int32, dtypes kept."""
    out = {}
    for name in ("k", "v"):
        a = np.array(cache[name])               # a writable copy
        out[name] = torch.from_numpy(a.reshape(a.shape[:3] + (-1,))).to(
            device)
    for name in ("k_scale", "v_scale"):
        if name in cache:
            a = np.array(cache[name], dtype=np.float32)
            out[name] = torch.from_numpy(
                np.ascontiguousarray(a.transpose(0, 1, 3, 2))).to(device)
    out["pos"] = torch.from_numpy(
        np.array(cache["pos"], dtype=np.int32)).to(device)
    return out
