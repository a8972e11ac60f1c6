"""Parameters carried across from the JAX package.

`params_from_jax` takes aha_tpu's Qwen3 parameter tree as numpy arrays
(what `Qwen3Model.init_random` / `load_params` / `load_qwen3_gguf`
produce, fused or not) and returns the port's tree: the same nesting and
stacked (L, ...) layers, the (in, out) dense linear layout kept, the dense
head turned from the JAX (K, V) to the port's vocab-major (V, K), and every
GGUF-quantized dict turned into the port's grid layout by `quant_from_jax`.
A tied head — one equal to the transposed embedding — shares the
embedding's storage instead of being copied.  `cache_from_jax` carries a
JAX KV cache across in the port's layout, so tests compare caches
directly.
"""

from __future__ import annotations

import numpy as np
import torch

from aha_tpu_torch.ops.quant_matmul import is_quantized

#: the JAX packer's K chunk, whose second half its 4-bit grid folds
K_CHUNK = 1024


def quant_from_jax(p: dict) -> dict:
    """A JAX packed dict (numpy, stacked (L, ...) or not) → the port's
    layout (ops/quant_matmul.py): column-major rows.  The JAX packer's K
    padding to whole 1024-row chunks is kept (its groups have scale 0 and
    contribute zeros; the port's kernels take any Kp ≥ K that 128 divides).

    int8: qt (..., Kp, N), st (..., Kp/128, N) → (..., N, Kp), (..., N,
    Kp/128).  4-bit: the JAX packer stores each 1024-row chunk's second
    half as (n − 8) & 15 in the high nibbles of the first half's bytes,
    with s/16 and b + 8s (a Mosaic workaround, aha_tpu pack_q4_rows); this
    unfolds it: n = (h + 8) & 15, s = 16·s4 (exact), b = b4 − 8·s (within
    an f32 ulp of the min the packer started from)."""
    if "qt" in p:
        qt = np.swapaxes(np.asarray(p["qt"]), -1, -2)
        st = np.swapaxes(np.asarray(p["st"], np.float32), -1, -2)
        return {"qt": torch.from_numpy(np.ascontiguousarray(qt, np.int8)),
                "st": torch.from_numpy(np.ascontiguousarray(st))}
    q4 = np.asarray(p["q4"]).view(np.uint8)             # (..., Kp/2, N)
    lead, (half, N) = q4.shape[:-2], q4.shape[-2:]
    nc = 2 * half // K_CHUNK
    c = q4.reshape(*lead, nc, K_CHUNK // 2, N)
    n = np.concatenate([c & 15, ((c >> 4) + 8) & 15], axis=-2)
    n = np.swapaxes(n.reshape(*lead, nc * K_CHUNK, N), -1, -2)   # (..., N, Kp)
    s = np.array(p["s4"], np.float32).reshape(*lead, nc, 8, N)
    b = np.array(p["b4"], np.float32).reshape(*lead, nc, 8, N)
    s[..., 4:, :] *= 16.0
    b[..., 4:, :] -= 8.0 * s[..., 4:, :]
    s = np.swapaxes(s.reshape(*lead, nc * 8, N), -1, -2)
    b = np.swapaxes(b.reshape(*lead, nc * 8, N), -1, -2)
    packed = (n[..., 0::2] | (n[..., 1::2] << 4)).astype(np.uint8)
    return {"q4": torch.from_numpy(np.ascontiguousarray(packed)),
            "s4": torch.from_numpy(np.ascontiguousarray(s)),
            "b4": torch.from_numpy(np.ascontiguousarray(b))}


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        if is_quantized(tree):
            return {k: v.to(device) for k, v in quant_from_jax(tree).items()}
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree, dtype=np.float32)      # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def params_from_jax(tree: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items()
           if k != "lm_head"}
    head = tree["lm_head"]
    if is_quantized(head):                      # the grids are vocab-major
        out["lm_head"] = _to_torch(head, device, dtype)
        return out
    head_kv = np.asarray(head["w"])
    embed = np.asarray(tree["embed"]["w"])
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
