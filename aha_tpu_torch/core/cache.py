"""KV cache (counterpart of aha_tpu/core/cache.py).

The JAX package keeps the cache as functional state and relies on jit
donation to update it in place.  Here the cache tensors are preallocated
once per length bucket and written IN PLACE (`index_copy_` at device
positions); the write head `pos` is an int32 DEVICE tensor, read by the
kernels themselves, so a decode step never syncs the host.  `pos` is 0-dim
for one stream, or a (B,) vector with one write head per slot for the
continuous-batching engine (core/batch_engine.py).

Layouts:
- bf16/f32: k/v (L, B, S, Hkv·D) — the flat rows the decode kernel reads
  (the Qwen3 model's);
- bf16/f32 with `flat=False`: k/v (L, B, S, Hkv, D), the JAX package's
  default, which the llama-family decoders keep.  Contiguous, so its bytes
  are the flat rows, and the decode kernel reads it through a view;
- int8 (`dtype=torch.int8`): k/v int8 (L, B, S, Hkv·D) plus float32
  scales `k_scale`/`v_scale` (L, B, S, Hkv), one per (row, kv-head).  The
  JAX package keeps its scales lane-oriented (L, B, Hkv, S), a Mosaic
  workaround; here a row's Hkv scales sit next to each other (32 bytes at
  Hkv = 8), one sector the decode kernel reads per row.

Under a tensor-parallel mesh (parallel/) a rank's cache is its slice of
these layouts by the model's cache rules (QWEN3_CACHE_RULES): the flat
rows' kv-head groups, and the int8 scales of those heads beside them.

Rolling state (`STATE_KEYS`): the hybrid decoders add per-slot state with
no row axis, slots on dim 1 as everywhere, which every step reads whatever
`pos` is — so `reset` zeroes it, a prefix snapshot copies it whole, and
admission copies a slot's whole:
- LFM2 (models/lfm2.py): `conv` (Lc, B, L, D), the last L gated inputs of
  each of its Lc short-conv layers, in the cache dtype;
- Qwen3.5 (models/qwen3_5.py): `conv` (Ll, B, K, conv_dim), the last K
  pre-conv inputs of each of its Ll GatedDeltaNet layers, in the cache
  dtype, and `rec` (Ll, B, Hv, Dk, Dv), the delta rule's recurrent state,
  always float32.  Its cache also holds the 0-dim `rope_delta` (0 for
  text), as the JAX cache does.
"""

from __future__ import annotations

from typing import Any

import torch

from aha_tpu_torch.parallel.mesh import local_shape, spec_for

#: cache entries that hold per-row state, rows on dim 2 in every layout
#: (sliced by a prefix snapshot)
ROW_KEYS = ("k", "v", "k_scale", "v_scale")
#: per-slot rolling state of the hybrid decoders (no row axis)
STATE_KEYS = ("conv", "rec")


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu",
                  per_slot_pos: bool = False,
                  flat: bool = True, mesh=None,
                  rules: tuple = ()) -> dict[str, Any]:
    """The cache of a model with `n_kv_heads` kv heads; with a tp `mesh`,
    this rank's slice of it by `rules` (parallel/mesh.local_shape)."""
    if not flat and dtype == torch.int8:
        raise ValueError("the int8 cache is flat (L, B, S, Hkv·D) only")

    def zeros(name, shape, dt):
        if mesh is not None:
            shape = local_shape(shape, spec_for(name, rules), mesh)
        return torch.zeros(shape, dtype=dt, device=device)

    shape = ((n_layers, batch, max_len, n_kv_heads * head_dim) if flat
             else (n_layers, batch, max_len, n_kv_heads, head_dim))
    cache = {
        "k": zeros("k", shape, dtype),
        "v": zeros("v", shape, dtype),
        "pos": torch.zeros((batch,) if per_slot_pos else (),
                           dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        sc = (n_layers, batch, max_len, n_kv_heads)
        cache["k_scale"] = zeros("k_scale", sc, torch.float32)
        cache["v_scale"] = zeros("v_scale", sc, torch.float32)
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
    K/V is NOT zeroed; rolling state is read by every step, so it is
    zeroed in place (a pooled cache hands the next request no stale
    state)."""
    cache["pos"].zero_()
    for name in STATE_KEYS:
        if name in cache:
            cache[name].zero_()
    return cache
