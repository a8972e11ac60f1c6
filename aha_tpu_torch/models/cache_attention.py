"""The attention layers' side of a decoder over the JAX package's 5-D
cache (core/cache.py, flat=False): the llama-family decoders
(models/llama.py) and the hybrids (models/lfm2.py, models/qwen3_5.py).
Their attention layers own consecutive slots of one K/V stack
(n_attn, B, S, Hkv, D), written in place at the device position
`cache["pos"]` — 0-dim for one stream, or (B,) for the continuous-batching
engine, where each slot's new row goes to its own position by one
capturable `index_put_` — and read by the flash prefill kernel (a fresh
block of ≥ 128 bucketed rows), a chunk over the cached rows (plain), or
the 5-D decode kernel (one slot or B at per-slot lengths).
"""

from __future__ import annotations

import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.ops.attention import (attention_decode_at,
                                         attention_prefill,
                                         attention_prefill_at)


class CacheAttention:
    """Per-call positions, the K/V write of one attention slot of the 5-D
    stack and the attention it routes to."""

    def __init__(self, n_attn: int, device: torch.device):
        # attention slots as device scalars: the decode kernel reads its
        # layer
        self._slot_ids = torch.arange(max(n_attn, 1), dtype=torch.int32,
                                      device=device)
        # arange(B) per slot count, kept: a captured decode step binds it
        self._batch_ids: dict[int, torch.Tensor] = {}

    def batch_ids(self, B: int, device) -> torch.Tensor:
        if B not in self._batch_ids:
            self._batch_ids[B] = torch.arange(B, device=device)
        return self._batch_ids[B]

    @staticmethod
    def positions(cache: dict, S: int, rope_len: int, device,
                  offset: torch.Tensor | None = None):
        """(positions, rope_at, valid_len) of a call of S rows: the rows
        the K/V goes to — (S,) shared by the batch from a 0-dim pos, or
        (B,) one a slot from a (B,) pos (S = 1; a position past the cache,
        a slot stepped past its budget, clamped to the last row, where the
        JAX scatter drops it: that slot's outputs are discarded) — the
        rope rows to gather, shifted by `offset` (an M-RoPE delta), and
        the decode step's live lengths (None in prefill)."""
        pos = cache["pos"]
        if pos.ndim == 0:
            positions = pos.long() + torch.arange(S, device=device)
            rope_at = positions
        else:
            if S != 1:
                raise ValueError("per-slot positions take one token per slot")
            last = min(kv.cache_max_len(cache), rope_len) - 1
            positions = pos.long().clamp(max=last)
            rope_at = positions[:, None]
        if offset is not None:
            rope_at = rope_at + offset.long()
        valid_len = None if S > 1 else (pos + 1).reshape(-1)
        return positions, rope_at, valid_len

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache: dict, slot: int, positions: torch.Tensor,
               valid_len: torch.Tensor | None,
               from_cache: bool) -> torch.Tensor:
        """Write k/v (B, S, Hkv, D) into attention slot `slot` at
        `positions`, then attend: a fresh prefill over the block itself
        (the flash prefill kernel at ≥ 128 bucketed rows), a from_cache
        chunk over the cache rows [0, pos + i], a decode step over each
        slot's [0, pos] (the 5-D decode kernel, one slot or B)."""
        B, S = q.shape[:2]
        for name, new in (("k", k), ("v", v)):
            dst = cache[name][slot]                # (B, S_cache, Hkv, D)
            new = new.to(dst.dtype)
            if cache["pos"].ndim == 1:            # row b at positions[b]
                dst.index_put_((self.batch_ids(B, q.device), positions),
                               new[:, 0])
            else:
                dst.index_copy_(1, positions, new)
        layer = self._slot_ids[slot]
        if S > 1 and from_cache:
            return attention_prefill_at(q, cache["k"], cache["v"], layer,
                                        cache["pos"])
        if S > 1:
            return attention_prefill(q, k, v, causal=True)
        return attention_decode_at(q, cache["k"], cache["v"], layer,
                                   valid_len)
