"""Autoregressive generation engine, single stream (counterpart of
aha_tpu/core/engine.py's TextEngine).

The JAX engine drives jitted prefill/decode functions over a DONATED,
functional cache.  Here the same loop runs eagerly over a pooled,
preallocated cache that the model writes in place (core/cache.py); the
write head `pos` and the sampled token stay on the device between steps,
so the host reads tokens back once per block of `DECODE_BLOCK` steps with
one `tolist()`, never once per step.

Kept from the JAX engine: the prefill and cache length buckets, the cache
pool, the prompt-prefix KV store with restore + suffix prefill, greedy
through the model's `greedy_token` (the fused head kernel) and sampled
decode, decode blocks of 16 with the same waste past eos (≤ block − 1
steps), and the Timing/Usage accounting.  Each decode call passes the
model a host bound on the live rows it reaches (`window`), which admits
the fused decode stack up to 2048 rows, as the JAX engine's live window
does; the kernels read the exact length from the device.  The cache is
bf16/f32 or int8 (`cache_dtype`, AHA_KV_INT8=1 when served); a prefix
snapshot carries the int8 layout's scales.  The continuous-batching engine
is core/batch_engine.py, sharing PrefixStore.  Not ported yet: speculative
decoding (raises), the per-bucket window variants (nothing is traced), and
jit/donation (PyTorch runs eagerly).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Iterator

import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.sampling import (DEFAULT_REPEAT_LAST_N,
                                         SamplingConfig, sample_token)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                   32768, 65536, 131072)
CACHE_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
                 131072)
REPEAT_WINDOW = 64
PREFIX_MIN_TOKENS = 32
#: decode steps per host read-back; ≤ DECODE_BLOCK − 1 steps run past eos
DECODE_BLOCK = 16
#: bytes of KV the prefix store may pin on the device
PREFIX_MAX_BYTES = 512 << 20


def bucket_for(n: int, buckets=PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class Timing:
    prompt_tokens: int = 0
    prompt_secs: float = 0.0
    completion_tokens: int = 0
    completion_secs: float = 0.0


class PrefixStore:
    """MRU store of prompt-prefix KV snapshots, bounded by entry count and
    by PREFIX_MAX_BYTES: a later prompt that starts with a stored prompt
    restores its rows and prefills only the suffix.  Shared by TextEngine
    and BatchEngine; a snapshot holds the cache's per-row entries
    (`kv.ROW_KEYS`: k/v and, for the int8 layout, their scales — the JAX
    PREFIX_RESTORE_KEYS less the hybrid models' rolling state)."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._bytes = 0
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()

    @staticmethod
    def _entry_bytes(entry: dict) -> int:
        return sum(t.numel() * t.element_size() for t in entry.values())

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt_ids: list[int]) -> tuple[dict | None, int]:
        """Longest stored entry whose tokens prefix this prompt.  Returns
        (entry, p): restore the entry's rows and prefill from p.  An exact
        repeat resumes at p = n − 1 so the suffix has a token to produce
        logits from."""
        best_key, best_p = None, 0
        for toks in self._entries:
            n = len(toks)
            if n > len(prompt_ids):
                continue
            p = n - 1 if n == len(prompt_ids) else n
            if p <= best_p or p < PREFIX_MIN_TOKENS:
                continue
            if list(prompt_ids[:n]) == list(toks):
                best_key, best_p = toks, p
        if best_key is None:
            return None, 0
        self._entries.move_to_end(best_key)
        return self._entries[best_key], best_p

    def store(self, prompt_ids: list[int], cache: dict) -> None:
        """Snapshot (copy) the prompt's KV rows [0, len)."""
        if self.max_entries <= 0 or len(prompt_ids) < PREFIX_MIN_TOKENS:
            return
        key = tuple(prompt_ids)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        n = len(prompt_ids)
        entry = {name: cache[name][:, :, :n].clone() for name in kv.ROW_KEYS
                 if name in cache}
        nbytes = self._entry_bytes(entry)
        if nbytes > PREFIX_MAX_BYTES:
            return
        self._entries[key] = entry
        self._bytes += nbytes
        while len(self._entries) > self.max_entries or \
                self._bytes > PREFIX_MAX_BYTES:
            _, old = self._entries.popitem(last=False)
            self._bytes -= self._entry_bytes(old)

    @staticmethod
    def restore(entry: dict, cache: dict, p: int) -> None:
        """Copy a snapshot into the cache's rows [0, n) and set pos to p."""
        for name, rows in entry.items():
            cache[name][:, :, :rows.shape[2]].copy_(rows)
        cache["pos"].fill_(p)


class TextEngine:
    """Drives one Qwen3Model (init_cache / backbone / logits / greedy_token
    / fuse_params) at batch 1; the cache has `cache_dtype` (default the
    parameters' dtype; torch.int8 for the quantized layout)."""

    def __init__(self, model, params: dict, eos_token_ids: list[int],
                 max_seq_len: int = 8192, prefix_cache_entries: int = 0,
                 spec_tokens: int = 0,
                 cache_dtype: torch.dtype | None = None):
        if spec_tokens > 0:
            raise ValueError("speculative decoding is not ported to "
                             "aha_tpu_torch yet; serve with spec_tokens=0")
        self.model = model
        # one [q|k|v] and one [gate|up] weight per layer: bit-identical
        # outputs, fewer weight streams per decode step
        self.params = model.fuse_params(params)
        self.cache_dtype = cache_dtype or self.params["embed"]["w"].dtype
        self.eos_token_ids = set(int(t) for t in eos_token_ids)
        self.max_seq_len = max_seq_len
        self.prefix_cache_entries = prefix_cache_entries
        self._prefix_entries = PrefixStore(prefix_cache_entries)
        self._cache_pool: dict[int, dict] = {}
        self.last_timing = Timing()

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["w"].device

    # -- cache pool ---------------------------------------------------------

    def _take_cache(self, cache_len: int) -> dict:
        c = self._cache_pool.pop(cache_len, None)
        if c is None:
            c = self.model.init_cache(1, cache_len, self.cache_dtype)
        return kv.reset(c)

    def _return_cache(self, cache: dict) -> None:
        self._cache_pool[kv.cache_max_len(cache)] = cache

    # -- steps --------------------------------------------------------------

    def _prefill(self, tokens: list[int], bucket: int, cache: dict,
                 from_cache: bool) -> torch.Tensor:
        """Prefill `tokens` right-padded to `bucket` at cache["pos"], advance
        pos by len(tokens), return the last real row's f32 logits (1, V)."""
        ids = torch.zeros((1, bucket), dtype=torch.int64)
        ids[0, :len(tokens)] = torch.tensor(tokens, dtype=torch.int64)
        hidden = self.model.backbone(self.params, ids.to(self.device), cache,
                                     from_cache=from_cache)
        kv.advance(cache, len(tokens))
        last = hidden[:, len(tokens) - 1:len(tokens)]
        return self.model.logits(self.params, last)[:, 0].float()

    @staticmethod
    def _repeat_window(cfg: SamplingConfig) -> int:
        last_n = (cfg.repeat_last_n if cfg.repeat_last_n is not None
                  else DEFAULT_REPEAT_LAST_N)
        return min(int(last_n), REPEAT_WINDOW)

    def _sample(self, logits: torch.Tensor, cfg: SamplingConfig,
                gen: torch.Generator | None, ring: torch.Tensor,
                n_gen: int) -> torch.Tensor:
        """Sample from (1, V) logits; record the token in the ring."""
        n_valid = min(n_gen, self._repeat_window(cfg))
        tok = sample_token(logits[0], cfg, gen, ring, n_valid)
        ring[n_gen % ring.shape[0]] = tok
        return tok

    def _decode_step(self, token: torch.Tensor, cache: dict,
                     cfg: SamplingConfig, gen, ring: torch.Tensor,
                     n_gen: int, window: int) -> torch.Tensor:
        """One decode step from a device token; returns the next device
        token (0-dim int32) without a host sync.  `window` bounds the live
        cache rows after the step."""
        hidden = self.model.backbone(self.params, token.reshape(1, 1), cache,
                                     window=window)
        kv.advance(cache, 1)
        if cfg.greedy and cfg.repeat_penalty == 1.0:
            return self.model.greedy_token(self.params, hidden)
        logits = self.model.logits(self.params, hidden)[:, 0].float()
        return self._sample(logits, cfg, gen, ring, n_gen)

    def _decode_block(self, token, cache, cfg, gen, ring, n_gen0: int,
                      n_steps: int, window: int) -> torch.Tensor:
        toks = []
        for i in range(n_steps):
            token = self._decode_step(token, cache, cfg, gen, ring,
                                      n_gen0 + i, window)
            toks.append(token)
        return torch.stack(toks)

    # -- main loop ----------------------------------------------------------

    # no_grad, not inference_mode: the pooled cache outlives the call, and
    # inference tensors refuse in-place updates outside inference mode
    @torch.no_grad()
    def stream_tokens(self, prompt_ids: list[int], cfg: SamplingConfig,
                      max_tokens: int = 1024) -> Iterator[int]:
        """Yields sampled token ids (including the final eos); records
        Timing into self.last_timing."""
        prompt_len = len(prompt_ids)
        if prompt_len == 0:
            raise ValueError("empty prompt")
        max_ctx = min(self.max_seq_len, CACHE_BUCKETS[-1])
        if prompt_len > max_ctx:
            raise ValueError(
                f"prompt is {prompt_len} tokens but the maximum context is "
                f"{max_ctx}; shorten the prompt or raise max_seq_len")
        cache_len = bucket_for(min(prompt_len + max_tokens, self.max_seq_len),
                               CACHE_BUCKETS)
        pf_bucket = min(bucket_for(prompt_len), cache_len)
        cache = self._take_cache(cache_len)
        timing = Timing(prompt_tokens=prompt_len)
        self.last_timing = timing
        gen = None
        if not cfg.greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
        ring = torch.zeros((REPEAT_WINDOW,), dtype=torch.int32,
                           device=self.device)

        entry, p = (None, 0)
        if self.prefix_cache_entries:
            entry, p = self._prefix_entries.match(prompt_ids)
            if entry is not None and \
                    p + bucket_for(prompt_len - p) > cache_len:
                entry, p = None, 0       # suffix bucket would not fit

        try:
            t0 = time.perf_counter()
            if entry is not None:
                self._prefix_entries.restore(entry, cache, p)
                suffix = prompt_ids[p:]
                logits = self._prefill(suffix, bucket_for(len(suffix)), cache,
                                       from_cache=True)
            else:
                logits = self._prefill(prompt_ids, pf_bucket, cache,
                                       from_cache=False)
            if self.prefix_cache_entries:
                self._prefix_entries.store(prompt_ids, cache)
            token = self._sample(logits, cfg, gen, ring, 0)
            token_host = int(token)
            timing.prompt_secs = time.perf_counter() - t0
            timing.completion_tokens = 1

            yield token_host
            if token_host in self.eos_token_ids:
                return
            t0 = time.perf_counter()
            max_decode = min(max_tokens, cache_len - prompt_len)
            blk = DECODE_BLOCK
            emitted = 1

            def emit(values):
                nonlocal emitted
                for v in values:
                    emitted += 1
                    timing.completion_tokens = emitted
                    timing.completion_secs = time.perf_counter() - t0
                    yield v
                    if v in self.eos_token_ids:
                        return True
                return False

            # whole blocks: the block's last token seeds the next block
            # live rows after a block: the prompt, the tokens sampled so
            # far (the last not yet in the cache) and the block's steps
            while emitted + blk <= max_decode:
                toks = self._decode_block(token, cache, cfg, gen, ring,
                                          emitted, blk,
                                          prompt_len + emitted + blk)
                token = toks[-1]
                if (yield from emit(toks.tolist())):
                    return
            rem = max_decode - emitted
            if rem <= 0:
                return
            if prompt_len + emitted + blk <= cache_len:
                # one overshooting block, extras discarded: blk − 1 wasted
                # device steps beat blk − 1 host round trips
                toks = self._decode_block(token, cache, cfg, gen, ring,
                                          emitted, blk,
                                          prompt_len + emitted + blk)
                yield from emit(toks.tolist()[:rem])
                return
            while emitted < max_decode:   # single-step tail at the bucket end
                token = self._decode_step(token, cache, cfg, gen, ring,
                                          emitted, prompt_len + emitted + 1)
                if (yield from emit([int(token)])):
                    return
        finally:
            self._return_cache(cache)

    def generate_tokens(self, prompt_ids: list[int], cfg: SamplingConfig,
                        max_tokens: int = 1024) -> list[int]:
        """Non-streaming: all sampled tokens, eos (if any) stripped."""
        out = list(self.stream_tokens(prompt_ids, cfg, max_tokens))
        if out and out[-1] in self.eos_token_ids:
            out = out[:-1]
        return out
