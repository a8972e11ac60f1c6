"""Data parallelism: D BatchEngine replicas in the serving process, one a
card, each with batch_slots/D slots, its own scheduler thread and its own
CUDA graphs (the JAX package shards the one engine's slot axis over the
dp mesh axis; slots are independent, so there are no collectives on the
decode path either way).

A request goes to the replica with the most free slots, a tie to the
lowest: the counts are of requests each replica is serving or has
queued, kept here.  The engine interface is BatchEngine's (stream_tokens,
generate_tokens, last_timing of the calling thread's request, shutdown).
"""

from __future__ import annotations

import threading
from typing import Iterator

from aha_tpu_torch.core.sampling import SamplingConfig


class ReplicaEngine:
    def __init__(self, engines: list):
        if not engines:
            raise ValueError("no replicas")
        self.engines = list(engines)
        self.slots = sum(e.slots for e in self.engines)
        self.eos_token_ids = self.engines[0].eos_token_ids
        self._busy = [0] * len(self.engines)
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def device(self):
        return self.engines[0].device

    def _pick(self) -> int:
        """The replica with the most free slots (the lowest on a tie),
        counted busy from now."""
        with self._lock:
            i = min(range(len(self.engines)),
                    key=lambda i: (self._busy[i] - self.engines[i].slots, i))
            self._busy[i] += 1
            return i

    def stream_tokens(self, prompt_ids: list[int], cfg: SamplingConfig,
                      max_tokens: int = 1024) -> Iterator[int]:
        i = self._pick()
        self._tls.engine = self.engines[i]
        try:
            yield from self.engines[i].stream_tokens(prompt_ids, cfg,
                                                     max_tokens)
        finally:
            with self._lock:
                self._busy[i] -= 1

    def generate_tokens(self, prompt_ids: list[int], cfg: SamplingConfig,
                        max_tokens: int = 1024) -> list[int]:
        out = list(self.stream_tokens(prompt_ids, cfg, max_tokens))
        if out and out[-1] in self.eos_token_ids:
            out = out[:-1]
        return out

    @property
    def last_timing(self):
        return getattr(self._tls, "engine", self.engines[0]).last_timing

    def shutdown(self) -> None:
        for e in self.engines:
            e.shutdown()
