"""Captured decode blocks: the CUDA-graph counterpart of the JAX engines'
jitted, cache-donating decode functions (aha_tpu/core/engine.py
_get_decode_n, aha_tpu/core/batch_engine.py _decode_n).

A decode block is `n_steps` decode steps whose every input lives on the
device and is updated in place: the pooled cache, the token, the
repeat-token ring, the generated count and the sampling generators.  The
first call of a key runs the block eagerly on the engine's capture stream
(its real result: nothing is computed twice) — which also creates, outside
the graph's memory, every lazy device object the block touches: the
decode kernels' ticket counters of that stream, cuBLAS's workspace — then
captures the same block into a graph, as JAX compiles on first use.  Every
later call of the key is one `replay()`: the same kernels, in the same
order, from one host call.

Launch accounting: the wrappers' Python code runs only while a block is
captured, so the launches the capturing thread counts (ops/launches.py
`recording`: not another thread's meanwhile) are taken back and added
again at every replay: a count still says how many times the card ran its
kernel.

A capture that fails raises; nothing falls back to the eager block.

One key's first use (its eager block and its capture) runs alone in the
process (`_FIRST_USE`): two engines' threads capturing at once — dp
replicas, each with its own scheduler — invalidate each other's
captures.  Replays of other engines go on meanwhile.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, Hashable

import torch

from aha_tpu_torch.ops import launches

#: held through a key's first use: one capture at a time in the process
_FIRST_USE = threading.Lock()
#: the modules whose functions carry a kernel's launch count
_COUNTED_PREFIX = "aha_tpu_torch."


def counted_wrappers() -> list:
    """Every kernel wrapper loaded so far: a module-level function of the
    port with an integer `.launches` (the card tests read every count
    through it, whichever thread launched)."""
    found = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith(_COUNTED_PREFIX) or mod is None:
            continue
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                found[id(fn)] = fn
    return list(found.values())


def add_launches(delta: list[tuple], times: int = 1) -> None:
    for fn, n in delta:
        launches.count(fn, n * times)


@dataclasses.dataclass
class Captured:
    """One captured block: the graph, its static output and the launches
    one replay makes."""
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor
    delta: list
    replays: int = 0

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        add_launches(self.delta)
        self.replays += 1
        return self.out


class DecodeGraphs:
    """One engine's captured decode blocks.  The engine owns one capture
    stream and one memory pool, shared by all its graphs (they replay one
    at a time, on one stream); `run(table, key, block)` replays the graph
    of `key` in `table` — a dict the caller keeps beside the tensors the
    block binds (a pooled cache) — capturing it on first use.  Counts the
    graphs captured and the seconds their first uses took (each key's
    eager first block and its capture)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.captured = 0
        self.capture_secs = 0.0

    def stats(self) -> dict:
        return {"graphs": self.captured,
                "capture_s": round(self.capture_secs, 4)}

    def run(self, table: dict, key: Hashable,
            block: Callable[[], torch.Tensor],
            generators: tuple = ()) -> torch.Tensor:
        """The block's output: a replay of its graph, or on the key's
        first use the eager block (its real result), then the capture.
        `generators`: the torch.Generators the block draws from, each
        registered with the graph, so a replay draws what the eager block
        would from the generator's state at that moment."""
        got = table.get(key)
        if got is not None:
            return got.replay()
        with _FIRST_USE:
            t0 = time.perf_counter()
            out = self._eager_on_stream(block)
            table[key] = self._capture(block, generators)
            self.captured += 1
            self.capture_secs += time.perf_counter() - t0
        return out

    def _eager_on_stream(self, block) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = block()
        cur.wait_stream(self.stream)
        # made on the capture stream, read on this one
        out.record_stream(cur)
        return out

    def _capture(self, block, generators) -> Captured:
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        counted: dict = {}
        try:
            # thread_local: a server's other threads may allocate meanwhile
            with launches.recording(counted), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                out = block()
        finally:
            delta = list(counted.items())
            add_launches(delta, -1)     # captured, not launched
        cur.wait_stream(self.stream)
        return Captured(graph, out, delta)
