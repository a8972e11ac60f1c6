"""Continuous-batching decode engine (counterpart of
aha_tpu/core/batch_engine.py).

Batch-1 decode is bound by reading the weights, so stepping B requests
together costs little more than stepping one: the engine keeps B "slots"
live in one decode step and multiplies aggregate throughput by up to B.

Design, as in the JAX engine:
- One shared slot cache (L, B, S, ...) with a per-slot position vector
  cache["pos"] (B,): the model writes each slot's new K/V row at its own
  position and the decode kernels mask each slot by its own length.
  Inactive slots keep stepping with frozen positions (pos += active);
  their outputs are discarded.
- Admission prefills a prompt at batch 1 into a pooled small cache, chunk
  by chunk (`prefill_chunk`) with decode dispatches for the live slots
  interleaved between chunks, then copies its rows into slot b.  A stored
  prompt prefix is restored first (PrefixStore, shared with TextEngine).
- Per-slot sampling parameters ride as (B,) tensors
  (core/sampling.sample_tokens_batch); every slot draws its noise from its
  own torch.Generator, seeded from its request's seed, so a slot's stream
  depends on nothing but its own seed and config.  When every slot is
  greedy with no penalty the step is a plain fast_argmax over the logits.
- A scheduler thread owns all device work: admissions between decode
  dispatches, `decode_block` steps per dispatch up to `runahead` steps
  ahead of the host, chunked token fetches, per-request output queues.

Where the JAX engine jits `decode_block` steps into one dispatch and reads
tokens back with copy_to_host_async, this one runs the steps eagerly and
reads back through a non-blocking copy into pinned memory plus a CUDA
event, so the scheduler never waits on the step it just issued.  Not
ported: the `mesh`/`dp`/`tp` sharded layouts and multimodal requests.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import (CACHE_BUCKETS, PREFILL_BUCKETS,
                                       REPEAT_WINDOW, PrefixStore, Timing,
                                       bucket_for)
from aha_tpu_torch.core.sampling import (SamplingConfig, fast_argmax,
                                         pack_sampling_params, sample_token,
                                         sample_tokens_batch)

#: seconds a client waits on its queue before checking the scheduler lives
LIVENESS_SECS = 5.0


@dataclasses.dataclass
class _Request:
    prompt_ids: list[int]
    cfg: SamplingConfig
    max_tokens: int
    out: "queue.Queue[int | None | BaseException]"
    cancelled: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    timing: Timing = dataclasses.field(default_factory=Timing)
    t_start: float = 0.0


class _HostCopy:
    """A device tensor's values on their way to the host: a non-blocking
    copy into pinned memory and an event recorded after it (on the CPU,
    the tensor itself)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


class BatchEngine:
    """Continuous batching over a model with per-slot decode positions
    (Qwen3Model: a (B,) cache["pos"] and prefill over cached rows)."""

    def __init__(self, model, params: dict, eos_token_ids: list[int],
                 slots: int = 4, cache_dtype: torch.dtype | None = None,
                 max_seq_len: int = 4096, runahead: int = 32,
                 prefix_cache_entries: int = 0, prefill_chunk: int = 512,
                 decode_block: int = 4):
        self.model = model
        self.params = model.fuse_params(params)
        self.eos_token_ids = set(int(t) for t in eos_token_ids)
        self.slots = B = slots
        self.cache_dtype = cache_dtype or self.params["embed"]["w"].dtype
        self.max_seq_len = min(max_seq_len, CACHE_BUCKETS[-1])
        self.runahead = max(1, runahead)
        # chunking reorders float reductions, so a chunked prompt's logits
        # may differ from a one-shot prefill's in the last bits
        self.prefill_chunk = max(0, prefill_chunk)
        self._admission: dict | None = None
        self.decode_block = max(1, decode_block)
        # each consumer thread sees ITS request's timing
        self._tls = threading.local()
        self._default_timing = Timing()

        dev = self.device
        self._cache = model.init_cache(B, self.max_seq_len, self.cache_dtype,
                                       per_slot_pos=True)
        i32 = dict(dtype=torch.int32, device=dev)
        self._rings = torch.zeros((B, REPEAT_WINDOW), **i32)
        self._tokens = torch.zeros((B,), **i32)
        self._n_gen = torch.zeros((B,), **i32)
        self._slot_ar = torch.arange(B, device=dev)
        self._gens = [torch.Generator(device=dev) for _ in range(B)]

        # host-side slot bookkeeping
        self._slot_req: list[_Request | None] = [None] * B
        self._emitted = [0] * B
        self._budget = [0] * B
        # device-side step inputs, refreshed only when the slot set changes
        self._sp = pack_sampling_params([SamplingConfig()] * B, dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._active_i32 = self._active.int()
        self._mode = "greedy"
        self._slots_dirty = True

        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._pf_caches: dict[int, dict] = {}
        self.prefix_cache_entries = prefix_cache_entries
        self._prefix_entries = PrefixStore(self.prefix_cache_entries)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["w"].device

    @property
    def last_timing(self) -> Timing:
        return getattr(self._tls, "timing", self._default_timing)

    # -- device steps -------------------------------------------------------

    def _step(self) -> torch.Tensor:
        """One batched decode step of every slot; returns the (B,) tokens
        (0 for inactive slots)."""
        cache = self._cache
        hidden = self.model.backbone(self.params, self._tokens[:, None],
                                     cache)
        cache["pos"].add_(self._active_i32)
        logits = self.model.logits(self.params, hidden)[:, 0].float()
        if self._mode == "greedy":
            # every slot greedy with penalty 1.0: pure argmax, as the
            # single-stream engine's greedy path
            toks = fast_argmax(logits)
        else:
            toks = sample_tokens_batch(logits, self._sp, self._rings,
                                       self._n_gen, self._gens)
        toks = torch.where(self._active, toks, 0)
        self._rings[self._slot_ar, (self._n_gen % REPEAT_WINDOW).long()] = toks
        self._n_gen.add_(self._active_i32)
        self._tokens = toks
        return toks

    def _decode_n(self, n_steps: int) -> torch.Tensor:
        """n_steps batched decode steps; the (n_steps, B) tokens in step
        order."""
        return torch.stack([self._step() for _ in range(n_steps)])

    def _seed_slot(self, slot: int, tok: torch.Tensor) -> None:
        """Seed a freshly admitted slot's loop state with its first token."""
        self._tokens[slot] = tok
        self._rings[slot].zero_()
        self._rings[slot, 0] = tok
        self._n_gen[slot] = 1

    def _insert(self, small: dict, slot: int, prompt_len: int) -> None:
        """Copy a prefilled 1-slot cache's rows [0, prompt_len) into slot
        `slot` of the shared cache and set that slot's position."""
        for name in kv.ROW_KEYS:
            if name in small:
                self._cache[name][:, slot, :prompt_len].copy_(
                    small[name][:, 0, :prompt_len])
        self._cache["pos"][slot] = prompt_len

    def _prefill(self, tokens: list[int], bucket: int, small: dict,
                 from_cache: bool = False) -> torch.Tensor:
        """A whole prompt into an empty small cache (fresh-block attention,
        the flash kernel at ≥ 128 rows), or with `from_cache` a chunk over
        the rows [0, pos) already there; (1, V) f32 logits of its last
        row."""
        ids = torch.zeros((1, bucket), dtype=torch.int64)
        ids[0, :len(tokens)] = torch.tensor(tokens, dtype=torch.int64)
        hidden = self.model.backbone(self.params, ids.to(self.device), small,
                                     from_cache=from_cache)
        kv.advance(small, len(tokens))
        last = hidden[:, len(tokens) - 1:len(tokens)]
        return self.model.logits(self.params, last)[:, 0].float()

    # -- public API ---------------------------------------------------------

    def start(self) -> None:
        # guarded: concurrent callers must never start two schedulers
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="aha-torch-batch-scheduler")
                self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def stream_tokens(self, prompt_ids: list[int], cfg: SamplingConfig,
                      max_tokens: int = 1024) -> Iterator[int]:
        """TextEngine's streaming interface: yields sampled token ids
        (including the final eos)."""
        prompt_len = len(prompt_ids)
        if prompt_len == 0:
            raise ValueError("empty prompt")
        if prompt_len >= self.max_seq_len:
            raise ValueError(
                f"prompt is {prompt_len} tokens but the shared batch cache "
                f"holds {self.max_seq_len}; shorten the prompt or raise "
                f"max_seq_len")
        self.start()
        req = _Request(prompt_ids=list(prompt_ids), cfg=cfg,
                       max_tokens=max_tokens, out=queue.Queue())
        req.timing.prompt_tokens = prompt_len
        req.t_start = time.perf_counter()
        self._tls.timing = req.timing   # live object, updated by scheduler
        self._pending.put(req)
        self._wake.set()
        try:
            while True:
                try:
                    item = req.out.get(timeout=LIVENESS_SECS)
                except queue.Empty:
                    # the scheduler forwards its own errors; if it died
                    # without delivering, fail instead of blocking forever
                    t = self._thread
                    if t is None or not t.is_alive():
                        raise RuntimeError(
                            "batch scheduler thread is not running")
                    continue
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            req.cancelled.set()

    def generate_tokens(self, prompt_ids: list[int], cfg: SamplingConfig,
                        max_tokens: int = 1024) -> list[int]:
        """Non-streaming: all sampled tokens, eos (if any) stripped."""
        out = list(self.stream_tokens(prompt_ids, cfg, max_tokens))
        if out and out[-1] in self.eos_token_ids:
            out = out[:-1]
        return out

    # -- scheduler ----------------------------------------------------------

    def _free_slots(self) -> list[int]:
        reserved = ({self._admission["slot"]} if self._admission is not None
                    else set())
        return [i for i, r in enumerate(self._slot_req)
                if r is None and i not in reserved]

    # An admission reserves a slot, restores a stored prefix, and prefills
    # the prompt one chunk per scheduler pass (decode dispatches for live
    # slots interleave between chunks).  The first token is sampled on the
    # device and delivered through the same fetch pipeline as decode steps.

    def _begin_admission(self, req: _Request, slot: int) -> None:
        prompt_len = len(req.prompt_ids)
        pf_bucket = min(bucket_for(prompt_len, PREFILL_BUCKETS),
                        self.max_seq_len)
        small = self._pf_caches.pop(pf_bucket, None)
        if small is None:
            small = self.model.init_cache(1, pf_bucket, self.cache_dtype)
        small = kv.reset(small)
        t0 = time.perf_counter()
        entry, p = (None, 0)
        if self.prefix_cache_entries:
            entry, p = self._prefix_entries.match(req.prompt_ids)
            if entry is not None and \
                    p + bucket_for(prompt_len - p) > pf_bucket:
                entry, p = None, 0       # suffix bucket would not fit
        if entry is not None:
            PrefixStore.restore(entry, small, p)
        self._admission = {"req": req, "slot": slot, "small": small,
                           "pf_bucket": pf_bucket, "off": p, "t0": t0,
                           "fresh": p == 0}

    def _advance_admission(self) -> list | None:
        """Run ONE prefill chunk; on the last, finalize the slot and return
        the first token's fetch entry (None otherwise)."""
        st = self._admission
        req, slot = st["req"], st["slot"]
        try:
            if req.cancelled.is_set():
                self._admission = None
                self._pf_caches[st["pf_bucket"]] = st["small"]
                req.out.put(None)
                return None
            prompt = req.prompt_ids
            n = len(prompt)
            take = min(n - st["off"], max(self.prefill_chunk or n, 1))
            chunk = prompt[st["off"]:st["off"] + take]
            # the chunk's bucket, cut to the small cache's free rows: the
            # JAX engine's dynamic_update_slice would shift an overrunning
            # chunk back over earlier rows
            cbucket = min(bucket_for(len(chunk), PREFILL_BUCKETS),
                          st["pf_bucket"] - st["off"])
            logits = self._prefill(chunk, cbucket, st["small"],
                                   from_cache=not (st["fresh"] and take == n))
            st["off"] += take
            st["fresh"] = False
            if st["off"] < n:
                return None
            self._admission = None
            return self._finalize_admission(req, slot, st, logits)
        except Exception as e:  # surface as the request's error
            self._admission = None
            req.out.put(e)
            req.out.put(None)
            return None

    def _finalize_admission(self, req: _Request, slot: int, st: dict,
                            logits: torch.Tensor) -> list:
        """Insert the prefilled rows into the slot, seed its loop state,
        and hand the (device) first token to the fetch pipeline."""
        prompt_len = len(req.prompt_ids)
        small = st["small"]
        if self.prefix_cache_entries:
            self._prefix_entries.store(req.prompt_ids, small)
        gen = self._gens[slot]
        gen.manual_seed(req.cfg.seed)
        tok = sample_token(logits[0], req.cfg, gen)
        self._insert(small, slot, prompt_len)
        self._pf_caches[st["pf_bucket"]] = small
        self._slot_req[slot] = req
        self._emitted[slot] = 0          # counted when the token is fetched
        self._budget[slot] = min(req.max_tokens,
                                 self.max_seq_len - prompt_len)
        self._slots_dirty = True
        self._seed_slot(slot, tok)
        return ["first", _HostCopy(tok), slot, req, st["t0"]]

    @staticmethod
    def _stamp(req: _Request) -> None:
        """Set completion_secs BEFORE the final token is enqueued, so a
        consumer that builds its usage chunk on seeing eos reads it."""
        req.timing.completion_secs = (
            time.perf_counter() - req.t_start - req.timing.prompt_secs)

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        if req is not None:
            if req.timing.completion_secs == 0.0:
                self._stamp(req)
            req.out.put(None)
        self._slot_req[slot] = None
        self._slots_dirty = True

    def _active_mask(self) -> list[bool]:
        return [r is not None and not r.cancelled.is_set()
                for r in self._slot_req]

    def _run(self) -> None:
        """Scheduler thread entry: a fatal error in the dispatch loop
        (device OOM, a kernel fault) reaches every active and queued
        request instead of leaving clients blocked."""
        try:
            # no_grad is thread-local: without it every step records a graph
            with torch.no_grad():
                self._run_inner()
        except BaseException as e:  # noqa: BLE001 — deliver, then re-raise
            for slot, r in enumerate(self._slot_req):
                if r is not None:
                    r.out.put(e)
                self._slot_req[slot] = None
            if self._admission is not None:
                self._admission["req"].out.put(e)
                self._admission = None
            while True:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                req.out.put(e)
                req.out.put(None)
            raise
        finally:
            for slot in range(self.slots):
                self._finish(slot)

    def _refresh_step_inputs(self, active: list[bool]) -> None:
        cfgs = [(r.cfg if r is not None else SamplingConfig())
                for r in self._slot_req]
        dev = self.device
        self._sp = pack_sampling_params(cfgs, dev)
        self._active = torch.tensor(active, dtype=torch.bool, device=dev)
        self._active_i32 = self._active.int()
        self._mode = "greedy" if all(
            c.greedy and c.repeat_penalty == 1.0 for c in cfgs) else "general"
        self._slots_dirty = False

    def _fetch(self, entries: list) -> list:
        """The host values of a batch of pending entries."""
        return [e[1].get() for e in entries]

    def _run_inner(self) -> None:
        # pending fetch entries, in dispatch order:
        #   ["step", copy of (n, B) tokens, slot_reqs, n]  — a decode dispatch
        #   ["first", copy of the token, slot, req, t0]    — an admission
        pending: list = []
        while not self._stop.is_set():
            for slot, r in enumerate(self._slot_req):
                if r is not None and r.cancelled.is_set():
                    self._finish(slot)

            # admissions: advance the one in progress by one chunk, else
            # start the next queued request (one at a time)
            admitted = False
            if self._admission is not None:
                first = self._advance_admission()
                if first is not None:
                    pending.append(first)
                    admitted = True
            while self._admission is None and self._free_slots():
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                if req.cancelled.is_set():
                    continue
                try:
                    self._begin_admission(req, self._free_slots()[0])
                    first = self._advance_admission()   # first chunk now
                    if first is not None:
                        pending.append(first)
                        admitted = True
                except Exception as e:  # surface as the request's error
                    self._admission = None
                    req.out.put(e)
                    req.out.put(None)

            active = self._active_mask()
            if not any(active) and not pending and self._admission is None:
                self._wake.clear()
                if self._pending.empty():
                    self._wake.wait(timeout=0.1)
                continue
            if self._slots_dirty:
                self._refresh_step_inputs(active)

            # dispatch up to `runahead` steps ahead of the fetch frontier;
            # mid-admission, cap new dispatches per pass so the next chunk
            # lands every few decode steps
            blk = self.decode_block
            in_flight = sum(e[3] for e in pending if e[0] == "step")
            cap_steps = (max(blk, 4) if self._admission is not None
                         else self.runahead)
            n_new = 0
            while any(active) and in_flight < self.runahead \
                    and n_new < cap_steps:
                seq = self._decode_n(blk)
                pending.append(["step", _HostCopy(seq),
                                list(self._slot_req), blk])
                in_flight += blk
                n_new += blk
                if admitted or not self._pending.empty():
                    break  # admit new work promptly

            if not pending:
                continue
            if self._admission is not None and len(pending) > 1:
                # mid-admission, fetch only once the pipeline is deep —
                # counted in STEPS, not entries
                steps = sum(e[3] for e in pending if e[0] == "step")
                if steps < self.runahead // 2:
                    continue
            n_fetch = max(1, len(pending) // 2) if len(pending) > 1 else 1
            batch = [pending.pop(0) for _ in range(n_fetch)]
            for fetched, entry in zip(self._fetch(batch), batch):
                if entry[0] == "first":
                    self._deliver_first(entry, fetched)
                else:
                    self._deliver_steps(entry, fetched)

    def _deliver_first(self, entry: list, tok: int) -> None:
        _, _, slot, req, t0 = entry
        if self._slot_req[slot] is not req:
            return                      # finished or cancelled meanwhile
        if req.cancelled.is_set():
            self._finish(slot)
            return
        req.timing.prompt_secs = time.perf_counter() - t0
        req.timing.completion_tokens = 1
        self._emitted[slot] = 1
        done = tok in self.eos_token_ids or self._budget[slot] <= 1
        if done:
            self._stamp(req)
        req.out.put(tok)
        if done:
            self._finish(slot)

    def _deliver_steps(self, entry: list, rows: list) -> None:
        _, _, slot_reqs, _ = entry
        for row in rows:
            for slot, req in enumerate(slot_reqs):
                if req is None or req is not self._slot_req[slot]:
                    continue
                if req.cancelled.is_set():
                    self._finish(slot)
                    continue
                if self._emitted[slot] == 0:
                    continue            # first token not yet delivered
                tok = row[slot]
                self._emitted[slot] += 1
                req.timing.completion_tokens = self._emitted[slot]
                done = tok in self.eos_token_ids or \
                    self._emitted[slot] >= self._budget[slot]
                if done:
                    self._stamp(req)
                req.out.put(tok)
                if done:
                    self._finish(slot)
