"""Engine checks shared by the hybrid families' parity tests
(test_torch_lfm2.py, test_torch_qwen3_5.py): greedy streams of the port's
TextEngine and BatchEngine against aha_tpu's, over rolling state — the
prefix store's extension and exact repeat, chunked admission, and a slot
re-admitted after another request finished.  float32 on the CPU; every
stream is read in a thread with a deadline, and every engine is shut down
by the `engines` fixture's finalizer."""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.batch_engine import BatchEngine as JBatchEngine
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig

#: seconds any engine request may take before the test fails
DEADLINE = 60.0


@pytest.fixture
def engines(request):
    made = []

    def make(cls, *a, **kw):
        e = cls(*a, **kw)
        made.append(e)
        return e

    request.addfinalizer(lambda: [e.shutdown() for e in made
                                  if hasattr(e, "shutdown")])
    return make


def ids(seed: int, n: int, vocab: int = 120) -> list[int]:
    return [int(x) for x in
            np.random.default_rng(seed).integers(1, vocab - 1, n)]


def run_all(engine, prompts, cfg, max_tokens) -> list:
    """Every prompt from its own thread at once; each must finish within
    DEADLINE."""
    out, errs = [None] * len(prompts), []

    def run(i):
        try:
            out[i] = engine.generate_tokens(prompts[i], cfg, max_tokens)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE)
        assert not t.is_alive(), "an engine request did not finish"
    if errs:
        raise errs[0]
    return out


def one(engine, prompt, cfg, max_tokens) -> list[int]:
    return run_all(engine, [prompt], cfg, max_tokens)[0]


def text_engine_streams(jm, jp, tm, tp, engines) -> None:
    """A 40-token prompt, its extension by 9 tokens and an exact repeat,
    in that order, through TextEngines with the prefix store: the
    extension restores the stored K/V rows and rolling state and prefills
    from 40; the repeat matches no entry (the state cannot rewind a
    token), so it prefills whole.  Each stream equals aha_tpu's TextEngine
    with its prefix store and a cold port engine's."""
    base = ids(3, 40)
    prompts = [base, base + ids(4, 9), base]
    j = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                max_seq_len=256, prefix_cache_entries=4)
    t = engines(TextEngine, tm, tp, eos_token_ids=[], max_seq_len=256,
                prefix_cache_entries=4)
    cold = engines(TextEngine, tm, tp, eos_token_ids=[], max_seq_len=256)
    want = [j.generate_tokens(p, JSampling(), max_tokens=10) for p in prompts]
    got = []
    for p in prompts:
        got.append(one(t, p, SamplingConfig(), 10))
        assert one(cold, p, SamplingConfig(), 10) == got[-1]
    assert got == want and got[0] == got[2]
    store = t._prefix_entries
    assert len(store) == 2
    assert store.match(base) == (None, 0)
    entry, p = store.match(prompts[1] + [7])
    assert p == 49 and "conv" in entry


def batch_engine_streams(jm, jp, tm, tp, engines) -> None:
    """Three slots, more requests than slots, chunks of 16 and the prefix
    store: short prompts and chunked ones, a 70-token prompt admitted in
    chunks, its extension restored from the store and its exact repeat
    admitted whole — the same greedy tokens as aha_tpu's BatchEngine.
    Every last chunk's bucket fits the small cache's free rows, where the
    reference writes chunks at the right rows (ROADMAP queue 3, its fault
    1)."""
    kw = dict(eos_token_ids=[], slots=3, max_seq_len=128, runahead=4,
              prefill_chunk=16, prefix_cache_entries=4)
    j = engines(JBatchEngine, jm, jp, cache_dtype=jnp.float32, **kw)
    t = engines(BatchEngine, tm, tp, cache_dtype=torch.float32, **kw)
    assert t.prefill_chunk == 16 and t.prefix_cache_entries == 4
    mixed = [[1, 2, 3], [9, 8, 7, 6, 5], ids(1, 40), [4, 5, 6, 7],
             ids(2, 100)]
    want = run_all(j, mixed, JSampling(), 10)
    assert run_all(t, mixed, SamplingConfig(), 10) == want
    assert len({tuple(x) for x in want}) == len(mixed)
    base = ids(5, 70)
    for p in (base, base + ids(6, 9), base):
        assert one(t, p, SamplingConfig(), 8) == one(j, p, JSampling(), 8)
    assert len(t._prefix_entries) == 4      # 40, 100, 70 and 79 tokens


def readmitted_slot(tm, tp, engines) -> None:
    """Two slots: a long request A, a short one B beside it, then C once B
    has finished — admitted into a slot whose rolling state earlier
    requests and inactive steps left behind.  C streams as it would in a
    fresh engine."""
    kw = dict(eos_token_ids=[], slots=2, max_seq_len=256, runahead=4)
    t = engines(BatchEngine, tm, tp, cache_dtype=torch.float32, **kw)
    fresh = engines(BatchEngine, tm, tp, cache_dtype=torch.float32, **kw)
    a, b, c = ids(7, 30), ids(8, 20), ids(9, 12)
    out = {}

    def run(name, prompt, n):
        out[name] = t.generate_tokens(prompt, SamplingConfig(), n)

    ta = threading.Thread(target=run, args=("a", a, 120), daemon=True)
    ta.start()
    run("b", b, 3)
    run("c", c, 12)
    ta.join(timeout=DEADLINE)
    assert not ta.is_alive(), "request A did not finish"
    assert len(out["a"]) == 120 and len(out["b"]) == 3
    assert out["c"] == one(fresh, c, SamplingConfig(), 12)
    assert out["a"] == one(fresh, a, SamplingConfig(), 120)
