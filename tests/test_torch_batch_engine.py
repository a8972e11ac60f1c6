"""aha_tpu_torch's continuous batching against aha_tpu's: per-slot decode
positions, the batched decode plain version against the Pallas batched
kernel (interpret mode, float32, 1e-5), and greedy token streams of the
port's BatchEngine equal to aha_tpu's BatchEngine on the same parameters
— more requests than slots, chunked admission (float32 and int8), a
prefix-cache hit — plus the slot behaviour of tests/test_batch_engine.py
(eos, cancellation, a scheduler crash, fetches during a long admission)
and seeded sampling that does not depend on the other slots.  Every
stream is read with a deadline and every engine is shut down by its
fixture.  float32 compute on the CPU, the tiny geometry of
tests/test_batch_engine.py."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.batch_engine import BatchEngine as JBatchEngine
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu.ops import flash_attention as jfa
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                        fuse_decode_params)
from aha_tpu_torch.ops.flash_attention import \
    flash_decode_at_layer_flat_batched

torch.set_num_threads(1)
GEO = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
GREEDY, JGREEDY = SamplingConfig(), JSampling()
DEADLINE = 60.0      # seconds any one engine call may take here


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**GEO))
    # scale 0.3: greedy streams that are not one repeated token
    jp = jm.init_random(jax.random.PRNGKey(0), scale=0.3)
    tm = Qwen3Model(Qwen3Config(**GEO))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def engines(request):
    """A factory of engines, every one shut down when the test ends."""
    made = []

    def make(cls, *a, **kw):
        e = cls(*a, **kw)
        made.append(e)
        return e

    request.addfinalizer(lambda: [e.shutdown() for e in made])
    return make


def _ids(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


def _run_all(engine, prompts, cfgs, max_tokens):
    """Every request from its own thread at once; each must finish within
    DEADLINE.  Returns the token lists in request order."""
    out, errs = [None] * len(prompts), []

    def run(i):
        try:
            out[i] = engine.generate_tokens(prompts[i], cfgs[i], max_tokens)
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


def _one(engine, prompt, cfg, max_tokens):
    return _run_all(engine, [prompt], [cfg], max_tokens)[0]


# -- the model ----------------------------------------------------------------


def test_vector_pos_decode_matches_scalar_and_jax(pair):
    """A (B,) pos decode step equals B scalar-pos steps (the port), and
    aha_tpu's (B,) pos step on the same caches."""
    jm, jp, tm, tp = pair
    lens, S = [5, 9, 17], 64
    caches, toks, ref, stepped = [], [], [], []
    for i, n in enumerate(lens):
        c = tm.init_cache(1, S, torch.float32)
        h = tm.backbone(tp, torch.tensor([_ids(i, n)]), c)
        c["pos"].fill_(n)
        toks.append(int(tm.logits(tp, h)[0, -1].argmax()))
        caches.append(c)
    for i in range(3):
        c = {k: v.clone() for k, v in caches[i].items()}
        h = tm.backbone(tp, torch.tensor([[toks[i]]]), c)
        ref.append(tm.logits(tp, h)[0, 0])
        stepped.append(c)
    big = tm.init_cache(3, S, torch.float32, per_slot_pos=True)
    big["k"] = torch.cat([c["k"] for c in caches], 1)
    big["v"] = torch.cat([c["v"] for c in caches], 1)
    big["pos"] = torch.tensor(lens, dtype=torch.int32)
    h = tm.backbone(tp, torch.tensor([[t] for t in toks]), big)
    got = tm.logits(tp, h)[:, 0]
    for i in range(3):
        torch.testing.assert_close(got[i], ref[i], atol=2e-5, rtol=0)
        # each slot's new row went to its own position
        torch.testing.assert_close(big["k"][:, i, :lens[i] + 1],
                                   stepped[i]["k"][:, 0, :lens[i] + 1],
                                   atol=2e-5, rtol=0)
    jbig = {"k": jnp.asarray(big["k"].numpy()), "v": jnp.asarray(
        big["v"].numpy()), "pos": jnp.asarray(lens, jnp.int32)}
    # the written rows are in big already; JAX rewrites the same rows
    jh, jc = jm.backbone(jp, jnp.asarray([[t] for t in toks]), jbig)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jm.logits(jp, jh)[:, 0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(big["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-4, atol=1e-5)


def test_batched_decode_plain_matches_jax_kernel():
    """The batched wrapper's plain version against the Pallas batched kernel
    (interpret mode) in float32, ragged lengths with a parked slot and
    split boundaries: within 1e-5."""
    rng = np.random.default_rng(11)
    L, B, S, Hkv, D, Hq = 3, 8, 512, 2, 64, 4
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((L, B, S, Hkv * D)).astype(np.float32)
    v = rng.standard_normal((L, B, S, Hkv * D)).astype(np.float32)
    valid = [1, 5, 64, 100, 128, 200, 511, 512]
    want = np.asarray(jfa.flash_decode_at_layer_flat_batched(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.int32(2),
        jnp.asarray(valid, jnp.int32), block_k=256, interpret=True))
    got = flash_decode_at_layer_flat_batched(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor(2, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["bf16", "batch", "int8", "slot_pos"])
def test_fused_gate_refuses_batches_and_int8(case):
    """The one-launch decode stack takes one bf16 token of batch 1 over a
    bf16 cache with a scalar pos; a batched step, an int8 cache or a
    per-slot pos take the per-op chain."""
    geo = dict(GEO, hidden_size=128, head_dim=64)
    tm = Qwen3Model(Qwen3Config(**geo))
    params = fuse_decode_params(tm.init_random(
        torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    B = 2 if case == "batch" else 1
    dtype = torch.int8 if case == "int8" else torch.bfloat16
    cache = tm.init_cache(B, 64, dtype, per_slot_pos=case == "slot_pos")
    x = torch.zeros((B, 1, 128), dtype=torch.bfloat16)
    assert tm._use_fused_stack(params, x, cache, 64) == (
        "bf16" if case == "bf16" else None)


# -- engines against aha_tpu's -------------------------------------------------


def _jax_engine(engines, pair, dtype, **kw):
    jm, jp, _, _ = pair
    return engines(JBatchEngine, jm, jp, eos_token_ids=[], cache_dtype=dtype,
                   max_seq_len=256, runahead=4, **kw)


def _port_engine(engines, pair, dtype, **kw):
    _, _, tm, tp = pair
    return engines(BatchEngine, tm, tp, eos_token_ids=[], cache_dtype=dtype,
                   max_seq_len=256, runahead=4, **kw)


def test_more_requests_than_slots_match_jax(pair, engines):
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], _ids(1, 29), [4, 5, 6, 7],
               [11, 12]]
    j = _jax_engine(engines, pair, jnp.float32, slots=2)
    t = _port_engine(engines, pair, torch.float32, slots=2)
    want = _run_all(j, prompts, [JGREEDY] * 5, 10)
    got = _run_all(t, prompts, [GREEDY] * 5, 10)
    assert got == want
    assert len({tuple(x) for x in got}) == 5


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_chunked_admission_matches_jax(pair, engines, dtype):
    """A 100-token prompt admitted in 32-token chunks, while a short
    request decodes in the other slot."""
    prompts = [_ids(2, 100), [3, 1, 4, 1, 5]]
    j = _jax_engine(engines, pair, getattr(jnp, dtype), slots=2,
                    prefill_chunk=32)
    t = _port_engine(engines, pair, getattr(torch, dtype), slots=2,
                     prefill_chunk=32)
    want = _run_all(j, prompts, [JGREEDY] * 2, 8)
    got = _run_all(t, prompts, [GREEDY] * 2, 8)
    assert got == want


def test_chunk_past_the_prefill_cache_stays_in_place(pair, engines):
    """50 tokens in chunks of 8: the last chunk's 32-row bucket would run
    past the 64-row prefill cache.  The port cuts the bucket to the free
    rows, so the stream equals a single-stream prefill's (aha_tpu's
    TextEngine); aha_tpu's BatchEngine shifts that chunk back over earlier
    rows instead (ROADMAP queue 3)."""
    jm, jp, _, _ = pair
    prompt = _ids(3, 50)
    single = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                     max_seq_len=256, runahead=4)
    want = single.generate_tokens(prompt, JGREEDY, max_tokens=8)
    t = _port_engine(engines, pair, torch.float32, slots=2, prefill_chunk=8)
    assert _one(t, prompt, GREEDY, 8) == want


def test_prefix_cache_hit_matches_jax(pair, engines):
    base = _ids(4, 40)
    ext = base + [5, 6, 7, 8]
    j = _jax_engine(engines, pair, jnp.float32, slots=2,
                    prefix_cache_entries=4)
    t = _port_engine(engines, pair, torch.float32, slots=2,
                     prefix_cache_entries=4)
    for ids in (base, base, ext):
        assert _one(t, ids, GREEDY, 6) == _one(j, ids, JGREEDY, 6)
    assert len(t._prefix_entries) == len(j._prefix_entries) == 2


# -- slot behaviour -------------------------------------------------------------


def test_eos_stops_a_slot(pair, engines):
    t = _port_engine(engines, pair, torch.float32, slots=2)
    probe = _one(t, [1, 2, 3], GREEDY, 8)
    eos = probe[3]
    _, _, tm, tp = pair
    e = engines(BatchEngine, tm, tp, eos_token_ids=[eos], slots=2,
                cache_dtype=torch.float32, max_seq_len=256)
    assert _one(e, [1, 2, 3], GREEDY, 8) == probe[:probe.index(eos)]


def test_cancelling_frees_the_slot(pair, engines):
    t = _port_engine(engines, pair, torch.float32, slots=1)
    it = t.stream_tokens([1, 2, 3], GREEDY, max_tokens=200)
    first = []
    reader = threading.Thread(target=lambda: first.append(next(it)),
                              daemon=True)
    reader.start()
    reader.join(timeout=DEADLINE)
    assert first, "no first token"
    it.close()                    # the client walks away mid-stream
    assert len(_one(t, [4, 5, 6], GREEDY, 5)) == 5


def test_scheduler_crash_reaches_every_client(pair, engines):
    t = _port_engine(engines, pair, torch.float32, slots=2)

    def boom(n_steps):
        raise RuntimeError("injected device failure")

    t._decode_n = boom
    errs = []

    def run(ids):
        try:
            t.generate_tokens(ids, GREEDY, max_tokens=8)
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=run, args=(ids,), daemon=True)
               for ids in ([1, 2, 3], [4, 5], [6, 7, 8, 9])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=DEADLINE)
        assert not th.is_alive()
    assert len(errs) == 3
    assert all("injected device failure" in e
               or "not running" in e for e in errs), errs


def test_admission_does_not_starve_fetches(pair, engines):
    """At the default runahead and decode_block, host fetches of the live
    stream's tokens happen between the chunks of a long admission."""
    t = _port_engine(engines, pair, torch.float32, slots=2, prefill_chunk=8)
    t.runahead = 32                       # the default
    order = []
    real_prefill, real_fetch = t._prefill, t._fetch

    def spy_prefill(*a, **k):
        if k.get("from_cache"):
            order.append("c")
        return real_prefill(*a, **k)

    def spy_fetch(*a, **k):
        order.append("f")
        return real_fetch(*a, **k)

    t._prefill, t._fetch = spy_prefill, spy_fetch
    it = t.stream_tokens([1, 2, 3], GREEDY, max_tokens=220)
    got_first = []
    reader = threading.Thread(target=lambda: got_first.append(next(it)),
                              daemon=True)
    reader.start()
    reader.join(timeout=DEADLINE)
    assert got_first
    order.clear()
    assert len(_one(t, _ids(5, 128), GREEDY, 2)) == 2    # 16 chunks
    it.close()
    chunks = [i for i, x in enumerate(order) if x == "c"]
    assert len(chunks) >= 16, order
    assert "f" in order[chunks[0]:chunks[-1]], order


def test_seeded_sampling_independent_of_other_slots(pair, engines):
    """A seeded sampled request gives the same stream alone and as the
    last of four requests (another slot, three other streams beside it,
    two of them sampled with other seeds)."""
    cfg = SamplingConfig(temperature=0.9, top_k=40, top_p=0.95,
                         repeat_penalty=1.2, seed=17)
    ids = _ids(6, 12)
    alone = _one(_port_engine(engines, pair, torch.float32, slots=4), ids,
                 cfg, 12)
    t = _port_engine(engines, pair, torch.float32, slots=4)
    others = [SamplingConfig(temperature=1.1, seed=3), GREEDY,
              SamplingConfig(temperature=0.7, top_k=5, seed=99)]
    got = _run_all(t, [_ids(7, 9), [1, 2], _ids(8, 30), ids],
                   others + [cfg], 12)
    assert got[3] == alone
    assert len(set(alone)) > 1
