"""Prompt-lookup speculative decoding in aha_tpu_torch's TextEngine against
aha_tpu's (tests/test_spec_decode.py holds the JAX engine): the same
numpy weights (a tiny Qwen3 from jax.random.PRNGKey(11), carried across
with params_from_jax) through both engines, float32 on the CPU.  Streams,
drafts and every round's (targets, a) must be identical — no tolerance:
each is a token id or a count."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.engine import spec_propose_device as jpropose
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine, spec_propose_device
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

torch.set_num_threads(1)
GEO = dict(vocab_size=120, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16, max_position_embeddings=512)
GREEDY, JGREEDY = SamplingConfig(), JSampling(temperature=None)


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**GEO), max_rope_len=512)
    jp = jm.init_random(jax.random.PRNGKey(11))
    tm = Qwen3Model(Qwen3Config(**GEO), max_rope_len=512)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _jengine(jm, jp, spec, **kw):
    return JEngine(jm, jp, eos_token_ids=kw.pop("eos", []),
                   cache_dtype=jnp.float32, max_seq_len=256,
                   spec_tokens=spec, **kw)


def _engine(tm, tp, spec, **kw):
    return TextEngine(tm, tp, eos_token_ids=kw.pop("eos", []),
                      max_seq_len=256, spec_tokens=spec, **kw)


@pytest.fixture(scope="module")
def engines(pair):
    """One engine of each kind per draft count, kept across tests."""
    jm, jp, tm, tp = pair
    return {spec: (_jengine(jm, jp, spec), _engine(tm, tp, spec))
            for spec in (0, 4, 8)}


@pytest.mark.parametrize("seed", [3, 7, 13])
@pytest.mark.parametrize("spec", [4, 8])
def test_spec_streams_equal_jax_and_plain(engines, spec, seed):
    prompt = [(seed * i) % 100 + 1 for i in range(24)]
    want = engines[0][1].generate_tokens(prompt, GREEDY, max_tokens=48)
    je, te = engines[spec]
    got = te.generate_tokens(prompt, GREEDY, max_tokens=48)
    assert got == want
    assert je.generate_tokens(prompt, JGREEDY, max_tokens=48) == want
    assert te.last_spec_a and max(te.last_spec_a) > 0


def test_spec_rounds_equal_jax_rounds(pair, engines):
    """From the same prefilled state, 4 rounds of _spec_rounds give the
    JAX _get_spec_rounds' targets and a, and its pos and hl after."""
    jm, jp, tm, tp = pair
    je, te = engines[8]
    G1, R, cache_len = 9, 4, 256
    prompt = [(i % 5) + 1 for i in range(20)]
    toks = np.zeros((1, 32), np.int32)
    toks[0, :20] = prompt
    jcache = je._take_cache(cache_len)
    logits, jcache = je._prefill(je.params, jnp.asarray(toks), jcache,
                                 jnp.int32(20))
    first = int(jnp.argmax(logits[0]))
    hist = np.zeros((cache_len + G1 + 8,), np.int32)
    hist[:20], hist[20] = prompt, first
    out = je._get_spec_rounds(G1, R, cache_len)(
        je.params, jnp.int32(first), jcache, jnp.asarray(hist),
        jnp.int32(21))
    jt, ja, _, jcache, _, jhl = out

    st = te._take(cache_len)
    try:
        tl = te._prefill(prompt, 32, st.cache, from_cache=False)
        assert int(tl[0].argmax()) == first
        st.token.fill_(first)
        te._spec_history(st, G1, prompt + [first])
        rows = te._spec_rounds(st, G1, R, 20)
        np.testing.assert_array_equal(rows[:, :G1].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(rows[:, G1].numpy(), np.asarray(ja))
        assert int(st.cache["pos"]) == int(jcache["pos"])
        assert int(st.hl) == int(jhl)
        assert int(st.token) == int(out[2])
    finally:
        te._return(st)


@pytest.mark.parametrize("g", [1, 3, 8])
def test_device_propose_equals_jax_and_host_scan(g):
    """spec_propose_device drafts what the JAX function and the host scan
    draft, for 30 random histories of every length."""
    rng = random.Random(42)
    for trial in range(30):
        hist = [rng.randrange(6) + 1 for _ in range(rng.randrange(2, 60))]
        buf = np.zeros((len(hist) + g + 4,), np.int32)
        buf[:len(hist)] = hist
        d, n = spec_propose_device(torch.from_numpy(buf),
                                   torch.tensor(len(hist), dtype=torch.int32),
                                   g)
        jd, jn = jpropose(jnp.asarray(buf), jnp.int32(len(hist)), g)
        got = d[:int(n)].tolist()
        assert got == TextEngine._ngram_propose(hist, g), (trial, hist, got)
        assert got == np.asarray(jd)[:int(jn)].tolist()
        assert int(n) == int(jn)


def test_ngram_propose():
    prop = TextEngine._ngram_propose
    assert prop([1, 2, 3, 9, 9, 1, 2, 3], 2) == [9, 9]   # trigram
    assert prop([5, 6, 5], 3) == [6, 5]                  # unigram fallback
    assert prop([1, 2, 3], 4) == []                      # no occurrence


def test_spec_respects_max_tokens_and_eos(pair, engines):
    _, _, tm, tp = pair
    prompt = [(5 * i) % 100 + 1 for i in range(16)]
    want = engines[0][1].generate_tokens(prompt, GREEDY, max_tokens=40)
    assert engines[8][1].generate_tokens(prompt, GREEDY, max_tokens=7) \
        == want[:7]
    # random models repeat greedily, so some token recurs: use it as eos
    eos = want[len(want) // 2]
    stop = _engine(tm, tp, 8, eos=[eos])
    got = list(stop.stream_tokens(prompt, GREEDY, max_tokens=40))
    assert got == want[:want.index(eos) + 1]
    jstop = _jengine(*pair[:2], 8, eos=[eos])
    assert list(jstop.stream_tokens(prompt, JGREEDY, max_tokens=40)) == got


@pytest.mark.parametrize("prompt_len,no_drafts",
                         [(10, False), (14, False), (14, True)])
def test_spec_bucket_end_is_exact_and_never_overruns(pair, engines,
                                                     prompt_len, no_drafts):
    """max_tokens past the 256-row bucket: every forward writes rows below
    the bucket's end, pos never passes it, and the stream equals plain
    decoding and the JAX spec engine's.  Draftless rounds (one token
    each) always leave rows the rounds cannot take: the stream is handed
    to the decode blocks' single-step tail."""
    jm, jp, tm, tp = pair
    te = _engine(tm, tp, 8, spec_no_drafts=no_drafts)
    prompt = [(3 * i) % 100 + 1 for i in range(prompt_len)]
    want = engines[0][1].generate_tokens(prompt, GREEDY, max_tokens=1024)
    seen = []
    real = tm.backbone

    def watched(params, ids, cache, **kw):
        seen.append((int(cache["pos"]), ids.shape[1]))
        out = real(params, ids, cache, **kw)
        assert int(cache["pos"]) <= kv.cache_max_len(cache)
        return out

    tm.backbone = watched
    try:
        got = te.generate_tokens(prompt, GREEDY, max_tokens=1024)
    finally:
        del tm.backbone
    assert got == want and len(got) == 256 - prompt_len
    assert all(p + s <= 256 for p, s in seen)
    rounds = [p for p, s in seen[1:] if s > 1]
    singles = [p for p, s in seen[1:] if s == 1]
    assert rounds and (singles or not no_drafts)
    assert not singles or max(rounds) < min(singles)
    assert engines[8][0].generate_tokens(prompt, JGREEDY,
                                         max_tokens=1024) == want


def test_spec_rounds_refuse_a_dispatch_past_the_bucket(pair, engines):
    """The host guard: rounds that could write row 256 are refused before
    anything runs (the JAX engine no-ops them on the device, a = −1)."""
    te = engines[8][1]
    st = te._take(256)
    try:
        te._spec_history(st, 9, [1, 2, 3])
        with pytest.raises(ValueError, match="overrun"):
            te._spec_rounds(st, 9, 1, 256 - 9 + 1)
        with pytest.raises(ValueError, match="overrun"):
            te._spec_rounds(st, 9, 8, 256 - 8 * 9 + 1)
        assert int(st.cache["pos"]) == 0
    finally:
        te._return(st)


def test_spec_off_for_a_model_without_rewind():
    """Qwen2.5-VL (as in the JAX package) has no supports_token_rewind:
    spec_tokens is silently 0 and the engine decodes plainly."""
    from aha_tpu_torch.models.llama import LlamaConfig
    from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLConfig,
                                                Qwen2_5VLModel, VisionConfig)

    cfg = Qwen2_5VLConfig(
        vision=VisionConfig(depth=1, hidden_size=32, intermediate_size=64,
                            num_heads=2, out_hidden_size=48,
                            fullatt_block_indexes=(0,)),
        text=LlamaConfig(vocab_size=100, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=1,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256,
                         tie_word_embeddings=True, qkv_bias=True),
        image_token_id=90, video_token_id=91, vision_start_token_id=92)
    model = Qwen2_5VLModel(cfg, max_rope_len=256)
    assert not getattr(model, "supports_token_rewind", False)
    params = model.init_random(torch.Generator().manual_seed(1))
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=256,
                     spec_tokens=8)
    assert eng.spec_tokens == 0
    out = eng.generate_tokens([(7 * i) % 80 + 1 for i in range(12)], GREEDY,
                              max_tokens=8)
    assert len(out) == 8 and eng.last_spec_a == []


@pytest.mark.parametrize("cfg", [
    SamplingConfig(temperature=0.8, top_k=20, seed=5),
    SamplingConfig(repeat_penalty=1.1)], ids=["sampled", "penalized"])
def test_spec_bypassed_by_sampled_and_penalized_requests(engines, cfg):
    prompt = [(11 * i) % 100 + 1 for i in range(20)]
    te = engines[8][1]
    got = te.generate_tokens(prompt, cfg, max_tokens=16)
    assert te.last_spec_a == []
    assert got == engines[0][1].generate_tokens(prompt, cfg, max_tokens=16)


def test_spec_composes_with_the_prefix_store(pair, engines):
    """Restore + suffix prefill, then rounds: exact, and as the JAX
    engine's."""
    jm, jp, tm, tp = pair
    base = [(i * 13) % 100 + 1 for i in range(40)]
    ext = base + [5, 6, 7, 8]
    both = _engine(tm, tp, 8, prefix_cache_entries=4)
    both.generate_tokens(base, GREEDY, max_tokens=6)
    assert len(both._prefix_entries) == 1
    want = engines[0][1].generate_tokens(ext, GREEDY, max_tokens=24)
    assert both.generate_tokens(ext, GREEDY, max_tokens=24) == want
    assert both.last_spec_a
    jboth = _jengine(jm, jp, 8, prefix_cache_entries=4)
    jboth.generate_tokens(base, JGREEDY, max_tokens=6)
    assert jboth.generate_tokens(ext, JGREEDY, max_tokens=24) == want


def test_spec_llama_family_with_mup_scalings():
    """The llama decoder (mup scalings, the 5-D cache) rewinds too: its
    spec streams equal plain decoding and the JAX spec engine's."""
    from aha_tpu.models.llama import LlamaConfig as JLlamaConfig
    from aha_tpu.models.llama import LlamaModel as JLlamaModel
    from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel

    geo = dict(vocab_size=120, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=512,
               scale_emb=12.0, scale_depth=1.4, dim_model_base=32)
    jm = JLlamaModel(JLlamaConfig(**geo), max_rope_len=512)
    jp = jm.init_random(jax.random.PRNGKey(4))
    tm = LlamaModel(LlamaConfig(**geo), max_rope_len=512)
    assert tm.supports_token_rewind
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    plain, fast = _engine(tm, tp, 0), _engine(tm, tp, 8)
    jfast = _jengine(jm, jp, 8)
    for seed in (2, 9):
        prompt = [(seed * i) % 100 + 1 for i in range(20)]
        want = plain.generate_tokens(prompt, GREEDY, max_tokens=40)
        assert fast.generate_tokens(prompt, GREEDY, max_tokens=40) == want
        assert jfast.generate_tokens(prompt, JGREEDY, max_tokens=40) == want


def test_spec_draftless_prompt_stays_exact(engines):
    """No repeated n-gram in the prompt: the proposer has nothing to draft
    from it, and the stream stays exact."""
    prompt = list(range(1, 19))
    assert TextEngine._ngram_propose(prompt, 8) == []
    want = engines[0][1].generate_tokens(prompt, GREEDY, max_tokens=40)
    je, te = engines[8]
    assert te.generate_tokens(prompt, GREEDY, max_tokens=40) == want
    assert je.generate_tokens(prompt, JGREEDY, max_tokens=40) == want


def test_spec_no_drafts_accepts_nothing_and_stays_exact(pair, engines):
    """spec_no_drafts=True: every round verifies its token alone (a = 0),
    on a prompt whose drafts would otherwise be accepted."""
    _, _, tm, tp = pair
    prompt = [(i % 7) + 1 for i in range(40)]
    want = engines[0][1].generate_tokens(prompt, GREEDY, max_tokens=48)
    eng = _engine(tm, tp, 8, spec_no_drafts=True)
    assert eng.generate_tokens(prompt, GREEDY, max_tokens=48) == want
    assert eng.last_spec_a and set(eng.last_spec_a) == {0}
    drafted = engines[8][1]
    assert drafted.generate_tokens(prompt, GREEDY, max_tokens=48) == want
    assert max(drafted.last_spec_a) > 0


def test_spec_over_the_int8_cache(pair):
    """Quantized row writes, the int8 chunk attention and the rewind: the
    spec stream equals the int8 plain stream."""
    _, _, tm, tp = pair
    plain = _engine(tm, tp, 0, cache_dtype=torch.int8)
    fast = _engine(tm, tp, 8, cache_dtype=torch.int8)
    for seed in (3, 7):
        prompt = [(seed * i) % 100 + 1 for i in range(24)]
        want = plain.generate_tokens(prompt, GREEDY, max_tokens=64)
        assert fast.generate_tokens(prompt, GREEDY, max_tokens=64) == want
        assert max(fast.last_spec_a) > 0


def test_spec_acceptance_saturates_on_cyclic_output(pair):
    """On cyclic output the proposer's longest-continuation rule lets
    acceptance reach the full draft budget (aha_tpu's regression test of
    a proposer pinned at one draft a round)."""
    _, _, tm, tp = pair
    eng = _engine(tm, tp, 15)
    out = eng.generate_tokens([(i % 7) + 1 for i in range(64)], GREEDY,
                              max_tokens=128)
    assert len(out) == 128
    a = eng.last_spec_a
    assert max(a) == 15, a
    assert sum(x == 15 for x in a) >= len(a) // 2, a


def test_spec_with_batch_slots_refused_before_loading(tmp_path):
    from aha_tpu_torch.models.loader import load_model

    # a missing path raising ValueError, not FileNotFoundError: the check
    # comes before any weights are read
    with pytest.raises(ValueError, match="spec-tokens"):
        load_model("Qwen/Qwen3-0.6B", str(tmp_path / "missing"),
                   max_seq_len=256, batch_slots=2, spec_tokens=8)


def test_served_chat_equal_with_and_without_spec(tmp_path, monkeypatch):
    """--spec-tokens through load_model leaves a greedy chat unchanged."""
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters
    from tests.fixtures import build_tiny_qwen3_repo

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    d = str(tmp_path / "q3")
    build_tiny_qwen3_repo(d)
    req = ChatCompletionParameters.model_validate({
        "messages": [{"role": "user", "content": "write me a poem please"}],
        "model": "q", "max_tokens": 24, "temperature": 0.0})
    plain = load_model("Qwen/Qwen3-0.6B", d, max_seq_len=512)
    fast = load_model("Qwen/Qwen3-0.6B", d, max_seq_len=512, spec_tokens=8)
    assert fast.engine.spec_tokens == 8
    a = plain.generate(req).choices[0].message
    b = fast.generate(req).choices[0].message
    assert (a.content, getattr(a, "reasoning_content", None)) == \
        (b.content, getattr(b, "reasoning_content", None))
    assert fast.engine.last_spec_a
