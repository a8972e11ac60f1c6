"""The engines' rolling-state support, for every family: `kv.reset` zeroes
conv / rec in place; the PrefixStore snapshots the state whole, skips an
exact repeat for an entry that carries it (and still matches one at n − 1
for a pure K/V entry), and restores it whole; BatchEngine's `_insert`
copies a slot's state whole; the loader serves lfm2 and qwen3_5 (LFM2's
chat equal to aha_tpu's on both engines, --spec-tokens ignored with the
engine's message).  CPU, float32."""

import itertools
import json
import os

import pytest
import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.engine import (PREFIX_MIN_TOKENS, PrefixStore,
                                       TextEngine)
from aha_tpu_torch.models.lfm2 import Lfm2Config, Lfm2Model
from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from aha_tpu_torch.models.qwen3_5 import Qwen3_5Model, Qwen3_5TextConfig

torch.set_num_threads(1)
LFM2 = dict(vocab_size=120, hidden_size=48, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, block_ff_dim=96,
            block_auto_adjust_ff_dim=False,
            layer_types=("conv", "full_attention", "conv", "full_attention"))
QWEN3_5 = dict(vocab_size=120, hidden_size=64, intermediate_size=128,
               num_hidden_layers=4, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16,
               linear_num_value_heads=4, linear_num_key_heads=2,
               linear_key_head_dim=16, linear_value_head_dim=16)


def _models():
    return {"lfm2": Lfm2Model(Lfm2Config(**LFM2), max_rope_len=256),
            "qwen3_5": Qwen3_5Model(Qwen3_5TextConfig(**QWEN3_5),
                                    max_rope_len=256)}


HYBRIDS = list(_models())


def _filled(cache: dict) -> dict:
    """Every float entry of the cache set to a distinct nonzero value."""
    for i, (name, t) in enumerate(sorted(cache.items())):
        if t.is_floating_point():
            t.copy_(torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape)
                    + 1.0 + i)
    return cache


@pytest.mark.parametrize("family", HYBRIDS)
@pytest.mark.parametrize("per_slot", [False, True])
def test_reset_zeroes_rolling_state_in_place(family, per_slot):
    """reset rewinds pos and zeroes conv (and rec) in their storage — a
    captured graph's bindings — and leaves the K/V rows as they were."""
    model = _models()[family]
    cache = _filled(model.init_cache(3, 64, torch.float32,
                                     per_slot_pos=per_slot))
    cache["pos"].fill_(7)
    ptrs = {n: cache[n].data_ptr() for n in kv.STATE_KEYS if n in cache}
    k = cache["k"].clone()
    kv.reset(cache)
    assert ptrs and all(cache[n].data_ptr() == p for n, p in ptrs.items())
    for name in ptrs:
        assert not cache[name].any(), name
    assert not cache["pos"].any() and torch.equal(cache["k"], k)
    assert ("rec" in cache) == (family == "qwen3_5")
    if "rec" in cache:
        assert cache["rec"].dtype == torch.float32


def _prompt(n, seed=0):
    return [(seed * 7 + 3 * i) % 100 + 1 for i in range(n)]


@pytest.mark.parametrize("family", HYBRIDS + ["qwen3", "llama"])
def test_prefix_store_exact_repeat_rule(family):
    """An entry that carries rolling state matches an extension at n and
    never an exact repeat (its state cannot rewind a token); a pure K/V
    entry still matches an exact repeat at n − 1."""
    if family == "qwen3":
        model = Qwen3Model(Qwen3Config(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, head_dim=16))
    elif family == "llama":
        model = LlamaModel(LlamaConfig(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1))
    else:
        model = _models()[family]
    stateful = family in HYBRIDS
    store = PrefixStore(4)
    n = PREFIX_MIN_TOKENS + 8
    base = _prompt(n)
    store.store(base, _filled(model.init_cache(1, 64, torch.float32)))
    entry, p = store.match(base + [5, 6])
    assert p == n and entry is not None
    assert ("conv" in entry) == stateful
    got, p = store.match(base)
    if stateful:
        assert (got, p) == (None, 0)
    else:
        assert got is entry and p == n - 1
    assert store.match(base[:-1] + [0]) == (None, 0)


@pytest.mark.parametrize("family", HYBRIDS)
def test_store_snapshots_and_restore_copies_state_whole(family):
    """store copies the rows [0, n) and the rolling state whole (later
    writes to the cache do not reach the entry); restore writes them back
    into another cache — the state whole, rope_delta too — and sets pos."""
    model = _models()[family]
    cache = _filled(model.init_cache(1, 64, torch.float32))
    n = PREFIX_MIN_TOKENS + 3
    store = PrefixStore(2)
    store.store(_prompt(n), cache)
    want = {name: t.clone() for name, t in cache.items()}
    for t in cache.values():
        t.zero_()
    entry, p = store.match(_prompt(n) + [9])
    assert p == n
    for name in kv.STATE_KEYS:
        if name in want:
            assert torch.equal(entry[name], want[name])
    other = model.init_cache(1, 128, torch.float32)
    PrefixStore.restore(entry, other, p)
    assert int(other["pos"]) == n
    for name in ("k", "v"):
        assert torch.equal(other[name][:, :, :n], want[name][:, :, :n])
        assert not other[name][:, :, n:].any()
    for name in kv.STATE_KEYS + ("rope_delta",):
        if name in want:
            assert torch.equal(other[name], want[name]), name


@pytest.mark.parametrize("family", HYBRIDS)
def test_insert_copies_a_slots_state_whole(family):
    """BatchEngine._insert writes the small cache's rows [0, n) and its
    whole rolling state into one slot, and that slot's pos; the other
    slots keep theirs."""
    model = _models()[family]
    params = model.init_random(torch.Generator().manual_seed(0))
    eng = BatchEngine(model, params, eos_token_ids=[], slots=3,
                      max_seq_len=64)
    try:
        big = eng._cache
        _filled(big)
        before = {name: t.clone() for name, t in big.items()}
        small = _filled(model.init_cache(1, 64, torch.float32))
        for t in small.values():
            if t.is_floating_point():
                t.neg_()
        eng._insert(small, 1, 20)
        assert big["pos"].tolist() == [0, 20, 0]
        for name in kv.STATE_KEYS:
            if name in small:
                assert torch.equal(big[name][:, 1], small[name][:, 0])
                assert torch.equal(big[name][:, 0], before[name][:, 0])
                assert torch.equal(big[name][:, 2], before[name][:, 2])
        assert torch.equal(big["k"][:, 1, :20], small["k"][:, 0, :20])
        assert torch.equal(big["k"][:, 1, 20:], before["k"][:, 1, 20:])
    finally:
        eng.shutdown()


@pytest.mark.parametrize("family", HYBRIDS + ["qwen3"])
@pytest.mark.parametrize("prefix", [0, 4])
def test_text_engine_streams_may_overlap(family, prefix):
    """Two stream_tokens generators open on one TextEngine at once, their
    tokens drawn in turn (with and without a prefix store): each request
    decodes on its own pooled cache (the second takes a new one while the
    first holds its bucket's), both streams equal the same requests run
    alone, and the caches go back to the pool."""
    from aha_tpu_torch.core.sampling import SamplingConfig

    if family == "qwen3":
        model = Qwen3Model(Qwen3Config(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, head_dim=16), max_rope_len=256)
    else:
        model = _models()[family]
    params = model.init_random(torch.Generator().manual_seed(1))
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=256,
                     prefix_cache_entries=prefix)
    greedy = SamplingConfig()
    a, b = _prompt(30, seed=1), _prompt(40, seed=2)
    want = [eng.generate_tokens(p, greedy, 20) for p in (a, b)]
    first, second = (eng.stream_tokens(p, greedy, 20) for p in (a, b))
    got = [[next(first)], [next(second)]]
    for pair in itertools.zip_longest(first, second):
        for out, tok in zip(got, pair):
            if tok is not None:
                out.append(tok)
    assert got == want
    assert not eng._live
    assert list(eng._cache_pool) == [256]


@pytest.mark.parametrize("family", HYBRIDS + ["qwen3"])
def test_text_engine_sampled_streams_may_overlap(family):
    """Two seeded sampled streams open on one TextEngine at once, their
    tokens drawn in turn, equal the same requests run alone: each request
    draws from its own generator, so the second request's seed does not
    re-seed the first's draws (as the JAX engine keeps a key a call)."""
    from aha_tpu_torch.core.sampling import SamplingConfig

    if family == "qwen3":
        model = Qwen3Model(Qwen3Config(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, head_dim=16), max_rope_len=256)
    else:
        model = _models()[family]
    params = model.init_random(torch.Generator().manual_seed(1), scale=0.3)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=256)
    cfgs = [SamplingConfig(temperature=1.0, top_k=50, seed=s)
            for s in (7, 8)]
    a, b = _prompt(30, seed=1), _prompt(40, seed=2)
    want = [eng.generate_tokens(p, c, 20) for p, c in zip((a, b), cfgs)]
    assert want[0] != want[1]
    first, second = (eng.stream_tokens(p, c, 20)
                     for p, c in zip((a, b), cfgs))
    got = [[next(first)], [next(second)]]
    for pair in itertools.zip_longest(first, second):
        for out, tok in zip(got, pair):
            if tok is not None:
                out.append(tok)
    assert got == want
    assert not eng._live


def test_engines_fuse_only_where_the_model_has_a_fusion():
    """LFM2 has no fuse_params (as aha_tpu's has none): both engines keep
    its tree; Qwen3.5's is fused."""
    models = _models()
    gen = torch.Generator().manual_seed(1)
    lp = models["lfm2"].init_random(gen)
    assert not hasattr(models["lfm2"], "fuse_params")
    assert TextEngine(models["lfm2"], lp, []).params is lp
    assert BatchEngine(models["lfm2"], lp, [], slots=2).params is lp
    qp = models["qwen3_5"].init_random(gen)
    fused = TextEngine(models["qwen3_5"], qp, []).params
    assert "in_proj" in fused["layers"][0]


# -- the loader ---------------------------------------------------------------


def _lfm2_repo(path: str) -> str:
    """A tiny LFM2 checkpoint in HF names (config.json with full_attn_idxs
    and intermediate_size, as published) with the test tokenizer."""
    from aha_tpu_torch.io.weights import save_hf_lfm2
    from tests.fixtures import CHAT_TEMPLATE, build_tokenizer

    os.makedirs(path, exist_ok=True)
    tok = build_tokenizer(path)
    eos = tok.token_to_id("<|im_end|>")
    cfg = {"architectures": ["Lfm2ForCausalLM"], "model_type": "lfm2",
           "vocab_size": tok.get_vocab_size(), "hidden_size": 48,
           "num_hidden_layers": 4, "num_attention_heads": 4,
           "num_key_value_heads": 2, "max_position_embeddings": 256,
           "intermediate_size": 96, "block_auto_adjust_ff_dim": False,
           "full_attn_idxs": [1, 3], "conv_L_cache": 3,
           "tie_word_embeddings": True, "eos_token_id": eos}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT_TEMPLATE}, f)
    model = Lfm2Model(Lfm2Config.from_dict(cfg))
    save_hf_lfm2(model.init_random(torch.Generator().manual_seed(3),
                                   scale=0.3), path)
    return path


@pytest.fixture(scope="module")
def lfm2_repo(tmp_path_factory):
    return _lfm2_repo(str(tmp_path_factory.mktemp("lfm2")))


@pytest.mark.parametrize("model_id,slots", [("LiquidAI/LFM2-1.2B", 1),
                                            ("LiquidAI/LFM2.5-1.2B-Instruct",
                                             3)])
def test_loader_serves_lfm2_as_the_reference(lfm2_repo, monkeypatch,
                                             model_id, slots):
    """lfm2 loads (no NotImplementedError) on a TextEngine or a
    BatchEngine of `slots`, and answers a greedy chat as aha_tpu's
    loader's model does."""
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu.params import ChatCompletionParameters as JParams
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.setenv("AHA_DTYPE", "float32")
    served = load_model(model_id, lfm2_repo, max_seq_len=256,
                        batch_slots=slots)
    try:
        assert isinstance(served.engine.model, Lfm2Model)
        assert isinstance(served.engine,
                          BatchEngine if slots > 1 else TextEngine)
        assert served.concurrent_streams == slots
        body = {"messages": [{"role": "user", "content": "hello world"}],
                "model": model_id, "max_tokens": 12, "temperature": 0.0}
        got = served.generate(ChatCompletionParameters.model_validate(body))
        want = jload_model(model_id, lfm2_repo, max_seq_len=256).generate(
            JParams.model_validate(body))
        assert got.choices[0].message.text() == \
            want.choices[0].message.text()
        assert got.choices[0].message.text()
    finally:
        if slots > 1:
            served.engine.shutdown()


def test_spec_tokens_are_ignored_on_rolling_state(lfm2_repo, monkeypatch,
                                                  capsys):
    """--spec-tokens on a hybrid: the engine keeps no speculation, with
    the message every model without token rewind gets."""
    from aha_tpu_torch.models.loader import load_model

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    served = load_model("LiquidAI/LFM2-1.2B", lfm2_repo, max_seq_len=256,
                        spec_tokens=4)
    assert served.engine.spec_tokens == 0
    assert "--spec-tokens ignored: Lfm2Model carries rolling conv/" \
        "recurrent state" in capsys.readouterr().out
