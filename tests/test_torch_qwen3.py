"""aha_tpu_torch's Qwen3 model and TextEngine against aha_tpu's on the same
parameters (made once in JAX from a seed, carried across with
params_from_jax): prefill logits and teacher-forced decode steps, fused vs
unfused parameters, and greedy token streams through both engines —
across the 128-row prefill bucket, through a prefix-cache hit, and through
the single-step tail at the end of a cache bucket.  float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.io.weights import open_weights, save_hf_qwen3
from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                        fuse_decode_params)

torch.set_num_threads(1)
GEO = dict(vocab_size=400, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**GEO))
    # scale 0.3: a random model whose greedy streams are not one repeated
    # token, so stream equality means something
    jp = jm.init_random(jax.random.PRNGKey(0), scale=0.3)
    tm = Qwen3Model(Qwen3Config(**GEO))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _ids(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 399, n)]


def test_params_from_jax_round_trip(pair):
    _, jp, _, tp = pair
    np.testing.assert_array_equal(tp["layers"]["q"]["w"].numpy(),
                                  np.asarray(jp["layers"]["q"]["w"]))
    assert tp["layers"]["mlp"]["down"]["w"].shape == (2, 128, 64)
    # tied head: the embedding's own storage, vocab-major
    assert tp["lm_head"]["w"] is tp["embed"]["w"]
    untied = {**jax.tree.map(np.asarray, jp),
              "lm_head": {"w": np.arange(64 * 400, dtype=np.float32)
                          .reshape(64, 400)}}
    head = params_from_jax(untied)["lm_head"]["w"]
    assert head.shape == (400, 64)
    np.testing.assert_array_equal(head.numpy(), untied["lm_head"]["w"].T)


def test_prefill_and_decode_steps_match_jax(pair):
    jm, jp, tm, tp = pair
    ids = _ids(1, 20)
    jc = jm.init_cache(1, 64, jnp.float32)
    tc = tm.init_cache(1, 64, torch.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([ids]), jc)
    th = tm.backbone(tp, torch.tensor([ids]), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tm.logits(tp, th).numpy(),
                               np.asarray(jm.logits(jp, jh)), **TOL)
    jc = {**jc, "pos": jnp.int32(20)}
    tc["pos"].fill_(20)
    for step, tok in enumerate(_ids(2, 8)):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        tc["pos"].add_(1)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL,
                                   err_msg=f"decode step {step}")
        assert int(tm.greedy_token(tp, th)) == \
            int(jm.greedy_token(jp, jh))
    np.testing.assert_allclose(tc["k"][:, :, :28].numpy(),
                               np.asarray(jc["k"][:, :, :28]), **TOL)


def test_forward_hidden_matches_jax(pair):
    jm, jp, tm, tp = pair
    ids = [_ids(4, 24), _ids(5, 24)]
    np.testing.assert_allclose(
        tm.forward_hidden(tp, torch.tensor(ids)).numpy(),
        np.asarray(jm.forward_hidden(jp, jnp.asarray(ids))), **TOL)


def test_checkpoint_save_load_round_trip(pair, tmp_path):
    """save_hf_qwen3 writes HF names and layout; load_params reads them back
    to the same tree, the tied head again sharing the embedding."""
    _, _, tm, tp = pair
    save_hf_qwen3(tp, str(tmp_path))
    back = tm.load_params(open_weights(str(tmp_path)), dtype=torch.float32)
    assert back["lm_head"]["w"] is back["embed"]["w"]

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            assert torch.equal(a, b)

    same(back, tp)


def test_fused_params_bit_identical(pair):
    _, _, tm, tp = pair
    fused = fuse_decode_params(tp)
    assert "qkv" in fused["layers"] and "gateup" in fused["layers"]["mlp"]
    ids = torch.tensor([_ids(3, 12)])
    a = tm.backbone(tp, ids, tm.init_cache(1, 32, torch.float32))
    b = tm.backbone(fused, ids, tm.init_cache(1, 32, torch.float32))
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def engines(pair):
    jm, jp, tm, tp = pair
    return (JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                    max_seq_len=512, prefix_cache_entries=4),
            TextEngine(tm, tp, eos_token_ids=[], max_seq_len=512,
                       prefix_cache_entries=4))


@pytest.mark.parametrize("n", [20, 150])
def test_greedy_streams_identical(engines, n):
    """150 tokens prefill in the 256 bucket (> 128); 40 decode tokens run
    two whole blocks of 16 plus an overshooting tail block."""
    je, te = engines
    ids = _ids(10 + n, n)
    want = je.generate_tokens(ids, JSampling(), max_tokens=40)
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=40)
    assert got == want and len(got) == 40


def test_prefix_cache_hit_stream_identical(engines):
    je, te = engines
    base = _ids(30, 40)
    ext = base + _ids(31, 6)
    n0 = len(te._prefix_entries)
    for ids in (base, base, ext):      # store, exact repeat, extension
        want = je.generate_tokens(ids, JSampling(), max_tokens=20)
        assert te.generate_tokens(ids, SamplingConfig(), max_tokens=20) == want
    assert len(te._prefix_entries) == n0 + 2 == len(je._prefix_entries)


def test_bucket_end_single_step_tail(pair):
    """prompt 230 in a 256-row cache: one block, then 9 single steps."""
    jm, jp, tm, tp = pair
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                 max_seq_len=256)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256)
    ids = _ids(40, 230)
    want = je.generate_tokens(ids, JSampling(), max_tokens=64)
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=64)
    assert got == want and len(got) == 26


def test_eos_stops_stream_and_timing(pair):
    _, _, tm, tp = pair
    ids = _ids(50, 20)
    free = TextEngine(tm, tp, eos_token_ids=[]).generate_tokens(
        ids, SamplingConfig(), max_tokens=12)
    eos = free[5]
    eng = TextEngine(tm, tp, eos_token_ids=[eos])
    streamed = list(eng.stream_tokens(ids, SamplingConfig(), max_tokens=12))
    assert streamed == free[:free.index(eos) + 1]
    t = eng.last_timing
    assert t.prompt_tokens == 20 and t.completion_tokens == len(streamed)
    assert t.prompt_secs > 0 and t.completion_secs >= 0


def test_sampled_stream_seeded(pair):
    _, _, tm, tp = pair
    eng = TextEngine(tm, tp, eos_token_ids=[])
    cfg = SamplingConfig(temperature=0.8, top_k=20, top_p=0.9,
                         repeat_penalty=1.1, seed=7)
    a = eng.generate_tokens(_ids(60, 24), cfg, max_tokens=24)
    assert a == eng.generate_tokens(_ids(60, 24), cfg, max_tokens=24)
    assert len(a) == 24 and all(0 <= t < 400 for t in a) and len(set(a)) > 1


def test_unported_engine_options_raise(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError):
        TextEngine(tm, tp, eos_token_ids=[], spec_tokens=4)
    with pytest.raises(ValueError):
        TextEngine(tm, tp, eos_token_ids=[]).generate_tokens(
            [], SamplingConfig())
