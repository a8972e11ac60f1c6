"""aha_tpu_torch's int8 KV cache against aha_tpu's: quantize_kv_rows bit
for bit, the q8 decode plain version against the JAX dequantizing fallback
(1e-5) and against both Pallas q8 kernels in interpret mode (the
tolerances of tests/test_flash_attention.py: cast 2e-3 abs, all-int8
2e-2 abs, 2e-2 rel), the chunk prefill over int8 rows, the caches a
prefill and decode steps leave (compared through cache_from_jax), and
greedy streams of the int8 TextEngine, cold and through a prefix-cache
hit.  float32 compute on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu.ops import attention as jattn
from aha_tpu.ops import flash_attention as jfa
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import cache_from_jax, params_from_jax
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from aha_tpu_torch.ops import attention
from aha_tpu_torch.ops.flash_attention import (
    flash_decode_at_layer_q8, flash_decode_at_layer_q8_batched,
    flash_decode_at_layer_q8_plain)
from aha_tpu_torch.utils.device import get_cache_dtype

torch.set_num_threads(1)
# the tiny geometry of tests/test_batch_engine.py
GEO = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
RAGGED = [1, 5, 64, 100, 128, 200, 511, 512]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantize_kv_rows_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                    # the 1e-8 floor
    x[0, 1, 0] = np.linspace(-2.54, 2.54, 16)           # halves: to even
    x[1, 2, 1] *= 1e4
    jq, js = jattn.quantize_kv_rows(jnp.asarray(x))
    tq, ts = attention.quantize_kv_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.shape == (3, 5, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


@pytest.fixture(scope="module")
def q8_case():
    """int8 rows and scales made with numpy, in both layouts: JAX scales
    lane-oriented (L, B, Hkv, S), the port's (L, B, S, Hkv)."""
    rng = np.random.default_rng(5)
    L, B, S, Hq, Hkv, D = 2, 8, 512, 4, 2, 64
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.integers(-127, 128, (L, B, S, Hkv * D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, B, S, Hkv * D)).astype(np.int8)
    ks = (rng.random((L, B, Hkv, S)) * 0.01 + 0.002).astype(np.float32)
    vs = (rng.random((L, B, Hkv, S)) * 0.01 + 0.002).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, ks, vs))
    targs = (_t(q), _t(k), _t(v), _t(ks.transpose(0, 1, 3, 2)),
             _t(vs.transpose(0, 1, 3, 2)))
    return jargs, targs


@pytest.mark.parametrize("layer", [0, 1])
def test_q8_plain_matches_jax_fallback(q8_case, layer):
    """The port's q8 decode (plain on the CPU, both wrappers) against the
    JAX XLA dequant fallback, per-slot lengths: within 1e-5."""
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = q8_case
    pos = np.asarray(RAGGED, np.int32) - 1
    want = np.asarray(jattn.attention_decode_at_q8(
        jq, jk, jv, jks, jvs, jnp.int32(layer), jnp.asarray(pos)))
    tl = torch.tensor(layer, dtype=torch.int32)
    vl = torch.tensor(RAGGED, dtype=torch.int32)
    got = flash_decode_at_layer_q8_batched(tq, tk, tv, tks, tvs, tl, vl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # one slot through the per-slot wrapper, and the model's router
    one = flash_decode_at_layer_q8(tq[3:4], tk[:, 3:4], tv[:, 3:4],
                                   tks[:, 3:4], tvs[:, 3:4], tl, vl[3:4])
    np.testing.assert_allclose(one.numpy(), want[3:4], rtol=1e-5, atol=1e-5)
    routed = attention.attention_decode_at_q8(tq, tk, tv, tks, tvs, tl, vl)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("mxu", [False, True])
def test_q8_plain_matches_jax_kernels(q8_case, mxu):
    """The plain version (both variants' reference on the card) against the
    Pallas q8 kernels in interpret mode: batched over ragged lengths, and
    the per-slot kernel at one slot."""
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = q8_case
    atol = 2e-2 if mxu else 2e-3
    layer = jnp.int32(1)
    tl = torch.tensor(1, dtype=torch.int32)
    vl = torch.tensor(RAGGED, dtype=torch.int32)
    ref = flash_decode_at_layer_q8_plain(tq, tk, tv, tks, tvs, tl, vl).numpy()
    got = np.asarray(jfa.flash_decode_at_layer_q8_batched(
        jq, jk, jv, jks, jvs, layer, jnp.asarray(RAGGED, jnp.int32),
        block_k=256, interpret=True, mxu=mxu))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=2e-2)
    b = 5                                               # 200 live rows
    got1 = np.asarray(jfa.flash_decode_at_layer_q8(
        jq[b:b + 1], jk[:, b:b + 1], jv[:, b:b + 1], jks[:, b:b + 1],
        jvs[:, b:b + 1], layer, jnp.int32(RAGGED[b]), block_k=256,
        interpret=True, mxu=mxu))
    np.testing.assert_allclose(got1, ref[b:b + 1], atol=atol, rtol=2e-2)


def test_prefill_at_q8_matches_jax():
    """The chunk prefill over int8 rows (plain on every device) against
    attention_prefill_at_q8, the chunk at offset 37."""
    rng = np.random.default_rng(3)
    L, S, Hq, Hkv, D, Sq = 2, 128, 4, 2, 16, 8
    q = rng.standard_normal((1, Sq, Hq, D)).astype(np.float32)
    k = rng.integers(-127, 128, (L, 1, S, Hkv * D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, 1, S, Hkv * D)).astype(np.int8)
    ks = (rng.random((L, 1, Hkv, S)) * 0.02).astype(np.float32)
    vs = (rng.random((L, 1, Hkv, S)) * 0.02).astype(np.float32)
    want = np.asarray(jattn.attention_prefill_at_q8(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs)), jnp.int32(1),
        jnp.int32(37)))
    got = attention.attention_prefill_at_q8(
        _t(q), _t(k), _t(v), _t(ks.transpose(0, 1, 3, 2)),
        _t(vs.transpose(0, 1, 3, 2)), torch.tensor(1, dtype=torch.int32),
        torch.tensor(37, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**GEO))
    # scale 0.3: greedy streams that are not one repeated token
    jp = jm.init_random(jax.random.PRNGKey(0), scale=0.3)
    tm = Qwen3Model(Qwen3Config(**GEO))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _ids(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


def test_int8_cache_layout_matches_jax(pair):
    """A prefill then three decode steps into an int8 cache: the port's
    cache equals aha_tpu's carried across with cache_from_jax — int8 rows
    within one step (a rounding tie a float ulp apart), scales within
    1e-5 — and the decode hidden states agree."""
    jm, jp, tm, tp = pair
    ids = _ids(1, 20)
    jc = jm.init_cache(1, 64, jnp.int8)
    tc = tm.init_cache(1, 64, torch.int8)
    assert set(tc) == {"k", "v", "pos", "k_scale", "v_scale"}
    assert tc["k_scale"].shape == (2, 1, 64, 2)
    jstep = jax.jit(jm.backbone)
    jh, jc = jstep(jp, jnp.asarray([ids]), jc)
    tm.backbone(tp, torch.tensor([ids]), tc)
    jc = {**jc, "pos": jnp.int32(20)}
    tc["pos"].fill_(20)
    for tok in _ids(2, 3):
        jh, jc = jstep(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        tc["pos"].add_(1)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-4)
    got = cache_from_jax(jax.tree.map(np.asarray, jc))
    assert int(got["pos"]) == int(tc["pos"]) == 23
    for name in ("k", "v"):
        d = (tc[name][:, :, :23].int() - got[name][:, :, :23].int()).abs()
        assert int(d.max()) <= 1, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[name][:, :, :23].numpy(),
                                   got[name][:, :, :23].numpy(), rtol=1e-5)


def test_int8_text_engine_streams_match_jax(pair):
    """Greedy streams of the int8 TextEngine equal aha_tpu's: a 10-token
    prompt across one 16-step decode block, and a prefix-cache hit that
    restores the int8 rows with their scales."""
    jm, jp, tm, tp = pair
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.int8,
                 max_seq_len=512, runahead=4, prefix_cache_entries=4)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=512,
                    prefix_cache_entries=4, cache_dtype=torch.int8)
    base = _ids(7, 40)
    for ids, n in ((_ids(3, 10), 20), (base, 10), (base + _ids(8, 6), 10)):
        want = je.generate_tokens(ids, JSampling(), max_tokens=n)
        got = te.generate_tokens(ids, SamplingConfig(), max_tokens=n)
        assert got == want, (len(ids), got, want)
    assert len(te._prefix_entries) == len(je._prefix_entries) == 2
    entry = next(iter(te._prefix_entries._entries.values()))
    assert set(entry) == {"k", "v", "k_scale", "v_scale"}
    assert entry["k"].dtype == torch.int8


def test_cache_dtype_from_env(monkeypatch):
    monkeypatch.setenv("AHA_KV_INT8", "1")
    assert get_cache_dtype(torch.device("cpu")) == torch.int8
    monkeypatch.delenv("AHA_KV_INT8")
    monkeypatch.setenv("AHA_DTYPE", "float32")
    assert get_cache_dtype(torch.device("cpu")) == torch.float32
