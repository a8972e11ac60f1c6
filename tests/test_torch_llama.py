"""aha_tpu_torch's LlamaModel against aha_tpu's on the same parameters (made
in JAX from a seed, biases and norm weights randomized, carried across with
params_from_jax), in its qwen2 form (q/k/v bias), its minicpm form (mup
scalings + LongRoPE) and with qk-norm: prefill logits, decode steps over
the 5-D cache, incremental decode equal to the full forward, the encoder
pass; the stacked-cache decode plain versions against the Pallas kernels
in interpret mode; and greedy streams through both TextEngines.  float32
on the CPU: tolerance rtol 1e-4, atol 1e-5 (the two frameworks sum in
other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models.llama import LlamaConfig as JConfig
from aha_tpu.models.llama import LlamaModel as JModel
from aha_tpu.ops.flash_attention import flash_decode as jflash_decode
from aha_tpu.ops.flash_attention import \
    flash_decode_at_layer as jdecode_at_layer
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aha_tpu_torch.ops import attention
from aha_tpu_torch.ops.flash_attention import (flash_decode,
                                               flash_decode_at_layer,
                                               flash_decode_plain)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
BASE = dict(vocab_size=120, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rope_theta=1e6)
FORMS = {
    "qwen2": dict(qkv_bias=True, tie_word_embeddings=True),
    "minicpm": dict(max_position_embeddings=64, scale_emb=12.0,
                    scale_depth=1.4, dim_model_base=16,
                    rope_scaling={"short_factor": [1.0] * 6,
                                  "long_factor": [2.0] * 6,
                                  "original_max_position_embeddings": 32}),
    "qk_norm": dict(qk_norm=True, o_bias=True, mlp_bias=True),
}


def _perturb(tree, rng):
    """Random biases and norm weights: the JAX init leaves them 0 and 1,
    where a dropped bias or norm would go unnoticed."""
    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name == "b":
            return rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return a
    out = walk(tree)
    for norm in ("ln1", "ln2", "q_norm", "k_norm"):
        if norm in out["layers"]:
            w = out["layers"][norm]["w"]
            out["layers"][norm]["w"] = (1 + 0.2 * rng.standard_normal(
                w.shape)).astype(np.float32)
    return out


def _pair(form: str, seed: int = 0):
    kw = {**BASE, **FORMS[form]}
    # the rope tables cover every position the tests reach (minicpm's
    # max_position_embeddings 64 bounds its own, past LongRoPE's original
    # 32: the long factors)
    jm = JModel(JConfig(**kw), max_rope_len=256)
    jp = _perturb(jax.tree.map(np.asarray, jm.init_random(
        jax.random.PRNGKey(seed), scale=0.3)), np.random.default_rng(seed))
    # load_params and the layers take a bias wherever the tree holds one;
    # the config's o_bias / mlp_bias flags shape init_random's tree
    tm = LlamaModel(LlamaConfig.from_dict(kw), max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


def _ids(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 119, n)]


@pytest.mark.parametrize("form", list(FORMS))
def test_prefill_and_decode_steps_match_jax(form):
    jm, jp, tm, tp = _pair(form)
    ids = _ids(1, 12)
    jc = jm.init_cache(1, 32, jnp.float32)
    tc = tm.init_cache(1, 32, torch.float32)
    assert tc["k"].shape == (2, 1, 32, 2, 12)       # the 5-D layout
    jh, jc = jm.backbone(jp, jnp.asarray([ids]), jc)
    th = tm.backbone(tp, torch.tensor([ids]), tc)
    np.testing.assert_allclose(tm.logits(tp, th).numpy(),
                               np.asarray(jm.logits(jp, jh)), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    jc = {**jc, "pos": jnp.int32(12)}
    tc["pos"].fill_(12)
    for step, tok in enumerate(_ids(2, 6)):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        kv.advance(tc, 1)
        np.testing.assert_allclose(tm.logits(tp, th).numpy(),
                                   np.asarray(jm.logits(jp, jh)), **TOL,
                                   err_msg=f"{form} decode step {step}")


@pytest.mark.parametrize("form", list(FORMS))
def test_incremental_decode_equals_full_forward(form):
    _, _, tm, tp = _pair(form, seed=3)
    ids = _ids(4, 10)
    full = tm.logits(tp, tm.backbone(tp, torch.tensor([ids]),
                                     tm.init_cache(1, 16, torch.float32)))[0]
    cache = tm.init_cache(1, 16, torch.float32)
    outs = [tm.logits(tp, tm.backbone(tp, torch.tensor([ids[:4]]),
                                      cache))[0, -1]]
    kv.advance(cache, 4)
    for tok in ids[4:-1]:
        outs.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[tok]]),
                                              cache))[0, 0])
        kv.advance(cache, 1)
    np.testing.assert_allclose(torch.stack(outs).numpy(), full[3:-1].numpy(),
                               **TOL)


def test_suffix_prefill_from_cache_matches_jax():
    """A chunk prefilled at a cache offset (the prefix-cache suffix)."""
    jm, jp, tm, tp = _pair("qwen2", seed=5)
    ids = _ids(6, 20)
    jc = jm.init_cache(1, 64, jnp.float32)
    tc = tm.init_cache(1, 64, torch.float32)
    _, jc = jm.backbone(jp, jnp.asarray([ids[:12]]), jc)
    tm.backbone(tp, torch.tensor([ids[:12]]), tc)
    jc = {**jc, "pos": jnp.int32(12)}
    tc["pos"].fill_(12)
    jh, _ = jm.backbone(jp, jnp.asarray([ids[12:]]), jc, from_cache=True)
    th = tm.backbone(tp, torch.tensor([ids[12:]]), tc, from_cache=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("form", ["qwen2", "qk_norm"])
def test_run_layers_no_cache_matches_jax(form):
    jm, jp, tm, tp = _pair(form, seed=7)
    x = np.random.default_rng(8).standard_normal((1, 9, 48)).astype(
        np.float32)
    np.testing.assert_allclose(
        tm.run_layers_no_cache(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jm.run_layers_no_cache(jp, jnp.asarray(x))), **TOL)


def test_fused_params_and_tied_head():
    _, _, tm, tp = _pair("qwen2", seed=9)
    assert tp["lm_head"]["w"] is tp["embed"]["w"]     # a view, not a copy
    fused = tm.fuse_params(tp)
    assert "qkv" in fused["layers"] and "b" in fused["layers"]["qkv"]
    ids = torch.tensor([_ids(10, 7)])
    a = tm.backbone(tp, ids, tm.init_cache(1, 8, torch.float32))
    b = tm.backbone(fused, ids, tm.init_cache(1, 8, torch.float32))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# -- the stacked-cache decode kernels' plain versions ------------------------


@pytest.fixture(scope="module")
def stacked_case():
    rng = np.random.default_rng(11)
    L, B, S, Hq, Hkv, D = 3, 2, 256, 8, 2, 64
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, 1, Hq, D), (L, B, S, Hkv, D),
                           (L, B, S, Hkv, D)))


@pytest.mark.parametrize("B,lens,layer", [(1, (1,), 0), (1, (200,), 2),
                                          (2, (77, 256), 1), (2, (1, 130), 2)])
def test_flash_decode_at_layer_plain_matches_pallas(stacked_case, B, lens,
                                                    layer):
    q, k, v = (a[:, :B] if a.ndim == 5 else a[:B] for a in stacked_case)
    vl = np.asarray(lens, np.int32)
    got = flash_decode_at_layer(
        torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(k)),
        torch.from_numpy(np.ascontiguousarray(v)),
        torch.tensor(layer, dtype=torch.int32), torch.from_numpy(vl))
    want = jdecode_at_layer(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(layer), jnp.asarray(vl), block_k=128,
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the model-level route: five dimensions go to this wrapper at any B
    via = attention.attention_decode_at(
        torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(k)),
        torch.from_numpy(np.ascontiguousarray(v)),
        torch.tensor(layer, dtype=torch.int32), torch.from_numpy(vl))
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("B,lens", [(1, (90,)), (2, (256, 5))])
def test_flash_decode_plain_matches_pallas(stacked_case, B, lens):
    q, k, v = stacked_case[0][:B], stacked_case[1][1, :B], \
        stacked_case[2][1, :B]
    k, v = np.ascontiguousarray(k), np.ascontiguousarray(v)
    vl = np.asarray(lens, np.int32)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(vl))
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(vl), block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(vl)).numpy(),
        got.numpy())
    # attention_decode takes the write index pos (rows 0..pos live)
    via = attention.attention_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(vl - 1))
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_decode_wrappers_reject_bad_caches():
    q = torch.zeros((1, 1, 4, 16))
    bad = torch.zeros((2, 1, 32, 2, 16)).transpose(2, 3)  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode_at_layer(q, bad, bad, torch.tensor(0, dtype=torch.int32),
                              torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(B, S, Hkv, D\)"):
        flash_decode(q, torch.zeros((2, 1, 32, 2, 16)),
                     torch.zeros((2, 1, 32, 2, 16)),
                     torch.tensor([4], dtype=torch.int32))


# -- engines -------------------------------------------------------------------


@pytest.mark.parametrize("form,n", [("qwen2", 20), ("qwen2", 150),
                                    ("minicpm", 20)])
def test_greedy_streams_identical(form, n):
    """Through both TextEngines: LlamaModel has no greedy_token, so both
    take logits + fast_argmax; 150 tokens cross the 128-row prefill
    bucket."""
    jm, jp, tm, tp = _pair(form, seed=12)
    max_len = 64 if form == "minicpm" else 256
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                 max_seq_len=max_len)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=max_len)
    ids = _ids(13, min(n, max_len - 24))
    g = SamplingConfig()
    want = je.generate_tokens(ids, JSampling(), max_tokens=20)
    assert te.generate_tokens(ids, g, max_tokens=20) == want
    assert len(set(want)) > 1


def test_prefix_cache_stream_identical():
    jm, jp, tm, tp = _pair("qwen2", seed=14)
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                 max_seq_len=256, prefix_cache_entries=4)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256,
                    prefix_cache_entries=4)
    base = _ids(15, 40)
    ext = base + _ids(16, 9)
    for ids in (base, ext):
        assert te.generate_tokens(ids, SamplingConfig(), max_tokens=12) == \
            je.generate_tokens(ids, JSampling(), max_tokens=12)
    assert len(te._prefix_entries) == 2


def test_int8_and_per_slot_caches_refused():
    _, _, tm, tp = _pair("qwen2")
    with pytest.raises(ValueError, match="int8"):
        tm.init_cache(1, 16, torch.int8)
    cache = kv.init_kv_cache(2, 2, 16, 2, 12, torch.float32, flat=False,
                             per_slot_pos=True)
    # per-slot positions decode one token a slot (continuous batching);
    # a per-slot prefill is refused, as in the Qwen3 model
    with pytest.raises(ValueError, match="per-slot"):
        tm.backbone(tp, torch.tensor([[1, 2], [3, 4]]), cache)


def test_config_from_dict_ignores_unknown_keys():
    cfg = LlamaConfig.from_dict({**BASE, "architectures": ["X"]})
    assert dataclasses.asdict(cfg)["vocab_size"] == 120
    assert cfg.head_dim_ == 12


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")}
    return {(prefix, tuple(np.shape(tree)))}


@pytest.mark.parametrize("flags", [dict(), dict(o_bias=True),
                                   dict(mlp_bias=True),
                                   dict(qkv_bias=True, o_bias=True,
                                        mlp_bias=True)], ids=str)
def test_init_random_bias_flags_match_jax(flags):
    """o_bias and mlp_bias (ERNIE-4.5's use_bias) give init_random the same
    tree as aha_tpu's, leaf for leaf and shape for shape, and zero biases
    leave the forward as the bias-free one."""
    kw = {**BASE, **flags}
    jtree = params_from_jax(jax.tree.map(np.asarray, JModel(
        JConfig(**kw), max_rope_len=64).init_random(jax.random.PRNGKey(0))))
    tm = LlamaModel(LlamaConfig(**kw), max_rope_len=64)
    tree = tm.init_random(torch.Generator().manual_seed(0))
    assert _paths(tree) == _paths(jtree)
    assert ("b" in tree["layers"]["o"]) == flags.get("o_bias", False)
    assert ("b" in tree["layers"]["mlp"]["down"]) == \
        flags.get("mlp_bias", False)
    plain = LlamaModel(LlamaConfig(**BASE), max_rope_len=64)
    bare = {**tree, "layers": {k: ({n: {"w": p["w"]} for n, p in v.items()}
                                   if k == "mlp" else
                                   {"w": v["w"]} if k in "qkvo" else v)
                               for k, v in tree["layers"].items()}}
    ids = torch.tensor([_ids(4, 9)])
    np.testing.assert_array_equal(
        tm.backbone(tree, ids, tm.init_cache(1, 16, torch.float32)).numpy(),
        plain.backbone(bare, ids, plain.init_cache(1, 16,
                                                   torch.float32)).numpy())
