"""aha_tpu_torch's VoxCPM (models/voxcpm.py) against aha_tpu's on the CPU,
float32, on tests/test_voxcpm.py's tiny config and a VoxCPM2 variant of it
(kv_channels on the local blocks, the concatenated mu and the fusion
projection): the LongRoPE table (and the port's longrope_table beneath
it), VoxMiniCPM with and without its cache (the one-row steps through row
8's plain version, which the card replaces by its float32 kernel), the
LocEnc, the LocDiT at a given t, the Euler solver with CFG-zero-star given
z, the prefill and 3 decode steps given JAX's noise (latents and stop
flags), `inference` over a voice prompt, and SingleChineseTokenizer.
Parameters cross with io/convert.params_from_jax."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models import voxcpm as jv
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import llama as tllama
from aha_tpu_torch.models import voxcpm as tv
from tests.test_voxcpm import TINY_CFG

torch.set_num_threads(1)
#: one module's agreement, max abs error relative to max |ref| (float32 on
#: both sides; sums in other orders)
TOL_MODULE = 1e-5
#: the whole patch loop's (prefill, CFM, feedback steps)
TOL_E2E = 1e-4

V2_CFG = {**TINY_CFG, "architecture": "voxcpm2",
          "encoder_config": {**TINY_CFG["encoder_config"], "kv_channels": 16},
          "dit_config": {**TINY_CFG["dit_config"], "kv_channels": 16}}


def _rel(got, ref) -> float:
    """Max abs error relative to max |ref| (absolute where ref is 0)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    top = float(np.abs(ref).max())
    return err / top if top > 0 else err


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module", params=["v1", "v2"])
def pair(request):
    d = TINY_CFG if request.param == "v1" else V2_CFG
    jcfg = jv.VoxCPMConfig.from_dict(d)
    tcfg = tv.VoxCPMConfig.from_dict(d)
    jm = jv.VoxCPMModel(jcfg, latent_dim=8)
    jp = jm.init_random(jax.random.PRNGKey(6))
    # a nonzero bias everywhere, so a dropped bias shows
    jp = jax.tree.map(lambda x: x + 0.01 if x.ndim == 1 else x, jp)
    tm = tv.VoxCPMModel(tcfg, latent_dim=8)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def test_configs_parse_alike():
    for d in (TINY_CFG, V2_CFG):
        j, t = jv.VoxCPMConfig.from_dict(d), tv.VoxCPMConfig.from_dict(d)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.is_v2 == t.is_v2


@pytest.mark.parametrize("rs,hd,n", [
    (None, 64, 100),
    ({"short_factor": [1.0, 1.5, 2.0, 3.0], "long_factor": [2.0] * 4,
      "original_max_position_embeddings": 64}, 8, 200),
    ({"short_factor": [1.0, 1.5, 2.0, 3.0], "long_factor": [2.0] * 4,
      "original_max_position_embeddings": 512}, 8, 100),
    ({"short_factor": [1.0] * 4, "original_max_position_embeddings": 64},
     16, 128),                 # a local block: factors of another width
])
def test_longrope_table_matches(rs, hd, n):
    cfg = jv.VoxLMConfig(hidden_size=hd * 4, num_attention_heads=4,
                         rope_scaling=rs, max_position_embeddings=4096)
    jc, js = jv.vox_longrope_table(cfg, n)
    tc, ts = tv.vox_longrope_table(tv.VoxLMConfig(**dataclasses.asdict(cfg)),
                                   n)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_longrope_table_is_the_ports_longrope_table():
    """With both factor lists at head_dim / 2, the VoxCPM table is the
    llama family's longrope_table, number for number."""
    rs = {"short_factor": [1.0, 1.5, 2.0, 3.0], "long_factor": [2.0] * 4,
          "original_max_position_embeddings": 64}
    cfg = tv.VoxLMConfig(hidden_size=32, num_attention_heads=4,
                         rope_scaling=rs, max_position_embeddings=4096)
    lcfg = tllama.LlamaConfig(hidden_size=32, num_attention_heads=4,
                              num_key_value_heads=2, rope_scaling=rs,
                              max_position_embeddings=4096, head_dim=8)
    for n in (50, 100):
        a, b = tv.vox_longrope_table(cfg, n), tllama.longrope_table(lcfg, n)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_minicpm_no_cache_causal_and_bidirectional(pair):
    jm, jp, tm, tp = pair
    x = np.random.default_rng(0).standard_normal((2, 7, 32)).astype(
        np.float32)
    for causal in (True, False):
        ref = jm.base_lm.forward(jp["base_lm"], jnp.asarray(x), causal=causal)
        got = tm.base_lm.forward(tp["base_lm"], _t(x), causal=causal)
        assert _rel(got, ref) <= TOL_MODULE


@pytest.mark.parametrize("which", ["base_lm", "residual_lm"])
def test_minicpm_with_cache_matches(pair, which):
    """A 4-row prefill then two one-row steps into a 16-row 5-D cache: the
    hidden states and the cache rows against the JAX model's."""
    jm, jp, tm, tp = pair
    jl, tl = getattr(jm, which), getattr(tm, which)
    x = np.random.default_rng(1).standard_normal((1, 6, 32)).astype(
        np.float32)
    jc, tc = jl.init_cache(1, 16), tl.init_cache(1, 16)
    for lo, hi in ((0, 4), (4, 5), (5, 6)):
        jh, jc = jl.forward_with_cache(jp[which], jnp.asarray(x[:, lo:hi]),
                                       jc)
        th, tc = tl.forward_with_cache(tp[which], _t(x[:, lo:hi]), tc)
        assert _rel(th, jh) <= TOL_MODULE
        assert int(tc["pos"]) == int(jc["pos"]) == hi
    assert tc["k"].shape == (tl.cfg.num_hidden_layers, 1, 16, 2, 8)
    assert _rel(tc["k"], jc["k"]) <= TOL_MODULE
    assert _rel(tc["v"], jc["v"]) <= TOL_MODULE


def test_one_row_steps_reach_row_8(pair, monkeypatch):
    """A prompt of several rows attends plainly; every one-row step goes
    through attention_decode_at, layer by layer, over rows [0, pos] of the
    5-D cache (the base LM's 2 layers here)."""
    from aha_tpu_torch.models import voxcpm as mod

    jm, jp, tm, tp = pair
    calls = []
    real = mod.attention_decode_at

    def spy(q, k, v, layer, valid):
        calls.append((int(layer), int(valid[0]), tuple(k.shape)))
        return real(q, k, v, layer, valid)

    monkeypatch.setattr(mod, "attention_decode_at", spy)
    c = tm.base_lm.init_cache(1, 10)
    x = torch.randn(1, 3, 32, generator=torch.Generator().manual_seed(0))
    _, c = tm.base_lm.forward_with_cache(tp["base_lm"], x, c)
    assert calls == []
    _, c = tm.base_lm.forward_with_cache(tp["base_lm"], x[:, :1], c)
    assert calls == [(0, 4, (2, 1, 10, 2, 8)), (1, 4, (2, 1, 10, 2, 8))]


def test_locenc_matches(pair):
    jm, jp, tm, tp = pair
    x = np.random.default_rng(2).standard_normal((1, 5, 2, 8)).astype(
        np.float32)
    ref = jm.feat_encoder.forward(jp["feat_encoder"], jnp.asarray(x))
    got = tm.feat_encoder.forward(tp["feat_encoder"], _t(x))
    assert got.shape == (1, 5, 24)
    assert _rel(got, ref) <= TOL_MODULE


@pytest.mark.parametrize("t", [1.0, 0.37])
def test_locdit_matches_at_t(pair, t):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(3)
    B = 2
    mu_w = 48 if jm.config.is_v2 else 24
    x, cond = (rng.standard_normal((B, 8, 2)).astype(np.float32)
               for _ in range(2))
    mu = rng.standard_normal((B, mu_w)).astype(np.float32)
    tt = np.full(B, t, np.float32)
    dt = np.zeros(B, np.float32)
    ref = jm.feat_dit.forward(jp["feat_dit"], *map(jnp.asarray,
                                                   (x, mu, tt, cond, dt)))
    got = tm.feat_dit.forward(tp["feat_dit"], *map(_t, (x, mu, tt, cond, dt)))
    assert got.shape == (B, 8, 2)
    assert _rel(got, ref) <= TOL_MODULE


def test_sway_schedule_and_time_embedding():
    np.testing.assert_allclose(tv.cfm_sway_t_span(10).numpy(),
                               np.asarray(jv.cfm_sway_t_span(10)),
                               rtol=0, atol=1e-6)
    t = np.asarray([0.0, 0.5, 1.0], np.float32)
    np.testing.assert_allclose(
        tv.sinusoidal_time_emb(_t(t), 24).numpy(),
        np.asarray(jv.sinusoidal_time_emb(jnp.asarray(t), 24)),
        rtol=0, atol=1e-4)


def test_scalar_quantize_matches(pair):
    jm, jp, tm, tp = pair
    x = np.random.default_rng(4).standard_normal((3, 32)).astype(np.float32)
    ref = jv.scalar_quantize(jp["fsq_layer"], jnp.asarray(x), 9)
    got = tv.scalar_quantize(tp["fsq_layer"], _t(x), 9)
    assert _rel(got, ref) <= TOL_MODULE


@pytest.mark.parametrize("zero_star", [True, False])
def test_euler_solver_with_cfg_zero_star(pair, zero_star):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(5)
    mu_w = 48 if jm.config.is_v2 else 24
    z, cond = (rng.standard_normal((1, 8, 2)).astype(np.float32)
               for _ in range(2))
    mu = rng.standard_normal((1, mu_w)).astype(np.float32)
    ref = jv.cfm_solve_euler(jm.feat_dit, jp["feat_dit"], jnp.asarray(z),
                             jv.cfm_sway_t_span(10), jnp.asarray(mu),
                             jnp.asarray(cond), 2.0, zero_star)
    got = tv.cfm_solve_euler(tm.feat_dit, tp["feat_dit"], _t(z),
                             tv.cfm_sway_t_span(10), _t(mu), _t(cond), 2.0,
                             zero_star)
    assert _rel(got, ref) <= TOL_MODULE


def _jax_noise(jm, seed: int, n: int) -> list[np.ndarray]:
    """The z the JAX loop draws for patch i: normal(keys[i], (1, D, P))."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    shape = (1, jm.latent_dim, jm.config.patch_size)
    return [np.asarray(jax.random.normal(keys[i], shape, jnp.float32))
            for i in range(n)]


def _ctx(model, prompt):
    return model.build_context([5, 9, 11, 40], prompt)


def test_prefill_and_three_decode_steps(pair):
    """The prefill, then 3 decode steps each given JAX's z: every patch's
    latents, stop flag and both LMs' next hidden states."""
    jm, jp, tm, tp = pair
    tt, tmk, af, am = _ctx(jm, None)
    T, n = len(tt), 3
    jb, jr = jm.base_lm.init_cache(1, T + n + 8), \
        jm.residual_lm.init_cache(1, T + n + 8)
    tb, tr = tm.base_lm.init_cache(1, T + n + 8), \
        tm.residual_lm.init_cache(1, T + n + 8)
    jout = jm._prefill(jp, jnp.asarray(tt)[None], jnp.asarray(tmk)[None],
                       jnp.asarray(af)[None], jnp.asarray(am)[None], jb, jr)
    tout = tm.prefill(tp, torch.from_numpy(tt)[None], _t(tmk)[None],
                      _t(af)[None], _t(am)[None], tb, tr)
    for a, b in zip(tout[:3], jout[:3]):
        assert _rel(a, b) <= TOL_MODULE
    jl, jres, jprev, jb, jr = jout
    tl, tres, tprev, tb, tr = tout
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    for i in range(n):
        z = jax.random.normal(keys[i], (1, 8, 2), jnp.float32)
        jpred, jstop, jl, jres, jb, jr = jm._decode_step(
            jp, jl, jres, jprev, jb, jr, keys[i], 10, 2.0)
        tpred, tstop, tl, tres, tb, tr = tm.decode_step(
            tp, tl, tres, tprev, tb, tr, _t(z), 10, 2.0)
        assert _rel(tpred, jpred) <= TOL_E2E
        assert int(tstop) == int(jstop)
        assert _rel(tl, jl) <= TOL_E2E and _rel(tres, jres) <= TOL_E2E
        jprev, tprev = jpred, tpred
    assert int(tb["pos"]) == T + n


@pytest.mark.parametrize("prompt", [False, True])
def test_inference_matches_given_jax_noise(pair, prompt):
    """`inference` over 3 patches (min_len 1), with and without a voice
    prompt's latents, given the noise the JAX loop draws from its seed."""
    jm, jp, tm, tp = pair
    feat = (np.random.default_rng(8).standard_normal((3, 2, 8)).astype(
        np.float32) if prompt else None)
    tt, tmk, af, am = _ctx(jm, feat)
    ref = jm.inference(jp, tt, tmk, af, am, min_len=1, max_len=3,
                       n_timesteps=4, cfg_value=2.0, seed=3)
    got = tm.inference(tp, tt, tmk, af, am, min_len=1, max_len=3,
                       n_timesteps=4, cfg_value=2.0,
                       noise=_jax_noise(jm, 3, 3))
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL_E2E


def test_inference_draws_its_own_seeded_noise(pair):
    """Without `noise` the loop draws from a CPU generator seeded by
    `seed`: the same seed the same latents, another seed others."""
    _, _, tm, tp = pair
    ctx = _ctx(tm, None)
    a = tm.inference(tp, *ctx, 1, 2, 3, 2.0, seed=1)
    b = tm.inference(tp, *ctx, 1, 2, 3, 2.0, seed=1)
    c = tm.inference(tp, *ctx, 1, 2, 3, 2.0, seed=2)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def test_build_context_with_a_voice_prompt(pair):
    jm, _, tm, _ = pair
    feat = np.random.default_rng(9).standard_normal((3, 2, 8)).astype(
        np.float32)
    for f in (None, feat):
        for a, b in zip(tm.build_context([5, 9], f),
                        jm.build_context([5, 9], f)):
            np.testing.assert_array_equal(a, b)


def _tokenizer_dir(path: str) -> str:
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {chr(c): i for i, c in enumerate(range(32, 127))}
    for t in ("你好", "你", "好", "世界", "世", "[UNK]"):
        vocab[t] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    tok.save(os.path.join(path, "tokenizer.json"))
    return path


@pytest.mark.parametrize("text", ["hi there", "你好", "ab你好c", "世界!"])
def test_single_chinese_tokenizer_matches(tmp_path, text):
    path = _tokenizer_dir(str(tmp_path))
    j, t = jv.SingleChineseTokenizer(path), tv.SingleChineseTokenizer(path)
    assert t.multichar == j.multichar == {"你好", "世界"}
    assert t.encode(text) == j.encode(text)
