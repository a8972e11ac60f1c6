"""LFM2 (models/lfm2.py) against aha_tpu/models/lfm2.py on the CPU in
float32, at the JAX tests' LFM2_TINY geometry (hidden 48, 4 layers: conv,
attention, conv, attention; 4/2 heads; conv window 3): the backbone's
hidden states and caches through padded and unpadded prefills (one
prompt shorter than the conv window), a chunk over cached rows and
state, decode steps at one and at three slots; greedy streams of both
engines (tests/hybrid_streams.py); HF-named safetensors; the config
parser and LFM2-1.2B's geometry.  Tolerances: hidden states and cache
rows within TOL (1e-4) of max |ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models.lfm2 import Lfm2Config as JConfig
from aha_tpu.models.lfm2 import Lfm2Model as JModel
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.lfm2 import Lfm2Config, Lfm2Model, lfm2_1_2b
from tests.hybrid_streams import (batch_engine_streams, engines,  # noqa: F401
                                  ids, readmitted_slot, text_engine_streams)

torch.set_num_threads(1)
#: hidden states and cache rows, relative to max |ref|
TOL = 1e-4
TINY = dict(vocab_size=120, hidden_size=48, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, block_ff_dim=96,
            block_auto_adjust_ff_dim=False,
            layer_types=("conv", "full_attention", "conv", "full_attention"))


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**TINY), max_rope_len=256)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(4),
                                                 scale=0.3))
    tm = Lfm2Model(Lfm2Config(**TINY), max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


def _compare_caches(jc, tc, n):
    """k/v rows [0, n) and the conv windows within TOL of max |ref|."""
    for name in ("k", "v"):
        assert _rel(tc[name][:, :, :n].numpy(),
                    np.asarray(jc[name])[:, :, :n]) <= TOL, name
    assert _rel(tc["conv"].numpy(), jc["conv"]) <= TOL


@pytest.mark.parametrize("n,bucket", [(37, 64), (2, 32), (32, 32)])
def test_prefill_and_decode_match_jax(pair, n, bucket):
    """A prompt of n tokens right-padded to `bucket` with its true length
    (2 tokens: shorter than the conv window; 32: unpadded), then three
    decode steps: hidden states of the real rows, K/V rows and the conv
    windows equal to aha_tpu's."""
    jm, jp, tm, tp = pair
    padded = ids(n, n) + [0] * (bucket - n)
    jc = jm.init_cache(1, 128, jnp.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([padded]), jc,
                         prompt_len=jnp.int32(n))
    tc = tm.init_cache(1, 128, torch.float32)
    th = tm.backbone(tp, torch.tensor([padded]), tc, prompt_len=n)
    assert _rel(th[0, :n].numpy(), np.asarray(jh)[0, :n]) <= TOL
    _compare_caches(jc, tc, n)
    assert int(tc["pos"]) == 0                  # the backbone leaves pos
    jc = {**jc, "pos": jnp.int32(n)}
    tc["pos"].fill_(n)
    for step, tok in enumerate((5, 9, 77)):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        tc["pos"].add_(1)
        assert _rel(tm.logits(tp, th).numpy(),
                    np.asarray(jm.logits(jp, jh))) <= TOL, step
    _compare_caches(jc, tc, n + 3)


def test_chunk_over_cached_rows_and_state_matches_jax(pair):
    """20 tokens prefilled, then a from_cache chunk of 17 padded to 32 that
    continues the K/V rows and the conv windows: as aha_tpu's; and the
    two chunks leave the same state as one 37-token prefill."""
    jm, jp, tm, tp = pair
    prompt = ids(11, 37)
    jc = jm.init_cache(1, 128, jnp.float32)
    _, jc = jm.backbone(jp, jnp.asarray([prompt[:20] + [0] * 12]), jc,
                        prompt_len=jnp.int32(20))
    jc = {**jc, "pos": jnp.int32(20)}
    jh, jc = jm.backbone(jp, jnp.asarray([prompt[20:] + [0] * 15]), jc,
                         prompt_len=jnp.int32(17), from_cache=True)
    tc = tm.init_cache(1, 128, torch.float32)
    tm.backbone(tp, torch.tensor([prompt[:20] + [0] * 12]), tc,
                prompt_len=20)
    tc["pos"].fill_(20)
    th = tm.backbone(tp, torch.tensor([prompt[20:] + [0] * 15]), tc,
                     prompt_len=17, from_cache=True)
    assert _rel(th[0, :17].numpy(), np.asarray(jh)[0, :17]) <= TOL
    _compare_caches(jc, tc, 37)
    whole = tm.init_cache(1, 128, torch.float32)
    wh = tm.backbone(tp, torch.tensor([prompt + [0] * 27]), whole,
                     prompt_len=37)
    assert _rel(th[0, :17].numpy(), wh[0, 20:37].numpy()) <= TOL
    assert _rel(tc["conv"].numpy(), whole["conv"].numpy()) <= TOL


def test_per_slot_decode_step_matches_jax(pair):
    """Three slots prefilled at batch 1 to ragged lengths (conv windows
    copied into their slots), then one (B,) pos step: logits, each slot's
    new K/V row and conv window against aha_tpu's backbone with a (B,)
    pos; each slot equal to a one-slot step (the port against itself)."""
    jm, jp, tm, tp = pair
    lens, S = [5, 17, 40], 64
    big = tm.init_cache(3, S, torch.float32, per_slot_pos=True)
    assert big["conv"].shape == (2, 3, 3, 48) and big["pos"].shape == (3,)
    want = []
    for b, n in enumerate(lens):
        small = tm.init_cache(1, S, torch.float32)
        tm.backbone(tp, torch.tensor([ids(b, n)]), small)
        for name in ("k", "v", "conv"):
            big[name][:, b] = small[name][:, 0]
        small["pos"].fill_(n)
        want.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[b + 3]]),
                                              small))[0, 0])
    big["pos"] = torch.tensor(lens, dtype=torch.int32)
    # copies: the port's step writes `big` in place
    jc = {name: jnp.asarray(big[name].numpy().copy())
          for name in ("k", "v", "conv")}
    jc["pos"] = jnp.asarray(lens, jnp.int32)
    toks = [[3], [4], [5]]
    th = tm.backbone(tp, torch.tensor(toks), big)
    jh, jc = jm.backbone(jp, jnp.asarray(toks), jc)
    got = tm.logits(tp, th)[:, 0]
    assert _rel(got.numpy(), np.asarray(jm.logits(jp, jh))[:, 0]) <= TOL
    assert _rel(got.numpy(), torch.stack(want).numpy()) <= TOL
    _compare_caches(jc, big, S)
    assert big["pos"].tolist() == lens


def test_decode_from_a_jax_cache_matches_jax(pair):
    """aha_tpu's cache after a padded prefill, carried across by
    cache_from_jax (5-D K/V kept, rolling state unchanged): four decode
    steps from it give aha_tpu's logits and state."""
    from aha_tpu_torch.io.convert import cache_from_jax

    jm, jp, tm, tp = pair
    jc = jm.init_cache(1, 64, jnp.float32)
    _, jc = jm.backbone(jp, jnp.asarray([ids(15, 21) + [0] * 11]), jc,
                        prompt_len=jnp.int32(21))
    jc = {**jc, "pos": jnp.int32(21)}
    tc = cache_from_jax(jax.tree.map(np.asarray, jc))
    for name in ("k", "v", "conv"):
        assert tc[name].shape == jc[name].shape, name
    for tok in (3, 30, 60, 90):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        tc["pos"].add_(1)
        assert _rel(tm.logits(tp, th).numpy(),
                    np.asarray(jm.logits(jp, jh))) <= TOL
    _compare_caches(jc, tc, 25)


# -- the engines --------------------------------------------------------------


def test_text_engine_streams_match_jax(pair, engines):  # noqa: F811
    text_engine_streams(*pair, engines)


def test_batch_engine_streams_match_jax(pair, engines):  # noqa: F811
    batch_engine_streams(*pair, engines)


def test_readmitted_slot_streams_as_in_a_fresh_engine(pair,
                                                      engines):  # noqa: F811
    readmitted_slot(pair[2], pair[3], engines)


# -- loading ------------------------------------------------------------------


def test_loads_hf_named_safetensors(pair, tmp_path):
    """The port's parameters written with HF LFM2 names (conv weights
    (D, 1, L), no lm_head: tied) load back equal through the port's
    load_params, and through aha_tpu's to the same logits."""
    from aha_tpu.io.weights import open_weights as jopen
    from aha_tpu_torch.io.weights import open_weights, save_hf_lfm2

    jm, _, tm, tp = pair
    save_hf_lfm2(tp, str(tmp_path))
    src = open_weights(str(tmp_path))
    assert src["model.layers.0.conv.conv.weight"].shape == (48, 1, 3)
    assert "lm_head.weight" not in src
    got = tm.load_params(src, dtype=torch.float32)
    assert got["lm_head"]["w"] is got["embed"]["w"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tp)):
        assert torch.equal(a, b)
    jp = jm.load_params(jopen(str(tmp_path)), dtype=jnp.float32)
    prompt = ids(12, 9)
    jh, _ = jm.backbone(jp, jnp.asarray([prompt]),
                        jm.init_cache(1, 32, jnp.float32))
    th = tm.backbone(got, torch.tensor([prompt]),
                     tm.init_cache(1, 32, torch.float32))
    assert _rel(tm.logits(got, th).numpy(),
                np.asarray(jm.logits(jp, jh))) <= TOL


@pytest.mark.parametrize("d", [
    {"num_hidden_layers": 4, "full_attn_idxs": [1, 3],
     "intermediate_size": 96, "block_auto_adjust_ff_dim": False},
    {"num_hidden_layers": 3, "layer_types": ["conv", "conv",
                                             "full_attention"],
     "block_ff_dim": 12288, "rope_parameters": {"rope_theta": 5e5}},
])
def test_config_from_dict_matches_jax(d):
    """layer_types or full_attn_idxs, the ff width under either name and
    auto-adjusted, rope_theta under rope_parameters: as aha_tpu reads
    them."""
    got, want = Lfm2Config.from_dict(d), JConfig.from_dict(d)
    assert got.__dict__ == want.__dict__
    assert got.intermediate_size == want.intermediate_size


def test_lfm2_1_2b_geometry():
    """HF LiquidAI/LFM2-1.2B: 10 conv and 6 attention layers, 32/8 heads
    of 64, 12288 auto-adjusted to 8192, tied."""
    cfg = lfm2_1_2b()
    m = Lfm2Model(cfg, max_rope_len=512)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.head_dim, m.n_attn_layers, m.n_conv_layers) == \
        (65536, 2048, 8192, 64, 6, 10)
    assert [i for i, t in enumerate(cfg.layer_types)
            if t == "full_attention"] == [2, 5, 8, 10, 12, 14]
    assert lfm2_1_2b(4).layer_types == ("conv", "conv", "full_attention",
                                         "conv")
    ref = JConfig.from_dict({
        "vocab_size": 65536, "hidden_size": 2048, "num_hidden_layers": 16,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "block_ff_dim": 12288, "conv_L_cache": 3, "rope_theta": 1e6,
        "norm_eps": 1e-5, "full_attn_idxs": [2, 5, 8, 10, 12, 14]})
    assert ref.__dict__ == cfg.__dict__
