"""aha_tpu_torch's Qwen3-ASR against aha_tpu's on the same parameters
(made in JAX from a seed at tests/test_asr.py's tiny geometry, biases
randomized, carried across with params_from_jax): the feature lengths,
the encoder's real rows, the spliced prefill's logits and its decode
steps, greedy streams through both TextEngines (float32), the encoder's
invariance to padded chunks, the tanh GELU the reference computes (the
exact GELU must miss the tolerance), and the HF-checkpoint round trip.
float32 on the CPU: encoder rows and logits within rtol 1e-4, atol 1e-5;
token streams exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import cache as jkv
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import qwen3_asr as J
from aha_tpu.models.qwen3 import Qwen3Config as JQwen3Config
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import qwen3_asr as T
from aha_tpu_torch.models.qwen3 import Qwen3Config

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
AUDIO = dict(d_model=64, encoder_attention_heads=4, encoder_ffn_dim=128,
             encoder_layers=2, num_mel_bins=128, downsample_hidden_size=16,
             n_window=50, output_dim=48)
TEXT = dict(vocab_size=200, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=12, tie_word_embeddings=True, max_position_embeddings=512)
AUDIO_TOKEN = 190
JCFG = J.Qwen3ASRConfig(audio=J.Qwen3ASRAudioConfig(**AUDIO),
                        text=JQwen3Config(**TEXT), audio_token_id=AUDIO_TOKEN)
TCFG = T.Qwen3ASRConfig(audio=T.Qwen3ASRAudioConfig(**AUDIO),
                        text=Qwen3Config(**TEXT), audio_token_id=AUDIO_TOKEN)


def randomized(tree, seed: int, scale: float = 0.1):
    """Random biases and norm shifts (the JAX init leaves them 0 / 1, where
    a dropped one would go unnoticed), numpy leaves."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            is_norm = set(t) <= {"w", "b"} and np.asarray(t["w"]).ndim == 1
            return {k: walk(v, "norm_w" if is_norm and k == "w" else k)
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        a = np.asarray(t, np.float32)
        if name == "b":
            return rng.standard_normal(a.shape).astype(np.float32) * scale
        if name == "norm_w":
            return 1.0 + rng.standard_normal(a.shape).astype(
                np.float32) * scale
        return a

    return walk(tree)


def pair(jcfg=JCFG, tcfg=TCFG, seed: int = 5, scale: float = 0.02):
    """(JAX model, JAX params, port model, port params) on the same
    numbers."""
    jm = J.Qwen3ASRModel(jcfg, max_rope_len=256)
    jp = randomized(jm.init_random(jax.random.PRNGKey(seed), scale=scale),
                    seed)
    tm = T.Qwen3ASRModel(tcfg, max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


@pytest.fixture(scope="module")
def models():
    return pair()


def mel_mm(n_frames: int = 150, bucket: int = 200, seed: int = 0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((1, 128, bucket)).astype(np.float32)
    mel[:, :, n_frames:] = 0.0
    n_out = T.get_feat_extract_output_lengths(n_frames)
    return ({"mel": jnp.asarray(mel), "n_out": jnp.int32(n_out)},
            {"mel": torch.from_numpy(mel), "n_out": n_out}, n_out)


def test_feat_extract_output_lengths_equal():
    for n in range(0, 1300):
        assert T.get_feat_extract_output_lengths(n) == \
            J.get_feat_extract_output_lengths(n)
    assert T.get_feat_extract_output_lengths(3000) == 390


def test_config_from_file_reads_the_thinker_nesting(tmp_path):
    import json

    (tmp_path / "config.json").write_text(json.dumps({
        "thinker_config": {"audio_config": AUDIO, "text_config": TEXT,
                           "audio_token_id": 77}}))
    got = T.Qwen3ASRConfig.from_file(str(tmp_path))
    ref = J.Qwen3ASRConfig.from_file(str(tmp_path))
    assert dataclasses.asdict(got.audio) == dataclasses.asdict(ref.audio)
    assert dataclasses.asdict(got.text) == dataclasses.asdict(ref.text)
    assert got.audio_token_id == ref.audio_token_id == 77


@pytest.mark.parametrize("n_frames, bucket", [(150, 200), (100, 100),
                                              (399, 400)])
def test_encoder_matches_jax(models, n_frames, bucket):
    jm, jp, tm, tp = models
    jmm, tmm, n_out = mel_mm(n_frames, bucket, seed=n_frames)
    ref = np.asarray(jm.encode_audio(jp["audio"], jmm["mel"], jmm["n_out"]))
    got = tm.encode_audio(tp["audio"], tmm["mel"], n_out).numpy()
    assert got.shape == ref.shape == (bucket // 100 * 13, 48)
    np.testing.assert_allclose(got[:n_out], ref[:n_out], **TOL)


def test_spliced_prefill_and_decode_match_jax(models):
    """The prefill with the audio spliced, then two decode steps over the
    cache: logits of every real row against the JAX backbone's."""
    jm, jp, tm, tp = models
    jmm, tmm, n_out = mel_mm()
    ids = [1, 2] + [AUDIO_TOKEN] * n_out + [3, 4]
    cache_j = jm.init_cache(1, 64, jnp.float32)
    hid_j, cache_j = jm.backbone(jp, jnp.asarray([ids]), cache_j, mm=jmm)
    ref = np.asarray(jm.logits(jp, hid_j))[0]
    cache = tm.init_cache(1, 64, torch.float32)
    hid = tm.backbone(tp, torch.tensor([ids]), cache, mm=tmm)
    got = tm.logits(tp, hid)[0].numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # without the audio the prompt's logits differ
    cache2 = tm.init_cache(1, 64, torch.float32)
    plain = tm.logits(tp, tm.backbone(tp, torch.tensor([ids]), cache2))
    assert not np.allclose(plain[0].numpy(), got, atol=1e-3)
    # decode steps continue from the spliced rows
    kv.advance(cache, len(ids))
    cache_j = jkv.advance(cache_j, len(ids))
    for tok in (5, 6):
        hj, cache_j = jm.backbone(jp, jnp.asarray([[tok]]), cache_j)
        cache_j = jkv.advance(cache_j, 1)
        h = tm.backbone(tp, torch.tensor([[tok]]), cache)
        kv.advance(cache, 1)
        np.testing.assert_allclose(tm.logits(tp, h)[0, 0].numpy(),
                                   np.asarray(jm.logits(jp, hj))[0, 0], **TOL)


def test_greedy_stream_equal_through_text_engines(models):
    """Greedy tokens through both TextEngines (float32, decode blocks of
    16 on both) with the audio in the prefill: the same stream."""
    jm, jp, tm, tp = models
    jmm, tmm, n_out = mel_mm(n_frames=250, bucket=400, seed=3)
    ids = [11, 12, 13] + [AUDIO_TOKEN] * n_out + [14, 15]
    ref = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                  max_seq_len=256, decode_block=16).generate_tokens(
        ids, JSampling(), 20, mm=jmm)
    eng = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256)
    got = eng.generate_tokens(ids, SamplingConfig(), 20, mm=tmm)
    assert len(got) == 20 and got == ref


def test_encoder_padding_invariance(models):
    """The real rows do not depend on padded chunks (the key mask)."""
    _, _, tm, tp = models
    _, small, n_out = mel_mm(150, 200)
    big = torch.zeros((1, 128, 400))
    big[:, :, :200] = small["mel"]
    a = tm.encode_audio(tp["audio"], small["mel"], n_out)
    b = tm.encode_audio(tp["audio"], big, n_out)
    np.testing.assert_allclose(a[:n_out].numpy(), b[:n_out].numpy(), **TOL)


@pytest.mark.parametrize("approximate, close",
                         [("tanh", True), ("none", False)])
def test_the_tanh_gelu_of_the_reference_is_pinned(monkeypatch, approximate,
                                                  close):
    """jax.nn.gelu's default is the tanh form, so the reference's encoder
    computes that, while config.json's activation_function "gelu" names
    the exact one: the port copies the reference's numbers.  At weights
    large enough for O(1) activations the exact GELU misses the
    tolerance."""
    jm, jp, tm, tp = pair(seed=9, scale=0.3)
    jmm, tmm, n_out = mel_mm(200, 200, seed=9)
    ref = np.asarray(jm.encode_audio(jp["audio"], jmm["mel"], jmm["n_out"]))
    monkeypatch.setattr(T, "GELU_APPROXIMATE", approximate)
    got = tm.encode_audio(tp["audio"], tmm["mel"], n_out).numpy()
    assert np.allclose(got, ref, **TOL) == close
    assert TCFG.audio.activation_function == "gelu"


def test_hf_checkpoint_round_trip(tmp_path, models):
    """save_hf_qwen3_asr writes the published names (thinker.audio_tower.,
    thinker.model.); load_params reads them back to the same tree, and
    the JAX loader reads the same file to the same numbers."""
    from aha_tpu.io.weights import open_weights as jopen
    from aha_tpu_torch.io.weights import open_weights, save_hf_qwen3_asr

    jm, jp, tm, tp = models
    save_hf_qwen3_asr(tp, str(tmp_path))
    src = open_weights(str(tmp_path))
    assert "thinker.audio_tower.conv2d1.weight" in src
    assert "thinker.model.layers.0.self_attn.q_proj.weight" in src
    back = tm.load_params(src, dtype=torch.float32)
    flat_a = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tp)))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
    jback = jm.load_params(jopen(str(tmp_path)), dtype=jnp.float32)
    ported = params_from_jax(jax.tree.map(np.asarray, jback))
    jmm, tmm, n_out = mel_mm()
    np.testing.assert_array_equal(
        tm.encode_audio(ported["audio"], tmm["mel"], n_out).numpy(),
        tm.encode_audio(back["audio"], tmm["mel"], n_out).numpy())


def test_fuse_params_fuses_the_decoder_only(models):
    _, _, tm, tp = models
    fused = tm.fuse_params(tp)
    assert "qkv" in fused["text"]["layers"] and "q" not in \
        fused["text"]["layers"]
    assert fused["audio"] is tp["audio"]
