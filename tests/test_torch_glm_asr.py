"""aha_tpu_torch's GLM-ASR-Nano against aha_tpu's on the same parameters
(made in JAX from a seed at tests/test_glm_asr.py's tiny geometry, biases
and norms randomized, carried across with params_from_jax): the token
formula, the partial rotary and the 1-D conv, the encoder, the spliced
prefill and a decode step, greedy streams through both TextEngines
(float32), and the served model on a checkpoint in HF names loaded by
both packages (30 s windows, the summed token count, the prompt's audio
token from processor_config.json): its prepared inputs and its reply
equal.  float32 on the CPU: rows and logits within rtol 1e-4, atol 1e-5;
token streams exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import cache as jkv
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import glm_asr_nano as J
from aha_tpu.models.llama import LlamaConfig as JLlamaConfig
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import glm_asr_nano as T
from aha_tpu_torch.models.llama import LlamaConfig
from tests.test_torch_qwen3_asr import randomized

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
AUDIO_TOK = 90
AUDIO = dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, head_dim=16,
             num_mel_bins=128, partial_rotary_factor=0.5)
TEXT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512, tie_word_embeddings=True)


def pair(text=TEXT, token=AUDIO_TOK, seed: int = 11):
    jcfg = J.GlmAsrNanoConfig(audio=J.GlmAsrAudioConfig(**AUDIO),
                              text=JLlamaConfig(**text), audio_token_id=token)
    tcfg = T.GlmAsrNanoConfig(audio=T.GlmAsrAudioConfig(**AUDIO),
                              text=LlamaConfig(**text), audio_token_id=token)
    jm = J.GlmAsrNanoModel(jcfg, max_rope_len=256)
    jp = randomized(jm.init_random(jax.random.PRNGKey(seed)), seed)
    tm = T.GlmAsrNanoModel(tcfg, max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


@pytest.fixture(scope="module")
def models():
    return pair()


def mel_mm(frames: int = 64, windows: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((windows, 128, frames)).astype(np.float32)
    n_tok = T.audio_token_length(frames)
    per = frames // 8
    gather = np.concatenate([np.arange(n_tok) + w * per
                             for w in range(windows)]).astype(np.int32)
    return ({"mel": jnp.asarray(mel), "gather": jnp.asarray(gather)},
            {"mel": torch.from_numpy(mel), "gather": torch.from_numpy(gather)},
            len(gather))


def test_audio_token_length_equal():
    for n in range(1, 4000):
        assert T.audio_token_length(n) == J.audio_token_length(n)
    assert T.audio_token_length(3000) == 375


def test_partial_rope_and_conv1d_match_jax():
    from aha_tpu.ops.rope import apply_partial_rope as jrope
    from aha_tpu.ops.rope import rope_table as jtable
    from aha_tpu_torch.ops.conv import conv1d
    from aha_tpu_torch.ops.rope import apply_partial_rope, rope_table

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    jc, js = jtable(8, 64, 10000.0)
    tc, ts = rope_table(8, 64, 10000.0)
    rq, rk = jrope(jnp.asarray(q), jnp.asarray(k), jc[:10], js[:10], 8)
    gq, gk = apply_partial_rope(torch.from_numpy(q), torch.from_numpy(k),
                                tc[:10], ts[:10], 8)
    np.testing.assert_allclose(gq.numpy(), np.asarray(rq), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_array_equal(gq[..., 8:].numpy(), q[..., 8:])
    x = rng.standard_normal((2, 5, 17)).astype(np.float32)
    w = rng.standard_normal((6, 5, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2,), ((1, 1),),
        dimension_numbers=("NCH", "OIH", "NCH")) + b[None, :, None]
    got = conv1d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                 torch.from_numpy(x), stride=2, padding=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("frames, windows", [(64, 1), (96, 2)])
def test_encoder_matches_jax(models, frames, windows):
    jm, jp, tm, tp = models
    jmm, tmm, _ = mel_mm(frames, windows, seed=frames)
    ref = np.asarray(jm.encode_audio(jp["audio"], jmm["mel"]))
    got = tm.encode_audio(tp["audio"], tmm["mel"]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_spliced_prefill_and_decode_match_jax(models):
    jm, jp, tm, tp = models
    jmm, tmm, n_tok = mel_mm()
    ids = [1, 2] + [AUDIO_TOK] * n_tok + [3, 4, 5]
    cache_j = jm.init_cache(1, 64, jnp.float32)
    hj, cache_j = jm.backbone(jp, jnp.asarray([ids]), cache_j, mm=jmm)
    cache = tm.init_cache(1, 64, torch.float32)
    h = tm.backbone(tp, torch.tensor([ids]), cache, mm=tmm)
    np.testing.assert_allclose(tm.logits(tp, h)[0].numpy(),
                               np.asarray(jm.logits(jp, hj))[0], **TOL)
    cache_j = jkv.advance(cache_j, len(ids))
    kv.advance(cache, len(ids))
    hj, _ = jm.backbone(jp, jnp.asarray([[7]]), cache_j)
    h = tm.backbone(tp, torch.tensor([[7]]), cache)
    np.testing.assert_allclose(tm.logits(tp, h)[0, 0].numpy(),
                               np.asarray(jm.logits(jp, hj))[0, 0], **TOL)


def test_greedy_stream_equal_through_text_engines(models):
    jm, jp, tm, tp = models
    jmm, tmm, n_tok = mel_mm(96, 2, seed=4)
    ids = [5, 6] + [AUDIO_TOK] * n_tok + [8, 9]
    ref = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                  max_seq_len=256, decode_block=16).generate_tokens(
        ids, JSampling(), 20, mm=jmm)
    got = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256
                     ).generate_tokens(ids, SamplingConfig(), 20, mm=tmm)
    assert len(got) == 20 and got == ref


# -- served --------------------------------------------------------------------

PAD_AUDIO = "<|pad_audio|>"


def _hf_tree(tp: dict) -> dict:
    """The port's GLM-ASR parameters under the HF names the loaders read
    (audio_tower., multi_modal_projector., language_model.)."""
    from aha_tpu_torch.io.weights import _hf_decoder, _hf_linear, _hf_norm

    ap, out = tp["audio"], {}
    for n in ("conv1", "conv2"):
        out[f"audio_tower.{n}.weight"] = ap[n]["w"].contiguous()
        out[f"audio_tower.{n}.bias"] = ap[n]["b"]
    _hf_norm(out, "audio_tower.norm", ap["norm"])
    for i, lp in enumerate(ap["layers"]):
        p = f"audio_tower.layers.{i}."
        _hf_norm(out, p + "input_layernorm", lp["ln1"])
        _hf_norm(out, p + "post_attention_layernorm", lp["ln2"])
        for k in "qkvo":
            _hf_linear(out, f"{p}self_attn.{k}_proj", lp[k])
        _hf_linear(out, p + "mlp.fc1", lp["fc1"])
        _hf_linear(out, p + "mlp.fc2", lp["fc2"])
    _hf_linear(out, "multi_modal_projector.linear_1", ap["proj1"])
    _hf_linear(out, "multi_modal_projector.linear_2", ap["proj2"])
    out.update(_hf_decoder(tp["text"], prefix="language_model.model."))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from safetensors.torch import save_file
    from tokenizers import AddedToken

    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu_torch.models.loader import load_model
    from tests.fixtures import CHAT_TEMPLATE, build_tokenizer

    path = str(tmp_path_factory.mktemp("glm_asr_tiny"))
    tok = build_tokenizer(path)
    tok.add_special_tokens([AddedToken(PAD_AUDIO, special=True)])
    tok.save(os.path.join(path, "tokenizer.json"))
    token = tok.token_to_id(PAD_AUDIO)
    # two 30 s windows are 750 audio tokens: positions past TEXT's 512
    text = {**TEXT, "vocab_size": tok.get_vocab_size(),
            "max_position_embeddings": 4096}
    files = {
        "config.json": {"audio_config": AUDIO, "text_config": text,
                        "audio_token_id": token},
        "generation_config.json": {
            "eos_token_id": [tok.token_to_id("<|im_end|>")]},
        "processor_config.json": {"audio_token": PAD_AUDIO,
                                  "max_audio_len": 60},
        "tokenizer_config.json": {"chat_template": CHAT_TEMPLATE.replace(
            "{{ message.content }}",
            "{% if message.content is string %}{{ message.content }}"
            "{% else %}{% for part in message.content %}"
            "{% if part.type == 'text' %}{{ part.text }}"
            f"{{% elif part.type == 'audio_url' %}}{PAD_AUDIO}{{% endif %}}"
            "{% endfor %}{% endif %}")}}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    _, _, _, tp = pair(text, token)
    save_file({k: v.contiguous() for k, v in _hf_tree(tp).items()},
              os.path.join(path, "model.safetensors"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        tm = load_model("ZhipuAI/GLM-ASR-Nano-2512", path, max_seq_len=2048)
    jm = jload_model("ZhipuAI/GLM-ASR-Nano-2512", path, max_seq_len=2048)
    return jm, tm


def _bodies(lengths, seed: int = 0):
    import base64

    from aha_tpu.params import ChatCompletionParameters as JParams
    from aha_tpu_torch.params import ChatCompletionParameters
    from aha_tpu_torch.utils.audio import wav_bytes

    rng = np.random.default_rng(seed)
    content = [{"type": "text", "text": "transcribe"}]
    for secs in lengths:
        wav = (0.2 * rng.standard_normal(int(16000 * secs))).astype(
            np.float32)
        content.append({"type": "audio_url", "audio_url": {
            "url": "data:audio/wav;base64,"
                   + base64.b64encode(wav_bytes(wav, 16000)).decode()}})
    body = {"model": "m", "max_tokens": 6,
            "messages": [{"role": "user", "content": content}]}
    return JParams.model_validate(body), \
        ChatCompletionParameters.model_validate(body)


@pytest.mark.parametrize("lengths", [(1.0,), (31.0, 0.02), (70.0,)],
                         ids=["1s", "two-audios", "capped"])
def test_served_inputs_and_reply_equal(served, lengths):
    """One short audio; two audios, the first over two windows, the second
    under 8 frames; one past max_audio_len (60 s: two windows kept)."""
    jm, tm = served
    jp, tp = _bodies(lengths, seed=len(lengths))
    got, ref = tm.get_data(tp), jm.get_data(jp)
    assert got.input_ids == ref.input_ids
    np.testing.assert_array_equal(got.mm["gather"].numpy(),
                                  np.asarray(ref.mm["gather"]))
    np.testing.assert_allclose(got.mm["mel"].numpy(),
                               np.asarray(ref.mm["mel"]), atol=1e-4, rtol=0)
    a, b = tm.generate(tp), jm.generate(jp)
    assert a.choices[0].message.content == b.choices[0].message.content
    assert a.usage.prompt_tokens == b.usage.prompt_tokens
