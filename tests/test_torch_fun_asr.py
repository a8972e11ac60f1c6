"""aha_tpu_torch's Fun-ASR-Nano against aha_tpu's on the same parameters
(made in JAX from a seed at tests/test_fun_asr.py's tiny geometry, biases
and norms randomized, carried across with params_from_jax, which turns
each FSMN's (K, D) taps into torch's depthwise (D, 1, K)): the token
formula, the FSMN memory, the encoder's and adaptor's real rows (pad
rows are not compared: the JAX CPU form lets them attend each other, the
port's segment attention gives them 0), the spliced prefill and a decode
step, greedy streams through both TextEngines (float32), the encoder's
invariance to the LFR bucket, and the served model: a checkpoint written
with save_hf_fun_asr_nano loaded by both packages, its prepared prompt
and inputs and its reply equal.  float32 on the CPU: rows and logits
within rtol 1e-4, atol 1e-5; token streams exactly."""

import dataclasses
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
from aha_tpu.models import fun_asr_nano as J
from aha_tpu.models.qwen3 import Qwen3Config as JQwen3Config
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import fun_asr_nano as T
from aha_tpu_torch.models.qwen3 import Qwen3Config
from tests.test_torch_qwen3_asr import randomized

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
ENC = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
           tp_blocks=1, kernel_size=5, n_mels=80, lfr_m=7, lfr_n=6)
ADA = dict(downsample_rate=2, encoder_dim=32, llm_dim=48, ffn_dim=64,
           n_layer=1, attention_heads=4)
LLM = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=12, tie_word_embeddings=True, max_position_embeddings=512)


def configs(llm=LLM):
    return (J.FunAsrNanoConfig(encoder=J.FunAsrEncoderConfig(**ENC),
                               adaptor=J.FunAsrAdaptorConfig(**ADA),
                               llm=JQwen3Config(**llm)),
            T.FunAsrNanoConfig(encoder=T.FunAsrEncoderConfig(**ENC),
                               adaptor=T.FunAsrAdaptorConfig(**ADA),
                               llm=Qwen3Config(**llm)))


def pair(llm=LLM, seed: int = 13):
    jcfg, tcfg = configs(llm)
    jm = J.FunAsrNanoModel(jcfg, max_rope_len=256)
    jp = randomized(jm.init_random(jax.random.PRNGKey(seed)), seed)
    tm = T.FunAsrNanoModel(tcfg, max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


@pytest.fixture(scope="module")
def models():
    return pair()


def speech_mm(t_lfr: int = 17, bucket: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    speech = np.zeros((1, bucket, 560), np.float32)
    speech[0, :t_lfr] = rng.standard_normal((t_lfr, 560)) * 0.1
    seg = np.full(bucket, -1, np.int32)
    seg[:t_lfr] = 0
    n_tok = T.fun_asr_token_length(t_lfr)
    gather = np.arange(n_tok, dtype=np.int32)
    return ({"speech": jnp.asarray(speech), "seg": jnp.asarray(seg),
             "gather": jnp.asarray(gather)},
            {"speech": torch.from_numpy(speech), "seg": torch.from_numpy(seg),
             "gather": torch.from_numpy(gather)}, n_tok)


def test_token_length_formula_equal():
    for t in range(1, 2100):
        assert T.fun_asr_token_length(t) == J.fun_asr_token_length(t)
    assert T.fun_asr_token_length(500) == 63


def test_fsmn_layout_and_memory(models):
    """params_from_jax turns the JAX (K, D) taps into (D, 1, K), and the
    port's depthwise conv equals the JAX package's sum of shifted rows."""
    _, jp, _, tp = models
    taps = np.asarray(jp["audio"]["encoders"][0]["fsmn"]["w"])     # (K, D)
    got = tp["audio"]["encoders"][0]["fsmn"]["w"]
    assert got.shape == (taps.shape[1], 1, taps.shape[0])
    np.testing.assert_array_equal(got[:, 0, :].t().numpy(), taps)
    v = np.random.default_rng(1).standard_normal((1, 9, 32)).astype(
        np.float32)
    K, left = taps.shape[0], (taps.shape[0] - 1) // 2
    vp = np.pad(v, ((0, 0), (left, K - 1 - left), (0, 0)))
    ref = sum(vp[:, i:i + 9] * taps[i] for i in range(K)) + v
    np.testing.assert_allclose(
        T.FunAsrNanoModel.fsmn_memory(torch.from_numpy(v), got).numpy(),
        ref, **TOL)


@pytest.mark.parametrize("t_lfr, bucket", [(17, 32), (32, 32), (9, 16)])
def test_encoder_and_adaptor_real_rows_match_jax(models, t_lfr, bucket):
    jm, jp, tm, tp = models
    jmm, tmm, n_tok = speech_mm(t_lfr, bucket, seed=t_lfr)
    ref = np.asarray(jm.encode_audio(jp["audio"], jmm["speech"], jmm["seg"]))
    got = tm.encode_audio(tp["audio"], tmm["speech"], tmm["seg"]).numpy()
    assert got.shape == ref.shape == (bucket // 2, 48)
    real = (t_lfr + 1) // 2              # adaptor rows from real frames
    np.testing.assert_allclose(got[:real], ref[:real], **TOL)
    assert n_tok <= real


def _prompt(n_tok):
    head, tail = [1, 2], [3, 4]
    ids = head + [0] * n_tok + tail
    fmask = np.zeros(32, bool)           # the prompt's bucket
    fmask[len(head):len(head) + n_tok] = True
    return ids, fmask


def test_spliced_prefill_and_decode_match_jax(models):
    jm, jp, tm, tp = models
    jmm, tmm, n_tok = speech_mm()
    ids, fmask = _prompt(n_tok)
    jmm["fbank_mask"] = jnp.asarray(fmask[:len(ids)])
    tmm["fbank_mask"] = torch.from_numpy(fmask)
    cache_j = jm.init_cache(1, 32, jnp.float32)
    hj, cache_j = jm.backbone(jp, jnp.asarray([ids]), cache_j, mm=jmm)
    cache = tm.init_cache(1, 32, torch.float32)
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
    jmm, tmm, n_tok = speech_mm(30, 32, seed=5)
    ids, fmask = _prompt(n_tok)
    jmm["fbank_mask"] = jnp.asarray(fmask)
    tmm["fbank_mask"] = torch.from_numpy(fmask)
    ref = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                  max_seq_len=256, decode_block=16).generate_tokens(
        ids, JSampling(), 20, mm=jmm)
    got = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256
                     ).generate_tokens(ids, SamplingConfig(), 20, mm=tmm)
    assert len(got) == 20 and got == ref


def test_encoder_bucket_invariance(models):
    _, _, tm, tp = models
    _, a, n_tok = speech_mm(17, 32)
    _, b, _ = speech_mm(17, 64)
    fa = tm.encode_audio(tp["audio"], a["speech"], a["seg"])
    fb = tm.encode_audio(tp["audio"], b["speech"], b["seg"])
    np.testing.assert_allclose(fa[:n_tok].numpy(), fb[:n_tok].numpy(), **TOL)


# -- served --------------------------------------------------------------------


def build_fun_asr_repo(path: str, seed: int = 0) -> dict:
    """A loadable tiny Fun-ASR-Nano repo: the test tokenizer, config.json in
    the published layout (audio_encoder_conf, frontend_conf,
    audio_adaptor_conf, llm_conf), the eos in generation_config.json, and
    seeded weights (JAX init, randomized) written by save_hf_fun_asr_nano.
    Returns the port's parameters."""
    from aha_tpu_torch.io.weights import save_hf_fun_asr_nano
    from tests.fixtures import build_tokenizer

    os.makedirs(path, exist_ok=True)
    tok = build_tokenizer(path)
    llm = {**LLM, "vocab_size": tok.get_vocab_size()}
    frontend = {k: ENC[k] for k in ("n_mels", "lfr_m", "lfr_n")}
    cfg = {"audio_encoder_conf": {k: v for k, v in ENC.items()
                                  if k not in frontend},
           "frontend_conf": frontend, "audio_adaptor_conf": ADA,
           "llm_conf": llm}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [tok.token_to_id("<|im_end|>")]}, f)
    _, _, _, tp = pair(llm, seed)
    save_hf_fun_asr_nano(tp, path)
    return tp


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu_torch.models.loader import load_model

    path = str(tmp_path_factory.mktemp("fun_asr_tiny"))
    build_fun_asr_repo(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        tm = load_model("FunAudioLLM/Fun-ASR-Nano-2512", path,
                        max_seq_len=512)
    jm = jload_model("FunAudioLLM/Fun-ASR-Nano-2512", path, max_seq_len=512)
    return jm, tm, path


def _bodies(secs: float, text: str | None, seed: int = 0):
    import base64

    from aha_tpu.params import ChatCompletionParameters as JParams
    from aha_tpu_torch.params import ChatCompletionParameters
    from aha_tpu_torch.utils.audio import wav_bytes

    rng = np.random.default_rng(seed)
    wav = (0.2 * rng.standard_normal(int(16000 * secs))).astype(np.float32)
    url = "data:audio/wav;base64," + base64.b64encode(
        wav_bytes(wav, 16000)).decode()
    content = [{"type": "audio_url", "audio_url": {"url": url}}]
    if text:
        content.append({"type": "text", "text": text})
    body = {"model": "m", "max_tokens": 10,
            "messages": [{"role": "user", "content": content}]}
    return JParams.model_validate(body), \
        ChatCompletionParameters.model_validate(body)


@pytest.mark.parametrize("secs, text", [(1.0, None), (3.0, "hello world")])
def test_served_inputs_and_reply_equal(served, secs, text):
    jm, tm, _ = served
    jp, tp = _bodies(secs, text, seed=int(secs))
    got, ref = tm.get_data(tp), jm.get_data(jp)
    assert got.input_ids == ref.input_ids
    for k in ("speech", "seg", "gather", "fbank_mask"):
        np.testing.assert_array_equal(got.mm[k],
                                      np.asarray(ref.mm[k]))
    a, b = tm.generate(tp), jm.generate(jp)
    assert a.choices[0].message.content == b.choices[0].message.content
    assert a.usage.completion_tokens == b.usage.completion_tokens


def test_served_refuses_a_request_without_audio(served):
    from aha_tpu_torch.params import ChatCompletionParameters

    _, tm, _ = served
    with pytest.raises(ValueError, match="FunASRNano need audio input"):
        tm.get_data(ChatCompletionParameters.model_validate(
            {"model": "m", "messages": [{"role": "user", "content": "hi"}]}))


def test_checkpoint_round_trip(served, models):
    """save_hf_fun_asr_nano writes the published names and load_params
    reads them back to the written tree."""
    from aha_tpu_torch.io.weights import open_weights

    _, tm, path = served
    src = open_weights(path)
    assert "audio_encoder.encoders0.0.self_attn.fsmn_block.weight" in src
    assert "llm.model.embed_tokens.weight" in src
    assert src["audio_encoder.encoders.0.self_attn.fsmn_block.weight"
               ].shape == (32, 1, 5)
    assert dataclasses.asdict(tm.asr_model.config.encoder) == \
        dataclasses.asdict(T.FunAsrEncoderConfig(**ENC))
