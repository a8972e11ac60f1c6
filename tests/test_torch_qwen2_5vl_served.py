"""The port's served Qwen2.5-VL on a tiny HF-saved repo (the recipe of
tests/test_qwen2_5vl_served.py, copied: a transformers
Qwen2_5_VLForConditionalGeneration with random weights, the test
tokenizer plus the four vision special tokens, an image-aware chat
template), loaded through both packages' load_model: a PNG data-URL image
chat gives aha_tpu's greedy text and prompt-token count, two image sizes
share a patch bucket, a text-only chat matches, an .npz video chat
matches (its digest changing with the source fps, as aha_tpu's does), and
AHA_KV_INT8=1 leaves the VL model's cache in its own dtype (only a model
with supports_kv_int8 takes int8, as aha_tpu/models/text_served.py has it).
float32 on the CPU."""

import base64
import io
import json
import os

import numpy as np
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu_torch.cli import model_id_for
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.qwen2_5vl_served import Qwen2_5VLChat
from aha_tpu_torch.params import ChatCompletionParameters
from tests.fixtures import CHAT_TEMPLATE, build_tokenizer

torch.set_num_threads(1)
MODEL = "Qwen/Qwen2.5-VL-3B-Instruct"
TINY_VL_KW = dict(
    vision_config=dict(
        depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
        in_chans=3, out_hidden_size=48, patch_size=14, spatial_merge_size=2,
        temporal_patch_size=2, window_size=56, fullatt_block_indexes=[1],
        hidden_act="silu"),
    hidden_size=48, intermediate_size=96, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, rope_theta=1000000.0,
    max_position_embeddings=4096, tie_word_embeddings=True,
    rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
    attention_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def vl_repo(tmp_path_factory):
    from tokenizers import AddedToken
    from transformers import Qwen2_5_VLConfig as HFConfig
    from transformers.models.qwen2_5_vl import \
        Qwen2_5_VLForConditionalGeneration

    path = str(tmp_path_factory.mktemp("vl-tiny"))
    tok = build_tokenizer(path)
    tok.add_special_tokens([AddedToken(t, special=True) for t in
                            ("<|vision_start|>", "<|image_pad|>",
                             "<|vision_end|>", "<|video_pad|>")])
    tok.save(os.path.join(path, "tokenizer.json"))
    cfg = HFConfig(
        vocab_size=tok.get_vocab_size(),
        image_token_id=tok.token_to_id("<|image_pad|>"),
        video_token_id=tok.token_to_id("<|video_pad|>"),
        vision_start_token_id=tok.token_to_id("<|vision_start|>"),
        vision_end_token_id=tok.token_to_id("<|vision_end|>"),
        **TINY_VL_KW)
    torch.manual_seed(0)
    Qwen2_5_VLForConditionalGeneration(cfg).save_pretrained(path)
    tpl = CHAT_TEMPLATE.replace(
        "{{ message.content }}",
        "{% if message.content is string %}{{ message.content }}"
        "{% else %}{% for part in message.content %}"
        "{% if part.type == 'text' %}{{ part.text }}"
        "{% elif part.type == 'image_url' %}"
        "<|vision_start|><|image_pad|><|vision_end|>"
        "{% elif part.type == 'video_url' %}"
        "<|vision_start|><|video_pad|><|vision_end|>{% endif %}"
        "{% endfor %}{% endif %}")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": tpl}, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [tok.token_to_id("<|im_end|>")]}, f)
    return path


@pytest.fixture(scope="module")
def both(vl_repo):
    return (load_model(MODEL, vl_repo, max_seq_len=512),
            jload_model(MODEL, vl_repo, max_seq_len=512))


def _png_data_url(w=64, h=48, seed=0) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _body(content, max_tokens=8):
    return {"messages": [{"role": "user", "content": content}],
            "model": "m", "max_tokens": max_tokens, "temperature": 0.0}


def _both_generate(both, body):
    port, jax_model = both
    return (port.generate(ChatCompletionParameters.model_validate(body)),
            jax_model.generate(JParameters.model_validate(body)))


def test_loads_the_vl_family(both):
    port, _ = both
    assert isinstance(port, Qwen2_5VLChat)
    assert port.engine.params["text"]["lm_head"]["w"] is \
        port.engine.params["text"]["embed"]["w"]        # tied: no copy
    assert port.engine.cache_dtype == torch.float32


def test_image_chat_matches_jax(both):
    body = _body([{"type": "text", "text": "describe "},
                  {"type": "image_url", "image_url": {"url": _png_data_url()}}])
    got, want = _both_generate(both, body)
    assert got.usage.prompt_tokens == want.usage.prompt_tokens > 6
    assert got.choices[0].message.content == want.choices[0].message.content
    # the same request again: the prefix store's hit streams the same
    again, _ = _both_generate(both, body)
    assert again.choices[0].message.content == got.choices[0].message.content


@pytest.mark.parametrize("size", [(64, 48), (88, 60)])
def test_image_sizes_share_a_bucket(both, size):
    body = _body([{"type": "image_url",
                   "image_url": {"url": _png_data_url(*size, seed=1)}}], 4)
    got, want = _both_generate(both, body)
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


def test_stream_chunks_match_jax(both):
    """The streamed deltas (the <think> channel routing applied) and the
    final usage chunk's token counts."""
    port, jax_model = both
    body = _body([{"type": "text", "text": "hello "},
                  {"type": "image_url",
                   "image_url": {"url": _png_data_url(seed=2)}}])

    def deltas(chunks):
        chunks = list(chunks)
        return ([(ch.delta.content, ch.delta.reasoning_content)
                 for c in chunks for ch in c.choices],
                (chunks[-1].usage.prompt_tokens,
                 chunks[-1].usage.completion_tokens))

    assert deltas(port.generate_stream(
        ChatCompletionParameters.model_validate(body))) == \
        deltas(jax_model.generate_stream(JParameters.model_validate(body)))


def test_text_only_chat_matches_jax(both):
    got, want = _both_generate(both, _body("hello world how are you", 6))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


def test_kv_int8_env_keeps_the_vl_cache(both, vl_repo, monkeypatch):
    """AHA_KV_INT8=1 is for Qwen3: the VL model keeps a float32 cache on
    the CPU and its image chat equals the one served without the
    variable."""
    port, _ = both
    monkeypatch.setenv("AHA_KV_INT8", "1")
    int8_env = load_model(MODEL, vl_repo, max_seq_len=512)
    assert int8_env.engine.cache_dtype == torch.float32
    body = _body([{"type": "text", "text": "what is this "},
                  {"type": "image_url",
                   "image_url": {"url": _png_data_url(seed=4)}}])
    mes = ChatCompletionParameters.model_validate(body)
    got, want = int8_env.generate(mes), port.generate(mes)
    assert got.usage.prompt_tokens == want.usage.prompt_tokens > 6
    assert got.choices[0].message.content == want.choices[0].message.content


def test_video_part_raises(both):
    """A video part no longer raises: an .npz data-URL video chat gives
    aha_tpu's greedy text and prompt-token count, and the request's
    content digest is aha_tpu's, which hashes each grid's temporal
    seconds: the same frames at another source fps take other M-RoPE
    positions and another digest."""
    from tests.vision_chat import npz_data_url

    port, jax_model = both
    video = [{"type": "text", "text": "what happens "},
             {"type": "video_url",
              "video_url": {"url": npz_data_url(side=56, fps=2.0)}}]
    got, want = _both_generate(both, _body(video))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens > 16
    assert got.choices[0].message.content == want.choices[0].message.content
    keys, rope = [], []
    for fps in (2.0, 1.0):
        b = _body([{"type": "video_url", "video_url": {
            "url": npz_data_url(side=56, fps=fps)}}])
        data = port.get_data(ChatCompletionParameters.model_validate(b))
        jdata = jax_model.get_data(JParameters.model_validate(b))
        assert data.mm_key == jdata.mm_key
        np.testing.assert_array_equal(data.mm["position_ids"],
                                      np.asarray(jdata.mm["position_ids"]))
        np.testing.assert_array_equal(data.mm["patches"],
                                      np.asarray(jdata.mm["patches"]))
        keys.append(data.mm_key)
        rope.append(data.mm["position_ids"])
    assert keys[0] != keys[1] and not np.array_equal(*rope)


def test_cli_serves_a_vl_directory_as_the_vl_model(vl_repo, tmp_path):
    assert model_id_for(vl_repo, "Qwen/Qwen3-0.6B") == MODEL
    assert model_id_for(vl_repo, "Qwen/Qwen2.5-VL-7B-Instruct") == \
        "Qwen/Qwen2.5-VL-7B-Instruct"
    assert model_id_for(str(tmp_path), "Qwen/Qwen3-0.6B") == "Qwen/Qwen3-0.6B"
    with pytest.raises(ValueError, match="batch-slots"):
        load_model(MODEL, vl_repo, batch_slots=2)
