"""The port's served Qwen3-VL on a tiny HF-saved repo (the recipe of
tests/test_qwen3vl_served.py: a transformers
Qwen3VLForConditionalGeneration with random weights, the test tokenizer
plus the four vision special tokens, a chat template that renders image
and video parts), loaded through both packages' load_model: a PNG
data-URL image chat, an .npz data-URL video chat (timestamped per-frame
placeholders) and a text-only chat give aha_tpu's greedy text and
prompt-token count, as does the stream of an image chat; the request's
inputs (ids, patches, rope ids, the content digest) equal aha_tpu's; the
loader builds one stream without a prefix store and refuses slots; `run`
of the directory serves it as Qwen/Qwen3-VL-8B-Instruct.  float32 on the
CPU."""

import base64

import numpy as np
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu_torch import cli
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.qwen3vl_served import Qwen3VLChat
from aha_tpu_torch.params import ChatCompletionParameters
from tests.vision_chat import (npz_data_url, png_data_url, vision_tokenizer,
                               write_template)

torch.set_num_threads(1)
MODEL = "Qwen/Qwen3-VL-8B-Instruct"
TINY_VL3_KW = dict(
    vision_config=dict(
        depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
        in_channels=3, out_hidden_size=48, patch_size=16,
        spatial_merge_size=2, temporal_patch_size=2,
        num_position_embeddings=16, deepstack_visual_indexes=[0, 1],
        hidden_act="gelu_pytorch_tanh"),
    text_config=dict(
        hidden_size=48, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=12,
        rope_theta=1000000.0, max_position_embeddings=4096,
        tie_word_embeddings=True,
        rope_scaling={"rope_type": "default", "mrope_section": [2, 2, 2],
                      "mrope_interleaved": True},
        attention_dropout=0.0))
@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def vl3_repo(tmp_path_factory):
    from transformers import Qwen3VLConfig as HFConfig
    from transformers.models.qwen3_vl import Qwen3VLForConditionalGeneration

    path = str(tmp_path_factory.mktemp("vl3-tiny"))
    tok = vision_tokenizer(path)
    kw = {**TINY_VL3_KW, "text_config": {
        **TINY_VL3_KW["text_config"], "vocab_size": tok.get_vocab_size()}}
    cfg = HFConfig(
        image_token_id=tok.token_to_id("<|image_pad|>"),
        video_token_id=tok.token_to_id("<|video_pad|>"),
        vision_start_token_id=tok.token_to_id("<|vision_start|>"),
        vision_end_token_id=tok.token_to_id("<|vision_end|>"), **kw)
    torch.manual_seed(0)
    Qwen3VLForConditionalGeneration(cfg).save_pretrained(path)
    write_template(path, tok)
    return path


@pytest.fixture(scope="module")
def both(vl3_repo):
    return (load_model(MODEL, vl3_repo, max_seq_len=1024),
            jload_model(MODEL, vl3_repo, max_seq_len=1024))


def body(content, max_tokens=8):
    return {"messages": [{"role": "user", "content": content}],
            "model": "m", "max_tokens": max_tokens, "temperature": 0.0}


def both_generate(both, b):
    port, jax_model = both
    return (port.generate(ChatCompletionParameters.model_validate(b)),
            jax_model.generate(JParameters.model_validate(b)))


IMAGE = [{"type": "text", "text": "describe "},
         {"type": "image_url", "image_url": {"url": png_data_url()}}]
VIDEO = [{"type": "text", "text": "what happens "},
         {"type": "video_url", "video_url": {"url": npz_data_url()}}]


def test_loads_the_family_single_stream(both, vl3_repo):
    port, _ = both
    assert isinstance(port, Qwen3VLChat)
    assert port.engine.prefix_cache_entries == 0       # as aha_tpu builds it
    assert port.engine.cache_dtype == torch.float32
    assert port.engine.params["text"]["lm_head"]["w"] is \
        port.engine.params["text"]["embed"]["w"]
    with pytest.raises(ValueError, match="batch-slots"):
        load_model(MODEL, vl3_repo, batch_slots=2)


@pytest.mark.parametrize("content", [IMAGE, VIDEO, "hello world how are you"],
                         ids=["image", "video", "text"])
def test_chat_matches_jax(both, content):
    got, want = both_generate(both, body(content))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


@pytest.mark.parametrize("content", [IMAGE, VIDEO], ids=["image", "video"])
def test_request_inputs_equal_jax(both, content):
    """get_data: the prompt ids (the video's timestamped per-frame
    placeholders), the padded patches and indices, the rope ids and delta,
    and the content digest."""
    port, jax_model = both
    b = body(content)
    got = port.get_data(ChatCompletionParameters.model_validate(b))
    want = jax_model.get_data(JParameters.model_validate(b))
    assert got.input_ids == list(want.input_ids)
    assert got.mm_key == want.mm_key
    assert tuple(got.mm_token_ids) == tuple(want.mm_token_ids)
    for name, a in got.mm.items():
        w = want.mm[name]
        if name == "rope_delta":
            assert a == int(w)
        else:
            np.testing.assert_array_equal(a, np.asarray(w),
                                          err_msg=name)
    if content is VIDEO:
        text = port.tokenizer.decode(got.input_ids)
        assert "<0.2 seconds>" in text and "<1.2 seconds>" in text


def test_stream_chunks_match_jax(both):
    port, jax_model = both
    b = body([{"type": "text", "text": "hello "},
              {"type": "image_url", "image_url": {"url": png_data_url(
                  96, 64, seed=2)}}])

    def deltas(chunks):
        chunks = list(chunks)
        return ([(ch.delta.content, ch.delta.reasoning_content)
                 for c in chunks for ch in c.choices],
                (chunks[-1].usage.prompt_tokens,
                 chunks[-1].usage.completion_tokens))

    assert deltas(port.generate_stream(
        ChatCompletionParameters.model_validate(b))) == \
        deltas(jax_model.generate_stream(JParameters.model_validate(b)))


def test_run_serves_the_directory_as_qwen3vl(vl3_repo, both, capsys,
                                             tmp_path):
    """The default model id of a directory whose config.json names
    qwen3_vl is Qwen/Qwen3-VL-8B-Instruct; `run` with a prompt and an
    image file answers as the served model does."""
    assert cli.model_id_for(vl3_repo, cli.DEFAULT_MODEL) == MODEL
    image = tmp_path / "x.png"
    image.write_bytes(base64.b64decode(png_data_url(seed=5).split(",")[1]))
    assert cli.main(["run", vl3_repo, "--input", "what is it",
                     "--input", str(image), "--max-tokens", "8",
                     "--max-seq-len", "1024"]) == 0
    out = capsys.readouterr().out.splitlines()
    port, _ = both
    b = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": f"file://{image}"}},
        {"type": "text", "text": "what is it"}]}],
         "model": MODEL, "max_tokens": 8}
    want = port.generate(ChatCompletionParameters.model_validate(b))
    assert "\n".join(out[1:-1]) == want.choices[0].message.text()
