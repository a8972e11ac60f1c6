"""The port's served LFM2-VL on a tiny HF-saved repo (the recipe of
tests/test_lfm2vl.py: a transformers Lfm2VlForConditionalGeneration with
random weights, the test tokenizer plus "<image>", a chat template that
renders image parts; a processor_config.json with 32-pixel tiles so that
small images split), loaded through both packages' load_model: PNG
data-URL image chats — unsplit, a 3 x 2 grid with its thumbnail, a 5 x 1
grid — and a text-only chat give aha_tpu's greedy text and prompt-token
count, as does the stream of an image chat; the request's inputs (ids with
every tile's row / column marker and placeholders, the packed pixels,
mask, host-resized positions and the unshuffle gather) equal aha_tpu's;
the loader builds one stream without a prefix store and refuses slots with
the reference's words; a directory whose config.json model type is
lfm2-vl is served as LiquidAI/LFM2-VL-1.6B.  float32 on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu_torch import cli
from aha_tpu_torch.models.lfm2vl_served import Lfm2VLChat
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.params import ChatCompletionParameters
from tests.fixtures import CHAT_TEMPLATE, build_tokenizer
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
MODEL = "LiquidAI/LFM2-VL-1.6B"
#: tiles of 32 px (8 x 8 patches of 4 px) on grids of 2 to 10
PROCESSOR = {"image_processor": {
    "tile_size": 32, "min_tiles": 2, "max_tiles": 10,
    "max_pixels_tolerance": 2.0, "do_image_splitting": True,
    "use_thumbnail": True}}


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    from tokenizers import AddedToken
    from transformers import Lfm2VlConfig
    from transformers.models.lfm2_vl import Lfm2VlForConditionalGeneration

    path = str(tmp_path_factory.mktemp("lfm2vl-tiny"))
    tok = build_tokenizer(path)
    tok.add_special_tokens([AddedToken("<image>", special=True)])
    tok.save(os.path.join(path, "tokenizer.json"))
    cfg = Lfm2VlConfig(
        text_config=dict(
            vocab_size=tok.get_vocab_size(), hidden_size=48,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, block_ff_dim=96, conv_L_cache=3,
            block_multiple_of=16, block_auto_adjust_ff_dim=False,
            layer_types=["conv", "full_attention", "conv",
                         "full_attention"],
            max_position_embeddings=2048, norm_eps=1e-5,
            rope_theta=1000000.0),
        vision_config=dict(
            hidden_size=32, intermediate_size=64, num_attention_heads=2,
            num_hidden_layers=2, num_patches=16, patch_size=4,
            hidden_act="gelu_pytorch_tanh", attention_dropout=0.0),
        image_token_id=tok.token_to_id("<image>"), downsample_factor=2,
        projector_hidden_size=64, projector_use_layernorm=True,
        projector_bias=True)
    torch.manual_seed(0)
    Lfm2VlForConditionalGeneration(cfg).save_pretrained(path)
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    d.update(min_image_tokens=1, max_image_tokens=16)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f)
    tpl = CHAT_TEMPLATE.replace(
        "{{ message.content }}",
        "{% if message.content is string %}{{ message.content }}"
        "{% else %}{% for part in message.content %}"
        "{% if part.type == 'text' %}{{ part.text }}"
        "{% elif part.type == 'image_url' %}<image>{% endif %}"
        "{% endfor %}{% endif %}")
    for name, obj in (("tokenizer_config.json", {"chat_template": tpl}),
                      ("generation_config.json",
                       {"eos_token_id": [tok.token_to_id("<|im_end|>")]}),
                      ("processor_config.json", PROCESSOR)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (load_model(MODEL, repo, max_seq_len=1024),
            jload_model(MODEL, repo, max_seq_len=1024))


def body(content, max_tokens=8, **kw):
    return {"messages": [{"role": "user", "content": content}],
            "model": "m", "max_tokens": max_tokens, "temperature": 0.0,
            **kw}


def chat(w, h, seed=0):
    return [{"type": "text", "text": "describe "},
            {"type": "image_url", "image_url": {"url": png_data_url(
                w, h, seed=seed)}}]


#: (content, rows, cols): unsplit; 3 columns x 2 rows with the thumbnail;
#: 5 x 1, whose markers the reference's Rust processor would drop
IMAGES = {"unsplit": (chat(32, 32), 1, 1), "3x2": (chat(96, 64, 1), 2, 3),
          "5x1": (chat(160, 32, 2), 1, 5)}


def test_loads_the_family_single_stream(both, repo):
    port, _ = both
    assert isinstance(port, Lfm2VLChat)
    assert port.engine.prefix_cache_entries == 0       # as aha_tpu builds it
    assert port.image_processor == PROCESSOR["image_processor"]
    assert port.pos_table.dtype == np.float32
    with pytest.raises(ValueError) as got:
        load_model(MODEL, repo, batch_slots=2)
    with pytest.raises(ValueError) as want:
        jload_model(MODEL, repo, batch_slots=2)
    assert str(got.value) == str(want.value)
    assert cli.model_id_for(repo, cli.DEFAULT_MODEL) == MODEL


@pytest.mark.parametrize("kind", list(IMAGES))
def test_token_expansion_and_inputs_equal_jax(both, kind):
    """get_data: the ids (markers and placeholders for any split grid), the
    packed batch (tiles, then the thumbnail) and its indices."""
    content, rows, cols = IMAGES[kind]
    port, jax_model = both
    b = body(content)
    got = port.get_data(ChatCompletionParameters.model_validate(b))
    want = jax_model.get_data(JParameters.model_validate(b))
    assert got.input_ids == list(want.input_ids)
    assert got.mm.keys() == want.mm.keys()
    for name, a in got.mm.items():
        np.testing.assert_allclose(a, np.asarray(want.mm[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
    n_images = got.mm["pixels"].shape[0]
    assert n_images == (1 if rows * cols == 1 else rows * cols + 1)
    text = port.tokenizer.decode(got.input_ids)
    assert ("<|img_row_1_col_1|>" in text) == (rows * cols > 1)
    assert (f"<|img_row_{rows}_col_{cols}|>" in text) == (rows * cols > 1)
    n_img = got.input_ids.count(port.vl_model.config.image_token_id)
    assert n_img == got.mm["gather"].shape[0]


@pytest.mark.parametrize("content", [IMAGES["unsplit"][0], IMAGES["3x2"][0],
                                     "hello world how are you"],
                         ids=["unsplit", "3x2", "text"])
def test_chat_matches_jax(both, content):
    port, jax_model = both
    b = body(content)
    got = port.generate(ChatCompletionParameters.model_validate(b))
    want = jax_model.generate(JParameters.model_validate(b))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


def test_stream_and_thinking_match_jax(both):
    """The stream's text and reasoning deltas, with enable_thinking on and
    off (the template's think block; in_reasoning as aha_tpu reads it)."""
    port, jax_model = both

    def deltas(chunks):
        chunks = list(chunks)
        return ([(ch.delta.content, ch.delta.reasoning_content)
                 for c in chunks for ch in c.choices],
                (chunks[-1].usage.prompt_tokens,
                 chunks[-1].usage.completion_tokens))

    for thinking in (False, True):
        b = body(chat(48, 40, seed=3), stream=True,
                 enable_thinking=thinking)
        got = port.get_data(ChatCompletionParameters.model_validate(b))
        want = jax_model.get_data(JParameters.model_validate(b))
        assert got.in_reasoning == want.in_reasoning
        assert deltas(port.generate_stream(
            ChatCompletionParameters.model_validate(b))) == \
            deltas(jax_model.generate_stream(JParameters.model_validate(b)))
