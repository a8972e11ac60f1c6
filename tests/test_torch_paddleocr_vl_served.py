"""The port's served PaddleOCR-VL on a tiny saved repo (the recipe of
tests/test_paddleocr_vl.py: the test tokenizer plus <|IMAGE_START|>,
<|IMAGE_PLACEHOLDER|>, <|IMAGE_END|>, a chat template that renders image
parts, use_bias, a preprocessor_config.json with its pixel bounds and
mean / std; seeded weights written by save_hf_paddleocr_vl), loaded
through both packages' load_model: PNG data-URL OCR chats (one image, two
images in one request) and a text-only chat give aha_tpu's greedy text and
prompt-token count, as does the stream of an OCR chat; the request's inputs
(ids with one placeholder a merge unit, the padded patches and indices,
the rope ids) equal aha_tpu's; the loader builds one stream without a
prefix store and refuses slots with the reference's words; `run` of the
directory (model type paddleocr_vl) reads an image with the family's task
prompt.  float32 on the CPU."""

import base64
import json
import os

import numpy as np
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu_torch import cli
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.paddleocr_vl_served import PaddleOCRVLChat
from aha_tpu_torch.params import ChatCompletionParameters
from tests.fixtures import CHAT_TEMPLATE, build_tokenizer
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
MODEL = "PaddlePaddle/PaddleOCR-VL"
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=56, patch_size=14,
              spatial_merge_size=2)
TEMPLATE_PARTS = (
    "{% if message.content is string %}{{ message.content }}"
    "{% else %}{% for part in message.content %}"
    "{% if part.type == 'text' %}{{ part.text }}"
    "{% elif part.type == 'image_url' %}"
    "<|IMAGE_START|><|IMAGE_PLACEHOLDER|><|IMAGE_END|>{% endif %}"
    "{% endfor %}{% endif %}")
#: the resize bounds and normalization the repo's preprocessor gives
PREPROCESSOR = {"min_pixels": 28 * 28, "max_pixels": 28 * 28 * 24,
                "image_mean": [0.4, 0.4, 0.4], "image_std": [0.3, 0.3, 0.3]}


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


def write_repo(path: str) -> None:
    """A servable tiny PaddleOCR-VL directory from seeded weights."""
    from tokenizers import AddedToken

    from aha_tpu_torch.io.weights import save_hf_paddleocr_vl
    from aha_tpu_torch.models.paddleocr_vl import (PaddleOCRVLConfig,
                                                   PaddleOCRVLModel)

    tok = build_tokenizer(path)
    tok.add_special_tokens([AddedToken(t, special=True) for t in
                            ("<|IMAGE_START|>", "<|IMAGE_PLACEHOLDER|>",
                             "<|IMAGE_END|>")])
    tok.save(os.path.join(path, "tokenizer.json"))
    img = tok.token_to_id("<|IMAGE_PLACEHOLDER|>")
    cfg = {"model_type": "paddleocr_vl", "vision_config": VISION,
           "vocab_size": tok.get_vocab_size(), "hidden_size": 48,
           "intermediate_size": 96, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 12, "rope_theta": 500000.0,
           "max_position_embeddings": 4096, "tie_word_embeddings": True,
           "use_bias": True, "rms_norm_eps": 1e-6,
           "rope_scaling": {"mrope_section": [2, 2, 2],
                            "rope_type": "default"},
           "image_token_id": img, "video_token_id": img,
           "vision_start_token_id": tok.token_to_id("<|IMAGE_START|>")}
    for name, d in (("config.json", cfg),
                    ("preprocessor_config.json", PREPROCESSOR),
                    ("generation_config.json",
                     {"eos_token_id": [tok.token_to_id("<|im_end|>")]}),
                    ("tokenizer_config.json", {"chat_template":
                     CHAT_TEMPLATE.replace("{{ message.content }}",
                                           TEMPLATE_PARTS)})):
        with open(os.path.join(path, name), "w") as f:
            json.dump(d, f)
    model = PaddleOCRVLModel(PaddleOCRVLConfig.from_dict(cfg),
                             max_rope_len=256)
    params = model.init_random(torch.Generator().manual_seed(0), scale=0.3)
    # nonzero biases: a dropped one would show
    g = torch.Generator().manual_seed(1)
    for lp in params["visual"]["layers"]:
        lp["q"]["b"] = torch.randn(32, generator=g) * 0.1
        lp["fc1"]["b"] = torch.randn(64, generator=g) * 0.1
    params["text"]["layers"]["o"]["b"] = torch.randn(2, 48, generator=g) * 0.1
    save_hf_paddleocr_vl(params, path)


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("paddle-tiny"))
    write_repo(path)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (load_model(MODEL, repo, max_seq_len=512),
            jload_model(MODEL, repo, max_seq_len=512))


def body(content, max_tokens=8):
    return {"messages": [{"role": "user", "content": content}],
            "model": "m", "max_tokens": max_tokens, "temperature": 0.0}


def both_generate(both, b):
    port, jax_model = both
    return (port.generate(ChatCompletionParameters.model_validate(b)),
            jax_model.generate(JParameters.model_validate(b)))


def image(url):
    return {"type": "image_url", "image_url": {"url": url}}


OCR = [image(png_data_url(84, 56)), {"type": "text", "text": "OCR:"}]
#: two images in one request; the second past max_pixels, resized down
TABLE = [image(png_data_url(64, 64, seed=1)),
         image(png_data_url(300, 200, seed=2)),
         {"type": "text", "text": "Table Recognition:"}]


def test_loads_the_family_single_stream(both, repo):
    port, _ = both
    assert isinstance(port, PaddleOCRVLChat)
    assert port.engine.prefix_cache_entries == 0       # as aha_tpu builds it
    assert port.engine.cache_dtype == torch.float32
    assert port.preprocessor == PREPROCESSOR
    assert "b" in port.engine.params["text"]["layers"]["qkv"]   # use_bias
    with pytest.raises(ValueError) as got:
        load_model(MODEL, repo, batch_slots=2)
    with pytest.raises(ValueError) as want:
        jload_model(MODEL, repo, batch_slots=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("content", [OCR, TABLE, "hello world how are you"],
                         ids=["ocr", "two-images", "text"])
def test_chat_matches_jax(both, content):
    got, want = both_generate(both, body(content))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


@pytest.mark.parametrize("content", [OCR, TABLE], ids=["ocr", "two-images"])
def test_request_inputs_equal_jax(both, content):
    """get_data: the prompt ids (one <|IMAGE_PLACEHOLDER|> a merge unit),
    the padded patches and every grid index, the rope ids and delta."""
    port, jax_model = both
    b = body(content)
    got = port.get_data(ChatCompletionParameters.model_validate(b))
    want = jax_model.get_data(JParameters.model_validate(b))
    assert got.input_ids == list(want.input_ids)
    assert got.mm.keys() == want.mm.keys()
    for name, a in got.mm.items():
        w = want.mm[name]
        if name == "rope_delta":
            assert a == int(w)
        else:
            np.testing.assert_array_equal(a, np.asarray(w),
                                          err_msg=name)
    tok = port.tokenizer
    n_ph = got.input_ids.count(port.vl_model.config.image_token_id)
    n_patches = int((got.mm["seg"] >= 0).sum())
    assert n_ph == n_patches // 4
    if content is TABLE:
        # 64 px → 56 (16 patches); 300 x 200 → past 24 merge units,
        # resized to 168 x 112 (96 patches)
        assert n_patches == 16 + 96
        assert "Table Recognition:" in tok.decode(got.input_ids)


def test_stream_chunks_match_jax(both):
    port, jax_model = both
    b = body(OCR)

    def deltas(chunks):
        chunks = list(chunks)
        return ([(ch.delta.content, ch.delta.reasoning_content)
                 for c in chunks for ch in c.choices],
                (chunks[-1].usage.prompt_tokens,
                 chunks[-1].usage.completion_tokens))

    assert deltas(port.generate_stream(
        ChatCompletionParameters.model_validate(b))) == \
        deltas(jax_model.generate_stream(JParameters.model_validate(b)))


@pytest.mark.parametrize("prompt", [None, "Formula Recognition:"],
                         ids=["default-prompt", "given-prompt"])
def test_run_reads_an_image_with_the_task_prompt(repo, both, capsys,
                                                 tmp_path, prompt):
    """The directory's config.json names paddleocr_vl: `run` serves it as
    PaddlePaddle/PaddleOCR-VL and answers an image with the family's task
    prompt ("OCR:") or the one given after it, as the served model does."""
    assert cli.model_id_for(repo, cli.DEFAULT_MODEL) == MODEL
    path = tmp_path / "page.png"
    path.write_bytes(base64.b64decode(png_data_url(84, 56, seed=5)
                                      .split(",")[1]))
    argv = ["run", repo, "--input", str(path)]
    if prompt:
        argv += ["--input", prompt]
    assert cli.main(argv + ["--max-tokens", "8", "--max-seq-len", "512"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("load model use time: ")
    assert out[-1].startswith("generate use time: ")
    port, _ = both
    want = port.generate(ChatCompletionParameters.model_validate({
        "messages": [{"role": "user", "content": [
            image(f"file://{path}"),
            {"type": "text", "text": prompt or "OCR:"}]}],
        "model": MODEL, "max_tokens": 8}))
    assert "\n".join(out[1:-1]) == want.choices[0].message.text()
