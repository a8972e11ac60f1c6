"""The port's served GLM-OCR on the tiny repo of tests/fixtures.py
(build_tiny_glm_ocr_repo: the test tokenizer, the reference's fixed
prompt ids inside a 59,300-row vocabulary, a 2-block tower and a 2-layer
decoder), loaded through both packages' load_model, float32 on the CPU:
one stream without a prefix store, the reference's refusal of slots;
each request's ids and host inputs equal aha_tpu's; greedy replies and
prompt counts equal aha_tpu's with one or two images, and a text-only
request after them equal to a fresh aha_tpu model's (the port resets the
pooled cache's rope_delta; aha_tpu's GLM prefill reads it);
/v1/chat/completions, streamed and not, answering as aha_tpu's server
does; `run` with the family's default prompt on a checkpoint written by
io/weights.save_hf_glm_ocr; and an image past 9,216 patches refused by
both processors, the port's ValueError naming the limit before anything
reaches the engine."""

import asyncio
import base64
import json

import numpy as np
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu.server import app as japp
from aha_tpu_torch import cli
from aha_tpu_torch.models.glm_ocr import GlmOcrModel
from aha_tpu_torch.models.glm_ocr_served import GlmOcrChat
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.server import app as tapp
from tests.fixtures import build_tiny_glm_ocr_repo
from tests.test_torch_hunyuan_ocr_served import _chat, _deltas
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
MODEL = "ZhipuAI/GLM-OCR"


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("glm-tiny"))
    build_tiny_glm_ocr_repo(path)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (load_model(MODEL, repo, max_seq_len=2048),
            jload_model(MODEL, repo, max_seq_len=2048))


def body(content, max_tokens=6, **kw):
    return {"messages": [{"role": "user", "content": content}],
            "model": MODEL, "max_tokens": max_tokens, "temperature": 0.0,
            **kw}


def image(w, h, seed=0, text="Read the text."):
    return [{"type": "image_url", "image_url": {"url": png_data_url(w, h,
                                                                    seed)}},
            {"type": "text", "text": text}]


REQUESTS = {
    "image": image(60, 90),
    "wide-image": image(100, 60, seed=1),
    "two-images": [*image(90, 60, seed=2, text="a"),
                   *image(60, 60, seed=3, text="b")],
    "image-default-prompt": image(70, 70, seed=4, text=""),
}


def test_loads_one_stream_without_a_prefix_store(both, repo):
    port, jax_model = both
    assert isinstance(port, GlmOcrChat)
    assert isinstance(port.glm_model, GlmOcrModel)
    eng = port.engine
    assert eng.prefix_cache_entries == 0 and eng.cache_dtype == torch.float32
    assert eng.eos_token_ids == set(jax_model.engine.eos_token_ids)
    with pytest.raises(ValueError) as got:
        load_model(MODEL, repo, batch_slots=2)
    with pytest.raises(ValueError) as want:
        jload_model(MODEL, repo, batch_slots=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", list(REQUESTS) + ["text"])
def test_request_inputs_equal_jax(both, name):
    port, jax_model = both
    b = body(REQUESTS.get(name, "hello world how are you"))
    got = port.get_data(ChatCompletionParameters.model_validate(b))
    want = jax_model.get_data(JParameters.model_validate(b))
    assert got.input_ids == list(want.input_ids)
    if name == "text":
        assert got.mm is None and want.mm is None
        return
    mm, jmm = got.mm, {k: np.asarray(v) for k, v in want.mm.items()}
    for k in ("patches", "vis_cos", "vis_sin", "pos_resample", "patch_mask",
              "position_ids"):
        np.testing.assert_array_equal(mm[k], jmm[k], err_msg=k)
    assert mm["rope_delta"] == int(jmm["rope_delta"])
    n_img = got.input_ids.count(port.glm_model.config.image_token_id)
    assert n_img * 4 <= mm["patches"].shape[0]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_reply_matches_jax(both, name):
    port, jax_model = both
    b = body(REQUESTS[name])
    got = port.generate(ChatCompletionParameters.model_validate(b))
    want = jax_model.generate(JParameters.model_validate(b))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


def test_text_reply_after_images_matches_a_fresh_jax_model(both, repo):
    """The port's pooled cache comes back from an image request with its
    rope_delta; a text-only prefill takes plain positions and zeroes it,
    so the reply equals a fresh aha_tpu model's (whose cache holds 0)."""
    port, _ = both
    port.generate(ChatCompletionParameters.model_validate(
        body(REQUESTS["image"])))
    b = body("hello world how are you", max_tokens=8)
    got = port.generate(ChatCompletionParameters.model_validate(b))
    want = jload_model(MODEL, repo, max_seq_len=2048).generate(
        JParameters.model_validate(b))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


@pytest.mark.parametrize("stream", [False, True], ids=["json", "stream"])
def test_chat_completions_equal_the_jax_server(both, stream):
    port, jax_model = both
    b = body(REQUESTS["wide-image"], stream=stream)
    got = asyncio.run(_chat(tapp, port, b))
    want = asyncio.run(_chat(japp, jax_model, b))
    assert got[0] == want[0] == 200
    if stream:
        assert _deltas(got[1]) == _deltas(want[1])
        assert _deltas(got[1])[1] > 0
    else:
        g, w = json.loads(got[1]), json.loads(want[1])
        assert g["choices"][0]["message"] == w["choices"][0]["message"]
        assert g["usage"]["prompt_tokens"] == w["usage"]["prompt_tokens"]


def test_run_uses_the_family_prompt(both, repo, tmp_path, capsys):
    """`run <dir> --model ZhipuAI/GLM-OCR --input page.png` on a checkpoint
    written by save_hf_glm_ocr answers under the JAX CLI's "Text
    Recognition:" as aha_tpu's served model answers that request."""
    from tokenizers import Tokenizer

    from aha_tpu.cli.main import _OCR_PROMPTS as JAX_OCR_PROMPTS
    from aha_tpu_torch.io.weights import save_hf_glm_ocr

    port, _ = both
    prompt = cli._OCR_PROMPTS["glm_ocr"]
    assert prompt == JAX_OCR_PROMPTS["glm_ocr"]
    out = str(tmp_path / "glm")
    with open(f"{repo}/generation_config.json") as f:
        generation = json.load(f)
    save_hf_glm_ocr(port.engine.params, port.glm_model.config,
                    Tokenizer.from_file(f"{repo}/tokenizer.json"), out,
                    generation=generation, preprocessor=port.preprocessor)
    path = tmp_path / "page.png"
    path.write_bytes(base64.b64decode(png_data_url(96, 64, seed=9)
                                      .split(",")[1]))
    assert cli.main(["run", out, "--model", MODEL, "--input", str(path),
                     "--max-tokens", "6", "--max-seq-len", "2048"]) == 0
    lines = capsys.readouterr().out.rstrip("\n").split("\n")
    assert lines[0].startswith("load model use time: ")
    assert lines[-1].startswith("generate use time: ")
    want = jload_model(MODEL, out, max_seq_len=2048).generate(
        JParameters.model_validate({
            "messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": f"file://{path}"}},
                {"type": "text", "text": prompt}]}],
            "model": MODEL, "max_tokens": 6}))
    assert "\n".join(lines[1:-1]) == want.choices[0].message.text()


def test_oversize_image_is_refused_before_the_engine(both, monkeypatch):
    """1400 x 1400 px under the default pixel budget: 100 x 100 = 10,000
    patches past the largest bucket (9,216).  aha_tpu's padding fails with
    a ValueError; the port's processor raises one naming the count and
    the limit, and the engine is never called."""
    port, jax_model = both
    b = body(image(1400, 1400, seed=5))
    big = {"size": {"shortest_edge": 12544, "longest_edge": 9633792}}
    monkeypatch.setattr(port, "preprocessor", {**port.preprocessor, **big})
    monkeypatch.setattr(jax_model, "preprocessor",
                        {**jax_model.preprocessor, **big})
    with pytest.raises(ValueError):
        jax_model.get_data(JParameters.model_validate(b))

    def never(*a, **kw):
        raise AssertionError("the engine was called")

    for name in ("stream_tokens", "generate_tokens"):
        monkeypatch.setattr(port.engine, name, never)
    with pytest.raises(ValueError, match="10000 patches.*9216"):
        port.generate(ChatCompletionParameters.model_validate(b))
