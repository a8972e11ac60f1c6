"""The port's served HunyuanOCR on the tiny repo of tests/fixtures.py
(build_tiny_hunyuan_ocr_repo: the test tokenizer with the two
placeholder tokens, a text-parts chat template, a 2-block tower and a
2-layer decoder), loaded through both packages' load_model, float32 on
the CPU: one stream without a prefix store, the reference's refusal of
slots; each request's ids and host inputs equal aha_tpu's (the port's
two 1-D position weights against its dense resample matrix); greedy
replies and prompt counts equal aha_tpu's, text-only and with one or two
images; /v1/chat/completions, streamed and not, answering as aha_tpu's
server does; `run` with the family's default prompt (a repo written by
io/weights.save_hf_hunyuan_ocr, whose template places the image marker);
and an image past 9,216 patches refused by both processors, the port's
ValueError naming the limit before anything reaches the engine."""

import asyncio
import base64
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu.server import app as japp
from aha_tpu_torch import cli
from aha_tpu_torch.models.hunyuan_ocr import HunyuanOCRModel
from aha_tpu_torch.models.hunyuan_ocr_served import (IMAGE_TOKEN,
                                                     HunyuanOCRChat)
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.server import app as tapp
from tests.fixtures import build_tiny_hunyuan_ocr_repo
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
MODEL = "Tencent-Hunyuan/HunyuanOCR"


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hy-tiny"))
    build_tiny_hunyuan_ocr_repo(path)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (load_model(MODEL, repo, max_seq_len=2048),
            jload_model(MODEL, repo, max_seq_len=2048))


def body(content, max_tokens=6, **kw):
    return {"messages": [{"role": "user", "content": content}],
            "model": MODEL, "max_tokens": max_tokens, **kw}


def image(w, h, seed=0, text=f"{IMAGE_TOKEN}Detect text."):
    return [{"type": "image_url", "image_url": {"url": png_data_url(w, h,
                                                                    seed)}},
            {"type": "text", "text": text}]


REQUESTS = {
    "text": "hello world how are you",
    "image": image(120, 80),
    "tall-image": image(50, 130, seed=1),
    "two-images": [*image(90, 60, seed=2, text=f"a {IMAGE_TOKEN}"),
                   *image(60, 90, seed=3, text=f" b {IMAGE_TOKEN} c")],
}


def test_loads_one_stream_without_a_prefix_store(both, repo):
    port, jax_model = both
    assert isinstance(port, HunyuanOCRChat)
    assert isinstance(port.hy_model, HunyuanOCRModel)
    eng = port.engine
    assert eng.prefix_cache_entries == 0 and eng.cache_dtype == torch.float32
    assert eng.eos_token_ids == set(jax_model.engine.eos_token_ids)
    assert port.generation_config == jax_model.generation_config
    with pytest.raises(ValueError) as got:
        load_model(MODEL, repo, batch_slots=2)
    with pytest.raises(ValueError) as want:
        jload_model(MODEL, repo, batch_slots=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", [n for n in REQUESTS if n != "text"])
def test_request_inputs_equal_jax(both, name):
    port, jax_model = both
    b = body(REQUESTS[name])
    got = port.get_data(ChatCompletionParameters.model_validate(b))
    want = jax_model.get_data(JParameters.model_validate(b))
    assert got.input_ids == list(want.input_ids)
    mm, jmm = got.mm, {k: np.asarray(v) for k, v in want.mm.items()}
    for k in ("patches", "patch_mask", "unit_gather", "token_gather",
              "position_ids"):
        np.testing.assert_array_equal(mm[k], jmm[k], err_msg=k)
    # the separable weights' outer products are the dense matrix's rows
    g = port.hy_model.config.vision.table_grid
    rows, oh, ow = [], 0, 0
    for (t, gh, gw) in mm["grids"]:
        wh = mm["pos_wh"][oh:oh + gh]
        ww = mm["pos_ww"][ow:ow + gw]
        rows += [np.einsum("hi,wj->hwij", wh, ww).reshape(gh * gw, g * g)] * t
        oh, ow = oh + gh, ow + gw
    rows = np.concatenate(rows)
    np.testing.assert_allclose(rows, jmm["pos_resample"][:len(rows)],
                               rtol=0, atol=1e-7)
    assert not jmm["pos_resample"][len(rows):].any()
    n_tok = sum((gh // 2) * (gw // 2 + 1) + 2 for _, gh, gw in mm["grids"])
    assert got.input_ids.count(port.hy_model.config.image_token_id) == n_tok


@pytest.mark.parametrize("name", list(REQUESTS))
def test_reply_matches_jax(both, name):
    """Greedy by the generation config (temperature 0, top_k 1)."""
    port, jax_model = both
    b = body(REQUESTS[name])
    got = port.generate(ChatCompletionParameters.model_validate(b))
    want = jax_model.generate(JParameters.model_validate(b))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


async def _chat(mod, model, b):
    client = TestClient(TestServer(mod.create_app(mod.ServerState(
        model=model))))
    await client.start_server()
    try:
        r = await client.post("/v1/chat/completions", json=b)
        return r.status, await r.text()
    finally:
        await client.close()


def _deltas(text: str) -> tuple[str, int]:
    """A stream's content deltas joined, and its usage chunk's completion
    tokens."""
    out, n = [], 0
    for line in text.splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            chunk = json.loads(line[6:])
            for c in chunk.get("choices", []):
                out.append(c["delta"].get("content") or "")
            if chunk.get("usage"):
                n = chunk["usage"]["completion_tokens"]
    return "".join(out), n


@pytest.mark.parametrize("stream", [False, True], ids=["json", "stream"])
def test_chat_completions_equal_the_jax_server(both, stream):
    port, jax_model = both
    b = body(REQUESTS["image"], stream=stream)
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
    """`run <dir> --model HunyuanOCR --input page.png` on a checkpoint
    written by save_hf_hunyuan_ocr (its template places the image marker)
    answers under the JAX CLI's Hunyuan prompt as aha_tpu's served model
    answers that request."""
    from tokenizers import Tokenizer

    from aha_tpu.cli.main import _OCR_PROMPTS as JAX_OCR_PROMPTS
    from aha_tpu_torch.io.weights import save_hf_hunyuan_ocr

    port, _ = both
    prompt = cli._OCR_PROMPTS["hunyuan_ocr"]
    assert prompt == JAX_OCR_PROMPTS["hunyuan_ocr"]
    src = port.engine.params
    out = str(tmp_path / "hy")
    tok = Tokenizer.from_file(f"{repo}/tokenizer.json")
    save_hf_hunyuan_ocr(src, port.hy_model.config, tok, out,
                        generation=port.generation_config,
                        preprocessor=port.preprocessor)
    path = tmp_path / "page.png"
    path.write_bytes(base64.b64decode(png_data_url(96, 64, seed=9)
                                      .split(",")[1]))
    assert cli.main(["run", out, "--model", MODEL, "--input", str(path),
                     "--max-tokens", "6", "--max-seq-len", "2048"]) == 0
    lines = capsys.readouterr().out.rstrip("\n").split("\n")
    assert lines[0].startswith("load model use time: ")
    assert lines[-1].startswith("generate use time: ")
    want = jload_model(MODEL, out, max_seq_len=2048).generate(
        JParameters.model_validate(body([
            {"type": "image_url", "image_url": {"url": f"file://{path}"}},
            {"type": "text", "text": prompt}], max_tokens=6)))
    assert "\n".join(lines[1:-1]) == want.choices[0].message.text()
    assert want.usage.prompt_tokens > 6 + 8


def test_oversize_image_is_refused_before_the_engine(both, monkeypatch):
    """1700 x 1600 px under a max_pixels that lets it through: 106 x 100
    = 10,600 patches past the largest bucket (9,216).  aha_tpu's padding
    fails with a ValueError; the port's processor raises one naming the
    count and the limit, and the engine is never called."""
    port, jax_model = both
    b = body(image(1700, 1600, seed=4))
    big = {"max_pixels": 16384 * 28 * 28}
    monkeypatch.setattr(port, "preprocessor", {**port.preprocessor, **big})
    monkeypatch.setattr(jax_model, "preprocessor",
                        {**jax_model.preprocessor, **big})
    with pytest.raises(ValueError):
        jax_model.get_data(JParameters.model_validate(b))

    def never(*a, **kw):
        raise AssertionError("the engine was called")

    for name in ("stream_tokens", "generate_tokens"):
        monkeypatch.setattr(port.engine, name, never)
    with pytest.raises(ValueError, match="10600 patches.*9216"):
        port.generate(ChatCompletionParameters.model_validate(b))
