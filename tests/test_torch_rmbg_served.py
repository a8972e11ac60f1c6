"""aha_tpu_torch's served RMBG-2.0 (models/rmbg2_0_served.py), its
/images/remove_background route and `run` of an image model against
aha_tpu's on the CPU, both loading tests.fixtures.build_tiny_rmbg_repo's
checkpoint at size 64: the mattes, the RGBA PNGs of two images (RGB
untouched, the alpha within ALPHA_LEVELS of the JAX server's), the route's
JSON, its 400 / 503, the stream refusal, and `run`'s PNG files."""

import asyncio
import base64
import io
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.server import app as japp
from aha_tpu_torch import cli
from aha_tpu_torch.models.base import UnsupportedOperation
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.rmbg2_0_served import RMBG2Served
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.server import app as tapp
from tests.fixtures import build_tiny_rmbg_repo

torch.set_num_threads(1)
MODEL_ID = "AI-ModelScope/RMBG-2.0"
#: the matte's agreement, max abs error relative to max |ref| (float32)
TOL_MATTE = 1e-4
#: alpha levels the PNGs may differ by: the matte's f32 differences can
#: flip its uint8 truncation, and the bicubic resize back spreads that
ALPHA_LEVELS = 2


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rmbg"))
    build_tiny_rmbg_repo(path)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (jload_model(MODEL_ID, repo, size=64),
            load_model(MODEL_ID, repo, size=64))


def _png_url(w: int, h: int, seed: int) -> str:
    img = Image.fromarray((np.random.default_rng(seed).random(
        (h, w, 3)) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


URLS = (_png_url(70, 50, 0), _png_url(40, 90, 1))


def _body(urls=URLS):
    return {"model": MODEL_ID, "messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": u}} for u in urls]}]}


def _decode(url: str) -> np.ndarray:
    assert url.startswith("data:image/png;base64,")
    img = Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1])))
    assert img.mode == "RGBA"
    return np.asarray(img)


def _same_pngs(got: list[np.ndarray], ref: list[np.ndarray]) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g[..., :3], r[..., :3])
        diff = np.abs(g[..., 3].astype(int) - r[..., 3].astype(int))
        assert diff.max() <= ALPHA_LEVELS


def test_matte_matches(both):
    jm, tm = both
    assert isinstance(tm, RMBG2Served) and tm.size == 64
    from aha_tpu.utils.image import load_image as jload_image
    from aha_tpu_torch.utils.image import load_image

    for url in URLS:
        px = tm.pixels(load_image(url))
        jimg = jload_image(url).resize((64, 64), Image.BICUBIC)
        arr = np.asarray(jimg, np.float32) / 255.0
        from aha_tpu.models.rmbg2_0_served import IMAGENET_MEAN, IMAGENET_STD

        ref_px = ((arr - IMAGENET_MEAN) / IMAGENET_STD).transpose(2, 0, 1)
        np.testing.assert_array_equal(px[0].numpy(), ref_px)
        ref = np.asarray(jm._forward(jm.params, ref_px[None]))[0, 0]
        got = tm.matte(px)
        assert np.abs(got - ref).max() <= TOL_MATTE * np.abs(ref).max()


def test_generate_pngs_match(both):
    jm, tm = both
    from aha_tpu.params import ChatCompletionParameters as JParams

    got = tm.generate(ChatCompletionParameters.model_validate(_body()))
    ref = jm.generate(JParams.model_validate(_body()))
    gparts = got.to_json_dict()["choices"][0]["message"]["content"]
    rparts = ref.to_json_dict()["choices"][0]["message"]["content"]
    assert [p["type"] for p in gparts] == ["image", "image"]
    assert got.choices[0].finish_reason == "stop" and got.usage is None
    pngs = [_decode(p["image_url"]["url"]) for p in gparts]
    assert [p.shape for p in pngs] == [(50, 70, 4), (90, 40, 4)]
    _same_pngs(pngs, [_decode(p["image_url"]["url"]) for p in rparts])


def test_stream_is_refused(both):
    _, tm = both
    with pytest.raises(UnsupportedOperation, match="model not support stream"):
        tm.generate_stream(ChatCompletionParameters.model_validate(_body()))


async def _post(mod, model, body):
    client = TestClient(TestServer(mod.create_app(mod.ServerState(
        model=model))))
    await client.start_server()
    try:
        kw = {"data": body} if isinstance(body, str) else {"json": body}
        r = await client.post("/images/remove_background", **kw)
        return r.status, r.content_type, await r.text()
    finally:
        await client.close()


def _ask(mod, model, body):
    return asyncio.run(_post(mod, model, body))


def test_route_json_matches_the_jax_server(both):
    jm, tm = both
    got, ref = _ask(tapp, tm, _body()), _ask(japp, jm, _body())
    assert got[:2] == ref[:2] == (200, "text/plain")
    g, r = json.loads(got[2]), json.loads(ref[2])
    assert set(g) == set(r) and g["model"] == r["model"]
    _same_pngs([_decode(p["image_url"]["url"])
                for p in g["choices"][0]["message"]["content"]],
               [_decode(p["image_url"]["url"])
                for p in r["choices"][0]["message"]["content"]])


def test_route_refusals_match_the_jax_server(both):
    jm, tm = both
    for mod, model in ((tapp, tm), (japp, jm)):
        assert _ask(mod, None, _body()) == (503, "text/plain",
                                            "model not init")
        status, _, text = _ask(mod, model, "{not json")
        assert status == 400 and text.startswith("invalid request: ")


@pytest.mark.parametrize("n", [1, 2])
def test_run_writes_the_pngs(repo, both, tmp_path, capsys, n):
    """`run` of an image model: one PNG per input, the served model's
    bytes; `--output x.png` names one, x_<i>.png several."""
    _, tm = both
    paths = []
    for i, url in enumerate(URLS[:n]):
        p = tmp_path / f"in{i}.png"
        p.write_bytes(base64.b64decode(url.split(",", 1)[1]))
        paths.append(str(p))
    out = str(tmp_path / "x.png")
    argv = ["run", repo, "--model", MODEL_ID, "--output", out]
    for p in paths:
        argv += ["--input", p]
    # the default size is the published 1024; the tiny repo runs at 64
    real = RMBG2Served.load.__func__

    def load64(cls, entry, path, **kw):
        return real(cls, entry, path, **{**kw, "size": 64})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RMBG2Served, "load", classmethod(load64))
        assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    dests = [out] if n == 1 else [str(tmp_path / f"x_{i}.png")
                                  for i in range(n)]
    assert lines[1:-1] == [f"Output saved to: {d}" for d in dests]
    want = tm.remove_background([f"file://{p}" for p in paths])
    for d, w in zip(dests, want):
        with open(d, "rb") as f:
            assert f.read() == w
