"""aha_tpu_torch's served Qwen3-ASR (models/qwen3_asr_served.py) and its
/v1/audio/transcriptions route against aha_tpu's, both loading the same
tiny checkpoint (tests/test_asr.py's repo: the test tokenizer with the
three audio tokens, thinker.* names, a chat template that renders audio
parts) on the CPU: the rendered prompt (marker collapse, the language
suffix) and the prepared chunks (ids exactly, the mel within the
TOL_MEL of test_torch_audio_feats), a chat reply, the long-audio chunking
with MAX_ASR_SECONDS patched small (the same text and usage token
counts), the FireRedVAD hand-off (`asr_vad_res`), and the multipart
route: a WAV upload answered with the JAX server's JSON, the language
code mapped to its name, a missing file 400, an oversized one 413, no
model 503, the temporary file removed."""

import asyncio
import base64
import glob
import os
import tempfile

import numpy as np
import pytest
import torch
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

from aha_tpu.models.fire_red_vad import VadFrameResult as JVadFrameResult
from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.server import app as japp
from aha_tpu_torch.models.fire_red_vad import VadFrameResult
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.server import app as tapp
from aha_tpu_torch.utils.audio import wav_bytes
from tests.test_asr import build_tiny_asr_repo

torch.set_num_threads(1)
MODEL_ID = "Qwen/Qwen3-ASR-0.6B"
#: the mel's agreement (test_torch_audio_feats.TOL_MEL)
TOL_MEL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("asr_tiny"))
    build_tiny_asr_repo(path)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (jload_model(MODEL_ID, repo, max_seq_len=512),
            load_model(MODEL_ID, repo, max_seq_len=512))


def _tone(secs: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * secs)) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _data_url(wav: np.ndarray) -> str:
    return ("data:audio/wav;base64,"
            + base64.b64encode(wav_bytes(wav, 16000)).decode())


def _request(content, **kw):
    body = {"messages": [{"role": "user", "content": content}],
            "model": MODEL_ID, "max_tokens": 8, **kw}
    return body


def _both_params(body):
    from aha_tpu.params import ChatCompletionParameters as JParams

    return (JParams.model_validate(body),
            ChatCompletionParameters.model_validate(body))


@pytest.mark.parametrize("lang, parts", [
    ("english", 1), ("Klingon", 1), (None, 2)])
def test_render_and_prepare_chunks_equal(both, lang, parts):
    jm, tm = both
    audio = {"type": "audio_url", "audio_url": {"url": _data_url(_tone(1.3))}}
    body = _request([audio] * parts + [{"type": "text", "text": "hi"}],
                    **({"metadata": {"language": lang}} if lang else {}))
    jp, tp = _both_params(body)
    assert tm._render(tp) == jm._render(jp)
    if lang == "english":
        assert tm._render(tp).endswith("language English'<asr_text>'")
    got, ref = tm.prepare_chunks(tp), jm.prepare_chunks(jp)
    assert len(got) == len(ref) == parts
    for g, r in zip(got, ref):
        assert g.input_ids == r.input_ids
        assert g.mm["n_out"] == int(r.mm["n_out"])
        np.testing.assert_allclose(g.mm["mel"].numpy(),
                                   np.asarray(r.mm["mel"]), atol=TOL_MEL,
                                   rtol=0)


def test_chat_reply_equal(both):
    jm, tm = both
    body = _request([{"type": "audio_url",
                      "audio_url": {"url": _data_url(_tone(2.0, 1))}}],
                    max_tokens=12)
    jp, tp = _both_params(body)
    got, ref = tm.generate(tp), jm.generate(jp)
    assert got.choices[0].message.content == ref.choices[0].message.content
    assert (got.usage.prompt_tokens, got.usage.completion_tokens) == \
        (ref.usage.prompt_tokens, ref.usage.completion_tokens)


def test_text_only_request_goes_through_the_thinker(both):
    jm, tm = both
    jp, tp = _both_params(_request("hello there"))
    assert [c.input_ids for c in tm.prepare_chunks(tp)] == \
        [c.input_ids for c in jm.prepare_chunks(jp)]
    assert tm.generate(tp).choices[0].message.content == \
        jm.generate(jp).choices[0].message.content


def test_long_audio_chunking_equal(both, monkeypatch):
    """Audio past MAX_ASR_SECONDS (patched to 1 s in both packages) splits
    into 3 chunks, each transcribed: the same text, and usage summed
    over the chunks to the same token counts."""
    import aha_tpu.models.qwen3_asr_served as jserved
    import aha_tpu_torch.models.qwen3_asr_served as tserved

    jm, tm = both
    monkeypatch.setattr(jserved, "MAX_ASR_SECONDS", 1.0)
    monkeypatch.setattr(tserved, "MAX_ASR_SECONDS", 1.0)
    wav = (0.1 * np.random.default_rng(0).standard_normal(16000 * 3)
           ).astype(np.float32)
    body = _request([{"type": "audio_url",
                      "audio_url": {"url": _data_url(wav)}}], max_tokens=4)
    jp, tp = _both_params(body)
    assert len(tm.prepare_chunks(tp)) == len(jm.prepare_chunks(jp)) == 3
    got, ref = tm.generate(tp), jm.generate(jp)
    assert got.choices[0].message.content == ref.choices[0].message.content
    assert (got.usage.prompt_tokens, got.usage.completion_tokens) == \
        (ref.usage.prompt_tokens, ref.usage.completion_tokens)
    one = tm.prepare_chunks(tp)[0]
    assert got.usage.prompt_tokens == 3 * len(one.input_ids)


def test_asr_vad_res(both):
    """A VadFrameResult without speech gives ""; with speech its buffer
    is transcribed through the fixed template, as asr_waveform and as the
    JAX model transcribe it."""
    jm, tm = both
    assert tm.asr_vad_res(VadFrameResult(is_speech=False,
                                         orig_audio=None)) == ""
    assert tm.asr_vad_res(VadFrameResult(is_speech=True,
                                         orig_audio=None)) == ""
    wav = _tone(1.0, 4)
    text = tm.asr_vad_res(VadFrameResult(is_speech=True, orig_audio=wav))
    assert text == tm.asr_waveform(wav)
    assert text == jm.asr_vad_res(JVadFrameResult(is_speech=True,
                                                  orig_audio=wav))


# -- the route -----------------------------------------------------------------


async def _post(mod, model, files=None, fields=(), multipart=True):
    client = TestClient(TestServer(mod.create_app(mod.ServerState(
        model=model))))
    await client.start_server()
    try:
        form = FormData()
        for name, (payload, fname) in (files or {}).items():
            form.add_field(name, payload, filename=fname,
                           content_type="audio/wav")
        for name, value in fields:
            # a content type makes a file-less form multipart too
            form.add_field(name, value, **({"content_type": "text/plain"}
                                           if multipart else {}))
        r = await client.post("/v1/audio/transcriptions", data=form)
        return r.status, await r.json()
    finally:
        await client.close()


def _ask(mod, model, *a, **kw):
    """One multipart POST to a fresh app of `mod` (the port's or the JAX
    package's server module) serving `model`."""
    return asyncio.run(_post(mod, model, *a, **kw))


@pytest.mark.parametrize("lang", ["en", "zh", None])
def test_transcription_json_equal_to_the_jax_server(both, lang):
    jm, tm = both
    files = {"file": (wav_bytes(_tone(1.5, 2), 16000), "tone.wav")}
    fields = [("language", lang)] if lang else []
    fields += [("temperature", "0.0"), ("model", "ignored")]
    got = _ask(tapp, tm, files, fields)
    ref = _ask(japp, jm, files, fields)
    assert got == ref
    assert got[0] == 200 and "<asr_text>" not in got[1]["text"]


def test_the_v1_and_bare_routes_and_a_clean_reply(both):
    """Both paths are routed; the reply's <asr_text> markers are cleaned
    (utils/mod.rs:634) as the reference cleans them."""
    _, tm = both
    paths = {r.resource.canonical for r in
             tapp.create_app().router.routes()}
    assert {"/audio/transcriptions", "/v1/audio/transcriptions"} <= paths
    for text in ("language English<asr_text> hello </asr_text> ",
                 "plain", ""):
        assert tapp.clean_asr_response(text) == \
            japp.clean_asr_response(text)


def test_language_code_maps_to_its_name(both):
    """The route hands the chat request language's name (en → English;
    an unknown code passes through), as the JAX route does."""
    assert tapp.LANGUAGE_NAMES == japp.LANGUAGE_NAMES
    seen = []

    class Recorder:
        entry = both[1].entry

        def generate(self, mes):
            seen.append(mes.metadata_value("language"))
            return both[1].generate(ChatCompletionParameters.model_validate(
                {"messages": [{"role": "user", "content": "x"}],
                 "model": MODEL_ID, "max_tokens": 1}))

    files = {"file": (wav_bytes(_tone(0.5), 16000), "a.wav")}
    for code in ("en", "yue", "xx"):
        assert _ask(tapp, Recorder(), files, [("language", code)])[0] == 200
    assert seen == ["English", "Cantonese", "xx"]


def test_refusals_equal_to_the_jax_server(both, monkeypatch):
    jm, tm = both
    for mod, model in ((tapp, tm), (japp, jm)):
        assert _ask(mod, model, {}, [("language", "en")]) == (400, {"error": {
            "message": "No audio file provided",
            "type": "invalid_request_error"}})
        assert _ask(mod, model, {}, [("language", "en")],
                    multipart=False) == (400, {"error": {
                        "message": "expected multipart form data",
                        "type": "invalid_request_error"}})
        files = {"file": (wav_bytes(_tone(0.5), 16000), "a.wav")}
        assert _ask(mod, None, files) == (503, {"error": {
            "message": "Model not initialized", "type": "server_error"}})
        monkeypatch.setattr(mod, "FILE_LIMIT", 1000)
        assert _ask(mod, model, files) == (413, {"error": {
            "message": "file too large", "type": "invalid_request_error"}})
        monkeypatch.undo()


def test_the_upload_is_removed_afterwards(both, tmp_path, monkeypatch):
    _, tm = both
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    files = {"file": (wav_bytes(_tone(0.5), 16000), "a.flac.wav")}
    assert _ask(tapp, tm, files)[0] == 200
    assert glob.glob(os.path.join(str(tmp_path), "*")) == []
