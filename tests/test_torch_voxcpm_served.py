"""aha_tpu_torch's served VoxCPM (models/voxcpm_served.py), its
/audio/speech route and `run` of a tts model against aha_tpu's on the CPU,
both loading the tiny repo tests/test_voxcpm.py writes (pytorch_model.bin,
a weight-normed audiovae.pth, a char-level tokenizer): the loaded
parameters, a generate's audio part decoded to samples given the noise
the JAX loop draws, the v1 prompt-wav refusal, the stream refusal, the
route's JSON against the JAX server's, its 400 / 500 / 503, the CLI's WAV,
and io/weights.save_hf_voxcpm read back by the loader."""

import asyncio
import base64
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.server import app as japp
from aha_tpu_torch import cli
from aha_tpu_torch.io.weights import save_hf_voxcpm
from aha_tpu_torch.models.base import UnsupportedOperation
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.voxcpm_served import VoxCPMServed
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.server import app as tapp
from aha_tpu_torch.utils.audio import load_wav_bytes
from tests.test_voxcpm import TINY_CFG, _build_tiny_repo

torch.set_num_threads(1)
MODEL_ID = "OpenBMB/VoxCPM-0.5B"
#: the waveform's agreement, max abs error relative to max |ref| (the
#: patch loop's latents through the VAE decode, float32 on both sides)
TOL_WAV = 1e-4
#: a 16-bit sample's step, which an f32 difference can flip the rounding of
LSB = 1.0 / 32767.0


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    # the directory's name is the served model's: no "2" in it, so v1
    path = os.path.join(str(tmp_path_factory.mktemp("vox")), "VoxCPM-0.5B")
    os.makedirs(path)
    params, vae_params = _build_tiny_repo(path)
    return path, params, vae_params


@pytest.fixture(scope="module")
def both(repo):
    path = repo[0]
    return (jload_model(MODEL_ID, path, max_seq_len=512),
            load_model(MODEL_ID, path, max_seq_len=512))


def _leaves(tree) -> list:
    """A tree's leaves, dict keys in sorted order (jax.tree's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(a, b, rtol=1e-5, atol=1e-6):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a.reshape(np.shape(b)), np.asarray(b),
                               rtol=rtol, atol=atol)


def test_load_matches_the_written_weights(repo, both):
    """The port loads the repo's weights (the weight norms folded) as the
    JAX package wrote them."""
    _, params, vae_params = repo
    tm = both[1]
    assert isinstance(tm, VoxCPMServed)
    assert tm.params["base_lm"]["layers"][0]["q"]["w"].dtype == torch.float32
    for want, tree in ((params, tm.params), (vae_params, tm.vae_params)):
        got, ref = _leaves(tree), _leaves(jax.tree.map(np.asarray, want))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close(a, b)


def _jax_noise(jm, seed: int, n: int) -> list:
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    shape = (1, jm.model.latent_dim, jm.config.patch_size)
    return [np.asarray(jax.random.normal(keys[i], shape)) for i in range(n)]


def _with_noise(monkeypatch, tm, noise):
    """Make the port's patch loop take `noise` instead of its own draws."""
    real = tm.model.inference
    monkeypatch.setattr(tm.model, "inference",
                        lambda *a, **k: real(*a, **{**k, "noise": noise}))


def _body(text="hi", **md):
    meta = {"max_len": "3", "min_len": "1", "inference_timesteps": "2",
            **md}
    return {"messages": [{"role": "user", "content": text}],
            "model": MODEL_ID, "metadata": meta}


def _samples(resp: dict) -> np.ndarray:
    part = resp["choices"][0]["message"]["content"][0]
    assert part["type"] == "audio"
    url = part["audio_url"]["url"]
    assert url.startswith("data:audio/wav;base64,")
    wav, rate = load_wav_bytes(base64.b64decode(url.split(",", 1)[1]))
    assert rate == 16000
    return wav


def _assert_same_audio(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape and len(ref) > 0
    tol = TOL_WAV * np.abs(ref).max() + LSB
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("text,prompt_text,prompt_wav", [
    ("hi", None, False), ("hello", None, False), ("hello", "ab", True)])
def test_synthesize_matches_given_jax_noise(both, tmp_path, text,
                                            prompt_text, prompt_wav):
    """synthesize's waveform, with and without a voice prompt (a WAV
    encoded by each side's VAE, padded left to whole patches)."""
    from aha_tpu_torch.utils.audio import save_wav

    jm, tm = both
    wav = None
    if prompt_wav:
        wav = str(tmp_path / "prompt.wav")
        t = np.arange(101) / 16000
        save_wav(wav, (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32),
                 16000)
    n = 4
    ref = jm.synthesize(text, prompt_text, wav, min_len=1, max_len=n,
                        inference_timesteps=3, seed=5)
    got = tm.synthesize(text, prompt_text, wav, min_len=1, max_len=n,
                        inference_timesteps=3, noise=_jax_noise(jm, 5, n))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL_WAV * np.abs(ref).max()


def test_generate_audio_part_matches(both, monkeypatch):
    """generate's single audio part, its WAV decoded to samples, equal to
    the JAX model's given the noise the JAX loop draws from seed 0."""
    jm, tm = both
    _with_noise(monkeypatch, tm, _jax_noise(jm, 0, 3))
    from aha_tpu.params import ChatCompletionParameters as JParams

    got = tm.generate(ChatCompletionParameters.model_validate(_body()))
    ref = jm.generate(JParams.model_validate(_body()))
    assert got.model == ref.model == "VoxCPM-0.5B"
    assert len(got.choices[0].message.content) == 1
    _assert_same_audio(_samples(got.to_json_dict()),
                       _samples(ref.to_json_dict()))


def test_v1_refuses_a_prompt_wav_without_prompt_text(both):
    _, tm = both
    body = _body()
    body["messages"][0]["content"] = [
        {"type": "text", "text": "hi"},
        {"type": "audio_url", "audio_url": {"url": "x.wav"}}]
    with pytest.raises(UnsupportedOperation,
                       match="reference mode is only supported with "
                             "VoxCPM2 models"):
        tm.generate(ChatCompletionParameters.model_validate(body))


def test_stream_is_refused(both):
    _, tm = both
    with pytest.raises(UnsupportedOperation,
                       match="VoxCPM-0.5B model not support stream"):
        tm.generate_stream(ChatCompletionParameters.model_validate(_body()))


async def _post_json(mod, model, path, body):
    client = TestClient(TestServer(mod.create_app(mod.ServerState(
        model=model))))
    await client.start_server()
    try:
        kw = {"data": body} if isinstance(body, str) else {"json": body}
        r = await client.post(path, **kw)
        return r.status, r.content_type, await r.text()
    finally:
        await client.close()


def _ask(mod, model, body, path="/audio/speech"):
    return asyncio.run(_post_json(mod, model, path, body))


def test_speech_route_json_matches_the_jax_server(both, monkeypatch):
    jm, tm = both
    _with_noise(monkeypatch, tm, _jax_noise(jm, 0, 3))
    got = _ask(tapp, tm, _body())
    ref = _ask(japp, jm, _body())
    assert got[:2] == ref[:2] == (200, "text/plain")
    g, r = json.loads(got[2]), json.loads(ref[2])
    assert set(g) == set(r)
    assert (g["object"], g["model"]) == (r["object"], r["model"])
    assert g["choices"][0]["message"]["role"] == "assistant"
    _assert_same_audio(_samples(g), _samples(r))


def test_speech_route_refusals_match_the_jax_server(both):
    jm, tm = both
    bad_wav = _body()
    bad_wav["messages"][0]["content"] = [
        {"type": "text", "text": "hi"},
        {"type": "audio_url", "audio_url": {"url": "x.wav"}}]
    for mod, model in ((tapp, tm), (japp, jm)):
        assert _ask(mod, None, _body()) == (503, "text/plain",
                                            "model not init")
        status, _, text = _ask(mod, model, "{not json")
        assert status == 400 and text.startswith("invalid request: ")
        assert _ask(mod, model, {"model": "x"})[0] == 400
        assert _ask(mod, model, bad_wav) == (
            500, "text/plain",
            "reference mode is only supported with VoxCPM2 models")
    paths = {r.resource.canonical for r in tapp.create_app().router.routes()}
    assert {"/audio/speech", "/images/remove_background"} <= paths


def test_run_writes_the_synthesized_wav(repo, both, tmp_path, capsys):
    """`run` of a tts model: the first input's speech as a 16-bit WAV at
    the VAE's rate, the samples synthesize gives in-process."""
    _, tm = both
    out = str(tmp_path / "x.wav")
    assert cli.main(["run", repo[0], "--model", MODEL_ID, "--input", "hi",
                     "--output", out]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("load model use time: ")
    assert lines[1] == f"Output saved to: {out}"
    assert lines[-1].startswith("generate use time: ")
    with open(out, "rb") as f:
        wav, rate = load_wav_bytes(f.read())
    assert rate == tm.vae.out_sample_rate
    want = np.clip(tm.synthesize("hi"), -1, 1)
    assert wav.shape == want.shape
    assert np.abs(wav - want).max() <= LSB


def test_saver_writes_what_the_loader_reads(repo, both, tmp_path):
    """io/weights.save_hf_voxcpm: the served model's parameters as
    config.json, pytorch_model.bin and audiovae.pth, loaded back equal
    (the VAE's weight norms split and folded again)."""
    _, tm = both
    path = str(tmp_path / "VoxCPM-0.5B")
    save_hf_voxcpm(tm.params, tm.vae_params, TINY_CFG, path)
    shutil.copy(os.path.join(repo[0], "tokenizer.json"), path)
    back = load_model(MODEL_ID, path)
    for a, b in ((tm.params, back.params), (tm.vae_params, back.vae_params)):
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
