"""aha_tpu_torch's FireRedVAD against aha_tpu's on the same parameters
(made in JAX from a seed, carried across with params_from_jax): the FSMN
lookback and lookahead convs, DetectModel's probabilities offline (with
the lookahead) and streaming, the port's frame-by-frame streaming equal
to its one-shot streaming pass (the tolerance the card's check uses),
CMVN, the smoothing, the segments of `detect_waveform` on
assets/audio/sample.wav and of `detect_file`, the `detect_frame` state
machine over a frame sequence, and `FireRedVad.init` from a checkpoint
directory in the reference's names.  float32 on the CPU: probabilities
within TOL_PROBS; decisions, segments and flushed buffers exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models import fire_red_vad as J
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import fire_red_vad as T

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "assets", "audio", "sample.wav")
#: probabilities (port vs JAX, and frame-by-frame vs one-shot streaming)
TOL_PROBS = 1e-5
TINY = dict(idim=8, r=3, m=1, h=16, p=8, n1=4, s1=1, n2=4, s2=1, odim=1)
#: the real frontend's 80 bins, dilated lookback and lookahead
FULL80 = dict(idim=80, r=3, m=2, h=32, p=16, n1=5, s1=2, n2=3, s2=2, odim=1)


def pair(cfg: dict, seed: int, scale: float = 0.2):
    jm = J.DetectModel(J.DetectModelConfig(**cfg))
    jp = jm.init_random(jax.random.PRNGKey(seed), scale=scale)
    tm = T.DetectModel(T.DetectModelConfig(**cfg))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _cmvn(mod):
    """CMVN stats of sample.wav's own fbank (count-normalised sums, as
    cmvn.json holds them), so the detector sees unit-scale features."""
    from aha_tpu_torch.ops.audio_feats import kaldi_fbank

    fb = kaldi_fbank(_sample()).astype(np.float64)
    count = float(len(fb))
    stats = np.stack([np.append(fb.sum(0), count),
                      np.append((fb ** 2).sum(0), count)])
    return mod.CMVN(stats.astype(np.float32))


def test_fsmn_convs_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 3)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    for pad in (3, 6):                   # s1 = 1 and 2
        cache = rng.standard_normal((2, pad, 3)).astype(np.float32)
        ry, rc = J._fsmn_lookback(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(cache))
        gy, gc = T._fsmn_lookback(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(cache))
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry),
                                   atol=TOL_PROBS)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    for s2 in (1, 2):
        np.testing.assert_allclose(
            T._fsmn_lookahead(torch.from_numpy(x), torch.from_numpy(w),
                              s2).numpy(),
            np.asarray(J._fsmn_lookahead(jnp.asarray(x), jnp.asarray(w), s2)),
            atol=TOL_PROBS)


@pytest.mark.parametrize("cfg", [TINY, FULL80, {**TINY, "n2": 0},
                                 {**TINY, "odim": 3}],
                         ids=["offline", "dilated80", "stream", "aed"])
@pytest.mark.parametrize("streaming", [False, True])
def test_detect_model_probs_match_jax(cfg, streaming):
    jm, jp, tm, tp = pair(cfg, seed=2)
    feats = np.random.default_rng(3).standard_normal(
        (1, 24, cfg["idim"])).astype(np.float32)
    ref, rc = jm.forward(jp, jnp.asarray(feats), streaming=streaming)
    got, gc = tm.forward(tp, torch.from_numpy(feats), streaming=streaming)
    assert got.shape == (1, 24, cfg["odim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_PROBS)
    for a, b in zip(gc, rc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_PROBS)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_streaming_equals_offline_streaming_pass(chunk):
    """Frame by frame (or in chunks) through the caches == one streaming
    pass over the whole sequence (the stream configuration, n2 = 0)."""
    _, _, tm, tp = pair({**FULL80, "n2": 0}, seed=4)
    feats = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 30, 80)).astype(np.float32))
    full, _ = tm.forward(tp, feats, streaming=True)
    caches, outs = None, []
    for t in range(0, 30, chunk):
        p, caches = tm.forward(tp, feats[:, t:t + chunk], caches,
                               streaming=True)
        outs.append(p)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=TOL_PROBS)


def test_cmvn_and_features_equal():
    tc, jc = _cmvn(T), _cmvn(J)
    np.testing.assert_array_equal(tc.means, jc.means)
    np.testing.assert_array_equal(tc.inv_std, jc.inv_std)
    wav = np.random.default_rng(6).standard_normal(8000).astype(
        np.float32) * 0.1
    np.testing.assert_array_equal(T.extract_feats(tc, wav),
                                  J.extract_feats(jc, wav))
    with pytest.raises(ValueError):
        T.CMVN(np.zeros((3, 4), np.float32))


@pytest.mark.parametrize("window", [1, 3, 5, 9])
def test_smoothing_and_decisions_equal(window):
    p = np.random.default_rng(window).uniform(0, 1, 40).astype(np.float32)
    np.testing.assert_array_equal(T.smooth_probs(p, window),
                                  J.smooth_probs(p, window))
    cfg = T.FireRedVadConfig(smooth_window_size=window)
    jcfg = J.FireRedVadConfig(smooth_window_size=window)
    tp, jp = T.VadPostprocessor(cfg), J.VadPostprocessor(jcfg)
    np.testing.assert_array_equal(tp.process_thresh(p), jp.process_thresh(p))
    assert tp.process(p, 0.4) == jp.process(p, 0.4)


def _vads(cfg: dict, seed: int, vad_cfg: str = "default_vad",
          speech: float = 0.5):
    """The same seeded detector as both packages' FireRedVad, its output
    bias set so that about a `speech` share of sample.wav's frames lie
    over the threshold."""
    jm, jp, tm, tp = pair(cfg, seed)
    jc, tc = _cmvn(J), _cmvn(T)
    feats = T.extract_feats(tc, _sample())
    logits = torch.logit(tm.forward(tp, torch.from_numpy(feats)[None])[0])
    thr = getattr(T.FireRedVadConfig, vad_cfg)().speech_threshold
    shift = float(torch.logit(torch.tensor(thr))
                  - logits.quantile(1.0 - speech))
    jp["out"]["b"] = jp["out"]["b"] + shift
    tp["out"]["b"] = tp["out"]["b"] + shift
    return (J.FireRedVad(jm, jp, jc, getattr(J.FireRedVadConfig, vad_cfg)(),
                         "VAD"),
            T.FireRedVad(tm, tp, tc, getattr(T.FireRedVadConfig, vad_cfg)(),
                         "VAD"))


def _sample() -> np.ndarray:
    from aha_tpu_torch.utils.audio import load_audio

    return load_audio(SAMPLE)[0]


def test_detect_waveform_segments_equal_on_the_sample():
    jv, tv = _vads(FULL80, seed=7)
    wav = _sample()
    probs_t = tv.frame_probs(wav)[:, 0]
    assert 0 < (probs_t >= 0.4).mean() < 1      # speech and silence both
    ref = jv.detect_waveform(wav)
    got = tv.detect_waveform(wav)
    assert got.dur == ref.dur == pytest.approx(3.0)
    assert got.timestamps == ref.timestamps and got.timestamps
    assert tv.detect_file(SAMPLE).timestamps == \
        jv.detect_file(SAMPLE).timestamps
    # at another rate, resampled to 16 kHz first
    from aha_tpu_torch.utils.audio import resample

    wav8 = resample(wav, 16000, 8000)
    assert tv.detect_waveform(wav8, 8000).timestamps == \
        jv.detect_waveform(wav8, 8000).timestamps


def test_detect_frame_state_machine_equal():
    """The streaming detector fed sample.wav frame by frame (400 samples,
    and a silent stretch to flush): the same flushed buffers at the same
    frames; a short frame raises."""
    jv, tv = _vads({**FULL80, "n2": 0}, seed=9, vad_cfg="default_stream_vad",
                   speech=0.9)
    wav = _sample()
    frames = [wav[i:i + 400] for i in range(0, len(wav) - 400, 400)]
    frames += [np.zeros(400, np.float32)] * 3
    got = [tv.detect_frame(f) for f in frames]
    ref = [jv.detect_frame(f) for f in frames]
    assert [g is None for g in got] == [r is None for r in ref]
    assert sum(g is not None for g in got) == 3     # three flushes
    for g, r in zip(got, ref):
        if g is not None:
            assert g.is_speech and r.is_speech
            np.testing.assert_array_equal(g.orig_audio, r.orig_audio)
    with pytest.raises(ValueError, match="Expected 400 samples"):
        tv.detect_frame(np.zeros(100, np.float32))
    tv.reset()
    assert tv.caches is None and not tv.speech_cache


def test_init_from_a_checkpoint_directory(tmp_path, monkeypatch):
    """A directory in the reference's names (dfsmn.*, out.*, cmvn.json):
    both packages' FireRedVad.init read the same detector; "stream" in the
    name picks the stream configuration."""
    from safetensors.torch import save_file

    jm, jp, tm, tp = pair({**FULL80, "r": 8, "m": 1, "h": 256, "p": 128,
                           "n1": 20, "s1": 1, "n2": 0}, seed=9)
    out = {}

    def lin(name, p, bias=True):
        out[name + ".weight"] = p["w"].t().contiguous()
        if bias:
            out[name + ".bias"] = p["b"]

    def fsmn(name, p):
        out[name + ".lookback_filter.weight"] = \
            p["lookback"].t().contiguous()[:, None, :]

    lin("dfsmn.fc1.0", tp["fc1"])
    lin("dfsmn.fc2.0", tp["fc2"])
    fsmn("dfsmn.fsmn1", tp["fsmn1"])
    for i, bp in enumerate(tp["blocks"]):
        lin(f"dfsmn.fsmns.{i}.fc1.0", bp["fc1"])
        lin(f"dfsmn.fsmns.{i}.fc2", bp["fc2"], bias=False)
        fsmn(f"dfsmn.fsmns.{i}.fsmn", bp["fsmn"])
    for i, dp in enumerate(tp["dnns"]):
        lin(f"dfsmn.dnns.{i}", dp)
    lin("out", tp["out"])
    path = tmp_path / "FireRedVAD-stream"
    path.mkdir()
    save_file(out, str(path / "model.safetensors"))
    cm = _cmvn(T)
    stats = np.stack([np.append(cm.means * 10, 10.0),
                      np.append((1 / cm.inv_std ** 2 + cm.means ** 2) * 10,
                                10.0)])
    (path / "cmvn.json").write_text(json.dumps({"cmvn": stats.tolist()}))
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    tv = T.FireRedVad.init(str(path))
    jv = J.FireRedVad.init(str(path))
    assert tv.cfg == T.FireRedVadConfig.default_stream_vad()
    assert tv.model.config == T.DetectModelConfig.default_stream_vad()
    wav = _sample()
    np.testing.assert_allclose(tv.frame_probs(wav),
                               np.asarray(jv.model.forward(
                                   jv.params, jnp.asarray(
                                       J.extract_feats(jv.cmvn, wav)[None]))[0]
                               )[0], atol=TOL_PROBS)
