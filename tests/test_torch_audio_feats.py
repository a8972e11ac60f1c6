"""The port's audio features (aha_tpu_torch/ops/audio_feats.py) against
aha_tpu/ops/audio_feats.py on the same seeded waveforms: the whisper
log-mel in torch against the JAX function at 1 s and at a padded frame
bucket (tolerance stated below: the two FFTs differ by float32 rounding,
which log10 magnifies near the 1e-10 floor), the mel filter bank and the
concatenated sinusoidal PE exactly equal, and the host Kaldi fbank and
LFR stacking bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops import audio_feats as J
from aha_tpu_torch.ops import audio_feats as T

#: log-mel agreement, absolute on whisper's (x + 4) / 4 scale (measured
#: ≈ 4e-6 at 1 s and at the 3,200-frame bucket)
TOL_MEL = 1e-4


def _wave(n: int, seed: int, real: int | None = None) -> np.ndarray:
    w = (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(
        np.float32)
    if real is not None:
        w[real:] = 0.0                  # a waveform padded to its bucket
    return w


@pytest.mark.parametrize("n, real", [(16000, None), (3200 * 160, 30000),
                                     (200 * 160, 16000)],
                         ids=["1s", "bucket3200", "bucket200"])
def test_whisper_log_mel_matches_jax(n, real):
    wav = _wave(n, seed=n % 97, real=real)
    ref = np.asarray(J.whisper_log_mel(jnp.asarray(wav)[None]))
    got = T.whisper_log_mel(torch.from_numpy(wav)[None]).numpy()
    assert got.shape == ref.shape == (1, 128, n // 160)
    np.testing.assert_allclose(got, ref, atol=TOL_MEL, rtol=0)


def test_whisper_log_mel_batch_and_bins():
    """A batch of windows (GLM-ASR's layout) at 80 bins: each row as the
    JAX function's, and each row as the port's batch of one (the max − 8
    clamp is over a row's own frames)."""
    wav = np.stack([_wave(8000, 3), _wave(8000, 4, real=4000)])
    ref = np.asarray(J.whisper_log_mel(jnp.asarray(wav), num_mel_bins=80))
    got = T.whisper_log_mel(torch.from_numpy(wav), num_mel_bins=80).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_MEL, rtol=0)
    one = T.whisper_log_mel(torch.from_numpy(wav[1:]), num_mel_bins=80)
    np.testing.assert_array_equal(one.numpy()[0], got[1])


def test_whisper_log_mel_matches_hf():
    """Both packages' frontend is HF's WhisperFeatureExtractor numbers."""
    from transformers.audio_utils import mel_filter_bank as hf_mel
    from transformers.audio_utils import spectrogram, window_function

    wav = _wave(16000, 0)
    filters = hf_mel(num_frequency_bins=201, num_mel_filters=128,
                     min_frequency=0.0, max_frequency=8000.0,
                     sampling_rate=16000, norm="slaney", mel_scale="slaney")
    ref = spectrogram(wav, window_function(400, "hann"), frame_length=400,
                      hop_length=160, power=2.0, mel_filters=filters,
                      log_mel="log10", mel_floor=1e-10)[:, :-1]
    ref = (np.maximum(ref, ref.max() - 8.0) + 4.0) / 4.0
    got = T.whisper_log_mel(torch.from_numpy(wav)[None]).numpy()[0]
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_mel_filter_bank_and_window_equal():
    np.testing.assert_array_equal(
        T.mel_filter_bank(201, 128, 0.0, 8000.0, 16000),
        J.mel_filter_bank(201, 128, 0.0, 8000.0, 16000))
    np.testing.assert_array_equal(T.hann_window(400), J.hann_window(400))
    np.testing.assert_array_equal(T.kaldi_mel_banks(80, 512, 16000.0),
                                  J.kaldi_mel_banks(80, 512, 16000.0))


@pytest.mark.parametrize("seq, dim, offset", [(13, 896, 0), (4096, 560, 0),
                                              (7, 64, 5)])
def test_sinusoidal_pe_exactly_equal(seq, dim, offset):
    np.testing.assert_array_equal(T.sinusoidal_pe_cat(seq, dim, offset),
                                  J.sinusoidal_pe_cat(seq, dim, offset))


@pytest.mark.parametrize("n", [16000, 48000 + 123, 300])
def test_kaldi_fbank_and_lfr_bit_equal(n):
    wav = _wave(n, seed=n)
    fb = T.kaldi_fbank(wav)
    np.testing.assert_array_equal(fb, J.kaldi_fbank(wav))
    for m, k in ((7, 6), (5, 3)):
        np.testing.assert_array_equal(T.apply_lfr(fb, m, k),
                                      J.apply_lfr(fb, m, k))
    assert T.apply_lfr(fb).shape == (int(np.ceil(len(fb) / 6)), 560)
