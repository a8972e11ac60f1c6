"""Audio features: STFT, mel filterbank, whisper log-mel (counterpart of
aha_tpu/ops/audio_feats.py).

`whisper_log_mel` runs in torch on the waveform's device with the JAX
function's framing copied step by step rather than `torch.stft`'s
defaults: reflect pad of n_fft/2, an explicit (frames, n_fft) gather, the
periodic Hann window, `torch.fft.rfft` of the float32 frames, the power
spectrum with its last frame dropped, the Slaney-scale Slaney-normed mel
bank, log10 floored at 1e-10 and clamped to (max - 8) over the whole
input (pad frames included), then (x + 4) / 4 — the HF
WhisperFeatureExtractor's numbers.  The filter banks are float32 numpy
tables built once per geometry.

`sinusoidal_pe_cat` and the Kaldi-compliance `kaldi_fbank` / `apply_lfr`
(Fun-ASR's and FireRedVAD's frontend) are host numpy, as in the JAX
package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    # periodic hann, as torch.hann_window(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    safe = np.maximum(freq, 1e-10)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) * logstep, mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)


@lru_cache(maxsize=8)
def mel_filter_bank(num_freq_bins: int, num_mel_bins: int, min_hz: float,
                    max_hz: float, sample_rate: int,
                    norm_slaney: bool = True) -> np.ndarray:
    """(num_freq_bins, num_mel_bins) triangular filters — HF
    transformers.audio_utils.mel_filter_bank with mel_scale='slaney'."""
    fft_freqs = np.linspace(0, sample_rate / 2, num_freq_bins)
    mel_min = _hz_to_mel_slaney(min_hz)
    mel_max = _hz_to_mel_slaney(max_hz)
    mel_pts = np.linspace(mel_min, mel_max, num_mel_bins + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm_slaney:
        enorm = 2.0 / (hz_pts[2:num_mel_bins + 2] - hz_pts[:num_mel_bins])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def stft_power(waveform: torch.Tensor, n_fft: int, hop_length: int,
               window: torch.Tensor, center: bool = True) -> torch.Tensor:
    """(B, T) → (B, n_frames, n_fft//2 + 1) power spectrum."""
    if center:
        pad = n_fft // 2
        waveform = torch.nn.functional.pad(waveform[:, None], (pad, pad),
                                           mode="reflect")[:, 0]
    T = waveform.shape[-1]
    n_frames = (T - n_fft) // hop_length + 1
    idx = (torch.arange(n_frames, device=waveform.device)[:, None]
           * hop_length
           + torch.arange(n_fft, device=waveform.device)[None, :])
    frames = waveform[:, idx] * window[None, None, :]
    spec = torch.fft.rfft(frames.float(), dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def whisper_log_mel(waveform: torch.Tensor, n_fft: int = 400,
                    hop_length: int = 160, num_mel_bins: int = 128,
                    sample_rate: int = 16000) -> torch.Tensor:
    """(B, T) float32 → (B, num_mel_bins, n_frames) whisper log-mel on the
    waveform's device; the final STFT frame is dropped like HF / the
    reference (feature_extraction_whisper.rs:102-106).  Callers pad
    waveforms to bucketed lengths."""
    dev = waveform.device
    waveform = waveform.float()
    window = torch.from_numpy(hann_window(n_fft).astype(np.float32)).to(dev)
    power = stft_power(waveform, n_fft, hop_length, window)  # (B, F, bins)
    power = power[:, :-1, :]
    fb = torch.from_numpy(mel_filter_bank(n_fft // 2 + 1, num_mel_bins, 0.0,
                                          8000.0, sample_rate)).to(dev)
    mel = torch.einsum("bfk,km->bmf", power, fb)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, max_val)
    return (log_spec + 4.0) / 4.0


def sinusoidal_pe_cat(seq_len: int, dim: int, offset: int = 0,
                      theta: float = 10000.0) -> np.ndarray:
    """(seq_len, dim): [sin | cos] concat PE (sinusoidal_pe.rs:22-50)."""
    half = dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    pos = np.arange(offset, offset + seq_len, dtype=np.float64)[:, None]
    freqs = pos * inv_freq[None, :]
    return np.concatenate([np.sin(freqs), np.cos(freqs)], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Kaldi-compliance fbank + LFR (Fun-ASR frontend; audio_utils.rs:1349-1406)
# ---------------------------------------------------------------------------


def _povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def _hz_to_mel_kaldi(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def kaldi_mel_banks(num_bins: int, padded_window: int, sample_rate: float,
                    low_freq: float = 20.0, high_freq: float = 0.0
                    ) -> np.ndarray:
    """(padded_window//2, num_bins) kaldi triangular mel filters (unnormed)."""
    if high_freq <= 0.0:
        high_freq += sample_rate / 2
    n_fft_bins = padded_window // 2
    fft_bin_width = sample_rate / padded_window
    mel_lo = _hz_to_mel_kaldi(low_freq)
    mel_hi = _hz_to_mel_kaldi(high_freq)
    mel_delta = (mel_hi - mel_lo) / (num_bins + 1)
    bin_mels = _hz_to_mel_kaldi(np.arange(n_fft_bins) * fft_bin_width)
    left = mel_lo + np.arange(num_bins) * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_mels[:, None] - left[None]) / mel_delta
    down = (right[None] - bin_mels[:, None]) / mel_delta
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def kaldi_fbank(waveform: np.ndarray, num_mel_bins: int = 80,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                sample_rate: int = 16000, preemphasis: float = 0.97,
                dither: float = 0.0) -> np.ndarray:
    """(T,) float waveform → (n_frames, num_mel_bins) log-mel, kaldi
    compliance (snip_edges, remove_dc, povey window, power spectrum).
    Input is scaled to int16 range like the reference (processor.rs:60)."""
    x = waveform.astype(np.float32) * 32768.0
    shift = int(sample_rate * frame_shift_ms / 1000)
    size = int(sample_rate * frame_length_ms / 1000)
    padded = 1 << (size - 1).bit_length()
    if len(x) < size:
        x = np.pad(x, (0, size - len(x)))
    n = 1 + (len(x) - size) // shift
    idx = np.arange(n)[:, None] * shift + np.arange(size)[None]
    frames = x[idx]
    if dither:
        frames = frames + np.random.randn(*frames.shape).astype(np.float32) * dither
    frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        first = frames[:, :1] - preemphasis * frames[:, :1]
        rest = frames[:, 1:] - preemphasis * frames[:, :-1]
        frames = np.concatenate([first, rest], axis=1)
    frames = frames * _povey_window(size)[None]
    frames = np.pad(frames, ((0, 0), (0, padded - size)))
    spec = np.fft.rfft(frames, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :padded // 2]
    fb = kaldi_mel_banks(num_mel_bins, padded, float(sample_rate))
    mel = power.astype(np.float32) @ fb
    return np.log(np.maximum(mel, 1.1920929e-7)).astype(np.float32)


def apply_lfr(feats: np.ndarray, lfr_m: int = 7, lfr_n: int = 6
              ) -> np.ndarray:
    """Low frame rate stacking (audio_utils.rs:1381-1406): stack lfr_m
    frames every lfr_n, left-padded by replicating the first frame."""
    t, d = feats.shape
    t_lfr = int(np.ceil(t / lfr_n))
    left = np.repeat(feats[:1], (lfr_m - 1) // 2, axis=0)
    x = np.concatenate([left, feats], axis=0)
    need = (t_lfr - 1) * lfr_n + lfr_m
    if x.shape[0] < need:
        x = np.concatenate(
            [x, np.repeat(x[-1:], need - x.shape[0], axis=0)], axis=0)
    out = np.stack([x[i * lfr_n:i * lfr_n + lfr_m].reshape(-1)
                    for i in range(t_lfr)])
    return out.astype(np.float32)
