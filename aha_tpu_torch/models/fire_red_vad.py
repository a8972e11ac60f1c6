"""FireRedVAD: FSMN voice-activity detection, the auxiliary model feeding
ASR (counterpart of aha_tpu/models/fire_red_vad.py).

Parity with src/models/fire_red_vad:
- DetectModel (model.rs:261-294): the DFSMN stack — fc1 (relu) → fc2
  (relu) → fsmn1 → (r−1)×[fc1 (relu) → fc2 (no bias) → fsmn → +residual] →
  m dnn (relu) → out linear → sigmoid;
- the FSMN memory (model.rs:13-146): a depthwise causal lookback conv
  (kernel n1, dilation s1) plus, offline only, a strictly-future
  lookahead conv (kernel n2, dilation s2); streaming keeps the last
  (n1−1)·s1 frames of the conv input as a fixed-shape cache, zeros at
  first;
- the frontend (processor.rs:61-144): kaldi fbank (16 kHz, 25/10 ms,
  dither 0, snip_edges, ×32768) and CMVN from cmvn.json;
- the post-processing (processor.rs:146-247): moving-average smoothing,
  threshold, decisions → (start, end) segments in seconds;
- the streaming `detect_frame` state machine (vad.rs:94-167).

The detector runs in float32 on its device (the taps kept (K, P) as the
JAX tree has them, each conv a sum of shifted slices); features and the
post-processing are host numpy.  No route or registry entry, as in the
reference: Qwen3ASRChat.asr_vad_res consumes its frames.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from aha_tpu_torch.ops.audio_feats import kaldi_fbank


@dataclasses.dataclass(frozen=True)
class DetectModelConfig:
    """config.rs:78-136."""

    idim: int = 80
    r: int = 8
    m: int = 1
    h: int = 256
    p: int = 128
    n1: int = 20
    s1: int = 1
    n2: int = 20
    s2: int = 1
    odim: int = 1

    @classmethod
    def default_vad(cls):
        return cls()

    @classmethod
    def default_stream_vad(cls):
        return cls(n2=0)

    @classmethod
    def default_aed(cls):
        return cls(odim=3)


@dataclasses.dataclass(frozen=True)
class FireRedVadConfig:
    """config.rs:1-71."""

    smooth_window_size: int = 5
    speech_threshold: float = 0.4
    min_speech_frame: int = 20
    max_speech_frame: int = 2000
    min_silence_frame: int = 20
    chunk_max_frame: int = 30000

    @classmethod
    def default_vad(cls):
        return cls()

    @classmethod
    def default_stream_vad(cls):
        return cls(smooth_window_size=1, speech_threshold=0.5,
                   min_speech_frame=8)

    @classmethod
    def default_aed(cls):
        return cls(min_speech_frame=8)


@dataclasses.dataclass
class VadFrameResult:
    """common/modules.rs VadFrameResult."""

    is_speech: bool
    orig_audio: np.ndarray | None
    model_name: str = "VAD"
    mode: str = "speech"


@dataclasses.dataclass
class VadResult:
    dur: float
    timestamps: list[tuple[float, float]]
    model_name: str
    mode: str = "speech"


def _fsmn_lookback(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv: y[t] = Σ_j w[j]·x[t−(n1−1)s1+j·s1].

    x (B, T, P); w (n1, P); cache (B, (n1−1)·s1, P), the trailing context
    (zeros at first).  Returns (y, new_cache)."""
    n1 = w.shape[0]
    pad = cache.shape[1]  # (n1−1)·s1
    s1 = pad // max(n1 - 1, 1) if n1 > 1 else 1
    xp = torch.cat([cache, x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, j * s1:j * s1 + T, :] * w[j] for j in range(n1))
    new_cache = xp[:, xp.shape[1] - pad:] if pad else cache
    return y, new_cache


def _fsmn_lookahead(x: torch.Tensor, w: torch.Tensor,
                    s2: int) -> torch.Tensor:
    """Strictly-future depthwise conv: y[t] = Σ_j w[j]·x[t+(j+1)·s2],
    zero-padded past the end (model.rs:120-139)."""
    n2 = w.shape[0]
    T = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, 0, n2 * s2))
    return sum(xp[:, (j + 1) * s2:(j + 1) * s2 + T, :] * w[j]
               for j in range(n2))


class DetectModel:
    """The FSMN detector as functions on tensors; caches a list of
    fixed-shape (B, (n1−1)·s1, P) float32 tensors, one per FSMN."""

    def __init__(self, config: DetectModelConfig,
                 device: torch.device | str = "cpu"):
        self.config = config
        self.device = torch.device(device)

    def init_caches(self, batch: int = 1) -> list[torch.Tensor]:
        c = self.config
        pad = (c.n1 - 1) * c.s1
        return [torch.zeros((batch, pad, c.p), dtype=torch.float32,
                            device=self.device) for _ in range(c.r)]

    @torch.no_grad()
    def forward(self, params: dict, feats: torch.Tensor,
                caches: list[torch.Tensor] | None = None,
                streaming: bool = False
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """feats (B, T, idim) → (probs (B, T, odim), new caches).
        streaming=True keeps the conv caches and drops the lookahead (the
        stream checkpoint has n2 = 0 anyway; offline T > 1 takes it,
        model.rs:120)."""
        c = self.config
        if caches is None:
            caches = self.init_caches(feats.shape[0])
        use_ahead = c.n2 > 0 and not streaming and feats.shape[1] > 1

        def lin(p, x):
            y = x @ p["w"]
            return y + p["b"] if "b" in p else y

        def fsmn(p, x, cache):
            y, new_cache = _fsmn_lookback(x, p["lookback"], cache)
            mem = x + y
            if use_ahead and "lookahead" in p:
                mem = mem + _fsmn_lookahead(x, p["lookahead"], c.s2)
            return mem, new_cache

        x = torch.relu(lin(params["fc1"], feats))
        x = torch.relu(lin(params["fc2"], x))
        x, nc = fsmn(params["fsmn1"], x, caches[0])
        new_caches = [nc]
        for i, bp in enumerate(params["blocks"]):
            h = torch.relu(lin(bp["fc1"], x))
            mem, nc = fsmn(bp["fsmn"], lin(bp["fc2"], h), caches[i + 1])
            new_caches.append(nc)
            x = x + mem
        for dp in params["dnns"]:
            x = torch.relu(lin(dp, x))
        return torch.sigmoid(lin(params["out"], x)), new_caches

    # -- parameters ---------------------------------------------------------

    def load_params(self, src) -> dict:
        """The reference checkpoint's names (dfsmn.*, out.*) → float32
        tensors on self.device: linears (in, out), each depthwise conv
        weight (P, 1, K) as taps (K, P)."""
        def get(name):
            return src[name].to(device=self.device, dtype=torch.float32)

        def lin(name, bias=True):
            out = {"w": get(name + ".weight").t().contiguous()}
            if bias:
                out["b"] = get(name + ".bias")
            return out

        def fsmn(prefix, ahead):
            out = {"lookback": get(prefix + ".lookback_filter.weight")
                   [:, 0, :].t().contiguous()}
            if ahead:
                out["lookahead"] = get(prefix + ".lookahead_filter.weight")[
                    :, 0, :].t().contiguous()
            return out

        c = self.config
        ahead = c.n2 > 0
        return {
            "fc1": lin("dfsmn.fc1.0"),
            "fc2": lin("dfsmn.fc2.0"),
            "fsmn1": fsmn("dfsmn.fsmn1", ahead),
            "blocks": [{
                "fc1": lin(f"dfsmn.fsmns.{i}.fc1.0"),
                "fc2": lin(f"dfsmn.fsmns.{i}.fc2", bias=False),
                "fsmn": fsmn(f"dfsmn.fsmns.{i}.fsmn", ahead),
            } for i in range(c.r - 1)],
            "dnns": [lin(f"dfsmn.dnns.{i}") for i in range(c.m)],
            "out": lin("out"),
        }

    def init_random(self, generator: torch.Generator,
                    scale: float = 0.2) -> dict:
        """Seeded random parameters at this config's geometry (zero
        biases), drawn on the generator's device."""
        c = self.config
        gdev = generator.device

        def w(*shape):
            return (torch.randn(shape, generator=generator, device=gdev,
                                dtype=torch.float32) * scale
                    ).to(self.device)

        def lin(i, o, bias=True):
            out = {"w": w(i, o)}
            if bias:
                out["b"] = torch.zeros(o, device=self.device)
            return out

        def fsmn():
            out = {"lookback": w(c.n1, c.p) * 0.1}
            if c.n2 > 0:
                out["lookahead"] = w(c.n2, c.p) * 0.1
            return out

        return {
            "fc1": lin(c.idim, c.h),
            "fc2": lin(c.h, c.p),
            "fsmn1": fsmn(),
            "blocks": [{"fc1": lin(c.p, c.h), "fc2": lin(c.h, c.p, False),
                        "fsmn": fsmn()} for _ in range(c.r - 1)],
            "dnns": [lin(c.p if i == 0 else c.h, c.h) for i in range(c.m)],
            "out": lin(c.h, c.odim),
        }


# ---------------------------------------------------------------------------
# CMVN + fbank frontend (processor.rs:17-144)
# ---------------------------------------------------------------------------


class CMVN:
    def __init__(self, stats: np.ndarray):
        stats = np.asarray(stats, np.float32)
        if stats.ndim != 2 or stats.shape[0] != 2:
            raise ValueError(f"CMVN stats must be (2, dim + 1), got "
                             f"{stats.shape}")
        dim = stats.shape[1] - 1
        count = stats[0, dim]
        means = stats[0, :dim] / count
        var = np.clip(stats[1, :dim] / count - means ** 2, 1e-20, None)
        self.means = means
        self.inv_std = 1.0 / np.sqrt(var)

    @classmethod
    def from_file(cls, path: str) -> "CMVN":
        with open(os.path.join(path, "cmvn.json")) as f:
            return cls(np.asarray(json.load(f)["cmvn"]))

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        return (feats - self.means) * self.inv_std


def extract_feats(cmvn: CMVN, waveform: np.ndarray) -> np.ndarray:
    """16 kHz float waveform → CMVN'd 80-dim fbank (kaldi_fbank applies the
    ×32768 i16 scaling itself, matching vad.rs:102)."""
    return cmvn(kaldi_fbank(waveform, num_mel_bins=80))


# ---------------------------------------------------------------------------
# Post-processing (processor.rs:146-247)
# ---------------------------------------------------------------------------


def smooth_probs(probs: np.ndarray, window: int) -> np.ndarray:
    """Moving average ('full' conv truncated to len), with the first
    window−1 entries replaced by the running mean (processor.rs:228-246)."""
    if window <= 1:
        return probs
    n = len(probs)
    out = np.convolve(probs, np.full(window, 1.0 / window), mode="full")[:n]
    head = min(window - 1, n)
    for i in range(head):
        out[i] = probs[:i + 1].mean()
    return out


class VadPostprocessor:
    def __init__(self, cfg: FireRedVadConfig):
        self.cfg = cfg
        self.frame_shift_s = 0.01

    def process_thresh(self, probs: np.ndarray) -> np.ndarray:
        sm = smooth_probs(np.asarray(probs, np.float32),
                          self.cfg.smooth_window_size)
        return (sm >= self.cfg.speech_threshold).astype(np.int32)

    def decision_to_segment(self, decisions: np.ndarray,
                            dur: float) -> list[tuple[float, float]]:
        segments, start = [], -1
        for t, flag in enumerate(decisions):
            if flag and start == -1:
                start = t
            elif not flag and start != -1:
                segments.append((start * self.frame_shift_s,
                                 t * self.frame_shift_s))
                start = -1
        if start != -1:
            end = min(dur, (len(decisions) - 1) * self.frame_shift_s)
            segments.append((start * self.frame_shift_s, end))
        return segments

    def process(self, probs: np.ndarray, dur: float):
        return self.decision_to_segment(self.process_thresh(probs), dur)


# ---------------------------------------------------------------------------
# FireRedVad (vad.rs:29-234)
# ---------------------------------------------------------------------------


class FireRedVad:
    FRAME_LENGTH_SAMPLES = 400
    MIN_SPEECH_FRAMES = 30   # ~250 ms
    LOOK_BACK_FRAMES = 15    # ~80 ms
    MIN_SPEECH_RATIO = 0.1
    END_SILENCE_RATIO = 0.8

    def __init__(self, model: DetectModel, params: dict, cmvn: CMVN,
                 cfg: FireRedVadConfig, model_name: str = "VAD"):
        self.model = model
        self.params = params
        self.cmvn = cmvn
        self.cfg = cfg
        self.model_name = model_name
        self.post = VadPostprocessor(cfg)
        self.caches: list | None = None
        self.speech_cache: list[np.ndarray] = []
        self.pred_cache: list[int] = []

    @classmethod
    def init(cls, path: str, device: torch.device | str | None = None
             ) -> "FireRedVad":
        """The checkpoint under `path` (its name picks the stream / aed /
        vad configuration, as the reference's does) on `device`, the
        port's device by default (the card; AHA_DEVICE=cpu for the
        CPU)."""
        from aha_tpu_torch.io.weights import open_weights
        from aha_tpu_torch.utils.device import device as default_device

        name = os.path.basename(path.rstrip("/")) or "VAD"
        low = name.lower()
        if "stream" in low:
            mc, cfg = (DetectModelConfig.default_stream_vad(),
                       FireRedVadConfig.default_stream_vad())
        elif "aed" in low:
            mc, cfg = (DetectModelConfig.default_aed(),
                       FireRedVadConfig.default_aed())
        else:
            mc, cfg = (DetectModelConfig.default_vad(),
                       FireRedVadConfig.default_vad())
        model = DetectModel(mc, device if device is not None
                            else default_device())
        params = model.load_params(open_weights(path))
        return cls(model, params, CMVN.from_file(path), cfg, name)

    def reset(self):
        self.caches = None
        self.speech_cache.clear()
        self.pred_cache.clear()

    def _probs(self, feats: np.ndarray, **kw):
        x = torch.from_numpy(np.ascontiguousarray(feats, np.float32))[None]
        return self.model.forward(self.params, x.to(self.model.device), **kw)

    # -- streaming (vad.rs:94-167) --------------------------------------------

    def detect_frame(self, audio_frame: np.ndarray) -> VadFrameResult | None:
        if len(audio_frame) < self.FRAME_LENGTH_SAMPLES:
            raise ValueError(
                f"Expected {self.FRAME_LENGTH_SAMPLES} samples, "
                f"got {len(audio_frame)}")
        feats = extract_feats(self.cmvn, np.asarray(audio_frame, np.float32))
        probs, self.caches = self._probs(feats, caches=self.caches,
                                         streaming=True)
        probs = probs[0, :, 0].cpu().numpy()
        preds = self.post.process_thresh(probs)

        final = None
        if preds.sum() > len(probs) * self.MIN_SPEECH_RATIO:
            self.speech_cache.append(np.asarray(audio_frame, np.float32))
            self.pred_cache.extend(int(p) for p in preds)
            if len(self.pred_cache) >= self.MIN_SPEECH_FRAMES:
                look_back = sum(self.pred_cache[-self.LOOK_BACK_FRAMES:])
                silence = 1.0 - look_back / self.LOOK_BACK_FRAMES
                if silence >= self.END_SILENCE_RATIO:
                    final = np.concatenate(self.speech_cache)
                    self.speech_cache.clear()
                    self.pred_cache.clear()
        else:
            if len(self.pred_cache) >= self.MIN_SPEECH_FRAMES:
                final = np.concatenate(self.speech_cache)
            self.speech_cache.clear()
            self.pred_cache.clear()
        if final is None:
            return None
        return VadFrameResult(is_speech=True, orig_audio=final,
                              model_name=self.model_name)

    # -- offline (vad.rs:198-229) ----------------------------------------------

    def frame_probs(self, waveform: np.ndarray) -> np.ndarray:
        """The offline per-frame probabilities (T, odim) of a 16 kHz
        waveform, in chunks of chunk_max_frame frames."""
        feats = extract_feats(self.cmvn, np.asarray(waveform, np.float32))
        chunk = self.cfg.chunk_max_frame
        return np.concatenate([
            self._probs(feats[s:s + chunk])[0][0].cpu().numpy()
            for s in range(0, len(feats), chunk)])

    def detect_waveform(self, waveform: np.ndarray,
                        sample_rate: int = 16000) -> VadResult:
        if sample_rate != 16000:
            from aha_tpu_torch.utils.audio import resample

            waveform = resample(waveform, sample_rate, 16000)
        dur = len(waveform) / 16000.0
        # aed: only the speech channel (vad.rs:212-220)
        probs = self.frame_probs(waveform)[:, 0]
        return VadResult(dur=dur, timestamps=self.post.process(probs, dur),
                         model_name=self.model_name)

    def detect_file(self, audio_path: str) -> VadResult:
        from aha_tpu_torch.utils.audio import load_audio

        wav, sr = load_audio(audio_path)
        return self.detect_waveform(wav, sr)
