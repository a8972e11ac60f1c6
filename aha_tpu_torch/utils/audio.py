"""Host-side audio IO: decode, resample, normalize, chunk (the port's copy
of aha_tpu/utils/audio.py, function for function).

Equivalent of the host parts of src/utils/audio_utils.rs (load via
hound/symphonia :381-589, sinc resampler :42-256, chunk splitting :1743,
float_range_normalize modules.rs:1353).  Decoding stays on the host;
everything after "samples as arrays" (mel/STFT) runs on the tensor's
device (aha_tpu_torch.ops.audio_feats).

WAV decodes via the stdlib; mp3/ogg/flac decode through SDL2_mixer (bundled
with pygame, imported lazily and run headless: SDL_AUDIODRIVER=dummy) —
the symphonia role in the reference.  Where pygame is absent they
raise the reference's ValueError.  The container's native sample rate is
parsed from its header first so SDL never resamples; rate conversion stays
in the polyphase `resample`.
"""

from __future__ import annotations

import base64
import io
import os
import struct
import urllib.parse
import wave

import numpy as np


def load_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a WAV container → (float32 mono-or-multi (T,) or (T, C), rate)."""
    with wave.open(io.BytesIO(data)) as w:
        rate = w.getframerate()
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width == 2:
        arr = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        arr = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        arr = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if n_channels > 1:
        arr = arr.reshape(-1, n_channels)
    return arr, rate


# -- compressed containers (mp3/ogg/flac via SDL2_mixer) ---------------------

_MP3_RATES = {0: (11025, 12000, 8000),      # MPEG-2.5
              2: (22050, 24000, 16000),     # MPEG-2
              3: (44100, 48000, 32000)}     # MPEG-1


def sniff_container(data: bytes) -> str:
    """Identify the audio container from magic bytes."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"OggS":
        return "ogg"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:3] == b"ID3":
        return "mp3"
    if len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return "mp3"
    if data[4:8] == b"ftyp":
        return "m4a"
    return "unknown"


def _native_rate(data: bytes, kind: str) -> int | None:
    """Parse the stream's sample rate from its header (no decode)."""
    if kind == "mp3":
        start = 0
        if data[:3] == b"ID3":          # skip the ID3v2 tag (syncsafe size)
            size = ((data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14
                    | (data[8] & 0x7F) << 7 | (data[9] & 0x7F))
            start = 10 + size

        # Layer III bitrates (kbps); index 0 = free, 15 = invalid
        v1_rates = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                    224, 256, 320, 0)
        v2_rates = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                    144, 160, 0)

        def parse(i):
            """Valid Layer III frame header at i → (rate, frame_len)."""
            if i + 4 > len(data):
                return None
            b1, b2 = data[i + 1], data[i + 2]
            if data[i] != 0xFF or (b1 & 0xE0) != 0xE0:
                return None
            version = (b1 >> 3) & 0x3
            layer = (b1 >> 1) & 0x3
            if version == 1 or layer != 1:      # reserved version / not L3
                return None
            br_idx, sr_idx = b2 >> 4, (b2 >> 2) & 0x3
            if br_idx in (0, 15) or sr_idx == 3:
                return None
            rate = _MP3_RATES[version][sr_idx]
            kbps = (v1_rates if version == 3 else v2_rates)[br_idx]
            per = 144 if version == 3 else 72
            flen = per * kbps * 1000 // rate + ((b2 >> 1) & 1)
            return rate, flen

        for i in range(start, min(len(data) - 4, start + 65536)):
            got = parse(i)
            if got is None:
                continue
            rate, flen = got
            # false syncs die here: the next frame must also parse
            nxt = parse(i + flen)
            if nxt is not None and nxt[0] == rate:
                return rate
        return None
    if kind == "flac":                  # STREAMINFO: rate in bits 144-164
        if len(data) >= 22:
            raw = struct.unpack(">I", data[18:22])[0]
            return raw >> 12
        return None
    if kind == "ogg":                   # vorbis/opus id header in first page
        i = data.find(b"\x01vorbis")
        if i >= 0 and len(data) >= i + 16:
            return struct.unpack("<I", data[i + 12:i + 16])[0]
        i = data.find(b"OpusHead")
        if i >= 0:
            return 48000                # opus always decodes at 48 kHz
        return None
    return None


def _sdl_decode(data: bytes, kind: str) -> tuple[np.ndarray, int]:
    """Decode mp3/ogg/flac with SDL2_mixer (pygame), headless.

    The mixer is (re)initialized at the stream's native rate so SDL performs
    no resampling — output samples are the decoder's own.
    """
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    try:
        import pygame
    except ImportError as e:  # pragma: no cover
        raise ValueError(
            f"cannot decode {kind}: SDL2_mixer (pygame) unavailable") from e
    rate = _native_rate(data, kind) or 44100
    if pygame.mixer.get_init() and pygame.mixer.get_init()[0] != rate:
        pygame.mixer.quit()
    if not pygame.mixer.get_init():
        pygame.mixer.init(frequency=rate, size=-16, channels=2)
    import pygame.sndarray
    sound = pygame.mixer.Sound(file=io.BytesIO(data))
    arr = pygame.sndarray.array(sound)      # (T, C) or (T,) int16
    audio = arr.astype(np.float32) / 32768.0
    return audio, rate


def load_audio_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode any supported container → (float32 samples, rate)."""
    kind = sniff_container(data)
    if kind == "wav":
        return load_wav_bytes(data)
    if kind in ("mp3", "ogg", "flac"):
        return _sdl_decode(data, kind)
    raise ValueError(
        f"unsupported audio container {kind!r}: send WAV, MP3, OGG or FLAC")


def load_audio(source: str) -> tuple[np.ndarray, int]:
    """Load from file://, data: base64, raw base64, or a plain path."""
    if source.startswith("file://"):
        path = urllib.parse.urlparse(source).path or source[7:]
        with open(path, "rb") as f:
            data = f.read()
    elif source.startswith("data:"):
        data = base64.b64decode(source.split(",", 1)[1])
    elif os.path.exists(source):
        with open(source, "rb") as f:
            data = f.read()
    else:
        # assume raw base64 payload (reference accepts it, img_utils.rs style)
        data = base64.b64decode(source)
    return load_audio_bytes(data)


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(axis=1)
    return audio


def resample(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy) — the host equivalent of the reference's
    sinc/Kaiser resampler (audio_utils.rs:42-256)."""
    if src_rate == dst_rate:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(audio, dst_rate // g, src_rate // g).astype(np.float32)


def float_range_normalize(audio: np.ndarray) -> np.ndarray:
    """Scale into [-1, 1] only if the peak exceeds 1 (modules.rs:1353-1368)."""
    peak = float(np.abs(audio).max()) if audio.size else 0.0
    if peak > 1.0:
        return (audio / peak).astype(np.float32)
    return audio.astype(np.float32)


def prepare_audio(source: str, target_rate: int = 16000) -> np.ndarray:
    """load → mono → resample → normalize: the standard ASR front door."""
    audio, rate = load_audio(source)
    audio = to_mono(audio)
    audio = resample(audio, rate, target_rate)
    return float_range_normalize(audio)


def split_audio_into_chunks(audio: np.ndarray, sample_rate: int,
                            max_seconds: float) -> list[np.ndarray]:
    """Split long audio at the frontend (audio_utils.rs:1743-1761)."""
    max_len = int(sample_rate * max_seconds)
    if len(audio) <= max_len:
        return [audio]
    return [audio[i:i + max_len] for i in range(0, len(audio), max_len)]


def save_wav(path_or_buf, audio: np.ndarray, sample_rate: int) -> None:
    """float32 (T,) → 16-bit PCM WAV."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path_or_buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    save_wav(buf, audio, sample_rate)
    return buf.getvalue()
