"""The port's host audio I/O (aha_tpu_torch/utils/audio.py) against
aha_tpu/utils/audio.py: WAV decode bit-exact at every sample width and
channel count, the container sniffing and native-rate parsing, an unknown
container refused with the reference's error, resampling, chunk splitting
and normalizing equal to JAX's, the front door (`prepare_audio`) from a
path and a data: URL, mp3 through pygame's SDL2_mixer where the
reference's fixtures exist (skipped as the reference's test skips
otherwise), and the weight reader: a .pth checkpoint read through
torch.load equal to the same tensors written as safetensors."""

import base64
import io
import os
import wave

import numpy as np
import pytest
import torch

from aha_tpu.utils import audio as J
from aha_tpu_torch.utils import audio as T

MP3_FIXTURES = [p for p in (
    "/opt/venv/lib/python3.12/site-packages/pygame/examples/data/house_lo.mp3",
    "/usr/lib/google-cloud-sdk/platform/gsutil/gslib/tests/test_data/test.mp3",
) if os.path.exists(p)]


def _tone(n: int = 4000, rate: int = 16000, amp: float = 0.5) -> np.ndarray:
    t = np.arange(n, dtype=np.float32) / rate
    return (amp * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def _wav(width: int, channels: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    n = 1000 * channels
    if width == 1:
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    elif width == 2:
        raw = rng.integers(-32768, 32768, n, dtype=np.int16).tobytes()
    else:
        raw = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32).tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(raw)
    return buf.getvalue()


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_bit_exact(width, channels):
    data = _wav(width, channels, seed=width * 10 + channels)
    got, rate = T.load_audio_bytes(data)
    ref, ref_rate = J.load_audio_bytes(data)
    assert rate == ref_rate == 22050
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(T.to_mono(got), J.to_mono(ref))


def test_wav_writer_bytes_equal():
    sig = _tone(1601) * 2.5            # clipped past ±1
    assert T.wav_bytes(sig, 16000) == J.wav_bytes(sig, 16000)


@pytest.mark.parametrize("data", [
    b"RIFF\x00\x00\x00\x00WAVEfmt ", b"ID3\x04\x00\x00\x00\x00\x00\x00rest",
    b"\xff\xfb\x90\x00data", b"OggS\x00junk", b"fLaC\x00junk",
    b"\x00\x00\x00 ftypM4A ", b"garbage!", b"\xff"])
def test_sniff_container_equal(data):
    assert T.sniff_container(data) == J.sniff_container(data)


def _frames(header: bytes, flen: int, n: int = 2) -> bytes:
    return (header + b"\x00" * (flen - 4)) * n


@pytest.mark.parametrize("data, kind", [
    (_frames(b"\xff\xfb\x90\x00", 417), "mp3"),
    (_frames(b"\xff\xfb\x94\x00", 384), "mp3"),
    (_frames(b"\xff\xf3\x88\x00", 288), "mp3"),
    (b"\xff\xfb\x90\x00" + b"\x00" * 64, "mp3"),
    (b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10
     + _frames(b"\xff\xfb\x90\x00", 417), "mp3"),
    (b"OggS" + b"\x00" * 24 + b"\x01vorbis" + b"\x00" * 5
     + (44100).to_bytes(4, "little") + b"\x00" * 8, "ogg"),
    (b"OggS" + b"\x00" * 24 + b"OpusHead" + b"\x00" * 12, "ogg"),
    (b"fLaC" + b"\x00" * 14 + (44100 << 12).to_bytes(4, "big") + b"\x00" * 8,
     "flac"),
    (b"fLaC\x00", "flac")])
def test_native_rate_equal(data, kind):
    assert T._native_rate(data, kind) == J._native_rate(data, kind)


def test_unknown_container_refused_as_the_reference():
    with pytest.raises(ValueError) as got:
        T.load_audio_bytes(b"not audio at all")
    with pytest.raises(ValueError) as ref:
        J.load_audio_bytes(b"not audio at all")
    assert str(got.value) == str(ref.value)
    assert "unsupported audio container" in str(got.value)


@pytest.mark.parametrize("src, dst", [(44100, 16000), (8000, 16000),
                                      (16000, 16000), (48000, 22050)])
def test_resample_equal(src, dst):
    x = np.random.default_rng(src).standard_normal(4410).astype(np.float32)
    got, ref = T.resample(x, src, dst), J.resample(x, src, dst)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("peak", [0.5, 1.0, 3.0])
def test_normalize_and_split_equal(peak):
    x = _tone(16000 * 3 + 17, amp=peak)
    np.testing.assert_array_equal(T.float_range_normalize(x),
                                  J.float_range_normalize(x))
    for secs in (1.0, 2.5, 10.0):
        got = T.split_audio_into_chunks(x, 16000, secs)
        ref = J.split_audio_into_chunks(x, 16000, secs)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    assert T.float_range_normalize(np.zeros(0, np.float32)).size == 0


def test_prepare_audio_path_and_data_url_equal(tmp_path):
    """The ASR front door (load → mono → 16 kHz → normalize) from a file
    path, a file:// URL, a data: URL and a raw base64 payload of a
    22.05 kHz stereo WAV."""
    data = _wav(2, 2, seed=7)
    path = tmp_path / "a.wav"
    path.write_bytes(data)
    b64 = base64.b64encode(data).decode()
    for src in (str(path), f"file://{path}", f"data:audio/wav;base64,{b64}",
                b64):
        got, ref = T.prepare_audio(src), J.prepare_audio(src)
        assert got.dtype == np.float32 and got.ndim == 1
        np.testing.assert_array_equal(got, ref)


@pytest.mark.skipif(not MP3_FIXTURES, reason="no mp3 fixtures in image")
@pytest.mark.parametrize("path", MP3_FIXTURES)
def test_mp3_through_pygame_equal(path):
    with open(path, "rb") as f:
        data = f.read()
    got, rate = T.load_audio_bytes(data)
    ref, ref_rate = J.load_audio_bytes(data)
    assert rate == ref_rate
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(T.prepare_audio(path),
                                  J.prepare_audio(path))


def test_mp3_without_pygame_refused_as_the_reference(monkeypatch):
    """Where pygame is absent the compressed containers raise the
    reference's ValueError (the card's machine has no pygame)."""
    import builtins

    real_import = builtins.__import__

    def no_pygame(name, *a, **kw):
        if name == "pygame" or name.startswith("pygame."):
            raise ImportError("no pygame")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pygame)
    data = _frames(b"\xff\xfb\x90\x00", 417)
    with pytest.raises(ValueError, match="SDL2_mixer"):
        T.load_audio_bytes(data)
    with pytest.raises(ValueError, match="SDL2_mixer"):
        J.load_audio_bytes(data)


@pytest.mark.parametrize("wrapped", [False, True])
def test_pth_weights_equal_safetensors(tmp_path, wrapped):
    """A .pth directory (and a single .bin file) read through torch.load
    gives the tensors a safetensors directory of the same state dict
    gives, bf16 included; a {"state_dict": ...} wrapper is unwrapped."""
    from safetensors.torch import save_file

    from aha_tpu_torch.io.weights import (SafetensorsSource,
                                          TorchPickleSource, open_weights)

    g = torch.Generator().manual_seed(3)
    sd = {"a.weight": torch.randn(4, 3, generator=g),
          "b.bias": torch.randn(5, generator=g).to(torch.bfloat16),
          "c.idx": torch.arange(6, dtype=torch.int64)}
    st_dir, pth_dir = tmp_path / "st", tmp_path / "pth"
    st_dir.mkdir()
    pth_dir.mkdir()
    save_file(sd, str(st_dir / "model.safetensors"))
    torch.save({"state_dict": sd, "epoch": 3} if wrapped else sd,
               str(pth_dir / "model.pth"))
    torch.save(sd, str(tmp_path / "single.bin"))
    st = open_weights(str(st_dir))
    assert isinstance(st, SafetensorsSource)
    for src in (open_weights(str(pth_dir)),
                open_weights(str(tmp_path / "single.bin"))):
        assert isinstance(src, TorchPickleSource)
        assert sorted(src.keys()) == sorted(st.keys())
        for k in sd:
            assert k in src
            assert src[k].dtype == st[k].dtype
            assert torch.equal(src[k], st[k])
    with pytest.raises(FileNotFoundError):
        open_weights(str(tmp_path / "empty_dir_missing"))
