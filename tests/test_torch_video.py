"""aha_tpu_torch/utils/video.py against aha_tpu/utils/video.py: the video
smart resize, frame sampling, .npy / .npz / GIF / directory / data: and
file:// loading, the temporal-group timestamps, container sniffing, the
processed patches and grids, the container decoder's chain through a
PyAV-shaped stub module, and the error text where no decoder is
installed.  Every result equal (arrays exactly, fps and timestamps as
floats)."""

import base64
import io
import sys
import types

import numpy as np
import pytest

from aha_tpu.utils import video as J
from aha_tpu_torch.utils import video as T


@pytest.mark.parametrize("args", [
    (8, 300, 400, 2, 28, 56 * 56, 100 * 28 * 28),    # shrunk under budget
    (4, 64, 64, 2, 32, 200 * 32 * 32, 10 ** 9),       # grown to min_pixels
    (16, 448, 448, 2, 32, 32 * 32 * 4, 16 * 16 * 4 * 1280 * 4),
    (9, 100, 2000, 2, 28, 56 * 56, 10 ** 8),
    (6, 120, 90, 2, 28, 56 * 56, 10 ** 7, 3),         # lcm with a ratio
])
def test_video_smart_resize_equal(args):
    assert T.video_smart_resize(*args) == J.video_smart_resize(*args)


@pytest.mark.parametrize("args", [
    (1, 300, 400, 2, 28, 0, 10 ** 9),                 # too few frames
    (4, 20, 400, 2, 28, 0, 10 ** 9),                  # under the factor
    (4, 28, 28 * 201, 2, 28, 0, 10 ** 9),             # aspect ratio
])
def test_video_smart_resize_refusals_equal(args):
    with pytest.raises(ValueError) as got:
        T.video_smart_resize(*args)
    with pytest.raises(ValueError) as want:
        J.video_smart_resize(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("total,src_fps,lo,hi", [
    (100, 25.0, 4, 16), (100, 25.0, 4, 6), (8, 0.0, 4, 64),
    (3, 30.0, 4, 64), (240, 24.0, 4, 64), (17, 2.0, 4, 8)])
def test_sample_frames_equal(total, src_fps, lo, hi):
    frames = np.arange(total, dtype=np.uint8)[:, None, None, None] \
        * np.ones((1, 2, 3, 3), np.uint8)
    got = T.sample_frames(frames, src_fps, 2.0, lo, hi)
    want = J.sample_frames(frames, src_fps, 2.0, lo, hi)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("idx,fps,m", [
    ([0, 10, 20, 30], 10.0, 2), ([0, 10, 20], 10.0, 2),
    ([0, 12, 25, 37, 50, 62, 75, 87], 25.0, 2), ([0, 1, 2, 3, 4], 2.0, 3)])
def test_video_timestamps_equal(idx, fps, m):
    assert T.video_timestamps(np.array(idx), fps, m) == \
        J.video_timestamps(np.array(idx), fps, m)


def _frames(n=5, h=16, w=20, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3),
                                                dtype=np.uint8)


def _both(source):
    (a, fa), (b, fb) = T.load_video_frames(source), J.load_video_frames(source)
    np.testing.assert_array_equal(a, b)
    assert fa == fb
    return a, fa


def test_load_npz_npy_and_data_urls(tmp_path):
    frames = _frames()
    buf = io.BytesIO()
    np.savez(buf, frames=frames, fps=4.0)
    url = "data:application/npz;base64," + base64.b64encode(
        buf.getvalue()).decode()
    got, fps = _both(url)
    np.testing.assert_array_equal(got, frames)
    assert fps == 4.0
    # an npz without "frames" or "fps": its first array, fps unknown
    buf = io.BytesIO()
    np.savez(buf, clip=frames[:3])
    assert _both("data:;base64," + base64.b64encode(
        buf.getvalue()).decode())[1] == 0.0
    path = tmp_path / "clip.npy"
    np.save(path, frames)
    got, fps = _both(str(path))
    np.testing.assert_array_equal(got, frames)
    assert fps == 0.0
    _both("file://" + str(path))
    _both(base64.b64encode(path.read_bytes()).decode())     # raw base64


def test_load_gif_and_directory(tmp_path):
    from PIL import Image

    frames = _frames(seed=1)
    imgs = [Image.fromarray(f) for f in frames]
    gif = tmp_path / "clip.gif"
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=250)
    got, fps = _both(str(gif))
    assert got.shape == (5, 16, 20, 3) and abs(fps - 4.0) < 1e-6
    d = tmp_path / "frames"
    d.mkdir()
    for i, img in enumerate(imgs):
        img.save(d / f"{i:03d}.png")
    got, fps = _both(str(d))
    np.testing.assert_array_equal(got, frames)
    assert fps == 0.0


def test_container_sniffing_equal():
    for data in (b"\x00\x00\x00\x18ftypisom" + b"\0" * 8,
                 b"\x1a\x45\xdf\xa3" + b"\0" * 16,
                 b"RIFF\x00\x00\x00\x00AVI " + b"\0" * 8,
                 b"\x93NUMPY" + b"\0" * 16, b"\x89PNG\r\n\x1a\n" + b"\0" * 8,
                 b"ftyp"):
        assert T._is_video_container(data) == J._is_video_container(data)
    assert T._is_video_container(b"\x1a\x45\xdf\xa3" + b"\0" * 4) == \
        "webm/mkv"


@pytest.mark.parametrize("data,kind", [
    (b"\x00\x00\x00\x18ftypisom" + b"\x00" * 64, "mp4"),
    (b"\x1a\x45\xdf\xa3" + b"\x00" * 64, "webm/mkv")])
def test_no_decoder_error_text_equal(monkeypatch, data, kind):
    """No PyAV, no imageio, no ffmpeg binary: both raise the same
    RuntimeError naming what to install."""
    import shutil

    monkeypatch.setitem(sys.modules, "av", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as got:
        T._frames_from_bytes(data)
    with pytest.raises(RuntimeError) as want:
        J._frames_from_bytes(data)
    assert str(got.value) == str(want.value)
    assert f"{kind} video" in str(got.value) and "PyAV" in str(got.value)


def test_container_decodes_through_stub_pyav(monkeypatch):
    """With a PyAV-shaped module, container bytes decode to the same
    (T, H, W, 3) frames and fps in both packages."""
    frames = [np.full((8, 6, 3), i, np.uint8) for i in range(4)]

    class _Stream:
        average_rate = 12.5

    class _Frame:
        def __init__(self, a):
            self._a = a

        def to_ndarray(self, format):
            assert format == "rgb24"
            return self._a

    class _Container:
        streams = types.SimpleNamespace(video=[_Stream()])

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def decode(self, stream):
            return [_Frame(a) for a in frames]

    fake = types.ModuleType("av")
    fake.open = lambda fh: _Container()
    monkeypatch.setitem(sys.modules, "av", fake)
    data = b"\x00\x00\x00\x18ftypisom" + b"\x00" * 64
    got, fps = T._frames_from_bytes(data)
    want, wfps = J._frames_from_bytes(data)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 8, 6, 3) and fps == wfps == 12.5
    assert (got[2] == 2).all()


@pytest.mark.parametrize("n,h,w,patch", [(8, 64, 96, 16), (5, 90, 60, 14),
                                         (4, 448, 448, 16)])
def test_preprocess_video_equal(n, h, w, patch):
    """Resize, normalization and temporal patchify: patches bit-equal and
    the same grid (an odd frame count pads with the last frame)."""
    frames = _frames(n, h, w, seed=n)
    mean, std = [0.48145466, 0.4578275, 0.40821073], \
        [0.26862954, 0.26130258, 0.27577711]
    args = (frames, patch, 2, 2, 32 * 32 * 4, 16 * 16 * 4 * 1280 * 4, mean,
            std)
    got, grid = T.preprocess_video_qwen_vl(*args)
    want, wgrid = J.preprocess_video_qwen_vl(*args)
    assert tuple(grid) == tuple(wgrid)
    np.testing.assert_array_equal(got, want)


def test_extract_vision_parts_in_order():
    from aha_tpu_torch.params import ChatCompletionParameters

    mes = ChatCompletionParameters.model_validate({
        "model": "m", "messages": [{"role": "user", "content": [
            {"type": "video_url", "video_url": {"url": "v1"}},
            {"type": "text", "text": "and"},
            {"type": "image_url", "image_url": {"url": "i1"}}]}]})
    assert T.extract_vision_parts(mes) == [("video", "v1"), ("image", "i1")]
