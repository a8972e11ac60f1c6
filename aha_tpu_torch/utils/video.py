"""Host-side video utilities (the port's copy of aha_tpu/utils/video.py).

Videos arrive as pre-decoded frames: an .npy / .npz array (T, H, W, 3)
uint8 (an npz may carry "fps"), an animated GIF / WebP (Pillow decodes
these), or a directory of frame images; `data:`, `file://` and plain path
sources all work.  A real container (mp4, webm / mkv, avi) is decoded by
whichever decoder the host has — PyAV, imageio's ffmpeg backend, or the
ffmpeg binary — and without one the error says what to install.  Then
frame sampling (round(duration · fps) frames clamped to [min_frames,
max_frames], every round(total / n)-th one), the video smart resize whose
pixel budget counts every frame, the temporal patchify, and the per
temporal group timestamps.  Everything here is numpy on the host.
"""

from __future__ import annotations

import base64
import io
import math
import os
import urllib.parse

import numpy as np

from aha_tpu_torch.utils.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


def video_smart_resize(num_frames: int, height: int, width: int,
                       temporal_factor: int, factor: int,
                       min_pixels: int, max_pixels: int,
                       ratio: int | None = None) -> tuple[int, int]:
    """(h_bar, w_bar) with the pixel budget counted across frames."""
    if num_frames < temporal_factor:
        raise ValueError(f"{num_frames} frames < temporal factor "
                         f"{temporal_factor}")
    if height < factor or width < factor:
        raise ValueError(f"height {height} or width {width} < factor {factor}")
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    if ratio:
        factor = math.lcm(factor, ratio)
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    t_bar = round(num_frames / temporal_factor) * temporal_factor
    if t_bar * h_bar * w_bar > max_pixels:
        beta = math.sqrt((num_frames * height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif t_bar * h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (num_frames * height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _is_video_container(data: bytes) -> str | None:
    """Container sniffing: 'mp4' (ftyp box), 'webm/mkv' (EBML), 'avi'."""
    if len(data) >= 12 and data[4:8] == b"ftyp":
        return "mp4"
    if data[:4] == b"\x1a\x45\xdf\xa3":
        return "webm/mkv"
    if data[:4] == b"RIFF" and data[8:12] == b"AVI ":
        return "avi"
    return None


def _decode_container(data: bytes, kind: str) -> tuple[np.ndarray, float]:
    """Decode a real video file through whichever decoder the host has:
    PyAV, imageio's ffmpeg backend, or the ffmpeg binary (with ffprobe for
    the frame size and rate); without any, a RuntimeError that says what
    to install."""
    try:
        import av  # PyAV

        with av.open(io.BytesIO(data)) as container:
            stream = container.streams.video[0]
            fps = float(stream.average_rate or 0.0)
            frames = [f.to_ndarray(format="rgb24")
                      for f in container.decode(stream)]
        return np.stack(frames), fps
    except ImportError:
        pass
    try:
        # imageio's ffmpeg backend; any plugin or backend failure falls
        # through to the ffmpeg binary
        import imageio.v2 as iio2

        reader = iio2.get_reader(io.BytesIO(data), format="ffmpeg")
        meta2 = reader.get_meta_data()
        fps = float(meta2.get("fps", 0.0) or 0.0)
        frames = [np.asarray(fr, np.uint8) for fr in reader]
        reader.close()
        if frames:
            return np.stack(frames), fps
    except Exception:  # noqa: BLE001 — no decoder here, try the binary
        pass
    import shutil

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        import json
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=f".{kind.split('/')[0]}") as f:
            f.write(data)
            f.flush()
            fps = 0.0
            meta: dict = {}
            ffprobe = shutil.which("ffprobe")
            if ffprobe:
                try:
                    meta = json.loads(subprocess.run(
                        [ffprobe, "-v", "quiet", "-print_format", "json",
                         "-show_streams", f.name], capture_output=True,
                        text=True, timeout=60).stdout)
                    for s in meta.get("streams", []):
                        if s.get("codec_type") == "video":
                            num, den = s.get("avg_frame_rate",
                                             "0/1").split("/")
                            fps = float(num) / max(float(den), 1.0)
                            break
                except Exception:  # noqa: BLE001 — fps stays unknown
                    pass
            probe = subprocess.run(
                [ffmpeg, "-v", "error", "-i", f.name, "-f", "rawvideo",
                 "-pix_fmt", "rgb24", "-vf", "scale=iw:ih", "-"],
                capture_output=True, timeout=600)
            if probe.returncode != 0:
                raise RuntimeError(
                    f"ffmpeg failed to decode {kind} input: "
                    f"{probe.stderr.decode(errors='replace')[:500]}")
            wh = None
            if ffprobe:
                for s in meta.get("streams", []):
                    if s.get("codec_type") == "video":
                        wh = (int(s["width"]), int(s["height"]))
            if wh is None:
                raise RuntimeError(
                    f"cannot size {kind} frames without ffprobe")
            w, h = wh
            raw = np.frombuffer(probe.stdout, np.uint8)
            n = len(raw) // (w * h * 3)
            return raw[:n * w * h * 3].reshape(n, h, w, 3).copy(), fps
    raise RuntimeError(
        f"input looks like a {kind} video but no video decoder is available "
        f"on this host — install PyAV (`pip install av`) or ffmpeg, or "
        f"pre-decode the clip to .npy/.npz frames (T, H, W, 3)")


def _frames_from_bytes(data: bytes) -> tuple[np.ndarray, float]:
    if data[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(data))
        return np.asarray(arr, np.uint8), 0.0
    if data[:2] == b"PK":  # npz
        z = np.load(io.BytesIO(data))
        fps = float(z["fps"]) if "fps" in z else 0.0
        key = "frames" if "frames" in z else z.files[0]
        return np.asarray(z[key], np.uint8), fps
    kind = _is_video_container(data)
    if kind is not None:
        return _decode_container(data, kind)
    from PIL import Image, ImageSequence

    img = Image.open(io.BytesIO(data))
    frames = [np.asarray(f.convert("RGB"), np.uint8)
              for f in ImageSequence.Iterator(img)]
    dur_ms = img.info.get("duration") or 0
    fps = 1000.0 / dur_ms if dur_ms else 0.0
    return np.stack(frames), fps


def load_video_frames(source: str) -> tuple[np.ndarray, float]:
    """(frames (T, H, W, 3) uint8, source fps — 0.0 when unknown)."""
    if source.startswith("data:"):
        return _frames_from_bytes(base64.b64decode(source.split(",", 1)[1]))
    path = source
    if source.startswith("file://"):
        path = urllib.parse.urlparse(source).path or source[7:]
    if os.path.isdir(path):
        from PIL import Image

        names = sorted(os.listdir(path))
        frames = [np.asarray(Image.open(os.path.join(path, n)).convert("RGB"),
                             np.uint8) for n in names]
        return np.stack(frames), 0.0
    if os.path.exists(path):
        with open(path, "rb") as f:
            return _frames_from_bytes(f.read())
    return _frames_from_bytes(base64.b64decode(source))


def sample_frames(frames: np.ndarray, src_fps: float, target_fps: float,
                  min_frames: int, max_frames: int
                  ) -> tuple[np.ndarray, np.ndarray, float]:
    """(sampled frames, original frame indices, effective fps).  With an
    unknown source fps the frames are taken as already sampled at
    target_fps."""
    total = frames.shape[0]
    if src_fps <= 0:
        src_fps = target_fps
    duration = total / src_fps
    n = round(duration * target_fps)
    n = min(max(n, min_frames), max_frames, total)
    interval = max(1, round(total / n))
    idx = np.arange(0, total, interval)
    return frames[idx], idx, src_fps


def preprocess_video_qwen_vl(frames: np.ndarray, patch_size: int,
                             merge_size: int, temporal_patch_size: int,
                             min_pixels: int, max_pixels: int,
                             mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD
                             ) -> tuple[np.ndarray, tuple]:
    """(T, H, W, 3) uint8 → (patches, grid_thw) through the video smart
    resize, normalization (CLIP's mean and std unless given) and the
    temporal patchify."""
    from PIL import Image

    from aha_tpu_torch.utils.image import patchify_qwen_vl

    T, H, W, _ = frames.shape
    factor = patch_size * merge_size
    h2, w2 = video_smart_resize(T, H, W, temporal_patch_size, factor,
                                min_pixels, max_pixels)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = np.empty((T, 3, h2, w2), np.float32)
    for i in range(T):
        img = Image.fromarray(frames[i]).resize((w2, h2), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
        out[i] = ((arr - mean) / std).transpose(2, 0, 1)
    return patchify_qwen_vl(out, patch_size, merge_size, temporal_patch_size)


def video_timestamps(frame_indices: np.ndarray, fps: float,
                     t_merge_size: int) -> list[float]:
    """Per temporal group midpoint timestamps (seconds)."""
    idx = list(frame_indices)
    if len(idx) % t_merge_size:
        idx += [idx[-1]] * (t_merge_size - len(idx) % t_merge_size)
    stamps = []
    for i in range(0, len(idx), t_merge_size):
        a = idx[i] / fps
        b = idx[i + t_merge_size - 1] / fps
        stamps.append((a + b) / 2.0)
    return stamps


def extract_vision_parts(mes) -> list[tuple[str, str]]:
    """[(kind, url)] in prompt order; kind in {"image", "video"}."""
    out = []
    for m in mes.messages:
        parts = m.content if isinstance(m.content, list) else []
        for p in parts:
            if getattr(p, "image_url", None) is not None:
                out.append(("image", p.image_url.url))
            elif getattr(p, "video_url", None) is not None:
                out.append(("video", p.video_url.url))
    return out
