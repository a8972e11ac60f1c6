"""Host-side image utilities (the port's copy of the Qwen-VL part of
aha_tpu/utils/image.py): load from a data: URL, base64, file:// or a path,
Qwen-VL smart resize to the factor-28 grid, CLIP normalization and the
merge-blocked patchify.  Decoding stays on the host (Pillow); everything
after is numpy feeding the device.  http(s) URLs are refused: the port
fetches nothing from the network.
"""

from __future__ import annotations

import base64
import io
import math
import os
import urllib.parse

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_image(source: str):
    """PIL image from file://, data:, raw base64, or a path."""
    from PIL import Image

    if source.startswith("file://"):
        path = urllib.parse.urlparse(source).path or source[7:]
        img = Image.open(path)
    elif source.startswith("data:"):
        img = Image.open(io.BytesIO(base64.b64decode(source.split(",", 1)[1])))
    elif source.startswith(("http://", "https://")):
        raise ValueError("image URLs are not fetched; send the image as a "
                         "data: URL, base64 or a local file")
    elif os.path.exists(source):
        img = Image.open(source)
    else:
        img = Image.open(io.BytesIO(base64.b64decode(source)))
    return img.convert("RGB")


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """Qwen-VL factor rounding (img_utils.rs:297-332 / HF smart_resize)."""
    if height < factor or width < factor:
        raise ValueError(
            f"height:{height} or width:{width} must be larger than factor:{factor}")
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def to_normalized_array(img) -> np.ndarray:
    """PIL → (C, H, W) float32, CLIP mean/std normalized."""
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    return arr.transpose(2, 0, 1)


def patchify_qwen_vl(frames: np.ndarray, patch_size: int = 14,
                     merge_size: int = 2, temporal_patch_size: int = 2
                     ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """(T, C, H, W) normalized frames → (N, C·tp·p·p) patches + grid_thw.

    Patch ordering matches HF Qwen2VLImageProcessor._preprocess: merge-unit
    blocks are contiguous so the (2×2) patch merger sees its four spatial
    neighbors consecutively.
    """
    T, C, H, W = frames.shape
    if T % temporal_patch_size != 0:
        reps = temporal_patch_size - (T % temporal_patch_size)
        frames = np.concatenate([frames] + [frames[-1:]] * reps, axis=0)
        T = frames.shape[0]
    grid_t = T // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    m, p = merge_size, patch_size
    x = frames.reshape(grid_t, temporal_patch_size, C,
                       grid_h // m, m, p, grid_w // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = x.reshape(grid_t * grid_h * grid_w,
                        C * temporal_patch_size * p * p)
    return patches.astype(np.float32), (grid_t, grid_h, grid_w)


def preprocess_image_qwen_vl(img, patch_size: int = 14, merge_size: int = 2,
                             temporal_patch_size: int = 2,
                             min_pixels: int = 56 * 56,
                             max_pixels: int = 14 * 14 * 4 * 1280
                             ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """image → (patches, grid_thw) through smart resize + normalize."""
    from PIL import Image

    factor = patch_size * merge_size
    w, h = img.size
    h2, w2 = smart_resize(h, w, factor, min_pixels, max_pixels)
    img = img.resize((w2, h2), Image.BICUBIC)
    frames = to_normalized_array(img)[None]  # (1, C, H, W)
    return patchify_qwen_vl(frames, patch_size, merge_size,
                            temporal_patch_size)
