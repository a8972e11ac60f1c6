"""Host-side image utilities (the port's copy of the Qwen-VL, SigLIP and
tiling parts of aha_tpu/utils/image.py): load from a data: URL, base64,
file:// or a path, Qwen-VL smart resize to the factor-28 grid, CLIP
normalization and the merge-blocked patchify; the SigLIP (NaViT) row-major
patchify and its preprocessing (PaddleOCR-VL); the tile grids, their
closest aspect ratio and the tile crop (LFM2-VL); DeepSeek-OCR's Gundam
tiling, edge-padded resize and scalar normalisation.  Decoding stays on the
host (Pillow); everything after is numpy feeding the device.  http(s) URLs
are fetched with `requests`, as the reference does.
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
        import requests

        r = requests.get(source, timeout=30)
        r.raise_for_status()
        img = Image.open(io.BytesIO(r.content))
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


def patchify_siglip(frames: np.ndarray, patch_size: int = 14
                    ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """(T, C, H, W) → (T·gh·gw, C·p·p) patches in ROW-MAJOR order (the
    PaddleOCR-VL NaViT packing — no temporal patching, no merge blocking)."""
    T, C, H, W = frames.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = frames.reshape(T, C, gh, p, gw, p).transpose(0, 2, 4, 1, 3, 5)
    return (x.reshape(T * gh * gw, C * p * p).astype(np.float32),
            (T, gh, gw))


def preprocess_image_siglip(img, patch_size: int = 14, merge_size: int = 2,
                            min_pixels: int = 28 * 28,
                            max_pixels: int = 28 * 28 * 4096,
                            mean: float = 0.5, std: float = 0.5
                            ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """image → (patches, grid_thw): smart resize to the factor
    patch · merge grid, scalar mean / std, row-major patchify."""
    from PIL import Image

    factor = patch_size * merge_size
    w, h = img.size
    h2, w2 = smart_resize(h, w, factor, min_pixels, max_pixels)
    img = img.resize((w2, h2), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = ((arr - mean) / std).transpose(2, 0, 1)
    return patchify_siglip(arr[None], patch_size)


def generate_target_ratios(min_num: int, max_num: int
                           ) -> list[tuple[int, int]]:
    """All (w, h) tile grids with min_num <= w*h <= max_num, sorted by
    area (img_utils.rs:114-132)."""
    ratios = {(i, j)
              for n in range(min_num, max_num + 1)
              for i in range(1, n + 1)
              for j in range(1, n + 1)
              if min_num <= i * j <= max_num}
    return sorted(ratios, key=lambda r: r[0] * r[1])


def find_closest_aspect_ratio(aspect_ratio: float,
                              target_ratios: list[tuple[int, int]],
                              width: int, height: int,
                              image_size: int) -> tuple[int, int]:
    """Best (grid_w, grid_h) for the image (img_utils.rs:135-163): the
    closest aspect ratio, a tie going to the larger grid where the image
    covers more than half of it."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif abs(diff - best_diff) < 1e-10:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def crop_img(img, grid_h: int, grid_w: int, image_size: int) -> list:
    """Resize to the exact grid and cut image_size tiles row-major
    (img_utils.rs:165-191)."""
    from PIL import Image

    resized = img.resize((image_size * grid_w, image_size * grid_h),
                         Image.BICUBIC)
    tiles = []
    for i in range(grid_w * grid_h):
        x1 = (i % grid_w) * image_size
        y1 = (i // grid_w) * image_size
        tiles.append(resized.crop((x1, y1, x1 + image_size, y1 + image_size)))
    return tiles


def dynamic_preprocess(img, min_num: int, max_num: int, image_size: int
                       ) -> tuple[list, tuple[int, int]]:
    """InternVL-style tiling (img_utils.rs:193-248): the closest grid of
    min_num..max_num tiles, the image cut into it.  Returns (tiles,
    (grid_w, grid_h))."""
    w, h = img.size
    ratios = generate_target_ratios(min_num, max_num)
    grid_w, grid_h = find_closest_aspect_ratio(w / h, ratios, w, h,
                                               image_size)
    tiles = crop_img(img, grid_h, grid_w, image_size)
    return tiles, (grid_w, grid_h)


def resize_with_edge_padding(img, width: int, height: int,
                             color: tuple = (127, 127, 127)):
    """Aspect-preserving resize centered on a solid canvas
    (img_utils.rs:250-270)."""
    from PIL import Image

    iw, ih = img.size
    ratio = min(width / iw, height / ih)
    nw = max(1, min(width, round(iw * ratio)))
    nh = max(1, min(height, round(ih * ratio)))
    resized = img.resize((nw, nh), Image.BICUBIC)
    if (nw, nh) == (width, height):
        return resized
    canvas = Image.new("RGB", (width, height), color)
    canvas.paste(resized, ((width - nw) // 2, (height - nh) // 2))
    return canvas


def img_transform(img, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """PIL → (C, H, W) float32, scaled to [0, 1] and normalised by a
    scalar mean / std (img_utils.rs:272-294)."""
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return ((arr - mean) / std).transpose(2, 0, 1)


def extract_image_sources(mes) -> list[str]:
    """All image_url part URLs of a chat request, in order."""
    from aha_tpu_torch.params import extract_parts

    return [p.image_url.url for m in mes.messages
            for p in extract_parts(m.content, "image_url")]
