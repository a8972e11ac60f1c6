"""The port's SigLIP and tiling helpers (aha_tpu_torch/utils/image.py)
against aha_tpu.utils.image's: the row-major patchify, the SigLIP
preprocessing under pixel bounds and scalar mean / std, the tile grids,
the closest aspect ratio (ties included), the tile crop, DeepSeek-OCR's
tiling, edge-padded resize and normalisation, and the image
sources of a chat request.  Exact equality: both are the same numpy and
Pillow arithmetic."""

import numpy as np
import pytest
from PIL import Image

from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu.utils import image as J
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.utils import image as T


def _img(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("shape,p", [((1, 3, 28, 42), 14), ((2, 3, 32, 16), 16),
                                     ((1, 3, 56, 56), 14)])
def test_patchify_siglip_equal(shape, p):
    frames = np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)
    got, grid = T.patchify_siglip(frames, p)
    want, wgrid = J.patchify_siglip(frames, p)
    assert grid == wgrid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,kw", [
    (64, 64, {}), (300, 200, dict(max_pixels=28 * 28 * 24)),
    (30, 90, dict(min_pixels=28 * 28 * 8)),
    (1240, 1754, dict(mean=0.4, std=0.3))])
def test_preprocess_image_siglip_equal(w, h, kw):
    img = _img(w, h, seed=w)
    got, grid = T.preprocess_image_siglip(img, **kw)
    want, wgrid = J.preprocess_image_siglip(img, **kw)
    assert grid == wgrid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(1, 1), (2, 10), (1, 12), (4, 6)])
def test_generate_target_ratios_equal(lo, hi):
    assert T.generate_target_ratios(lo, hi) == J.generate_target_ratios(lo, hi)


def test_find_closest_aspect_ratio_equal():
    """Every size on a grid of widths and heights, tile 512 and 448 (ties
    between grids of one aspect ratio decided by the image's area)."""
    ratios = T.generate_target_ratios(2, 10)
    for tile in (512, 448):
        for w in range(64, 4000, 173):
            for h in range(64, 3000, 211):
                assert T.find_closest_aspect_ratio(
                    w / h, ratios, w, h, tile) == J.find_closest_aspect_ratio(
                        w / h, ratios, w, h, tile), (w, h, tile)


@pytest.mark.parametrize("rows,cols", [(2, 3), (1, 5), (3, 1)])
def test_crop_img_equal(rows, cols):
    img = _img(150, 97, seed=rows * cols)
    got, want = T.crop_img(img, rows, cols, 32), J.crop_img(img, rows, cols, 32)
    assert len(got) == len(want) == rows * cols
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_extract_image_sources_equal():
    b = {"model": "m", "messages": [
        {"role": "user", "content": [
            {"type": "text", "text": "a"},
            {"type": "image_url", "image_url": {"url": "data:x"}},
            {"type": "image_url", "image_url": {"url": "file:///y.png"}}]},
        {"role": "assistant", "content": "b"},
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "z"}}]}]}
    assert T.extract_image_sources(ChatCompletionParameters.model_validate(
        b)) == J.extract_image_sources(JParameters.model_validate(b)) == \
        ["data:x", "file:///y.png", "z"]


@pytest.mark.parametrize("w,h,lo,hi,size", [
    (1400, 700, 2, 9, 640), (1654, 2339, 2, 9, 640),
    (300, 1200, 2, 6, 768), (900, 500, 2, 6, 768)])
def test_dynamic_preprocess_equal(w, h, lo, hi, size):
    """DeepSeek-OCR's Gundam tiling (v1: 2..9 tiles of 640, v2: 2..6 of
    768): the same grid and tiles."""
    img = _img(w, h, seed=w + h)
    got, grid = T.dynamic_preprocess(img, lo, hi, size)
    want, wgrid = J.dynamic_preprocess(img, lo, hi, size)
    assert grid == wgrid and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("w,h,size", [(1654, 2339, 1024), (700, 1400, 640),
                                      (640, 640, 640), (50, 30, 512)])
def test_resize_with_edge_padding_equal(w, h, size):
    img = _img(w, h, seed=h)
    got = T.resize_with_edge_padding(img, size, size)
    want = J.resize_with_edge_padding(img, size, size)
    assert got.size == want.size == (size, size)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mean,std", [(0.5, 0.5), (0.4, 0.3)])
def test_img_transform_equal(mean, std):
    img = _img(37, 21, seed=3)
    got = T.img_transform(img, mean, std)
    want = J.img_transform(img, mean, std)
    assert got.shape == (3, 21, 37) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
