"""Torch F.interpolate semantics as two matrix products (the port's copy of
the resizes DeepSeek-OCR and RMBG-2.0 use from aha_tpu/utils/interpolate.py).

Interpolation along an axis is a linear map: the (out_size, in_size)
weight matrix is built on the host in float64 numpy with torch's rules
(source coordinates and the triangle kernel for linear, the antialias
path's stretched a = -0.5 cubic kernel with normalised rows), cast to
float32 and applied on the tensor's device with `torch.matmul` — one
product for a 1-D mode, two for a 2-D one.  The same weights as the JAX
package's, so both give the same values.

Supported: linear / bilinear with align_corners False or True (RMBG-2.0's
decoder resizes take True: source coordinates i·(in − 1)/(out − 1)), and
bicubic with antialias (the rel-pos tables and the position tables).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


@functools.lru_cache(maxsize=64)
def resize_weights_1d(in_size: int, out_size: int, mode: str = "linear",
                      antialias: bool = False,
                      align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) float64 weight matrix W with resized = W @ x
    (read-only: the result is cached)."""
    w = _weights(in_size, out_size, mode, antialias, align_corners)
    w.flags.writeable = False
    return w


def _weights(in_size: int, out_size: int, mode: str, antialias: bool,
             align_corners: bool) -> np.ndarray:
    if (mode not in ("linear", "cubic") or (mode == "cubic" and not antialias)
            or (align_corners and (mode != "linear" or antialias))):
        raise ValueError(f"unsupported resize: {mode!r}, "
                         f"antialias={antialias}, "
                         f"align_corners={align_corners}")
    w = np.zeros((out_size, in_size))
    scale = in_size / out_size
    if antialias:
        # torch's antialias path: the kernel stretched by the downscale
        # factor (at least 1), each row normalised; upsampling takes it too
        # (plain a = -0.5 cubic)
        fscale = max(scale, 1.0)
        support = (2.0 if mode == "cubic" else 1.0) * fscale
        centers = scale * (np.arange(out_size, dtype=np.float64) + 0.5)
        for i in range(out_size):
            lo = max(0, int(centers[i] - support + 0.5))
            hi = min(in_size, int(centers[i] + support + 0.5))
            x = (np.arange(lo, hi) + 0.5 - centers[i]) / fscale
            row = (_cubic_kernel(x, -0.5) if mode == "cubic"
                   else _linear_kernel(x))
            s = row.sum()
            if s != 0:
                row = row / s
            w[i, lo:hi] = row
        return w
    # torch area_pixel_compute_source_index, clamped as the linear modes do
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        coords = (i * (in_size - 1) / (out_size - 1) if out_size > 1
                  else np.zeros(out_size))
    else:
        coords = (i + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    x0 = np.floor(coords).astype(np.int64)
    x1 = np.minimum(x0 + 1, in_size - 1)
    t = coords - x0
    np.add.at(w, (np.arange(out_size), x0), 1.0 - t)
    np.add.at(w, (np.arange(out_size), x1), t)
    return w


def _on(w: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(w.astype(np.float32)).to(x.device)


def interpolate(x: torch.Tensor, size, mode: str = "bilinear",
                antialias: bool = False,
                align_corners: bool = False) -> torch.Tensor:
    """Torch F.interpolate over the trailing spatial dims, computed in
    float32 and returned in x's dtype.

    x: (..., L) for "linear" with an int `size`, or (..., H, W) for
    "bilinear" / "bicubic" with `size=(h, w)`.
    """
    dt = x.dtype
    xf = x.float()
    if isinstance(size, int):
        wl = resize_weights_1d(x.shape[-1], size, mode, antialias,
                               align_corners)
        return torch.matmul(xf, _on(wl.T, x)).to(dt)
    th, tw = size
    mode1d = {"bilinear": "linear", "bicubic": "cubic"}[mode]
    wh = resize_weights_1d(x.shape[-2], th, mode1d, antialias, align_corners)
    ww = resize_weights_1d(x.shape[-1], tw, mode1d, antialias, align_corners)
    out = torch.matmul(_on(wh, x), xf)
    return torch.matmul(out, _on(ww.T, x)).to(dt)
