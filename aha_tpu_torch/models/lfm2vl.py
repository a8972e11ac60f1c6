"""LFM2-VL: a SigLIP2 NaViT tower and a pixel-unshuffle projector on the
LFM2 hybrid (conv / attention) decoder (counterpart of
aha_tpu/models/lfm2vl.py).

- Siglip2 embeddings: a linear patch embedding over flattened (patch² ·
  3) pixels; the square learned position table resized bilinearly to each
  image's (h, w) patch grid on the host (pad rows reuse row 0) and added;
- encoder: pre-LN ViT blocks with biases, attention as masked sdpa over
  each image's real patches (plain torch on the card: the reference runs
  it outside any Pallas kernel), an MLP with the EXACT GELU (the JAX
  package's choice; transformers' SigLIP2 takes the tanh one), the post
  LayerNorm;
- projector: space-to-depth by downsample_factor as a host-built gather
  (the reference's double-reshape order), LayerNorm, linear / exact GELU /
  linear into the text width;
- the text model: the port's Lfm2Model, the projected features spliced
  into its input embeddings at the image-token positions.

The pixels enter the tower in the parameters' dtype, as the port's other
towers take theirs (the JAX tower promotes its weights to the f32
pixels').  Not ported: the tensor-parallel partition rules.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.models import siglip
from aha_tpu_torch.models.lfm2 import Lfm2Config, Lfm2Model, lfm2_1_2b
from aha_tpu_torch.ops.attention import sdpa
from aha_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class Lfm2VLVisionConfig:
    """Defaults: the JAX package's (SigLIP2 base)."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_attention_heads: int = 12
    num_hidden_layers: int = 12
    num_channels: int = 3
    num_patches: int = 256
    patch_size: int = 16
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "Lfm2VLVisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class Lfm2VLConfig:
    text: Lfm2Config
    vision: Lfm2VLVisionConfig
    image_token_id: int = 396
    downsample_factor: int = 2
    projector_hidden_size: int = 2560
    max_image_tokens: int = 256
    min_image_tokens: int = 64

    @classmethod
    def from_dict(cls, d: dict) -> "Lfm2VLConfig":
        names = {f.name for f in dataclasses.fields(cls)} - {"text", "vision"}
        return cls(text=Lfm2Config.from_dict(d["text_config"]),
                   vision=Lfm2VLVisionConfig.from_dict(d["vision_config"]),
                   **{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_file(cls, model_dir: str) -> "Lfm2VLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


def lfm2vl_1_6b(depth: int = 26, layers: int = 16) -> Lfm2VLConfig:
    """LFM2-VL-1.6B's geometry: the SigLIP2 so400m tower (hidden 1152, ff
    4304, 16 heads of 72, patch 16, a 256-entry position table; 26 blocks
    as published, a depth this repository cannot confirm) with the
    projector of transformers' Lfm2VlConfig (2560 wide, downsample 2,
    image token 396, bias, LayerNorm) over LFM2-1.2B's decoder
    (`lfm2_1_2b`); depths cut to `depth` blocks and `layers` text
    layers."""
    return Lfm2VLConfig(
        text=lfm2_1_2b(layers),
        vision=Lfm2VLVisionConfig(
            hidden_size=1152, intermediate_size=4304, num_attention_heads=16,
            num_hidden_layers=depth, num_patches=256, patch_size=16),
        image_token_id=396, downsample_factor=2, projector_hidden_size=2560)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize's "bilinear" along
    one axis: the triangle kernel at half-pixel centres, widened by
    n_in / n_out when shrinking (its antialias), each column normalized."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_pos_embeddings(table: np.ndarray, h: int, w: int,
                          max_len: int) -> np.ndarray:
    """Square (n², d) learned table → bilinear (h·w, d), padded to max_len
    with row 0 (model.rs:51-87).  Host-side, once per request; the
    arithmetic of the reference's jax.image.resize(..., "bilinear") in
    numpy: an axis of equal size is left as it is, a shrinking one is
    antialiased."""
    side = int(np.sqrt(table.shape[0]))
    grid = np.asarray(table, np.float32).reshape(side, side, -1)
    if h != side:
        grid = np.einsum("hwd,hH->Hwd", grid, _resize_weights(side, h))
    if w != side:
        grid = np.einsum("hwd,wW->hWd", grid, _resize_weights(side, w))
    out = np.ascontiguousarray(grid, np.float32).reshape(h * w, -1)
    if h * w < max_len:
        out = np.concatenate(
            [out, np.repeat(out[:1], max_len - h * w, axis=0)])
    return out


class Siglip2VisionTower:
    """The SigLIP2 NaViT encoder on an explicit device.  Parameters:
    patch_embedding (w (in_dim, d), b), pos_table (n², d) float32 (read on
    the host), post_ln, and a list of per-block dicts."""

    def __init__(self, cfg: Lfm2VLVisionConfig,
                 device: torch.device | str = "cpu"):
        self.v = cfg
        self.device = torch.device(device)
        self.head_dim = cfg.head_dim

    def encode(self, vp: dict, pixels: torch.Tensor, pixel_mask: torch.Tensor,
               pos_embeds: torch.Tensor) -> torch.Tensor:
        """pixels (B, N, patch²·3); pixel_mask (B, N) bool; pos_embeds
        (B, N, D) host-resized → hidden (B, N, D)."""
        v = self.v
        pe = vp["patch_embedding"]
        x = nn.linear(pe, pixels.to(device=pe["w"].device,
                                    dtype=pe["w"].dtype))
        x = x + pos_embeds.to(x.dtype)
        mask = pixel_mask[:, None, None, :]         # True = attend
        H, hd = v.num_attention_heads, self.head_dim
        B, N, D = x.shape
        eps = v.layer_norm_eps
        for lp in vp["layers"]:
            h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"], eps)
            q = nn.linear(lp["q"], h).reshape(B, N, H, hd)
            k = nn.linear(lp["k"], h).reshape(B, N, H, hd)
            val = nn.linear(lp["v"], h).reshape(B, N, H, hd)
            attn = sdpa(q, k, val, mask).reshape(B, N, D)
            x = x + nn.linear(lp["o"], attn)
            h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"], eps)
            x = x + nn.linear(lp["fc2"], F.gelu(nn.linear(lp["fc1"], h),
                                                approximate="none"))
        return layer_norm(x, vp["post_ln"]["w"], vp["post_ln"]["b"], eps)

    def load_params(self, src, dtype: torch.dtype, vt: str) -> dict:
        """The tower's HF names under `vt` → its parameters on
        self.device (the position table float32)."""
        def get(name, dt=dtype):
            return src[name].to(device=self.device, dtype=dt)

        def lin(name):
            return {"w": get(name + ".weight").t().contiguous(),
                    "b": get(name + ".bias")}

        def norm(name):
            return {"w": get(name + ".weight"), "b": get(name + ".bias")}

        return {
            "patch_embedding": lin(vt + "embeddings.patch_embedding"),
            "pos_table": get(vt + "embeddings.position_embedding.weight",
                             torch.float32),
            "post_ln": norm(vt + "post_layernorm"),
            "layers": siglip.block_params(lin, norm, vt + "encoder.layers.",
                                          self.v.num_hidden_layers),
        }

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters (zero biases, unit LayerNorms; the
        position table float32) drawn on the generator's device and moved
        to self.device."""
        v = self.v
        gdev = generator.device

        def w(*shape, dt=dtype):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dt)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o):
            return {"w": w(i, o), "b": full(0.0, o)}

        def norm(d):
            return {"w": full(1.0, d), "b": full(0.0, d)}

        D, I = v.hidden_size, v.intermediate_size
        in_dim = v.num_channels * v.patch_size ** 2
        return {
            "patch_embedding": lin(in_dim, D),
            "pos_table": w(v.num_patches, D, dt=torch.float32),
            "post_ln": norm(D),
            "layers": siglip.init_blocks(lin, norm, D, I,
                                         v.num_hidden_layers),
        }


def unshuffle_gather(shapes: list[tuple[int, int]], n_padded: int,
                     factor: int, units_bucket: int | None = None
                     ) -> np.ndarray:
    """Host-side index map replicating the projector's space-to-depth.

    The reference's double-reshape (model.rs:226-236) concatenates, for
    output unit (r, c), the f² patch features at rows r·f+dr, cols c·f+dc
    in row-major (dr, dc) order.  Returns (units, f²) indices into the
    flattened (B·n_padded) tower output, each packed row one image."""
    rows = []
    for i, (h, w) in enumerate(shapes):
        base = i * n_padded
        for r in range(h // factor):
            for c in range(w // factor):
                rows.append([base + (r * factor + dr) * w + (c * factor + dc)
                             for dr in range(factor)
                             for dc in range(factor)])
    out = np.asarray(rows, np.int32)
    if units_bucket and units_bucket > len(out):
        pad = np.zeros((units_bucket - len(out), factor * factor), np.int32)
        out = np.concatenate([out, pad])
    return out


class _Scoped:
    """A checkpoint whose decoder sits under model.language_model.: the
    decoder's model.* names mapped there."""

    def __init__(self, src):
        self.src = src

    @staticmethod
    def _map(name: str) -> str:
        if name.startswith("model."):
            return "model.language_model." + name[len("model."):]
        return name

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.src[self._map(name)]

    def __contains__(self, name: str) -> bool:
        return self._map(name) in self.src


class Lfm2VLModel:
    """The model TextEngine drives; `mm` (prefill only) carries the packed
    NaViT batch as tensors (models/lfm2vl_served.py builds it): pixels (B,
    N, patch²·3) float32, pixel_mask (B, N) bool, pos_embeds (B, N, D)
    float32, gather (units, f²) int32.  Parameters: Lfm2Model's tree with
    "visual" (the tower's) and "projector" beside the decoder's."""

    def __init__(self, config: Lfm2VLConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu"):
        self.config = config
        self.device = torch.device(device)
        self.text = Lfm2Model(config.text, max_rope_len=max_rope_len,
                              device=self.device)
        self.n_layers = self.text.n_layers
        self.tower = Siglip2VisionTower(config.vision, self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return self.text.init_cache(batch, max_len, dtype)

    def encode_vision(self, params: dict, mm: dict) -> torch.Tensor:
        """→ (units, text_hidden) projected image features in input order
        (model.rs:286-304); mm["gather"] (units, f²) packs each image's
        space-to-depth."""
        c = self.config
        hidden = self.tower.encode(params["visual"], mm["pixels"],
                                   mm["pixel_mask"], mm["pos_embeds"])
        flat = hidden.reshape(-1, hidden.shape[-1])      # (B·N, D)
        units = flat[mm["gather"].long()]                # (units, f², D)
        x = units.reshape(units.shape[0], -1)            # (units, f²·D)
        p = params["projector"]
        if "ln" in p:
            x = layer_norm(x, p["ln"]["w"], p["ln"]["b"],
                           c.vision.layer_norm_eps)
        x = F.gelu(nn.linear(p["l1"], x), approximate="none")
        return nn.linear(p["l2"], x)

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, prompt_len: int | None = None,
                 from_cache: bool = False,
                 window: int | None = None) -> torch.Tensor:
        """With `mm`: the image features replace the image-token rows of
        the input embeddings; then Lfm2Model's backbone (its conv and
        K/V state rules unchanged)."""
        embeds = None
        if mm is not None:
            feats = self.encode_vision(params, mm)
            embeds = nn.embedding(params["embed"], input_ids)
            is_img = input_ids[0] == self.config.image_token_id
            idx = (torch.cumsum(is_img.long(), 0) - 1).clamp(
                0, feats.shape[0] - 1)
            embeds = torch.where(is_img[None, :, None],
                                 feats[idx][None].to(embeds.dtype), embeds)
        return self.text.backbone(params, input_ids, cache,
                                  prompt_len=prompt_len,
                                  from_cache=from_cache, window=window,
                                  inputs_embeds=embeds)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.logits(params, hidden)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of an Lfm2VlForConditionalGeneration checkpoint: the
        decoder under model.language_model., the tower under
        model.vision_tower.vision_model., the projector under
        model.multi_modal_projector. (its LayerNorm where present)."""
        params = self.text.load_params(_Scoped(src), dtype)
        params["visual"] = self.tower.load_params(
            src, dtype, "model.vision_tower.vision_model.")
        mp = "model.multi_modal_projector."

        def get(name):
            return src[name].to(device=self.device, dtype=dtype)

        def lin(name):
            p = {"w": get(name + ".weight").t().contiguous()}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        proj = {"l1": lin(mp + "linear_1"), "l2": lin(mp + "linear_2")}
        if mp + "layer_norm.weight" in src:
            proj["ln"] = {"w": get(mp + "layer_norm.weight"),
                          "b": get(mp + "layer_norm.bias")}
        params["projector"] = proj
        return params

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters: the decoder's, the tower's, then the
        projector's (zero biases, a unit LayerNorm), drawn from one
        generator."""
        c = self.config
        params = self.text.init_random(generator, dtype, scale)
        params["visual"] = self.tower.init_random(generator, dtype, scale)
        in_dim = c.vision.hidden_size * c.downsample_factor ** 2
        gdev = generator.device

        def lin(i, o):
            x = torch.randn((i, o), generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return {"w": x.to(device=self.device, dtype=dtype),
                    "b": torch.zeros(o, device=self.device, dtype=dtype)}

        params["projector"] = {
            "ln": {"w": torch.ones(in_dim, device=self.device, dtype=dtype),
                   "b": torch.zeros(in_dim, device=self.device,
                                    dtype=dtype)},
            "l1": lin(in_dim, c.projector_hidden_size),
            "l2": lin(c.projector_hidden_size, c.text.hidden_size),
        }
        return params
