"""PaddleOCR-VL: a SigLIP NaViT tower over the ERNIE-4.5 decoder with
contiguous M-RoPE (counterpart of aha_tpu/models/paddleocr_vl.py).

- patch embedding as one matmul over the flattened 14 x 14 conv, plus its
  bias; the learned (side x side) position table bilinearly interpolated
  to each grid with torch's half-pixel rule: the 4 taps' indices and
  weights come from the host, the gather and its f32 sum run on the
  device;
- encoder blocks: LayerNorm pre-norms, q / k / v as three linears with
  biases, the 2-D (h, w) rotary over row-major patch coordinates,
  attention within one segment through segment_attention (the
  segment-flash kernel on the card at the tower's D 72; every image of a
  request is segment 0, as in the JAX package; pad rows carry seg = -1),
  out_proj, an MLP with the tanh GELU (jax.nn.gelu's default); the post
  LayerNorm;
- the projector (mlp_AR): a LayerNorm with the TEXT config's eps, the
  row-major 2 x 2 merge as a host-built gather, linear / exact GELU /
  linear into the text width;
- the text model: the port's LlamaModel in its ERNIE-4.5 form (biases
  where use_bias says so) with contiguous M-RoPE sections; image features
  spliced at the image-token positions; `rope_delta` kept in the cache for
  decode positions.

Everything that depends only on the grids (coordinates, taps, segments,
the merge gather, M-RoPE ids, rope_delta) is numpy on the host, once per
request, as in the JAX package.

Tensor parallelism (`mesh` with tp > 1, parallel/): the rules are llama's
(PADDLEOCR_VL_PARTITION_RULES), so the ERNIE decoder is the sharded
LlamaModel under "text." (its o / MLP biases added once after the
reduce), and the SigLIP tower and the projector run whole on every rank,
as the JAX mesh replicates them.
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
from aha_tpu_torch.models.llama import (LLAMA_CACHE_RULES,
                                        LLAMA_PARTITION_RULES, LlamaConfig,
                                        LlamaModel, check_tp as llama_tp)
from aha_tpu_torch.models.qwen2_5vl import get_rope_index as _qwen_rope_index
from aha_tpu_torch.ops.attention import segment_attention
from aha_tpu_torch.ops.norms import layer_norm
from aha_tpu_torch.ops.rope import (apply_rope, gather_rope, mrope_cos_sin,
                                    mrope_sections, vision_cos_sin,
                                    vision_inv_freq)


@dataclasses.dataclass(frozen=True)
class PaddleVisionConfig:
    """Defaults: the JAX package's (PaddleOCR-VL's 27-block tower)."""
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 384
    patch_size: int = 14
    spatial_merge_size: int = 2
    layer_norm_eps: float = 1e-6
    tokens_per_second: int = 2  # for the shared get_rope_index video path

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "PaddleVisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class PaddleOCRVLConfig:
    vision: PaddleVisionConfig
    text: LlamaConfig
    mrope_section: tuple[int, ...] = (16, 24, 24)
    image_token_id: int = 100295
    video_token_id: int = 100296
    vision_start_token_id: int = 101305

    @classmethod
    def from_dict(cls, d: dict) -> "PaddleOCRVLConfig":
        """A config.json's dict: the text fields top-level, `use_bias`
        setting the q/k/v, o and MLP biases together."""
        vision = PaddleVisionConfig.from_dict(d.get("vision_config", {}))
        use_bias = d.get("use_bias", False)
        text = LlamaConfig.from_dict({
            **d, "qkv_bias": use_bias, "o_bias": use_bias,
            "mlp_bias": use_bias})
        rs = d.get("rope_scaling") or {}
        return cls(
            vision=vision, text=text,
            mrope_section=tuple(rs.get("mrope_section", (16, 24, 24))),
            image_token_id=d.get("image_token_id", 100295),
            video_token_id=d.get("video_token_id", 100296),
            vision_start_token_id=d.get("vision_start_token_id", 101305))

    @classmethod
    def from_file(cls, model_dir: str) -> "PaddleOCRVLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


#: ERNIE-4.5-0.3B, PaddleOCR-VL's decoder: transformers' Ernie4_5Config
#: defaults (its docstring names baidu/ERNIE-4.5-0.3B-PT)
ERNIE_4_5_0_3B = dict(
    vocab_size=103424, hidden_size=1024, intermediate_size=3072,
    num_hidden_layers=18, num_attention_heads=16, num_key_value_heads=2,
    head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
    max_position_embeddings=131072, tie_word_embeddings=True)


def paddleocr_vl_0_9b(depth: int = 27, layers: int = 18) -> PaddleOCRVLConfig:
    """PaddleOCR-VL-0.9B's geometry: PaddleVisionConfig's tower (27 blocks
    at 1152, ff 4304, 16 heads of 72, patch 14, a 27 x 27 position table,
    merge 2) over ERNIE-4.5-0.3B (18 layers at 1024, ff 3072, 16/2 heads
    of 128, vocab 103424, θ 500000, tied, no bias), M-RoPE (16, 24, 24),
    PaddleOCRVLConfig's token ids; depths cut to `depth` blocks and
    `layers` text layers."""
    return PaddleOCRVLConfig(
        vision=PaddleVisionConfig(num_hidden_layers=depth),
        text=LlamaConfig(**{**ERNIE_4_5_0_3B, "num_hidden_layers": layers}),
        mrope_section=(16, 24, 24))


# ---------------------------------------------------------------------------
# Host geometry
# ---------------------------------------------------------------------------


def paddle_vision_geometry(grid_thw: list[tuple[int, int, int]],
                           cfg: PaddleVisionConfig) -> dict[str, np.ndarray]:
    """Row-major (h, w) coords, 4-tap interpolated pos-embed taps (torch
    bilinear half-pixel), segment ids (every image segment 0: one
    full-attention segment a request) and the row-major → merge-unit
    gather for the projector."""
    m = cfg.spatial_merge_size
    side = cfg.image_size // cfg.patch_size
    pos_hw, pidx, pw, seg, merge_gather = [], [], [], [], []
    base = 0
    for (t, h, w) in grid_thw:
        hpos = np.repeat(np.arange(h), w)
        wpos = np.tile(np.arange(w), h)
        for _ in range(t):
            pos_hw.append(np.stack([hpos, wpos], -1))
            seg.append(np.full(h * w, 0, np.int32))

        # torch bilinear (align_corners=False): src = (dst+0.5)*scale - 0.5
        def taps(n_dst):
            scale = side / n_dst
            src = (np.arange(n_dst) + 0.5) * scale - 0.5
            i0 = np.clip(np.floor(src), 0, side - 1).astype(np.int64)
            i1 = np.clip(i0 + 1, 0, side - 1)
            frac = np.clip(src - np.floor(src), 0.0, 1.0)
            frac = np.where(src < 0, 0.0, frac)
            return i0, i1, frac

        h0, h1, dh = taps(h)
        w0, w1, dw = taps(w)
        idx4 = np.stack([
            np.add.outer(h0 * side, w0), np.add.outer(h0 * side, w1),
            np.add.outer(h1 * side, w0), np.add.outer(h1 * side, w1)],
            -1).reshape(h * w, 4)
        w4 = np.stack([
            np.outer(1 - dh, 1 - dw), np.outer(1 - dh, dw),
            np.outer(dh, 1 - dw), np.outer(dh, dw)], -1).reshape(h * w, 4)
        for _ in range(t):
            pidx.append(idx4)
            pw.append(w4)

        # projector merge gather: unit (t, hu, wu) pulls rows in 2x2 order
        idx = np.arange(t * h * w).reshape(t, h, w) + base
        g = idx.reshape(t, h // m, m, w // m, m).transpose(0, 1, 3, 2, 4)
        merge_gather.append(g.reshape(-1))
        base += t * h * w
    return {
        "pos_hw": np.concatenate(pos_hw).astype(np.int32),
        "seg": np.concatenate(seg),
        "pos_idx": np.concatenate(pidx).astype(np.int32),
        "pos_w": np.concatenate(pw).astype(np.float32),
        "merge_gather": np.concatenate(merge_gather).astype(np.int32),
    }


#: the same algorithm as Qwen2.5-VL's (model.rs:446-665), as the JAX
#: package aliases it
get_rope_index = _qwen_rope_index


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class PaddleOCRVLModel:
    """The model TextEngine drives; `mm` (prefill only) carries the patches
    and the host indices as tensors (models/paddleocr_vl_served.py builds
    it): patches (N, C·p·p), seg (N,) int32, pos_hw (N, 2), pos_idx (N, 4)
    int32, pos_w (N, 4) float32, merge_gather (N,) int32, position_ids
    (3, S), rope_delta an int.  Parameters: {"visual": ..., "text":
    LlamaModel's}; the encoder blocks are a list of per-block dicts."""

    def __init__(self, config: PaddleOCRVLConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.text = LlamaModel(config.text, max_rope_len=max_rope_len,
                               device=self.device, mesh=mesh)
        #: the tp mesh of this rank (None on one device)
        self.mesh = self.text.mesh
        self.n_layers = self.text.n_layers
        v = config.vision
        self.v_inv_freq = torch.from_numpy(
            vision_inv_freq(v.head_dim).astype(np.float32)).to(self.device)
        self.sections = torch.from_numpy(mrope_sections(
            self.text.cos.shape[-1], config.mrope_section)).to(self.device)

    @staticmethod
    def fuse_params(params: dict) -> dict:
        """The text decoder's [q|k|v] and [gate|up] fused (bit-identical,
        biases too); the tower is untouched."""
        return {**params, "text": LlamaModel.fuse_params(params["text"])}

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        cache = self.text.init_cache(batch, max_len, dtype)
        cache["rope_delta"] = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        return cache

    # -- vision ---------------------------------------------------------------

    def encode_vision(self, vp: dict, mm: dict) -> torch.Tensor:
        """patches (N, C·p·p) [padded; pad rows have seg = -1] →
        (N_units, text_hidden) in original order."""
        v = self.config.vision
        patches = mm["patches"]
        N = patches.shape[0]
        unit = v.spatial_merge_size ** 2
        pe_w = vp["patch_embed"]["w"]
        # per-patch conv == matmul over the flattened patch
        x = patches.to(device=pe_w.device, dtype=pe_w.dtype) @ pe_w \
            + vp["patch_embed"]["b"]
        table = vp["pos_embed"]["w"]
        # the 4 taps summed in f32, then cast
        pe = (table[mm["pos_idx"].long()].float()
              * mm["pos_w"].float()[..., None]).sum(dim=1)
        x = x + pe.to(x.dtype)
        cos, sin = vision_cos_sin(self.v_inv_freq, mm["pos_hw"])
        seg = mm["seg"]
        H, hd = v.num_attention_heads, v.head_dim
        eps = v.layer_norm_eps
        for lp in vp["layers"]:
            h = layer_norm(x, lp["ln1"]["w"], lp["ln1"].get("b"), eps)
            # three contiguous (1, N, H, hd) tensors: the segment kernel
            # reads each head's hd columns, never the next head's
            q = nn.linear(lp["q"], h).reshape(N, H, hd)[None]
            k = nn.linear(lp["k"], h).reshape(N, H, hd)[None]
            vv = nn.linear(lp["v"], h).reshape(N, H, hd)[None]
            q, k = apply_rope(q, k, cos, sin)
            attn = segment_attention(q, k, vv, seg).reshape(N, v.hidden_size)
            x = x + nn.linear(lp["o"], attn)
            h = layer_norm(x, lp["ln2"]["w"], lp["ln2"].get("b"), eps)
            h = F.gelu(nn.linear(lp["fc1"], h), approximate="tanh")
            x = x + nn.linear(lp["fc2"], h)
        x = layer_norm(x, vp["post_ln"]["w"], vp["post_ln"].get("b"), eps)

        # projector: pre-norm (the text eps), row-major 2x2 merge through
        # the host gather, mlp
        proj = vp["proj"]
        h = layer_norm(x, proj["pre_norm"]["w"], proj["pre_norm"].get("b"),
                       self.config.text.rms_norm_eps)
        h = h[mm["merge_gather"].long()].reshape(N // unit,
                                                 unit * v.hidden_size)
        h = F.gelu(nn.linear(proj["fc1"], h), approximate="none")
        return nn.linear(proj["fc2"], h)

    # -- CausalLM ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm`: encode the images, splice their features at the
        image-token positions and take M-RoPE positions (rope_delta stored
        in the cache).  Without: a decode step (or a suffix prefill over
        restored rows) continues at pos + rope_delta; a text-only prefill
        takes plain positions and resets rope_delta to 0.  `window` and
        `prompt_len` are accepted and unused."""
        B, S = input_ids.shape
        text = self.text
        x = text.embed(params["text"], input_ids)
        if mm is not None:
            feats = self.encode_vision(params["visual"], mm)
            is_img = (input_ids[0] == self.config.image_token_id) | \
                     (input_ids[0] == self.config.video_token_id)
            idx = (torch.cumsum(is_img.long(), 0) - 1).clamp(
                0, feats.shape[0] - 1)
            x = torch.where(is_img[None, :, None],
                            feats[idx][None].to(x.dtype), x)
            cos, sin = mrope_cos_sin(text.cos, text.sin,
                                     mm["position_ids"][:, :S], self.sections)
            cache["rope_delta"].fill_(int(mm["rope_delta"]))
        elif S == 1 or from_cache:
            pos_eff = (cache["pos"] + cache["rope_delta"]).long()
            cos, sin = gather_rope(text.cos, text.sin,
                                   pos_eff + torch.arange(S, device=x.device))
        else:
            positions = cache["pos"].long() + torch.arange(S, device=x.device)
            cos, sin = gather_rope(text.cos, text.sin, positions)
            cache["rope_delta"].zero_()
        return text.run_layers(params["text"], x, cache, cos_sin=(cos, sin),
                               from_cache=from_cache)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.logits(params["text"], hidden)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.greedy_token(params["text"], hidden)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of a PaddleOCR-VL checkpoint (the tower under
        visual.vision_model., the projector under mlp_AR., the ERNIE
        decoder under model.) → the port's layout on self.device."""
        v = self.config.vision

        def get(name):
            return src[name].to(device=self.device, dtype=dtype)

        def lin(name):
            p = {"w": get(name + ".weight").t().contiguous()}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        vm = "visual.vision_model."
        in_dim = v.num_channels * v.patch_size ** 2
        conv = get(vm + "embeddings.patch_embedding.weight")
        visual = {
            "patch_embed": {
                "w": conv.reshape(v.hidden_size, in_dim).t().contiguous(),
                "b": get(vm + "embeddings.patch_embedding.bias")},
            "pos_embed": {"w": get(vm + "embeddings.position_embedding"
                                        ".weight")},
            "post_ln": norm(vm + "post_layernorm"),
            "proj": {"pre_norm": norm("mlp_AR.pre_norm"),
                     "fc1": lin("mlp_AR.linear_1"),
                     "fc2": lin("mlp_AR.linear_2")},
            "layers": siglip.block_params(lin, norm, vm + "encoder.layers.",
                                          v.num_hidden_layers),
        }
        text = self.text.load_params(src, dtype=dtype)
        return {"visual": visual, "text": text}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters (zero biases, unit LayerNorms): the text
        decoder's, then the tower's, drawn from one generator on its
        device and moved to self.device."""
        v = self.config.vision
        text = self.text.init_random(generator, dtype, scale)
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o):
            return {"w": w(i, o), "b": full(0.0, o)}

        def norm(d):
            return {"w": full(1.0, d), "b": full(0.0, d)}

        d = v.hidden_size
        unit = v.spatial_merge_size ** 2
        side = v.image_size // v.patch_size
        visual = {
            "patch_embed": {"w": w(v.num_channels * v.patch_size ** 2, d),
                            "b": full(0.0, d)},
            "pos_embed": {"w": w(side * side, d)},
            "post_ln": norm(d),
            "proj": {"pre_norm": norm(d),
                     "fc1": lin(unit * d, unit * d),
                     "fc2": lin(unit * d, self.config.text.hidden_size)},
            "layers": siglip.init_blocks(lin, norm, d, v.intermediate_size,
                                         v.num_hidden_layers),
        }
        return {"visual": visual, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params): the JAX
# package's PADDLEOCR_VL_PARTITION_RULES, llama's — they match the ERNIE
# decoder under "text." and no path of the SigLIP tower or the projector.
PADDLEOCR_VL_PARTITION_RULES = LLAMA_PARTITION_RULES
PADDLEOCR_VL_CACHE_RULES = LLAMA_CACHE_RULES
PaddleOCRVLModel.partition_rules = PADDLEOCR_VL_PARTITION_RULES
PaddleOCRVLModel.cache_rules = PADDLEOCR_VL_CACHE_RULES


def check_tp(config: PaddleOCRVLConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the ERNIE decoder
    (its 2 kv heads stop it at tp 2), naming the dimension; the tower is
    replicated."""
    llama_tp(config.text, tp)
