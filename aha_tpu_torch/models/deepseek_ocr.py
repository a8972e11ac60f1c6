"""DeepSeek-OCR: SAM ViTDet and CLIP towers feeding a DeepSeek-V2 MoE
decoder (counterpart of aha_tpu/models/deepseek_ocr.py; version 2 puts a
Qwen2 decoder-as-encoder where CLIP was).

- SAM ViTDet-B: the 16 x 16 patch conv, the absolute position table
  resized bicubic-antialias to the grid (utils/interpolate.py), 12 blocks
  (LayerNorm eps 1e-6, 14 x 14 windows with four global blocks, the
  decomposed relative-position bias — its tables resized linearly to
  2·side − 1 rows and gathered by host-built indices —, exact GELU), the
  neck (1 x 1 conv, channel LayerNorm, 3 x 3 conv, channel LayerNorm) and
  two stride-2 3 x 3 convs: 1024 px → (1024, 16, 16);
- CLIP-L/14 over the SAM features as its patch embeddings: class token,
  position table resized to the grid, pre-LayerNorm, 24 pre-norm blocks
  with plain attention and quick-GELU (eps 1e-5); its rows after the
  class token, beside SAM's, go through the linear projector;
- the decoder: DeepSeek-V2 with MHA (10 heads of 128 at the published
  width), a dense SwiGLU first layer and MoE layers after it
  (ops/moe.py: the capacity C from the PADDED token count, as the
  reference computes it); the K/V cache is the JAX package's 5-D layout,
  prefill of ≥ 128 bucketed rows through the flash prefill kernel and
  every decode step through flash_decode_at_layer
  (models/cache_attention.py).

The towers compute in their input's dtype — float32 pixels, as the
reference's request carries them, which promotes its bfloat16 weights to
float32 — and their features are cast to the decoder's dtype where they
replace the image tokens' embeddings.  All image geometry (the Gundam
tile grid, newline and separator rows) is a host-built gather index over
the projected rows (`deepseek_vision_layout`).

Tensor parallelism (`mesh` with tp > 1, parallel/), by
DEEPSEEK_OCR_PARTITION_RULES: a rank's decoder holds H/tp heads (q / k /
v by columns), the dense layer's I/tp MLP columns and V/tp vocab rows of
the embedding and the head; o and the dense down are row-sharded (one
f32 all_reduce each); the cache is the rank's (L, B, S, H/tp, D) slice.
The routed experts are expert-parallel: rank r holds experts [r·E/tp,
(r + 1)·E/tp) whole, the router runs on every rank and the capacity
comes from the global E and N (ops/moe.py), and the shared experts are
split as a dense MLP; a MoE layer's routed and shared partial sums go
through ONE f32 all_reduce.  The SAM and CLIP towers (or version 2's
Qwen2 encoder) run whole on every rank, as the JAX mesh replicates them.
check_tp refuses a tp that does not divide the heads (10 at the published
width: tp 4 is refused), the MLP, the vocab, the routed experts or the
shared experts' width.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.models.cache_attention import CacheAttention
from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aha_tpu_torch.ops.attention import sdpa
from aha_tpu_torch.ops.conv import conv2d, layer_norm_2d
from aha_tpu_torch.ops.moe import default_capacity, moe_ffn
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import apply_rope, gather_rope, rope_table
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_divides, text_dims
from aha_tpu_torch.utils.interpolate import interpolate


# ---------------------------------------------------------------------------
# Configs (the JAX package's defaults: HF deepseek-ai/DeepSeek-OCR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamViTConfig:
    """SAM ViTDet-B."""
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: tuple = (2, 5, 8, 11)
    net2_chans: int = 512
    net3_chans: int = 1024  # 896 for version 2


@dataclasses.dataclass(frozen=True)
class ClipViTConfig:
    """CLIP-L/14-224."""
    image_size: int = 224
    patch_size: int = 14
    num_layers: int = 24
    hidden_size: int = 1024
    num_heads: int = 16
    ffn_hidden_size: int = 4096
    eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 129280
    hidden_size: int = 1280
    intermediate_size: int = 6848
    moe_intermediate_size: int = 896
    num_hidden_layers: int = 12
    num_attention_heads: int = 10
    num_key_value_heads: int = 10
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    norm_topk_prob: bool = False
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8192
    bos_token_id: int = 0
    eos_token_id: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_routed_experts > 0 and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)


@dataclasses.dataclass(frozen=True)
class DeepseekOCRConfig:
    language: DeepseekV2Config = DeepseekV2Config()
    sam: SamViTConfig = SamViTConfig()
    clip: ClipViTConfig = ClipViTConfig()
    projector_input_dim: int = 2048
    projector_n_embed: int = 1280
    image_token_id: int = 128815
    version: int = 1  # 2 = qwen2 decoder-as-encoder, no CLIP / image_newline

    @classmethod
    def from_file(cls, model_dir: str) -> "DeepseekOCRConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            d = json.load(f)
        lang = d.get("language_config", d)
        lf = {f.name for f in dataclasses.fields(DeepseekV2Config)}
        language = DeepseekV2Config(
            **{k: v for k, v in lang.items() if k in lf})
        vis = d.get("vision_config", {})
        width = vis.get("width", {})
        sam_d = width.get("sam_vit_b", {})
        version = 2 if width.get("qwen2-0-5b") else 1
        down = sam_d.get("downsample_channels",
                         (512, 896) if version == 2 else (512, 1024))
        sam = SamViTConfig(
            img_size=vis.get("image_size", 1024),
            embed_dim=sam_d.get("width", 768),
            depth=sam_d.get("layers", 12),
            num_heads=sam_d.get("heads", 12),
            mlp_ratio=vis.get("mlp_ratio", 4.0),
            window_size=sam_d.get("window_size", 14),
            out_chans=sam_d.get("out_chans", 256),
            global_attn_indexes=tuple(
                sam_d.get("global_attn_indexes", (2, 5, 8, 11))),
            net2_chans=down[0], net3_chans=down[1])
        clip_d = width.get("clip-l-14-224") or {}
        clip = ClipViTConfig(
            image_size=clip_d.get("image_size", 224),
            patch_size=clip_d.get("patch_size", 14),
            num_layers=clip_d.get("layers", 24),
            hidden_size=clip_d.get("width", 1024),
            num_heads=clip_d.get("heads", 16),
            ffn_hidden_size=4 * clip_d.get("width", 1024))
        proj = d.get("projector_config", {})
        return cls(language=language, sam=sam, clip=clip,
                   projector_input_dim=proj.get("input_dim", 2048),
                   projector_n_embed=proj.get("n_embed", 1280),
                   image_token_id=d.get("image_token_id", 128815),
                   version=version)


#: version 2's encoder: Qwen2-0.5B's decoder geometry
QWEN2_0_5B_ENCODER = LlamaConfig(
    vocab_size=151936, hidden_size=896, intermediate_size=4864,
    num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
    rope_theta=1000000.0, rms_norm_eps=1e-6, qkv_bias=True)


def _to_dtype(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_dtype(v, dtype) for v in tree]
    return tree.to(dtype)


# ---------------------------------------------------------------------------
# SAM ViTDet encoder
# ---------------------------------------------------------------------------


def _rel_pos_table(table: torch.Tensor, q_size: int,
                   k_size: int) -> torch.Tensor:
    """get_rel_pos: the (L, hd) table resized to 2·max(q, k) − 1 rows by
    torch linear interpolation (rounded back to its dtype), then the
    (q, k) relative-coordinate rows gathered → (q, k, hd)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if table.shape[0] != max_rel_dist:
        t = interpolate(table.float().t()[None], max_rel_dist, "linear")
        table = t[0].t().to(table.dtype)
    qc = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    kc = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    idx = np.asarray(qc - kc + (k_size - 1) * max(q_size / k_size, 1.0),
                     np.int64)
    return table[torch.from_numpy(idx).to(table.device)]


def _sam_attention(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention with the decomposed relative-position bias on (B, H, W, C)
    grids: float32 scores and bias, probabilities cast to v's dtype."""
    B, H, W, C = x.shape
    hd = C // num_heads
    qkv = nn.linear_promoted(p["qkv"], x).reshape(B, H * W, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (hd ** -0.5)                                   # (B, nh, HW, HW)
    rh = _rel_pos_table(p["rel_pos_h"], H, H).to(q.dtype).float()
    rw = _rel_pos_table(p["rel_pos_w"], W, W).to(q.dtype).float()
    r_q = q.reshape(B, num_heads, H, W, hd).float()
    rel_h = torch.einsum("bnhwd,hkd->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwd,wkd->bnhwk", r_q, rw)
    # bias(q = (h, w), k = (hk, wk)) = rel_h[h, w, hk] + rel_w[h, w, wk]
    scores = scores.view(B, num_heads, H, W, H, W)
    scores += rel_h[..., :, None] + rel_w[..., None, :]
    probs = torch.softmax(scores.view(B, num_heads, H * W, H * W), dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return nn.linear_promoted(p["proj"],
                              out.transpose(1, 2).reshape(B, H, W, C))


def _window_partition(x: torch.Tensor, ws: int):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = H + ph, W + pw
    x = x.reshape(B, hp // ws, ws, wp // ws, ws, C)
    win = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return win, (hp, wp)


def _window_unpartition(win: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    C = win.shape[-1]
    B = win.shape[0] // (hp * wp // ws // ws)
    x = win.reshape(B, hp // ws, wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)
    return x[:, :h, :w]


def sam_encode(p: dict, pixels: torch.Tensor,
               cfg: SamViTConfig) -> torch.Tensor:
    """(B, 3, S, S) → (B, net3_chans, S/64, S/64)."""
    x = conv2d(p["patch"], pixels, stride=cfg.patch_size)    # (B, E, h, w)
    x = x.permute(0, 2, 3, 1)                                # (B, h, w, E)
    h = x.shape[1]
    pos = p["pos"]                                           # (1, g, g, E)
    if pos.shape[1] != h:
        pos = interpolate(pos.permute(0, 3, 1, 2).float(), (h, h),
                          "bicubic", antialias=True).permute(0, 2, 3, 1)
    x = x + pos.to(x.dtype)
    for i, bp in enumerate(p["blocks"]):
        xn = nn.ln(bp["norm1"], x, eps=1e-6)
        if i in cfg.global_attn_indexes:
            attn = _sam_attention(bp["attn"], xn, cfg.num_heads)
        else:
            win, pad_hw = _window_partition(xn, cfg.window_size)
            win = _sam_attention(bp["attn"], win, cfg.num_heads)
            attn = _window_unpartition(win, cfg.window_size, pad_hw,
                                       (x.shape[1], x.shape[2]))
        x = x + attn
        xn = nn.ln(bp["norm2"], x, eps=1e-6)
        m = F.gelu(nn.linear_promoted(bp["lin1"], xn), approximate="none")
        x = x + nn.linear_promoted(bp["lin2"], m)
    x = x.permute(0, 3, 1, 2)                                # (B, E, h, w)
    x = conv2d(p["neck0"], x)
    x = layer_norm_2d(p["neck1"], x)
    x = conv2d(p["neck2"], x, padding=1)
    x = layer_norm_2d(p["neck3"], x)
    x = conv2d(p["net2"], x, stride=2, padding=1)
    return conv2d(p["net3"], x, stride=2, padding=1)


# ---------------------------------------------------------------------------
# CLIP tower (v1) over the SAM features as patch embeddings
# ---------------------------------------------------------------------------


def clip_encode(p: dict, patch_embeds: torch.Tensor,
                cfg: ClipViTConfig) -> torch.Tensor:
    """(B, hidden, h, w) SAM features → (B, 1 + h·w, hidden); the layers
    are stacked (L, ...) as in the JAX package."""
    B, D, h, w = patch_embeds.shape
    x = patch_embeds.reshape(B, D, h * w).transpose(1, 2)
    cls = p["cls"][None, None].expand(B, 1, D).to(x.dtype)
    x = torch.cat([cls, x], dim=1)                           # (B, 1+hw, D)
    pos = p["pos"]                                           # (n_pos, D)
    src = math.isqrt(pos.shape[0] - 1)
    tgt = math.isqrt(x.shape[1])
    if src != tgt:
        grid = pos[1:].reshape(1, src, src, D).permute(0, 3, 1, 2)
        grid = interpolate(grid.float(), (tgt, tgt), "bicubic",
                           antialias=True)
        grid = grid.permute(0, 2, 3, 1).reshape(tgt * tgt, D)
        pos = torch.cat([pos[:1], grid.to(pos.dtype)], dim=0)
    x = x + pos[None].to(x.dtype)
    x = nn.ln(p["pre_ln"], x, eps=cfg.eps)
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    layers = p["layers"]
    S = x.shape[1]
    for i in range(layers["qkv"]["w"].shape[0]):
        lp = {k: {n: t[i] for n, t in v.items()} for k, v in layers.items()}
        h_ = nn.ln(lp["ln1"], x, eps=cfg.eps)
        q, k, v = nn.linear_promoted(lp["qkv"], h_).chunk(3, dim=-1)
        a = sdpa(q.reshape(B, S, nh, hd), k.reshape(B, S, nh, hd),
                 v.reshape(B, S, nh, hd)).reshape(B, S, nh * hd)
        x = x + nn.linear_promoted(lp["out"], a)
        h_ = nn.linear_promoted(lp["fc1"], nn.ln(lp["ln2"], x, eps=cfg.eps))
        # quick_gelu
        x = x + nn.linear_promoted(lp["fc2"], h_ * torch.sigmoid(1.702 * h_))
    return x


# ---------------------------------------------------------------------------
# v2: the Qwen2 decoder as encoder
# ---------------------------------------------------------------------------


def qwen2_encode(model: LlamaModel, p: dict,
                 sam_flat: torch.Tensor) -> torch.Tensor:
    """SAM tokens and learned query tokens through the Qwen2 stack with a
    mixed mask — image rows attend the image rows, query rows every image
    row and the queries before them —; the query rows' outputs.  The
    stack runs in the features' dtype."""
    B, n, _ = sam_flat.shape
    query = p["query_768"] if n == 144 else p["query_1024"]   # (n, 896)
    x = torch.cat([sam_flat, query[None].expand(B, n, query.shape[-1])
                   .to(sam_flat.dtype)], dim=1)
    ones = torch.ones((n, n), dtype=torch.bool, device=x.device)
    allow = torch.cat([torch.cat([ones, torch.zeros_like(ones)], dim=1),
                       torch.cat([ones, torch.tril(ones)], dim=1)], dim=0)
    mask = torch.where(allow, 0.0, torch.finfo(torch.float32).min)[None, None]
    return model.run_layers_no_cache(p["params"], x, mask)[:, n:]


def load_qwen2_encoder(model: LlamaModel, src, dtype: torch.dtype) -> dict:
    """Version 2's encoder under model.qwen2_model.: the Qwen2 stack's
    layers and final norm (its embedding is never read) and its two
    learned query sets (144 queries for a 768 px view, 256 for 1024).
    The stack is kept in float32, the dtype of the pixels and so of the
    SAM features it runs on, as the reference promotes it."""
    qm = "model.qwen2_model."
    stack = model.load_params(src, dtype, prefix=qm + "model.model.")
    out = {"params": _to_dtype({k: stack[k] for k in ("layers", "norm")},
                               torch.float32)}
    for n in ("query_768", "query_1024"):
        out[n] = src[f"{qm}{n}.weight"].to(device=model.device, dtype=dtype)
    return out


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class DeepseekOCRModel:
    """The model TextEngine drives.  `mm` (prefill only): "global" (n, 3,
    S, S) and optional "crops" (c, 3, s, s) pixels, "gather_idx" the
    token-order index over the projected rows (models/deepseek_ocr_served
    builds it).  Parameters: the JAX tree — "sam", "clip" (its layers
    stacked), "projector", "image_newline", "view_seperator" (or v2's
    "qwen2enc"), the decoder's "layers" as a list (dense and MoE layers
    differ), "embed", "norm", and the head vocab-major (V, K)."""

    def __init__(self, config: DeepseekOCRConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        #: the tp mesh of this rank (None on one device)
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        tp = self.mesh.tp if self.mesh is not None else 1
        check_tp(config, tp)
        c = config.language
        self.n_layers = c.num_hidden_layers
        self.n_heads = c.num_attention_heads // tp
        self.n_kv_heads = c.num_key_value_heads // tp
        #: the routed experts this rank holds
        self.n_experts = c.n_routed_experts // tp
        self.head_dim = c.head_dim
        self.cos, self.sin = rope_table(
            self.head_dim, min(max_rope_len, c.max_position_embeddings),
            c.rope_theta, device=self.device)
        self.attn = CacheAttention(self.n_layers, self.device)
        if config.version == 2:
            self.qwen2_model = LlamaModel(QWEN2_0_5B_ENCODER,
                                          max_rope_len=1024,
                                          device=self.device)

    # -- vision ---------------------------------------------------------------

    def encode_views(self, p: dict, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) views → (B, nq·nq, n_embed) projected features."""
        sam = sam_encode(p["sam"], pixels, self.config.sam)   # (B, C, h, w)
        B, C, h, w = sam.shape
        sam_flat = sam.reshape(B, C, h * w).transpose(1, 2)
        if self.config.version == 1:
            clip_out = clip_encode(p["clip"], sam, self.config.clip)
            feats = torch.cat([clip_out[:, 1:], sam_flat], dim=-1)
        else:
            feats = qwen2_encode(self.qwen2_model, p["qwen2enc"], sam_flat)
        return nn.linear_promoted(p["projector"], feats)

    def assemble_vision(self, p: dict, mm: dict) -> torch.Tensor:
        """The projected rows of every view, then image_newline (v1) and
        view_seperator, gathered into token order."""
        parts = []
        if "crops" in mm:
            cf = self.encode_views(p, mm["crops"])
            parts.append(cf.reshape(-1, cf.shape[-1]))
        gf = self.encode_views(p, mm["global"])
        parts.append(gf.reshape(-1, gf.shape[-1]))
        if "image_newline" in p:
            parts.append(p["image_newline"][None].to(gf.dtype))
        parts.append(p["view_seperator"][None].to(gf.dtype))
        return torch.cat(parts, dim=0)[mm["gather_idx"].long()]

    # -- CausalLM -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """The 5-D cache of the model's kv heads; under a mesh, this
        rank's Hkv/tp of them (DEEPSEEK_OCR_CACHE_RULES)."""
        return kv.init_kv_cache(self.n_layers, batch, max_len,
                                self.config.language.num_key_value_heads,
                                self.head_dim, dtype, self.device,
                                flat=False, mesh=self.mesh,
                                rules=self.cache_rules)

    def mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        """A layer's dense SwiGLU or its MoE over (B, S, D); the MoE's
        capacity from B·S, the padded token count, and the global expert
        count (under a mesh too)."""
        if "mlp" in lp:
            return tp_layers.swiglu_mlp(lp["mlp"], h, self.mesh)
        c = self.config.language
        B, S, D = h.shape
        out = moe_ffn(
            lp["moe"], h.reshape(B * S, D), c.num_experts_per_tok,
            scoring=c.scoring_func, norm_topk_prob=c.norm_topk_prob,
            routed_scaling_factor=c.routed_scaling_factor,
            capacity=default_capacity(B * S, c.num_experts_per_tok,
                                      c.n_routed_experts), mesh=self.mesh)
        return out.reshape(B, S, D)

    def _layer(self, lp: dict, li: int, x: torch.Tensor, cos, sin,
               cache: dict, from_cache: bool, positions: torch.Tensor,
               valid_len: torch.Tensor | None) -> torch.Tensor:
        eps = self.config.language.rms_norm_eps
        B, S, _ = x.shape
        h = rms_norm(x, lp["ln1"]["w"], eps)
        q = nn.linear(lp["q"], h).reshape(B, S, self.n_heads, self.head_dim)
        k = nn.linear(lp["k"], h).reshape(B, S, self.n_kv_heads,
                                          self.head_dim)
        v = nn.linear(lp["v"], h).reshape(B, S, self.n_kv_heads,
                                          self.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        attn = self.attn.attend(q, k, v, cache, li, positions, valid_len,
                                from_cache)
        x = x + tp_layers.row_linear(lp["o"], attn.reshape(B, S, -1),
                                     self.mesh)
        return x + self.mlp(lp, rms_norm(x, lp["ln2"]["w"], eps))

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """Embeddings (image rows spliced in by the cumsum of the image
        mask) → final-normed hidden; K/V written at [pos, pos + S), pos
        left as it was.  `window` and `prompt_len` are accepted and
        unused."""
        S = input_ids.shape[1]
        x = self.embed(params, input_ids)
        if mm is not None:
            feats = self.assemble_vision(params, mm)
            is_img = input_ids[0] == self.config.image_token_id
            idx = (torch.cumsum(is_img.long(), 0) - 1).clamp(
                0, feats.shape[0] - 1)
            x = torch.where(is_img[None, :, None],
                            feats[idx][None].to(x.dtype), x)
        positions, rope_at, valid_len = self.attn.positions(
            cache, S, self.cos.shape[0], x.device)
        cos, sin = gather_rope(self.cos, self.sin, rope_at)
        for li, lp in enumerate(params["layers"]):
            x = self._layer(lp, li, x, cos, sin, cache, from_cache,
                            positions, valid_len)
        return rms_norm(x, params["norm"]["w"],
                        self.config.language.rms_norm_eps)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embedding; under a mesh the masked lookup in the
        rank's vocab rows, summed over the ranks."""
        return tp_layers.embedding(params["embed"], input_ids,
                                   self.config.language.vocab_size, self.mesh)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The head is vocab-major (V, K); under a mesh each rank's V/tp
        columns, gathered."""
        return tp_layers.head_logits(params["lm_head"]["w"], hidden,
                                     self.config.language.vocab_size,
                                     self.mesh)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy next token for ONE hidden state (0-dim int32): under a
        mesh the value-out head kernel over this rank's vocab shard and
        the ranks' combine (parallel/layers.head_greedy)."""
        return tp_layers.head_greedy(params["lm_head"]["w"], hidden,
                                     self.config.language.vocab_size,
                                     self.mesh)

    # -- parameters -----------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of a DeepSeek-OCR checkpoint → the port's layout on
        self.device: (in, out) linears, the routed experts stacked (E, in,
        out), the router float32 (D, E).  Under a mesh each sharded tensor
        is read as this rank's slice (io/weights.shard_getters): q / k / v
        and the gates / ups by output rows, o and the downs by input
        columns, the embedding and the head by vocab rows, and only the
        rank's E/tp routed experts are read."""
        from aha_tpu_torch.io.weights import shard_getters

        c = self.config
        lc = c.language
        shard_get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def get(name, dt=dtype):
            return src[name].to(device=self.device, dtype=dt)

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        def conv(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        sm = "model.sam_model."
        sam = {"patch": conv(sm + "patch_embed.proj"),
               "pos": get(sm + "pos_embed"), "blocks": []}
        for i in range(c.sam.depth):
            b = f"{sm}blocks.{i}."
            sam["blocks"].append({
                "norm1": norm(b + "norm1"), "norm2": norm(b + "norm2"),
                "attn": {"qkv": lin(b + "attn.qkv"),
                         "proj": lin(b + "attn.proj"),
                         "rel_pos_h": get(b + "attn.rel_pos_h"),
                         "rel_pos_w": get(b + "attn.rel_pos_w")},
                "lin1": lin(b + "mlp.lin1"), "lin2": lin(b + "mlp.lin2")})
        for j in range(4):
            sam[f"neck{j}"] = conv(f"{sm}neck.{j}")
        sam["net2"] = conv(sm + "net_2")
        sam["net3"] = conv(sm + "net_3")
        params = {"sam": sam, "projector": lin("model.projector.layers"),
                  "view_seperator": get("model.view_seperator")}
        if c.version == 1:
            cl = "model.vision_model."
            layers = []
            for i in range(c.clip.num_layers):
                b = f"{cl}transformer.layers.{i}."
                layers.append({
                    "ln1": norm(b + "layer_norm1"),
                    "ln2": norm(b + "layer_norm2"),
                    "qkv": lin(b + "self_attn.qkv_proj"),
                    "out": lin(b + "self_attn.out_proj"),
                    "fc1": lin(b + "mlp.fc1"), "fc2": lin(b + "mlp.fc2")})
            params["clip"] = {
                "cls": get(cl + "embeddings.class_embedding"),
                "patch": {"w": get(cl + "embeddings.patch_embedding.weight")},
                "pos": get(cl + "embeddings.position_embedding.weight"),
                "pre_ln": norm(cl + "pre_layrnorm"),
                "layers": {k: {n: torch.stack([lp[k][n] for lp in layers])
                               for n in layers[0][k]} for k in layers[0]}}
            params["image_newline"] = get("model.image_newline")
        else:
            params["qwen2enc"] = load_qwen2_encoder(self.qwen2_model, src,
                                                    dtype)
        layers = []
        for i in range(lc.num_hidden_layers):
            p = f"model.layers.{i}."
            lp = {"ln1": norm(p + "input_layernorm"),
                  "ln2": norm(p + "post_attention_layernorm"),
                  **{n: lin(f"{p}self_attn.{n}_proj", 0)
                     for n in ("q", "k", "v")},
                  "o": lin(p + "self_attn.o_proj", 1)}
            if lc.is_moe_layer(i):
                first = (self.mesh.tp_rank * self.n_experts
                         if self.mesh is not None else 0)
                experts = {n: {"w": torch.stack([
                    get(f"{p}mlp.experts.{e}.{n}_proj.weight").t()
                    for e in range(first, first + self.n_experts)])}
                    for n in ("gate", "up", "down")}
                sh = p + "mlp.shared_experts."
                lp["moe"] = {
                    "gate": {"w": get(p + "mlp.gate.weight",
                                      torch.float32).t().contiguous()},
                    "experts": experts,
                    "shared": {"gate": lin(sh + "gate_proj", 0),
                               "up": lin(sh + "up_proj", 0),
                               "down": lin(sh + "down_proj", 1)}}
            else:
                lp["mlp"] = {"gate": lin(p + "mlp.gate_proj", 0),
                             "up": lin(p + "mlp.up_proj", 0),
                             "down": lin(p + "mlp.down_proj", 1)}
            layers.append(lp)
        params["layers"] = layers
        params["embed"] = {"w": shard_get("model.embed_tokens.weight", 0)}
        params["norm"] = norm("model.norm")
        params["lm_head"] = {"w": shard_get("lm_head.weight", 0)}  # (V, K)
        return params

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters (zero biases, unit norms) at this
        config's geometry, drawn from one generator on its device and
        moved to self.device; the router float32.  Version 2's encoder
        (`qwen2enc`) is not drawn, as in the JAX package."""
        c = self.config
        lc = c.language
        gdev = generator.device

        def w(*shape, dt=dtype):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dt)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o, bias=True, *lead):
            p = {"w": w(*lead, i, o)}
            if bias:
                p["b"] = full(0.0, *lead, o)
            return p

        def norm(d, *lead):
            return {"w": full(1.0, *lead, d), "b": full(0.0, *lead, d)}

        s = c.sam
        g = s.img_size // s.patch_size
        sam = {"patch": {"w": w(s.embed_dim, 3, s.patch_size, s.patch_size),
                         "b": full(0.0, s.embed_dim)},
               "pos": w(1, g, g, s.embed_dim), "blocks": [],
               "neck0": {"w": w(s.out_chans, s.embed_dim, 1, 1)},
               "neck1": norm(s.out_chans),
               "neck2": {"w": w(s.out_chans, s.out_chans, 3, 3)},
               "neck3": norm(s.out_chans),
               "net2": {"w": w(s.net2_chans, s.out_chans, 3, 3)},
               "net3": {"w": w(s.net3_chans, s.net2_chans, 3, 3)}}
        mlp_dim = int(s.embed_dim * s.mlp_ratio)
        hd = s.embed_dim // s.num_heads
        for i in range(s.depth):
            size = g if i in s.global_attn_indexes else s.window_size
            sam["blocks"].append({
                "norm1": norm(s.embed_dim), "norm2": norm(s.embed_dim),
                "attn": {"qkv": lin(s.embed_dim, 3 * s.embed_dim),
                         "proj": lin(s.embed_dim, s.embed_dim),
                         "rel_pos_h": w(2 * size - 1, hd),
                         "rel_pos_w": w(2 * size - 1, hd)},
                "lin1": lin(s.embed_dim, mlp_dim),
                "lin2": lin(mlp_dim, s.embed_dim)})
        params = {"sam": sam,
                  "projector": lin(c.projector_input_dim,
                                   c.projector_n_embed),
                  "view_seperator": w(c.projector_n_embed)}
        if c.version == 1:
            cv = c.clip
            L, d = cv.num_layers, cv.hidden_size
            n_pos = (cv.image_size // cv.patch_size) ** 2 + 1
            params["clip"] = {
                "cls": w(d),
                "patch": {"w": w(d, 3, cv.patch_size, cv.patch_size)},
                "pos": w(n_pos, d), "pre_ln": norm(d),
                "layers": {"ln1": norm(d, L), "ln2": norm(d, L),
                           "qkv": lin(d, 3 * d, True, L),
                           "out": lin(d, d, True, L),
                           "fc1": lin(d, cv.ffn_hidden_size, True, L),
                           "fc2": lin(cv.ffn_hidden_size, d, True, L)}}
            params["image_newline"] = w(c.projector_n_embed)
        d = lc.hidden_size
        nq = lc.num_attention_heads * self.head_dim
        nkv = lc.num_key_value_heads * self.head_dim
        layers = []
        for i in range(lc.num_hidden_layers):
            lp = {"ln1": {"w": full(1.0, d)}, "ln2": {"w": full(1.0, d)},
                  "q": lin(d, nq, False), "k": lin(d, nkv, False),
                  "v": lin(d, nkv, False), "o": lin(nq, d, False)}
            if lc.is_moe_layer(i):
                E, Fm = lc.n_routed_experts, lc.moe_intermediate_size
                Fs = Fm * lc.n_shared_experts
                lp["moe"] = {
                    "gate": {"w": w(d, E, dt=torch.float32)},
                    "experts": {"gate": {"w": w(E, d, Fm)},
                                "up": {"w": w(E, d, Fm)},
                                "down": {"w": w(E, Fm, d)}},
                    "shared": {"gate": lin(d, Fs, False),
                               "up": lin(d, Fs, False),
                               "down": lin(Fs, d, False)}}
            else:
                lp["mlp"] = {"gate": lin(d, lc.intermediate_size, False),
                             "up": lin(d, lc.intermediate_size, False),
                             "down": lin(lc.intermediate_size, d, False)}
            layers.append(lp)
        params["layers"] = layers
        params["embed"] = {"w": w(lc.vocab_size, d)}
        params["norm"] = {"w": full(1.0, d)}
        params["lm_head"] = {"w": w(lc.vocab_size, d)}
        return params


# ---------------------------------------------------------------------------
# Host geometry: the Gundam layout → a flat gather index
# ---------------------------------------------------------------------------


def deepseek_vision_layout(images: list[dict], version: int,
                           crop_rows_total: int | None = None) -> np.ndarray:
    """Token-order gather index over the concatenated feature rows.

    images: per-image dicts {"nq": crop-view queries a side, "nb":
    base-view queries a side, "wr"/"hr": the crop grid (1, 1 = no
    crops)}.  Feature rows (as assemble_vision lays them out): every crop
    view of every image first (nq·nq rows each; `crop_rows_total`
    overrides the region's size when the crop batch is padded), then
    every global view (nb·nb each), then image_newline (v1 only), then
    view_seperator.  Per image, in token order: the local rows (each
    row of tiles ending in a newline in v1), the global rows (the same),
    the view separator.
    """
    n_crop_rows = sum(d["wr"] * d["hr"] * d["nq"] ** 2 for d in images
                      if d["wr"] * d["hr"] > 1)
    if crop_rows_total is not None:
        assert crop_rows_total >= n_crop_rows
        n_crop_rows = crop_rows_total
    n_global_rows = sum(d["nb"] ** 2 for d in images)
    newline_row = n_crop_rows + n_global_rows  # v1 only
    sep_row = newline_row + (1 if version == 1 else 0)
    idx = []
    crop_base = 0
    global_base = n_crop_rows
    for d in images:
        nq, nb, wr, hr = d["nq"], d["nb"], d["wr"], d["hr"]
        if wr * hr > 1:
            # local tiles: (hr, wr, nq, nq) → (hr·nq, wr·nq) row-major
            for r in range(hr * nq):
                for cc in range(wr * nq):
                    crop = (r // nq) * wr + (cc // nq)
                    within = (r % nq) * nq + (cc % nq)
                    idx.append(crop_base + crop * nq * nq + within)
                if version == 1:
                    idx.append(newline_row)
            crop_base += wr * hr * nq * nq
        for r in range(nb):
            for cc in range(nb):
                idx.append(global_base + r * nb + cc)
            if version == 1:
                idx.append(newline_row)
        global_base += nb * nb
        idx.append(sep_row)
    return np.asarray(idx, np.int32)


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's DEEPSEEK_OCR_PARTITION_RULES on the port's layouts: the
# decoder's layers a list (dense and MoE layers differ), linears (in,
# out); the routed experts (E, in, out) split on their expert axis (each
# rank E/tp whole experts); the shared experts split as a dense MLP; the
# embedding and the head vocab-major (V, K) (the JAX head is (K, V)).  The
# router ("moe.gate.w") and the towers stay replicated.
DEEPSEEK_OCR_PARTITION_RULES = (
    (r"^layers\.\d+\.(q|k|v)\.w", (None, "tp")),
    (r"^layers\.\d+\.(q|k|v)\.b", ("tp",)),
    (r"^layers\.\d+\.o\.w", ("tp", None)),
    (r"^layers\.\d+\.mlp\.(gate|up)\.w", (None, "tp")),
    (r"^layers\.\d+\.mlp\.down\.w", ("tp", None)),
    (r"moe\.experts\.(gate|up|down)\.w", ("tp", None, None)),
    (r"moe\.shared\.(gate|up)\.w", (None, "tp")),
    (r"moe\.shared\.down\.w", ("tp", None)),
    (r"^embed\.w", ("tp", None)),
    (r"^lm_head\.w", ("tp", None)),
)
# the 5-D cache (L, B, S, Hkv, D): kv heads over tp
DEEPSEEK_OCR_CACHE_RULES = ((r"^(k|v)$", (None, None, None, "tp", None)),)
DeepseekOCRModel.partition_rules = DEEPSEEK_OCR_PARTITION_RULES
DeepseekOCRModel.cache_rules = DEEPSEEK_OCR_CACHE_RULES


def check_tp(config: DeepseekOCRConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the decoder's
    heads, kv heads, dense MLP or vocab, its routed experts or its shared
    experts' width (the JAX mesh replicates them), naming the
    dimension."""
    lc = config.language
    check_divides(tp, {**text_dims(lc),
                       "n_routed_experts": lc.n_routed_experts,
                       "the shared experts' width":
                       lc.moe_intermediate_size * lc.n_shared_experts})
