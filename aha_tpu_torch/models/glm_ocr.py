"""GLM-OCR: a GLM-4V-style vision tower over the GLM text decoder with
partial-rotary interleaved M-RoPE (counterpart of
aha_tpu/models/glm_ocr.py).

Where the reference and transformers' Glm4v disagree, the JAX package
follows transformers, and so does the port: patches in merge-blocked
order, the learned position table resampled bicubically to each grid
(border-clamped taps, as grid_sample's border padding) with a post-conv
RMS norm, q / k / v biases in the text attention where the checkpoint has
them.

- the tower: the patch conv (temporal 2 x 14 x 14) as one matmul, the
  post-conv RMS norm, the resampled positions as one host-built (N, g²)
  matrix (g = 24: small) times the table; blocks of RMS norm, a fused qkv,
  the split-half 2-D rope over (h, w) patch coordinates, plain masked sdpa
  over the patch bucket (as the reference, outside any Pallas kernel),
  the projection and a SwiGLU MLP; the post norm, the m x m downsample
  conv as one einsum over blocked units, the merger (proj, LayerNorm,
  exact GELU, SwiGLU);
- the decoder over the 5-D cache (rows 1 and 8 through
  models/cache_attention.py): four RMS norms a layer (input, after the
  attention's projection, before the MLP, after the MLP), q / k / v with
  biases where present, the rope over the first rotary_dim = head_dim / 2
  channels in interleaved pairs with t / h / w sections, the fused
  gate_up; `rope_delta` kept in the cache: an image prefill stores it, a
  decode step (or a suffix prefill over restored rows) continues at pos +
  rope_delta, a text-only prefill takes plain positions and resets it to
  0 (the JAX package's GLM prefill reads a pooled cache's stale delta
  there instead; PaddleOCR-VL's does not).

The tower computes in the patches' float32, as the JAX package promotes
its bf16 weights (`nn.linear_promoted`); the decoder in the parameters'
dtype.  Host geometry (blocked coordinates, vision cos / sin, the position
resample, M-RoPE ids and rope_delta) is numpy, once per request.

Tensor parallelism (`mesh` with tp > 1, parallel/), by
GLM_OCR_PARTITION_RULES: a rank's decoder holds Hq/tp query and Hkv/tp kv
heads (q / k / v with their biases by columns), V/tp vocab rows of the
embedding and the head, and I/tp columns of gate AND the matching I/tp
columns of up, side by side in its [gate | up] — the layer splits the
fused product with chunk(2), so a rank's halves must pair up (the JAX
rule cuts the fused matrix into contiguous columns, so at tp 2 one
device holds all of gate and GSPMD reshards around it); o and down are
row-sharded (one f32 all_reduce each); the cache is the rank's (L, B, S,
Hkv/tp, D) slice.  In the tower each block's MLP and the merger's shard
gate / up by columns (their biases with them) and down by rows, reduced
in f32; the attention, the downsample and the merger's projection run
whole on every rank.  check_tp refuses a tp that does not divide the
decoder or either MLP.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.models.cache_attention import CacheAttention
from aha_tpu_torch.ops.attention import sdpa
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import rotate_half
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_divides, text_dims
from aha_tpu_torch.utils.interpolate import resize_weights_1d


@dataclasses.dataclass(frozen=True)
class GlmOcrVisionConfig:
    depth: int = 24
    hidden_size: int = 1024
    num_heads: int = 8
    in_channels: int = 3
    image_size: int = 336
    patch_size: int = 14
    rms_norm_eps: float = 1e-5
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    out_hidden_size: int = 1536
    intermediate_size: int = 4096
    attention_bias: bool = False
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_dict(cls, d: dict) -> "GlmOcrVisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class GlmOcrTextConfig:
    vocab_size: int = 59264
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int | None = None
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.5
    mrope_section: tuple = (8, 12, 12)
    attention_bias: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim_ * self.partial_rotary_factor)


@dataclasses.dataclass(frozen=True)
class GlmOcrConfig:
    vision: GlmOcrVisionConfig = GlmOcrVisionConfig()
    text: GlmOcrTextConfig = GlmOcrTextConfig()
    image_token_id: int = 59280
    image_start_token_id: int = 59256
    image_end_token_id: int = 59257

    @classmethod
    def from_dict(cls, d: dict) -> "GlmOcrConfig":
        """A config.json's dict: text_config (or the top level) with its
        rope under rope_parameters or rope_scaling, vision_config."""
        tc = d.get("text_config", d)
        rp = tc.get("rope_parameters") or tc.get("rope_scaling") or {}
        tf = {f.name for f in dataclasses.fields(GlmOcrTextConfig)}
        text_kw = {k: v for k, v in tc.items() if k in tf}
        if "mrope_section" in rp:
            text_kw["mrope_section"] = tuple(rp["mrope_section"])
        if "partial_rotary_factor" in rp:
            text_kw["partial_rotary_factor"] = rp["partial_rotary_factor"]
        if "rope_theta" in rp:
            text_kw["rope_theta"] = rp["rope_theta"]
        return cls(vision=GlmOcrVisionConfig.from_dict(
                       d.get("vision_config", {})),
                   text=GlmOcrTextConfig(**text_kw),
                   image_token_id=d.get("image_token_id", 59280),
                   image_start_token_id=d.get("image_start_token_id", 59256),
                   image_end_token_id=d.get("image_end_token_id", 59257))

    @classmethod
    def from_file(cls, model_dir: str) -> "GlmOcrConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Host geometry
# ---------------------------------------------------------------------------


def glm_vision_geometry(grids: list[tuple[int, int, int]],
                        v: GlmOcrVisionConfig) -> dict:
    """Per-patch (h, w) coordinates and image index in merge-blocked order
    (transformers Glm4vVisionModel.rot_pos_emb)."""
    m = v.spatial_merge_size
    hs, ws, seg = [], [], []
    for n, (t, h, w) in enumerate(grids):
        hp = np.broadcast_to(np.arange(h)[:, None], (h, w))
        wp = np.broadcast_to(np.arange(w)[None, :], (h, w))

        def block(a):
            return (a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3)
                    .reshape(-1))

        hs.append(np.tile(block(hp), t))
        ws.append(np.tile(block(wp), t))
        seg.append(np.full(t * h * w, n, np.int32))
    return {"h": np.concatenate(hs).astype(np.int32),
            "w": np.concatenate(ws).astype(np.int32),
            "seg": np.concatenate(seg)}


def glm_rope_index(input_ids: list[int], grids: list[tuple[int, int, int]],
                   cfg: GlmOcrConfig) -> tuple[np.ndarray, int]:
    """(3, S) t/h/w position ids + rope_delta (model.rs:1088-1167)."""
    m = cfg.vision.spatial_merge_size
    ids = np.asarray(input_ids)
    pos = np.zeros((3, len(ids)), np.int64)
    st = 0
    i = 0
    g = 0
    while i < len(ids):
        if ids[i] == cfg.image_token_id:
            t, h, w = grids[g]
            g += 1
            lh, lw = h // m, w // m
            n = t * lh * lw
            pos[0, i:i + n] = np.repeat(np.arange(t), lh * lw) + st
            pos[1, i:i + n] = np.tile(np.repeat(np.arange(lh), lw), t) + st
            pos[2, i:i + n] = np.tile(np.arange(lw), t * lh) + st
            st += max(t, lh, lw)
            i += n
        else:
            start = i
            while i < len(ids) and ids[i] != cfg.image_token_id:
                i += 1
            pos[:, start:i] = st + np.arange(i - start)
            st += i - start
    return pos, int(st - len(ids))


def glm_vision_rope(h: np.ndarray, w: np.ndarray, v: GlmOcrVisionConfig
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(N, hd) float32 cos / sin from 2-D coords (model.rs:271-341): the h
    frequencies then the w ones, the row twice (split-half rotation)."""
    dim = v.head_dim // 2
    inv = 1.0 / (v.rope_theta ** (np.arange(0, dim, 2) / dim))
    freqs = np.concatenate([h[:, None] * inv[None], w[:, None] * inv[None]],
                           axis=1)                       # (N, hd/2)
    emb = np.concatenate([freqs, freqs], axis=1)          # (N, hd)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def glm_pos_resample_matrix(geom: dict, grids: list[tuple[int, int, int]],
                            table_grid: int) -> np.ndarray:
    """(N, g²) matrix R with R @ pos_table == the per-patch interpolated
    position embedding: torch's bicubic resize (a = -0.75, border-clamped
    taps) of the (g, g) table to each image's grid, gathered at the
    blocked coordinates (transformers Glm4vVisionEmbeddings with
    grid_sample padding_mode=border).  At g = 24 the matrix is N x 576."""
    g = table_grid
    rows = np.zeros((len(geom["h"]), g * g), np.float32)
    for n, (t, gh, gw) in enumerate(grids):
        sel = geom["seg"] == n
        wh = resize_weights_1d(g, gh, "cubic")            # (gh, g)
        ww = resize_weights_1d(g, gw, "cubic")            # (gw, g)
        rows[sel] = (wh[geom["h"][sel]][:, :, None]
                     * ww[geom["w"][sel]][:, None, :]).reshape(sel.sum(),
                                                               g * g)
    return rows


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


def _rot_vision(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """Split-half rotation of (N, nh, hd) by (N, hd) tables
    (rope.rs:75-94)."""
    c = cos[:, None, :].to(x.dtype)
    s = sin[:, None, :].to(x.dtype)
    return x * c + rotate_half(x) * s


class GlmOcrVisionTower:
    """The GLM-4V tower and its merger; under a tp `mesh` each SwiGLU (a
    block's, the merger's) is a rank's (gate / up columns, down rows)."""

    def __init__(self, v: GlmOcrVisionConfig, mesh=None):
        self.v = v
        self.mesh = mesh

    def _swiglu(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        """down(SiLU(gate(h)) · up(h)), promoted to h's float32; down's
        f32 partial sums reduced over the ranks."""
        return tp_layers.row_linear(
            p["down"], F.silu(nn.linear_promoted(p["gate"], h))
            * nn.linear_promoted(p["up"], h), self.mesh, promoted=True)

    def encode(self, p: dict, mm: dict) -> torch.Tensor:
        """mm: patches (N, C·tp·p·p) padded to a bucket, vis_cos / vis_sin
        (N, hd), pos_resample (N, g²) and patch_mask (1, 1, 1, N) masking
        the padded keys → the merged (N / m², out_hidden) features."""
        v = self.v
        eps = v.rms_norm_eps
        x = nn.linear_promoted(p["patch"], mm["patches"])   # (N, D)
        x = rms_norm(x, p["post_conv_norm"]["w"], eps)
        pos = mm["pos_resample"].float() @ p["pos_embed"].float()
        x = x + pos.to(x.dtype)
        cos, sin = mm["vis_cos"], mm["vis_sin"]
        nh, hd = v.num_heads, v.head_dim
        mask = mm.get("patch_mask")
        blocks = p["blocks"]
        for i in range(blocks["qkv"]["w"].shape[0]):
            lp = nn.tree_at(blocks, i)
            h = rms_norm(x, lp["norm1"]["w"], eps)
            qkv = nn.linear_promoted(lp["qkv"], h).reshape(-1, 3, nh, hd)
            q = _rot_vision(qkv[:, 0], cos, sin)
            k = _rot_vision(qkv[:, 1], cos, sin)
            a = sdpa(q[None], k[None], qkv[:, 2][None], mask)[0]
            x = x + nn.linear_promoted(lp["proj"], a.reshape(-1, nh * hd))
            h = rms_norm(x, lp["norm2"]["w"], eps)
            x = x + self._swiglu(lp["mlp"], h)
        x = rms_norm(x, p["post_norm"]["w"], eps)
        # the m x m stride-m downsample over one blocked unit: one
        # full-window dot product a unit
        m = v.spatial_merge_size
        x = x.reshape(-1, m, m, v.hidden_size)
        w = p["downsample"]["w"].to(x.dtype)                 # (O, D, m, m)
        x = torch.einsum("nijd,odij->no", x, w) \
            + p["downsample"]["b"].to(x.dtype)
        mp = p["merger"]                                     # model.rs:604-653
        h = nn.linear_promoted(mp["proj"], x)
        h = nn.ln(mp["post_norm"], h, eps=eps)
        h = F.gelu(h, approximate="none")
        return self._swiglu(mp, h)


# ---------------------------------------------------------------------------
# Decoder rope: partial, interleaved, t / h / w sections
# ---------------------------------------------------------------------------


def _glm_mrope_cos_sin(pos: torch.Tensor, cfg: GlmOcrTextConfig,
                       inv: torch.Tensor, axes: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """pos (3, S) → interleaved cos / sin (S, rotary_dim) in float32
    (rope.rs:245-313 / transformers apply_multimodal_rotary_pos_emb):
    column c of the [f | f] row takes its section's axis (cycling t, h,
    w), then the first half's values each repeated twice.  `inv` / `axes`:
    glm_inv_freq's (rotary_dim / 2,) float32 frequencies and
    glm_mrope_axes on pos's device, made once (a captured step reads
    them)."""
    rd = cfg.rotary_dim
    freqs = pos[:, :, None].float() * inv[None, None]     # (3, S, rd/2)
    emb = torch.cat([freqs, freqs], dim=-1)               # (3, S, rd)
    cos, sin = torch.cos(emb), torch.sin(emb)
    sel = axes[None, None, :].expand(1, *cos.shape[1:])
    cos = torch.take_along_dim(cos, sel, dim=0)[0]        # (S, rd)
    sin = torch.take_along_dim(sin, sel, dim=0)[0]
    return (torch.repeat_interleave(cos[:, :rd // 2], 2, dim=-1),
            torch.repeat_interleave(sin[:, :rd // 2], 2, dim=-1))


def glm_inv_freq(cfg: GlmOcrTextConfig, device) -> torch.Tensor:
    """The rotary_dim / 2 frequencies θ^(-2i / rotary_dim), computed in
    float64 and cast to float32, as the JAX package does."""
    rd = cfg.rotary_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rd, 2) / rd))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def glm_mrope_axes(cfg: GlmOcrTextConfig) -> np.ndarray:
    """The axis (0 t, 1 h, 2 w) of each of the rotary_dim columns:
    sections of 2·s columns in turn, cycling over the three."""
    axes = np.zeros(cfg.rotary_dim, np.int64)
    off = 0
    for i, s in enumerate(cfg.mrope_section):
        axes[off:off + 2 * s] = i % 3
        off += 2 * s
    return axes


def _apply_partial_interleaved(x: torch.Tensor, cos: torch.Tensor,
                               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first rotary_dim channels of (B, S, H, hd) in
    interleaved pairs; the rest pass through."""
    rd = cos.shape[-1]
    xr, xp = x[..., :rd], x[..., rd:]
    pairs = xr.reshape(*xr.shape[:-1], rd // 2, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]],
                      dim=-1).reshape(xr.shape)
    c = cos[:, None, :].to(x.dtype)
    s = sin[:, None, :].to(x.dtype)
    return torch.cat([xr * c + rot * s, xp], dim=-1)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class GlmOcrModel:
    """The model TextEngine drives.  `mm` (prefill only; built by
    models/glm_ocr_served.build_mm): patches, vis_cos, vis_sin,
    pos_resample, patch_mask, the (3, S) position_ids and rope_delta (an
    int).  Parameters: the JAX tree — {"visual": the tower (blocks stacked
    (L, ...)), "text": embed, layers stacked (L, ...), norm, the head
    vocab-major (V, K)}."""

    def __init__(self, config: GlmOcrConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        #: the tp mesh of this rank (None on one device)
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        tp = self.mesh.tp if self.mesh is not None else 1
        check_tp(config, tp)
        self.tower = GlmOcrVisionTower(config.vision, self.mesh)
        c = config.text
        self.n_layers = c.num_hidden_layers
        self.n_heads = c.num_attention_heads // tp
        self.n_kv_heads = c.num_key_value_heads // tp
        self.head_dim = c.head_dim_
        # kept: a captured decode step reads them
        self.inv_freq = glm_inv_freq(c, self.device)
        self.mrope_axes = torch.from_numpy(glm_mrope_axes(c)).to(self.device)
        self.attn = CacheAttention(self.n_layers, self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        cache = kv.init_kv_cache(self.n_layers, batch, max_len,
                                 self.config.text.num_key_value_heads,
                                 self.head_dim, dtype, self.device,
                                 flat=False, mesh=self.mesh,
                                 rules=self.cache_rules)
        cache["rope_delta"] = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        return cache

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm`: encode the images, splice their features at the
        image-token positions, take the M-RoPE ids (rope_delta stored in
        the cache).  Without: a decode step (or a suffix prefill over
        restored rows) continues at pos + rope_delta; a text-only prefill
        takes plain positions and resets rope_delta to 0.  `window` and
        `prompt_len` are accepted and unused."""
        c = self.config.text
        tp = params["text"]
        S = input_ids.shape[1]
        x = self.embed(tp, input_ids)
        offset = None
        if mm is not None:
            feats = self.tower.encode(params["visual"], mm)
            is_img = input_ids[0] == self.config.image_token_id
            idx = (torch.cumsum(is_img.long(), 0) - 1).clamp(
                0, feats.shape[0] - 1)
            x = torch.where(is_img[None, :, None],
                            feats[idx][None].to(x.dtype), x)
            pos3 = mm["position_ids"][:, :S]
            cache["rope_delta"].fill_(int(mm["rope_delta"]))
        elif S == 1 or from_cache:
            offset = cache["rope_delta"]
        else:
            cache["rope_delta"].zero_()
        positions, rope_at, valid_len = self.attn.positions(
            cache, S, c.max_position_embeddings, x.device, offset)
        if mm is None:
            pos3 = rope_at.reshape(1, S).expand(3, S)
        cos, sin = _glm_mrope_cos_sin(pos3, c, self.inv_freq,
                                      self.mrope_axes)
        layers = tp["layers"]
        for li in range(self.n_layers):
            x = self._layer(nn.tree_at(layers, li), li, x, cos, sin, cache,
                            from_cache, positions, valid_len)
        return rms_norm(x, tp["norm"]["w"], c.rms_norm_eps)

    def _layer(self, lp: dict, li: int, x: torch.Tensor, cos, sin,
               cache: dict, from_cache: bool, positions: torch.Tensor,
               valid_len: torch.Tensor | None) -> torch.Tensor:
        eps = self.config.text.rms_norm_eps
        B, S, _ = x.shape
        h = rms_norm(x, lp["ln_in"]["w"], eps)
        q = nn.linear(lp["q"], h).reshape(B, S, self.n_heads, self.head_dim)
        k = nn.linear(lp["k"], h).reshape(B, S, self.n_kv_heads,
                                          self.head_dim)
        v = nn.linear(lp["v"], h).reshape(B, S, self.n_kv_heads,
                                          self.head_dim)
        q = _apply_partial_interleaved(q, cos, sin)
        k = _apply_partial_interleaved(k, cos, sin)
        attn = self.attn.attend(q, k, v, cache, li, positions, valid_len,
                                from_cache)
        attn = tp_layers.row_linear(lp["o"], attn.reshape(B, S, -1),
                                    self.mesh)
        x = x + rms_norm(attn, lp["ln_post_attn"]["w"], eps)
        h = rms_norm(x, lp["ln_mid"]["w"], eps)
        g, u = nn.linear(lp["gate_up"], h).chunk(2, dim=-1)
        h = tp_layers.row_linear(lp["down"], F.silu(g) * u, self.mesh)
        return x + rms_norm(h, lp["ln_post_mlp"]["w"], eps)

    def embed(self, tp: dict, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embedding of the text tree `tp`; under a mesh the
        masked lookup in the rank's vocab rows, summed over the ranks."""
        return tp_layers.embedding(tp["embed"], input_ids,
                                   self.config.text.vocab_size, self.mesh)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The head is vocab-major (V, K); under a mesh each rank's V/tp
        columns, gathered."""
        return tp_layers.head_logits(params["text"]["lm_head"]["w"], hidden,
                                     self.config.text.vocab_size, self.mesh)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy next token for ONE hidden state (0-dim int32): under a
        mesh the value-out head kernel over this rank's vocab shard and
        the ranks' combine (parallel/layers.head_greedy)."""
        return tp_layers.head_greedy(params["text"]["lm_head"]["w"], hidden,
                                     self.config.text.vocab_size, self.mesh)

    # -- parameters -----------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of a GLM-OCR checkpoint (the tower under
        model.visual., the decoder under model.language_model.) → the
        port's layout on self.device: (in, out) linears, blocks and layers
        stacked, lm_head where the checkpoint has one (else tied).  Under a
        mesh each sharded tensor is read as this rank's slice
        (io/weights.shard_getters): q / k / v and the towers' gate / up by
        output rows with their biases, [gate | up] as the rank's rows of
        each half, o and the downs by input columns, the embedding and the
        head by vocab rows."""
        from aha_tpu_torch.io.weights import shard_getters

        c = self.config
        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def swiglu(prefix):
            return {"gate": lin(prefix + "gate_proj", 0),
                    "up": lin(prefix + "up_proj", 0),
                    "down": lin(prefix + "down_proj", 1)}

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        vs = "model.visual."
        blocks = [{"norm1": norm(f"{vs}blocks.{i}.norm1"),
                   "norm2": norm(f"{vs}blocks.{i}.norm2"),
                   "qkv": lin(f"{vs}blocks.{i}.attn.qkv"),
                   "proj": lin(f"{vs}blocks.{i}.attn.proj"),
                   "mlp": swiglu(f"{vs}blocks.{i}.mlp.")}
                  for i in range(c.vision.depth)]
        patch = {"w": get(vs + "patch_embed.proj.weight").reshape(
            c.vision.hidden_size, -1).t().contiguous()}
        if vs + "patch_embed.proj.bias" in src:
            patch["b"] = get(vs + "patch_embed.proj.bias")
        visual = {
            "patch": patch,
            "post_conv_norm": norm(vs + "post_conv_layernorm"),
            "pos_embed": get(vs + "embeddings.position_embedding.weight"),
            "blocks": nn.tree_stack(blocks),
            "post_norm": norm(vs + "post_layernorm"),
            "downsample": {"w": get(vs + "downsample.weight"),
                           "b": get(vs + "downsample.bias")},
            "merger": {"proj": lin(vs + "merger.proj"),
                       "post_norm": norm(vs + "merger.post_projection_norm"),
                       **swiglu(vs + "merger.")},
        }
        ts = "model.language_model."
        layers = [{"ln_in": norm(f"{ts}layers.{i}.input_layernorm"),
                   "ln_mid": norm(f"{ts}layers.{i}.post_attention_layernorm"),
                   "ln_post_attn": norm(
                       f"{ts}layers.{i}.post_self_attn_layernorm"),
                   "ln_post_mlp": norm(f"{ts}layers.{i}.post_mlp_layernorm"),
                   **{n: lin(f"{ts}layers.{i}.self_attn.{n}_proj", 0)
                      for n in "qkv"},
                   "o": lin(f"{ts}layers.{i}.self_attn.o_proj", 1),
                   "gate_up": lin(f"{ts}layers.{i}.mlp.gate_up_proj", 0,
                                  chunks=2),
                   "down": lin(f"{ts}layers.{i}.mlp.down_proj", 1)}
                  for i in range(c.text.num_hidden_layers)]
        embed = {"w": get(ts + "embed_tokens.weight", 0)}
        head = ({"w": get("lm_head.weight", 0)} if "lm_head.weight" in src
                else {"w": embed["w"]})
        return {"visual": visual,
                "text": {"embed": embed, "layers": nn.tree_stack(layers),
                         "norm": norm(ts + "norm"), "lm_head": head}}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (the JAX
        module has none): N(0, scale) weights, zero biases, unit norms,
        drawn from one generator on its device and moved to self.device;
        an untied head.  As transformers' Glm4v sizes them, the blocks'
        MLP is out_hidden_size wide and the merger's intermediate_size."""
        c = self.config
        v, t = c.vision, c.text
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o, bias, *lead):
            p = {"w": w(*lead, i, o)}
            if bias:
                p["b"] = full(0.0, *lead, o)
            return p

        def rms(d, *lead):
            return {"w": full(1.0, *lead, d)}

        d, L, f, m = v.hidden_size, v.depth, v.intermediate_size, \
            v.spatial_merge_size
        g = v.image_size // v.patch_size
        o = v.out_hidden_size
        patch_in = v.in_channels * v.temporal_patch_size * v.patch_size ** 2
        visual = {
            "patch": lin(patch_in, d, True),
            "post_conv_norm": rms(d),
            "pos_embed": w(g * g, d),
            "blocks": {"norm1": rms(d, L), "norm2": rms(d, L),
                       "qkv": lin(d, 3 * d, v.attention_bias, L),
                       "proj": lin(d, d, v.attention_bias, L),
                       "mlp": {"gate": lin(d, o, False, L),
                               "up": lin(d, o, False, L),
                               "down": lin(o, d, False, L)}},
            "post_norm": rms(d),
            "downsample": {"w": w(o, d, m, m), "b": full(0.0, o)},
            "merger": {"proj": lin(o, o, False),
                       "post_norm": {"w": full(1.0, o), "b": full(0.0, o)},
                       "gate": lin(o, f, False), "up": lin(o, f, False),
                       "down": lin(f, o, False)},
        }
        D, hd, Lt = t.hidden_size, t.head_dim_, t.num_hidden_layers
        nq, nkv = t.num_attention_heads * hd, t.num_key_value_heads * hd
        bias = t.attention_bias
        text = {"embed": {"w": w(t.vocab_size, D)},
                "layers": {"ln_in": rms(D, Lt), "ln_mid": rms(D, Lt),
                           "ln_post_attn": rms(D, Lt),
                           "ln_post_mlp": rms(D, Lt),
                           "q": lin(D, nq, bias, Lt),
                           "k": lin(D, nkv, bias, Lt),
                           "v": lin(D, nkv, bias, Lt),
                           "o": lin(nq, D, False, Lt),
                           "gate_up": lin(D, 2 * t.intermediate_size, False,
                                          Lt),
                           "down": lin(t.intermediate_size, D, False, Lt)},
                "norm": rms(D), "lm_head": {"w": w(t.vocab_size, D)}}
        return {"visual": visual, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's GLM_OCR_PARTITION_RULES on the port's layouts: linears stacked
# (L, in, out); the embedding and the head vocab-major (V, K) (the JAX
# head is (K, V)).  The fused [gate | up] takes ("tp", 2): each half split
# over the ranks and a rank's parts kept side by side — the port's layer
# splits the product with chunk(2) — where the JAX rule cuts the fused
# columns contiguously and GSPMD reshards.  The JAX rules leave the
# decoder's q / k / v biases to GSPMD; a rank here holds the slice of its
# columns.
GLM_OCR_PARTITION_RULES = (
    (r"text\.layers\.(q|k|v)\.w", (None, None, "tp")),
    (r"text\.layers\.(q|k|v)\.b", (None, "tp")),
    (r"text\.layers\.o\.w", (None, "tp", None)),
    (r"text\.layers\.gate_up\.w", (None, None, ("tp", 2))),
    (r"text\.layers\.down\.w", (None, "tp", None)),
    (r"text\.embed\.w", ("tp", None)),
    (r"text\.lm_head\.w", ("tp", None)),
    (r"visual\.blocks\.mlp\.(gate|up)\.w", (None, None, "tp")),
    (r"visual\.blocks\.mlp\.(gate|up)\.b", (None, "tp")),
    (r"visual\.blocks\.mlp\.down\.w", (None, "tp", None)),
    (r"visual\.merger\.(gate|up)\.w", (None, "tp")),
    (r"visual\.merger\.(gate|up)\.b", ("tp",)),
    (r"visual\.merger\.down\.w", ("tp", None)),
)
# the 5-D cache (L, B, S, Hkv, D): kv heads over tp
GLM_OCR_CACHE_RULES = ((r"^(k|v)$", (None, None, None, "tp", None)),)
GlmOcrModel.partition_rules = GLM_OCR_PARTITION_RULES
GlmOcrModel.cache_rules = GLM_OCR_CACHE_RULES


def check_tp(config: GlmOcrConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the decoder's
    heads, kv heads, MLP or vocab, a tower block's MLP (out_hidden_size
    wide) or the merger's (intermediate_size), naming the dimension."""
    v = config.vision
    check_divides(tp, {**text_dims(config.text),
                       "vision out_hidden_size": v.out_hidden_size,
                       "vision intermediate_size": v.intermediate_size})
