"""HunyuanOCR: a ViT over interpolated position embeddings with full
attention, its perceive merger, and the Hunyuan decoder (rope before the
q/k RMS norm, an alpha-scaled rope theta, xdrope on layer 0 of an image
prefill) (counterpart of aha_tpu/models/hunyuan_ocr.py).

- the tower: the patch conv as one matmul over the flattened 16 x 16
  patch plus its bias; the learned (g, g) position table (g = 2048 / 16,
  its CLS row dropped at load) resized to each image's (gh, gw) grid by
  torch's bilinear rule as two 1-D linear resizes of the (g, g, D) table
  — a (gh, g) and a (gw, g) weight matrix from the host —, rows in
  row-major patch order (the JAX package builds the dense (N, g²) product
  of the two on the host and multiplies it into the table); 27 blocks of
  LayerNorm, q / k / v / o with biases, plain masked sdpa over the patch
  bucket (as the reference, outside any Pallas kernel) and an exact-GELU
  MLP;
- perceive: an RMS norm, the m x m merge conv as one einsum over the
  host-gathered units, the exact GELU, the 1 x 1 conv, the MLP, the
  newline / begin / end rows gathered into the reference's token order by
  a host index, an RMS norm;
- the decoder over the 5-D cache (rows 1 and 8 through
  models/cache_attention.py): q / k / v, rope, then the q / k RMS norms,
  the K / V write at cache["pos"], a SwiGLU MLP, the tied head.  Layer 0
  of a prefill with images takes xdrope's cos / sin over 4 position
  channels; every other layer and every decode step the plain 1-D rope
  at cache["pos"] (a decode step is capturable: no host sync).

The towers compute in the patches' float32, as the JAX package promotes
its bf16 weights (`nn.linear_promoted`); the decoder in the parameters'
dtype.  Host geometry (the 1-D resize weights, the merge and token
gathers, the 4-channel position ids) is numpy, once per request.

Tensor parallelism (`mesh` with tp > 1, parallel/), by
HUNYUAN_OCR_PARTITION_RULES: a rank's decoder holds Hq/tp query and
Hkv/tp kv heads (q / k / v with their biases by columns), its I/tp MLP
columns and V/tp vocab rows of the tied embedding and head; o and down
are row-sharded (one f32 all_reduce each, an o bias added once); the
embedding is the masked lookup summed over the ranks, the greedy token
the value-out head kernel and the ranks' combine; the cache is the
rank's (L, B, S, Hkv/tp, D) slice.  In the tower fc1 (w and b) is
column-sharded and fc2 row-sharded, its f32 partial sums reduced once
and its bias added once — the JAX rules shard fc2's output columns and
GSPMD gathers fc1's output to feed it; the numbers are one device's up
to the order of summation.  The tower's attention and the perceive
merger run whole on every rank.  check_tp refuses a tp that does not
divide the decoder (vocab 120,818: tp 4 is refused) or the tower's MLP.
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
from aha_tpu_torch.ops.rope import gather_rope, rotate_half, rope_table
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_divides, text_dims
from aha_tpu_torch.utils.interpolate import resize_weights_1d


@dataclasses.dataclass(frozen=True)
class HunyuanVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    patch_size: int = 16
    max_image_size: int = 2048
    spatial_merge_size: int = 2
    out_hidden_size: int = 1024
    rms_norm_eps: float = 1e-5
    num_channels: int = 3

    @property
    def table_grid(self) -> int:
        """g: the learned position table is (g · g, D)."""
        return self.max_image_size // self.patch_size

    @classmethod
    def from_dict(cls, d: dict) -> "HunyuanVisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class HunyuanOCRConfig:
    """Defaults: the JAX package's (HunyuanOCR's 24-layer decoder at 1024,
    16/8 heads of 128, vocab 120818, tied; its 27-block tower)."""
    vocab_size: int = 120818
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    attention_bias: bool = False
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_alpha: float = 1.0
    xdrope_section: tuple = (16, 24, 24)
    max_position_embeddings: int = 32768
    image_token_id: int = 120120
    vision: HunyuanVisionConfig = HunyuanVisionConfig()

    @property
    def scaled_theta(self) -> float:
        """theta · alpha^(d/(d-2)) (model.rs:478-483)."""
        d = self.head_dim
        return self.rope_theta * self.rope_alpha ** (d / (d - 2))

    @classmethod
    def from_dict(cls, d: dict) -> "HunyuanOCRConfig":
        """A config.json's dict: the decoder's fields top-level,
        rope_scaling's `alpha` and `xdrope_section`, the tower under
        vision_config."""
        names = {f.name for f in dataclasses.fields(cls)} - {
            "vision", "rope_alpha", "xdrope_section"}
        kw = {k: v for k, v in d.items() if k in names}
        rs = d.get("rope_scaling", {}) or {}
        if "alpha" in rs:
            kw["rope_alpha"] = rs["alpha"]
        if "xdrope_section" in rs:
            kw["xdrope_section"] = tuple(rs["xdrope_section"])
        vision = HunyuanVisionConfig.from_dict(d.get("vision_config", {}))
        return cls(vision=vision, **kw)

    @classmethod
    def from_file(cls, model_dir: str) -> "HunyuanOCRConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


def hunyuan_ocr_default(depth: int | None = None,
                        layers: int | None = None) -> HunyuanOCRConfig:
    """The JAX package's HunyuanOCR geometry (HunyuanOCRConfig()'s
    defaults: tower 27 blocks at 1152, 16 heads of 72, MLP 4304, patch 16,
    a 128 x 128 position table, merge 2, out 1024; decoder 24 layers at
    1024, 16/8 heads of 128, MLP 3072, vocab 120818, tied), depths cut to
    `depth` blocks and `layers` decoder layers where given."""
    c = HunyuanOCRConfig()
    if depth is not None:
        c = dataclasses.replace(c, vision=dataclasses.replace(
            c.vision, num_hidden_layers=depth))
    if layers is not None:
        c = dataclasses.replace(c, num_hidden_layers=layers)
    return c


# ---------------------------------------------------------------------------
# Host geometry
# ---------------------------------------------------------------------------


def hunyuan_pos_weights(grids: list[tuple[int, int, int]], table_grid: int
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per image (t, gh, gw): the (gh, g) and (gw, g) float32 weights of
    torch's bilinear resize (align_corners False) of the (g, g) position
    table along its rows and its columns (model.rs:85-99); the image's
    table is wh @ table @ ww.T per channel, row-major (the JAX package's
    `hunyuan_pos_resample_matrix` is their outer product, (gh·gw, g²))."""
    g = table_grid
    return [(resize_weights_1d(g, gh, "linear").astype(np.float32),
             resize_weights_1d(g, gw, "linear").astype(np.float32))
            for (_, gh, gw) in grids]


def hunyuan_vision_geometry(grids: list[tuple[int, int, int]], m: int,
                            unit_bucket: int | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """(unit_gather (U, m, m), token_gather (T,)) for the perceive merger.

    unit_gather: patch-row indices of each merge unit, row-major per image.
    token_gather indexes rows = [units(0..U_pad), newline, begin, end] in
    the reference's per-image order: begin, each unit row followed by a
    newline, end (model.rs:166-194; count ph·(pw+1)+2, processor.rs:164).
    """
    units, tokens = [], []
    patch_off = 0
    for (t, gh, gw) in grids:
        for _ in range(t):
            ph, pw = gh // m, gw // m
            for r in range(ph):
                for cc in range(pw):
                    units.append([[patch_off + (r * m + i) * gw + cc * m + j
                                   for j in range(m)] for i in range(m)])
            patch_off += gh * gw
    U = len(units)
    U_pad = unit_bucket if unit_bucket is not None else U
    assert U_pad >= U
    newline, begin, end = U_pad, U_pad + 1, U_pad + 2
    unit_off = 0
    for (t, gh, gw) in grids:
        for _ in range(t):
            ph, pw = gh // m, gw // m
            tokens.append(begin)
            for r in range(ph):
                tokens.extend(range(unit_off + r * pw, unit_off + (r + 1) * pw))
                tokens.append(newline)
            tokens.append(end)
            unit_off += ph * pw
    unit_arr = np.zeros((U_pad, m, m), np.int32)
    unit_arr[:U] = np.asarray(units, np.int32).reshape(U, m, m)
    return unit_arr, np.asarray(tokens, np.int32)


def hunyuan_position_ids(input_ids: list[int],
                         grids: list[tuple[int, int, int]], m: int,
                         image_token_id: int) -> np.ndarray:
    """(4, S) xdrope position ids: [seq, h, w, t]; image token runs get
    per-row/col grid coords, t=0 (processor.rs:176-217)."""
    ids = np.asarray(input_ids)
    S = len(ids)
    seq = np.arange(S, dtype=np.int64)
    h = seq.copy()
    w = seq.copy()
    t = seq.copy()
    img_pos = np.flatnonzero(ids == image_token_id)
    cum = 0
    for (tt, gh, gw) in grids:
        for _ in range(tt):
            ph, pw = gh // m, gw // m
            n = ph * (pw + 1) + 2
            start = int(img_pos[cum]) + 1
            rep = (pw + 1) * ph
            w[start:start + rep] = np.tile(np.arange(pw + 1), ph)
            h[start:start + rep] = np.repeat(np.arange(ph), pw + 1)
            t[start:start + rep] = 0
            cum += n
    return np.stack([seq, h, w, t])


def xdrope_channels(head_dim: int, xdrope_section: tuple) -> np.ndarray:
    """Which of the 4 position channels owns each of the head_dim rotary
    columns of the full [cos | cos] row: sections of 2·s columns in turn,
    channels cycling over len(xdrope_section) (rope.rs:644-684)."""
    ch = np.zeros(head_dim, np.int64)
    off = 0
    for i, s in enumerate(xdrope_section):
        ch[off:off + 2 * s] = i % len(xdrope_section)
        off += 2 * s
    return ch


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


def hunyuan_pos_embed(table: torch.Tensor, pos_wh: torch.Tensor,
                      pos_ww: torch.Tensor, grids, n_rows: int,
                      table_grid: int) -> torch.Tensor:
    """The (n_rows, D) float32 position rows of every image's patches in
    row-major order (each image's rows repeated over its t frames), zero
    past the real patches: per image, its (gh, g) rows of `pos_wh` and
    (gw, g) rows of `pos_ww` applied to the (g, g, D) table as two
    products."""
    g = table_grid
    t3 = table.float().reshape(g, g, -1)
    parts, oh, ow = [], 0, 0
    for (t, gh, gw) in grids:
        wh, ww = pos_wh[oh:oh + gh].float(), pos_ww[ow:ow + gw].float()
        rows = torch.einsum("hi,ijd->hjd", wh, t3)          # (gh, g, D)
        img = torch.einsum("wj,hjd->hwd", ww, rows)         # (gh, gw, D)
        parts.extend([img.reshape(gh * gw, -1)] * t)
        oh, ow = oh + gh, ow + gw
    pos = torch.cat(parts)
    return F.pad(pos, (0, 0, 0, n_rows - pos.shape[0]))


class HunyuanVisionTower:
    """The ViT and its perceive merger; under a tp `mesh` each block's MLP
    is a rank's (fc1 columns, fc2 rows)."""

    def __init__(self, v: HunyuanVisionConfig, mesh=None):
        self.v = v
        self.mesh = mesh

    def encode(self, p: dict, mm: dict) -> torch.Tensor:
        """mm: patches (N, C·p·p) bucket-padded row-major, pos_wh (Σgh, g)
        and pos_ww (Σgw, g) float32, grids (the host's (t, gh, gw) per
        image), patch_mask (1, 1, 1, N) additive.  Returns per-patch
        features (N, D) BEFORE the perceive merger (the merger needs
        per-image geometry)."""
        v = self.v
        x = nn.linear_promoted(p["patch"], mm["patches"])
        pos = hunyuan_pos_embed(p["pos_embed"], mm["pos_wh"], mm["pos_ww"],
                                mm["grids"], x.shape[0], v.table_grid)
        x = x + pos.to(x.dtype)
        nh = v.num_attention_heads
        hd = v.hidden_size // nh
        mask = mm.get("patch_mask")
        blocks = p["blocks"]
        for i in range(blocks["q"]["w"].shape[0]):
            lp = nn.tree_at(blocks, i)
            h = nn.ln(lp["ln1"], x, eps=v.rms_norm_eps)
            q = nn.linear_promoted(lp["q"], h).reshape(-1, nh, hd)
            k = nn.linear_promoted(lp["k"], h).reshape(-1, nh, hd)
            vv = nn.linear_promoted(lp["v"], h).reshape(-1, nh, hd)
            a = sdpa(q[None], k[None], vv[None], mask)[0]
            x = x + nn.linear_promoted(lp["o"], a.reshape(-1, nh * hd))
            h = nn.ln(lp["ln2"], x, eps=v.rms_norm_eps)
            x = x + tp_layers.row_linear(lp["fc2"], F.gelu(
                nn.linear_promoted(lp["fc1"], h), approximate="none"),
                self.mesh, promoted=True)
        return x

    def perceive(self, p: dict, feats: torch.Tensor, mm: dict
                 ) -> torch.Tensor:
        """All images' patch features → the merged token sequence
        (model.rs:166-194): the merge conv as one einsum over the
        host-gathered m x m units, GELU, the 1 x 1 conv, the MLP; each
        row's newline and each image's begin / end gathered in by the
        host's token index."""
        v = self.v
        x = rms_norm(feats, p["before_rms"]["w"], v.rms_norm_eps)
        units = x[mm["unit_gather"].long()]               # (U, m, m, D)
        w0 = p["proj0"]["w"].to(x.dtype)                  # (2D, D, m, m)
        u = torch.einsum("uijd,odij->uo", units, w0) \
            + p["proj0"]["b"].to(x.dtype)
        u = F.gelu(u, approximate="none")
        u = nn.linear_promoted(p["proj2"], u)             # 1 x 1 conv
        rows = torch.cat([
            nn.linear_promoted(p["mlp"], u),
            nn.linear_promoted(p["mlp"], p["image_newline"][None].to(u.dtype)),
            p["image_begin"][None].to(u.dtype),
            p["image_end"][None].to(u.dtype),
        ], dim=0)
        out = rows[mm["token_gather"].long()]
        return rms_norm(out, p["after_rms"]["w"], v.rms_norm_eps)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class HunyuanOCRModel:
    """The model TextEngine drives.  `mm` (prefill only; built by
    models/hunyuan_ocr_served.build_mm): patches, pos_wh, pos_ww, grids,
    patch_mask, unit_gather, token_gather and the (4, S) position_ids.
    Parameters: the JAX tree — "visual" (the tower's blocks stacked (L,
    ...), "perceive"), the decoder's "layers" as a list, "embed", "norm",
    and the tied head vocab-major (V, K), sharing the embedding."""

    def __init__(self, config: HunyuanOCRConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        #: the tp mesh of this rank (None on one device)
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        tp = self.mesh.tp if self.mesh is not None else 1
        check_tp(config, tp)
        self.tower = HunyuanVisionTower(config.vision, self.mesh)
        c = config
        self.n_layers = c.num_hidden_layers
        self.n_heads = c.num_attention_heads // tp
        self.n_kv_heads = c.num_key_value_heads // tp
        self.head_dim = c.head_dim
        self.cos, self.sin = rope_table(
            self.head_dim, min(max_rope_len, c.max_position_embeddings),
            c.scaled_theta, device=self.device)
        self.xd_channels = torch.from_numpy(xdrope_channels(
            self.head_dim, c.xdrope_section)).to(self.device)
        self.attn = CacheAttention(self.n_layers, self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """The 5-D cache of the model's kv heads; under a mesh, this
        rank's Hkv/tp of them (HUNYUAN_OCR_CACHE_RULES)."""
        return kv.init_kv_cache(self.n_layers, batch, max_len,
                                self.config.num_key_value_heads,
                                self.head_dim, dtype, self.device,
                                flat=False, mesh=self.mesh,
                                rules=self.cache_rules)

    # -- vision ---------------------------------------------------------------

    def encode_vision(self, vp: dict, mm: dict) -> torch.Tensor:
        feats = self.tower.encode(vp, mm)
        return self.tower.perceive(vp["perceive"], feats, mm)

    def _xd_cos_sin(self, pos4: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """xdrope (rope.rs:644-684): the full [cos | cos] rows gathered at
        the 4 position channels, each column taken from its section's
        channel (cycling).  pos4: (4, S) → (S, head_dim) cos / sin."""
        cos4, sin4 = gather_rope(self.cos, self.sin, pos4)  # (4, S, hd/2)
        cos4 = torch.cat([cos4, cos4], dim=-1)              # (4, S, hd)
        sin4 = torch.cat([sin4, sin4], dim=-1)
        sel = self.xd_channels[None, None, :].expand(1, *cos4.shape[1:])
        return (torch.take_along_dim(cos4, sel, dim=0)[0],
                torch.take_along_dim(sin4, sel, dim=0)[0])

    # -- CausalLM -------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """Embeddings (image rows spliced in by the cumsum of the image
        mask) → final-normed hidden; K/V written at [pos, pos + S), pos
        left as it was.  `window` and `prompt_len` are accepted and
        unused."""
        c = self.config
        S = input_ids.shape[1]
        x = self.embed(params, input_ids)
        if mm is not None:
            feats = self.encode_vision(params["visual"], mm)
            is_img = input_ids[0] == c.image_token_id
            idx = (torch.cumsum(is_img.long(), 0) - 1).clamp(
                0, feats.shape[0] - 1)
            x = torch.where(is_img[None, :, None],
                            feats[idx][None].to(x.dtype), x)
        positions, rope_at, valid_len = self.attn.positions(
            cache, S, self.cos.shape[0], x.device)
        cos, sin = gather_rope(self.cos, self.sin, rope_at)
        cos, sin = torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)
        if mm is not None and "position_ids" in mm:
            xd_cos, xd_sin = self._xd_cos_sin(mm["position_ids"][:, :S])
        else:
            xd_cos, xd_sin = cos, sin
        for li, lp in enumerate(params["layers"]):
            ci, si = (xd_cos, xd_sin) if li == 0 else (cos, sin)
            x = self._layer(lp, li, x, ci, si, cache, from_cache, positions,
                            valid_len)
        return rms_norm(x, params["norm"]["w"], c.rms_norm_eps)

    def _layer(self, lp: dict, li: int, x: torch.Tensor, cos, sin,
               cache: dict, from_cache: bool, positions: torch.Tensor,
               valid_len: torch.Tensor | None) -> torch.Tensor:
        eps = self.config.rms_norm_eps
        B, S, _ = x.shape
        h = rms_norm(x, lp["ln1"]["w"], eps)
        q = nn.linear(lp["q"], h).reshape(B, S, self.n_heads, self.head_dim)
        k = nn.linear(lp["k"], h).reshape(B, S, self.n_kv_heads,
                                          self.head_dim)
        v = nn.linear(lp["v"], h).reshape(B, S, self.n_kv_heads,
                                          self.head_dim)
        # rope FIRST, the q / k RMS norms AFTER (model.rs:359-362)
        c2 = cos[:, None, :].to(q.dtype)
        s2 = sin[:, None, :].to(q.dtype)
        q = q * c2 + rotate_half(q) * s2
        k = k * c2 + rotate_half(k) * s2
        q = rms_norm(q, lp["q_norm"]["w"], eps)
        k = rms_norm(k, lp["k_norm"]["w"], eps)
        attn = self.attn.attend(q, k, v, cache, li, positions, valid_len,
                                from_cache)
        x = x + tp_layers.row_linear(lp["o"], attn.reshape(B, S, -1),
                                     self.mesh)
        h = rms_norm(x, lp["ln2"]["w"], eps)
        return x + tp_layers.swiglu_mlp(lp["mlp"], h, self.mesh)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embedding; under a mesh the masked lookup in the
        rank's vocab rows, summed over the ranks."""
        return tp_layers.embedding(params["embed"], input_ids,
                                   self.config.vocab_size, self.mesh)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The head is vocab-major (V, K); under a mesh each rank's V/tp
        columns, gathered."""
        return tp_layers.head_logits(params["lm_head"]["w"], hidden,
                                     self.config.vocab_size, self.mesh)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy next token for ONE hidden state (0-dim int32): under a
        mesh the value-out head kernel over this rank's vocab shard and
        the ranks' combine (parallel/layers.head_greedy)."""
        return tp_layers.head_greedy(params["lm_head"]["w"], hidden,
                                     self.config.vocab_size, self.mesh)

    # -- parameters -----------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of a HunyuanOCR checkpoint (the tower under vit., the
        decoder under model.) → the port's layout on self.device: (in, out)
        linears, the tower's blocks stacked, the position table without
        its CLS row (model.rs:55-59), the head tied to the embedding
        (model.rs:553).  Under a mesh each sharded tensor is read as this
        rank's slice (io/weights.shard_getters): q / k / v, gate / up and
        the tower's fc1 by output rows with their biases, o, down and fc2
        by input columns, the embedding by vocab rows."""
        from aha_tpu_torch.io.weights import shard_getters

        c = self.config
        v = c.vision
        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        vs = "vit."
        g = v.table_grid
        pe = get(vs + "embeddings.position_embedding.weight")
        blocks = []
        for i in range(v.num_hidden_layers):
            b = f"{vs}layers.{i}."
            blocks.append({
                "ln1": norm(b + "input_layernorm"),
                "ln2": norm(b + "post_attention_layernorm"),
                **{n: lin(f"{b}self_attn.{n}_proj") for n in "qkvo"},
                "fc1": lin(b + "mlp.dense_h_to_4h", 0),
                "fc2": lin(b + "mlp.dense_4h_to_h", 1)})
        pc = vs + "perceive."
        visual = {
            "patch": {"w": get(vs + "embeddings.patch_embedding.weight")
                      .reshape(v.hidden_size, -1).t().contiguous(),
                      "b": get(vs + "embeddings.patch_embedding.bias")},
            "pos_embed": pe[1:1 + g * g].contiguous(),
            "blocks": nn.tree_stack(blocks),
            "perceive": {
                "before_rms": norm(pc + "before_rms"),
                "after_rms": norm(pc + "after_rms"),
                "proj0": {"w": get(pc + "proj.0.weight"),
                          "b": get(pc + "proj.0.bias")},
                "proj2": {"w": get(pc + "proj.2.weight").reshape(
                    4 * v.hidden_size, 2 * v.hidden_size).t().contiguous(),
                    "b": get(pc + "proj.2.bias")},
                "mlp": lin(pc + "mlp"),
                "image_newline": get(pc + "image_newline"),
                "image_begin": get(pc + "image_begin"),
                "image_end": get(pc + "image_end")},
        }
        layers = []
        for i in range(c.num_hidden_layers):
            p = f"model.layers.{i}."
            layers.append({
                "ln1": norm(p + "input_layernorm"),
                "ln2": norm(p + "post_attention_layernorm"),
                **{n: lin(f"{p}self_attn.{n}_proj", 0) for n in "qkv"},
                "o": lin(p + "self_attn.o_proj", 1),
                "q_norm": norm(p + "self_attn.query_layernorm"),
                "k_norm": norm(p + "self_attn.key_layernorm"),
                "mlp": {"gate": lin(p + "mlp.gate_proj", 0),
                        "up": lin(p + "mlp.up_proj", 0),
                        "down": lin(p + "mlp.down_proj", 1)}})
        embed = {"w": get("model.embed_tokens.weight", 0)}
        return {"visual": visual, "layers": layers, "embed": embed,
                "norm": norm("model.norm"), "lm_head": {"w": embed["w"]}}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (the JAX
        module has none): N(0, scale) weights, zero biases, unit norms,
        drawn from one generator on its device and moved to
        self.device; the head tied to the embedding."""
        c = self.config
        v = c.vision
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o, bias=True, *lead):
            p = {"w": w(*lead, i, o)}
            if bias:
                p["b"] = full(0.0, *lead, o)
            return p

        def ln(d, *lead):
            return {"w": full(1.0, *lead, d), "b": full(0.0, *lead, d)}

        d, L, f = v.hidden_size, v.num_hidden_layers, v.intermediate_size
        g, m = v.table_grid, v.spatial_merge_size
        visual = {
            "patch": lin(v.num_channels * v.patch_size ** 2, d),
            "pos_embed": w(g * g, d),
            "blocks": {"ln1": ln(d, L), "ln2": ln(d, L),
                       **{n: lin(d, d, True, L) for n in "qkvo"},
                       "fc1": lin(d, f, True, L), "fc2": lin(f, d, True, L)},
            "perceive": {
                "before_rms": {"w": full(1.0, d)},
                "after_rms": {"w": full(1.0, v.out_hidden_size)},
                "proj0": {"w": w(2 * d, d, m, m), "b": full(0.0, 2 * d)},
                "proj2": lin(2 * d, 4 * d),
                "mlp": lin(4 * d, v.out_hidden_size),
                "image_newline": w(4 * d),
                "image_begin": w(v.out_hidden_size),
                "image_end": w(v.out_hidden_size)},
        }
        D, hd = c.hidden_size, c.head_dim
        nq, nkv = c.num_attention_heads * hd, c.num_key_value_heads * hd
        layers = [{"ln1": {"w": full(1.0, D)}, "ln2": {"w": full(1.0, D)},
                   "q": lin(D, nq, c.attention_bias),
                   "k": lin(D, nkv, c.attention_bias),
                   "v": lin(D, nkv, c.attention_bias),
                   "o": lin(nq, D, c.attention_bias),
                   "q_norm": {"w": full(1.0, hd)},
                   "k_norm": {"w": full(1.0, hd)},
                   "mlp": {"gate": lin(D, c.intermediate_size, False),
                           "up": lin(D, c.intermediate_size, False),
                           "down": lin(c.intermediate_size, D, False)}}
                  for _ in range(c.num_hidden_layers)]
        embed = {"w": w(c.vocab_size, D)}
        return {"visual": visual, "layers": layers, "embed": embed,
                "norm": {"w": full(1.0, D)}, "lm_head": {"w": embed["w"]}}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's HUNYUAN_OCR_PARTITION_RULES on the port's layouts: the
# decoder's layers a list, linears (in, out); the embedding and the tied
# head vocab-major (V, K) (the JAX head is (K, V)); the tower's blocks
# stacked (L, in, out), fc1 split by columns (w and b) and fc2 by rows —
# the JAX rule splits fc2's output columns, the port its input rows, so
# a rank's fc1 output feeds its fc2 rows without a gather.  The JAX rules
# leave the attention's and the MLP's biases to GSPMD; a rank here holds
# the slice of its columns.
HUNYUAN_OCR_PARTITION_RULES = (
    (r"^layers\.\d+\.(q|k|v)\.w", (None, "tp")),
    (r"^layers\.\d+\.(q|k|v)\.b", ("tp",)),
    (r"^layers\.\d+\.o\.w", ("tp", None)),
    (r"^layers\.\d+\.mlp\.(gate|up)\.w", (None, "tp")),
    (r"^layers\.\d+\.mlp\.(gate|up)\.b", ("tp",)),
    (r"^layers\.\d+\.mlp\.down\.w", ("tp", None)),
    (r"^embed\.w", ("tp", None)),
    (r"^lm_head\.w", ("tp", None)),
    (r"visual\.blocks\.(fc1)\.w", (None, None, "tp")),
    (r"visual\.blocks\.(fc1)\.b", (None, "tp")),
    (r"visual\.blocks\.(fc2)\.w", (None, "tp", None)),
)
# the 5-D cache (L, B, S, Hkv, D): kv heads over tp
HUNYUAN_OCR_CACHE_RULES = ((r"^(k|v)$", (None, None, None, "tp", None)),)
HunyuanOCRModel.partition_rules = HUNYUAN_OCR_PARTITION_RULES
HunyuanOCRModel.cache_rules = HUNYUAN_OCR_CACHE_RULES


def check_tp(config: HunyuanOCRConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the decoder's
    heads, kv heads, MLP or vocab, or the tower's MLP (the JAX mesh
    replicates them), naming the dimension."""
    check_divides(tp, {**text_dims(config),
                       "vision intermediate_size":
                       config.vision.intermediate_size})
