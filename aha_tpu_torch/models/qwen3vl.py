"""Qwen3-VL: a ViT with interpolated learned positions and deepstack
features, over the Qwen3 text decoder with interleaved M-RoPE
(counterpart of aha_tpu/models/qwen3vl.py).

- patch embedding as one matmul over the flattened conv3d weight, plus
  its bias; the learned (side x side) position table bilinearly
  interpolated to each grid: the 4 taps' indices and weights come from the
  host, the gather and its f32 sum run on the device;
- vision blocks: LayerNorm pre-norms, fused qkv with the 2-D (h, w)
  rotary, attention within each frame through segment_attention (the
  segment-flash kernel on the card; pad rows carry seg = -1), an MLP with
  the tanh GELU (the JAX blocks' jax.nn.gelu default);
- the 2x2 patch merger (LayerNorm before the shuffle) into the text width,
  and one deepstack merger per `deepstack_visual_indexes` block
  (LayerNorm after the shuffle, over 4 x the tower width), both with the
  exact GELU;
- the text model: the port's Qwen3Model with interleaved M-RoPE; image
  and video features spliced at their placeholder tokens, deepstack level
  i added at those positions after text layer i (the row index passed
  explicitly, not kept as model state); `rope_delta` kept in the cache for
  decode positions.

Decode runs the per-op text layers (prefill kernel, flat-cache decode
kernel, greedy head kernel) and never the fused decode stack, as the JAX
model's `_run_text` does.

Everything that depends only on the grids (the merge-unit order, frame
segments, the 4-tap position indices, M-RoPE ids, rope_delta) is numpy
on the host, once per request.

Tensor parallelism (`mesh` with tp > 1, parallel/), by
QWEN3VL_PARTITION_RULES: the text model is the sharded Qwen3Model
(models/qwen3.py), deepstack levels added to its replicated hidden after
each text layer, the M-RoPE ids replicated.  In every vision block fc1 (w
and b) is column-sharded and fc2 row-sharded (reduced in f32, its bias
added once), and so is each merger's pair; the fused-qkv attention stays
replicated, as in the JAX rules: every rank runs the tower's attention
whole.  check_tp refuses a tp that does not divide the text dimensions,
the tower's MLP or a merger's hidden width.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.models.qwen3 import (QWEN3_CACHE_RULES,
                                        QWEN3_PARTITION_RULES, Qwen3Config,
                                        Qwen3Model, fuse_decode_params)
from aha_tpu_torch.ops.attention import segment_attention
from aha_tpu_torch.ops.norms import layer_norm, rms_norm
from aha_tpu_torch.ops.rope import (apply_rope, gather_rope, mrope_cos_sin,
                                    mrope_interleaved_sections,
                                    vision_cos_sin, vision_inv_freq)
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_vl_tp


@dataclasses.dataclass(frozen=True)
class Qwen3VLVisionConfig:
    """Defaults: the JAX package's (Qwen3-VL's 27-block tower at 1152)."""
    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    in_channels: int = 3
    out_hidden_size: int = 2048
    patch_size: int = 16
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: tuple[int, ...] = (8, 16, 24)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3VLVisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: tuple(v) if isinstance(v, list) else v
             for k, v in d.items() if k in names}
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Qwen3VLConfig:
    vision: Qwen3VLVisionConfig
    text: Qwen3Config
    mrope_section: tuple[int, ...] = (24, 20, 20)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3VLConfig":
        """A config.json's dict: text fields nested under text_config or
        top-level, the M-RoPE sections under rope_scaling."""
        vision = Qwen3VLVisionConfig.from_dict(d.get("vision_config", {}))
        text_d = {**d, **d.get("text_config", {})}
        rope_scaling = text_d.get("rope_scaling") or {}
        return cls(
            vision=vision, text=Qwen3Config.from_dict(text_d),
            mrope_section=tuple(rope_scaling.get("mrope_section",
                                                 (24, 20, 20))),
            image_token_id=d.get("image_token_id", 151655),
            video_token_id=d.get("video_token_id", 151656),
            vision_start_token_id=d.get("vision_start_token_id", 151652))

    @classmethod
    def from_file(cls, model_dir: str) -> "Qwen3VLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


#: Qwen/Qwen3-VL-8B-Instruct's published text decoder (its config.json's
#: text_config)
QWEN3VL_8B_TEXT = dict(
    vocab_size=151936, hidden_size=4096, intermediate_size=12288,
    num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rms_norm_eps=1e-6, rope_theta=5e6,
    max_position_embeddings=262144, tie_word_embeddings=False)


def qwen3vl_8b(depth: int = 27, layers: int = 36,
               deepstack: tuple[int, ...] = (8, 16, 24)) -> Qwen3VLConfig:
    """Qwen3-VL-8B-Instruct's geometry (tower: 27 blocks at 1152, 16 heads
    of 72, patch 16, 2304 position embeddings, deepstack after blocks 8, 16
    and 24, out 4096), its depths cut to `depth` vision blocks (deepstack
    at `deepstack`) and `layers` text layers."""
    return Qwen3VLConfig(
        vision=Qwen3VLVisionConfig(depth=depth, out_hidden_size=4096,
                                   deepstack_visual_indexes=deepstack),
        text=Qwen3Config(**{**QWEN3VL_8B_TEXT, "num_hidden_layers": layers}),
        mrope_section=(24, 20, 20))


# ---------------------------------------------------------------------------
# Host-side geometry
# ---------------------------------------------------------------------------


def _unitize(a: np.ndarray, h: int, w: int, m: int) -> np.ndarray:
    """(h, w) row-major → merge-unit order, flat."""
    return a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)


def vision_geometry_qwen3vl(grid_thw: list[tuple[int, int, int]],
                            cfg: Qwen3VLVisionConfig) -> dict[str, np.ndarray]:
    """Per patch, in the merge-unit order the processor emits: the (h, w)
    rotary coordinates, the frame segment (one per frame of every grid),
    and the 4-tap bilinear position-table indices and weights."""
    m = cfg.spatial_merge_size
    side = int(cfg.num_position_embeddings ** 0.5)
    pos_hw, seg, pidx, pw = [], [], [], []
    frame = 0
    for (t, h, w) in grid_thw:
        hpos = np.arange(h)[:, None] * np.ones(w, np.int64)[None]
        wpos = np.ones(h, np.int64)[:, None] * np.arange(w)[None]
        hu, wu = _unitize(hpos, h, w, m), _unitize(wpos, h, w, m)
        hg = np.linspace(0, side - 1, h)
        wg = np.linspace(0, side - 1, w)
        h0, w0 = np.floor(hg).astype(np.int64), np.floor(wg).astype(np.int64)
        h1, w1 = np.minimum(h0 + 1, side - 1), np.minimum(w0 + 1, side - 1)
        dh, dw = hg - h0, wg - w0
        idx4 = np.stack([
            np.add.outer(h0 * side, w0), np.add.outer(h0 * side, w1),
            np.add.outer(h1 * side, w0), np.add.outer(h1 * side, w1)], -1)
        w4 = np.stack([
            np.outer(1 - dh, 1 - dw), np.outer(1 - dh, dw),
            np.outer(dh, 1 - dw), np.outer(dh, dw)], -1)
        idx4u = np.stack([_unitize(idx4[..., i], h, w, m)
                          for i in range(4)], -1)
        w4u = np.stack([_unitize(w4[..., i], h, w, m) for i in range(4)], -1)
        for _ in range(t):
            pos_hw.append(np.stack([hu, wu], -1))
            pidx.append(idx4u)
            pw.append(w4u)
            seg.append(np.full(h * w, frame, np.int32))
            frame += 1
    return {
        "pos_hw": np.concatenate(pos_hw).astype(np.int32),
        "seg": np.concatenate(seg),
        "pos_idx": np.concatenate(pidx).astype(np.int32),
        "pos_w": np.concatenate(pw).astype(np.float32),
    }


def get_rope_index_qwen3vl(input_ids: list[int],
                           grid_thw: list[tuple[int, int, int]],
                           cfg: Qwen3VLConfig) -> tuple[np.ndarray, int]:
    """(3, S) M-RoPE ids + rope_delta.  A video's frames come as per-frame
    (1, h, w) grids (its timestamps are in the prompt), so t advances one
    a frame."""
    m = cfg.vision.spatial_merge_size
    ids = np.asarray(input_ids)
    S = len(ids)
    pos = np.zeros((3, S), np.int64)
    vision_tokens = (cfg.image_token_id, cfg.video_token_id)
    current, img_i, i = 0, 0, 0
    while i < S:
        if ids[i] in vision_tokens:
            t, h, w = grid_thw[img_i]
            lh, lw = h // m, w // m
            n = t * lh * lw
            t_idx = np.broadcast_to(np.arange(t)[:, None, None],
                                    (t, lh, lw)) + current
            h_idx = np.broadcast_to(np.arange(lh)[None, :, None],
                                    (t, lh, lw)) + current
            w_idx = np.broadcast_to(np.arange(lw)[None, None, :],
                                    (t, lh, lw)) + current
            pos[0, i:i + n] = t_idx.reshape(-1)
            pos[1, i:i + n] = h_idx.reshape(-1)
            pos[2, i:i + n] = w_idx.reshape(-1)
            current = int(pos[:, i:i + n].max()) + 1
            i += n
            img_i += 1
        else:
            pos[:, i] = current
            current += 1
            i += 1
    return pos, int(pos.max()) + 1 - S


# ---------------------------------------------------------------------------
# The vision tower (shared by Qwen3-VL and Qwen3.5)
# ---------------------------------------------------------------------------


class Qwen3VLVisionTower:
    """The deepstack ViT on an explicit device.  Parameters: patch_embed
    (w (in_dim, d), b), pos_embed (w (n_pos, d)), merger and ds_mergers
    (norm, fc1, fc2 with biases), and a list of per-block dicts.  Under a
    tp `mesh` the MLPs and mergers are a rank's (fc1 columns, fc2 rows)."""

    def __init__(self, vision: Qwen3VLVisionConfig,
                 device: torch.device | str = "cpu", mesh=None):
        self.v = vision
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        # head_dim / 4 frequencies a row and a column: D / 2 rotary pairs
        self.inv_freq = torch.from_numpy(
            vision_inv_freq(vision.head_dim).astype(np.float32)).to(
                self.device)

    def encode(self, vp: dict, mm: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """patches (N, in_dim), padded rows with seg = -1 → (main (N_units,
        out), deepstack (n_ds, N_units, out))."""
        v = self.v
        patches = mm["patches"]
        N = patches.shape[0]
        unit = v.spatial_merge_size ** 2
        pe_w = vp["patch_embed"]["w"]
        x = patches.to(device=pe_w.device, dtype=pe_w.dtype) @ pe_w \
            + vp["patch_embed"]["b"]
        table = vp["pos_embed"]["w"]
        # the 4 taps summed in f32, then cast
        pe = (table[mm["pos_idx"].long()].float()
              * mm["pos_w"].float()[..., None]).sum(dim=1)
        x = x + pe.to(x.dtype)
        cos, sin = vision_cos_sin(self.inv_freq, mm["pos_hw"])
        seg = mm["seg"]
        H, hd = v.num_heads, v.head_dim
        ds_feats = []
        for i, lp in enumerate(vp["blocks"]):
            h = layer_norm(x, lp["norm1"]["w"], lp["norm1"].get("b"), 1e-6)
            qkv = nn.linear(lp["qkv"], h).reshape(N, 3, H, hd)
            # q/k come out of the rotary contiguous; v stays a strided view
            # of the qkv product, which the segment kernel reads in place
            q, k = apply_rope(qkv[:, 0][None], qkv[:, 1][None], cos, sin)
            attn = segment_attention(q, k, qkv[:, 2][None], seg)
            x = x + nn.linear(lp["proj"], attn.reshape(N, v.hidden_size))
            h = layer_norm(x, lp["norm2"]["w"], lp["norm2"].get("b"), 1e-6)
            x = x + tp_layers.row_linear(
                lp["fc2"], F.gelu(nn.linear(lp["fc1"], h), approximate="tanh"),
                self.mesh)
            if i in v.deepstack_visual_indexes:
                j = v.deepstack_visual_indexes.index(i)
                ds_feats.append(self._merger(vp["ds_mergers"][j], x, unit,
                                             post_shuffle=True))
        main = self._merger(vp["merger"], x, unit, post_shuffle=False)
        ds = (torch.stack(ds_feats) if ds_feats
              else main.new_zeros((0,) + tuple(main.shape)))
        return main, ds

    def _merger(self, mp: dict, x: torch.Tensor, unit: int,
                post_shuffle: bool) -> torch.Tensor:
        """2x2 shuffle into (N_units, unit · d), LayerNorm before it (the
        main merger) or after it (a deepstack merger), then fc1, the exact
        GELU and fc2."""
        N = x.shape[0]
        if post_shuffle:
            h = x.reshape(N // unit, unit * x.shape[-1])
            h = layer_norm(h, mp["norm"]["w"], mp["norm"].get("b"), 1e-6)
        else:
            h = layer_norm(x, mp["norm"]["w"], mp["norm"].get("b"), 1e-6)
            h = h.reshape(N // unit, unit * x.shape[-1])
        h = F.gelu(nn.linear(mp["fc1"], h), approximate="none")
        return tp_layers.row_linear(mp["fc2"], h, self.mesh)

    def load_params(self, src, dtype: torch.dtype, vt: str) -> dict:
        """The tower's HF names under `vt` ("visual." or "model.visual.")
        → its parameters on self.device; under a mesh, fc1 (w and b) read
        as the rank's output rows and fc2 as its input columns
        (io/weights.shard_getters)."""
        from aha_tpu_torch.io.weights import shard_getters

        v = self.v
        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        def merger(prefix):
            return {"norm": norm(prefix + "norm"),
                    "fc1": lin(prefix + "linear_fc1", 0),
                    "fc2": lin(prefix + "linear_fc2", 1)}

        in_dim = v.in_channels * v.temporal_patch_size * v.patch_size ** 2
        pe = get(vt + "patch_embed.proj.weight")
        return {
            "patch_embed": {"w": pe.reshape(v.hidden_size, in_dim).t()
                            .contiguous(),
                            "b": get(vt + "patch_embed.proj.bias")},
            "pos_embed": {"w": get(vt + "pos_embed.weight")},
            "merger": merger(vt + "merger."),
            "ds_mergers": [merger(f"{vt}deepstack_merger_list.{i}.")
                           for i in range(len(v.deepstack_visual_indexes))],
            "blocks": [{
                "norm1": norm(f"{vt}blocks.{i}.norm1"),
                "norm2": norm(f"{vt}blocks.{i}.norm2"),
                "qkv": lin(f"{vt}blocks.{i}.attn.qkv"),
                "proj": lin(f"{vt}blocks.{i}.attn.proj"),
                "fc1": lin(f"{vt}blocks.{i}.mlp.linear_fc1", 0),
                "fc2": lin(f"{vt}blocks.{i}.mlp.linear_fc2", 1),
            } for i in range(v.depth)],
        }

    def init_random(self, generator: torch.Generator, text_hidden: int,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters (zero biases, unit LayerNorms) drawn
        on the generator's device and moved to self.device."""
        v = self.v
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
        in_dim = v.in_channels * v.temporal_patch_size * v.patch_size ** 2

        def merger(post):
            return {"norm": norm(unit * d if post else d),
                    "fc1": lin(unit * d, unit * d),
                    "fc2": lin(unit * d, text_hidden)}

        return {
            "patch_embed": {"w": w(in_dim, d), "b": full(0.0, d)},
            "pos_embed": {"w": w(v.num_position_embeddings, d)},
            "merger": merger(False),
            "ds_mergers": [merger(True) for _ in v.deepstack_visual_indexes],
            "blocks": [{
                "norm1": norm(d), "norm2": norm(d),
                "qkv": lin(d, 3 * d), "proj": lin(d, d),
                "fc1": lin(d, v.intermediate_size),
                "fc2": lin(v.intermediate_size, d),
            } for _ in range(v.depth)],
        }


def splice_vision(x: torch.Tensor, input_ids: torch.Tensor,
                  feats: torch.Tensor, token_ids: tuple[int, int]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The features' rows put at the image / video placeholder positions
    of batch row 0: (x, the (S,) placeholder mask, each position's feature
    row), the last two for the deepstack injection."""
    ids = input_ids[0]
    vis = (ids == token_ids[0]) | (ids == token_ids[1])
    rows = (torch.cumsum(vis.long(), 0) - 1).clamp(0, feats.shape[0] - 1)
    x = torch.where(vis[None, :, None], feats[rows][None].to(x.dtype), x)
    return x, vis, rows


def inject_deepstack(x: torch.Tensor, ds_level: torch.Tensor,
                     vis: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One deepstack level added at the placeholder positions."""
    inject = ds_level[rows].to(x.dtype)
    return x + torch.where(vis[None, :, None], inject[None], 0.0)


class Qwen3VLModel:
    """The model TextEngine drives; `mm` (prefill only) carries the patches
    and the host indices as tensors (models/qwen3vl_served.py builds it):
    patches (N, C·tp·p·p), seg (N,) int32, pos_hw (N, 2), pos_idx (N, 4)
    int32, pos_w (N, 4) float32, position_ids (3, S), rope_delta an int.
    Parameters: {"visual": the tower's, "text": Qwen3Model's}."""

    #: from_cache suffix prefill over restored rows; rope_delta travels in
    #: the snapshot (multimodal prompts key on the mm digest)
    supports_prefix_cache = True

    def __init__(self, config: Qwen3VLConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        check_vl_tp(config, mesh.tp if mesh is not None else 1)
        self.text = Qwen3Model(config.text, max_rope_len=max_rope_len,
                               device=self.device, mesh=mesh)
        #: the tp mesh of this rank (None on one device)
        self.mesh = self.text.mesh
        self.n_layers = self.text.n_layers
        self.tower = Qwen3VLVisionTower(config.vision, self.device, mesh)
        self.sections = torch.from_numpy(mrope_interleaved_sections(
            self.text.cos.shape[-1], config.mrope_section)).to(self.device)

    @staticmethod
    def fuse_params(params: dict) -> dict:
        """The text decoder's [q|k|v] and [gate|up] fused (bit-identical);
        the tower is untouched."""
        return {**params, "text": fuse_decode_params(params["text"])}

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        cache = self.text.init_cache(batch, max_len, dtype)
        cache["rope_delta"] = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        return cache

    def encode_vision(self, vp: dict, mm: dict):
        return self.tower.encode(vp, mm)

    # -- CausalLM ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm`: encode the images / frames, splice their features and
        take interleaved M-RoPE positions (rope_delta stored in the cache).
        Without: decode, or a text-only suffix prefill over a restored
        multimodal prefix, continues at pos + rope_delta; a text-only
        prefill takes plain positions and sets rope_delta to 0.  `window`
        and `prompt_len` are accepted and unused: decode runs the per-op
        layers."""
        B, S = input_ids.shape
        text = self.text
        x = text.embed(params["text"], input_ids)
        ds = vis = rows = None
        if mm is not None:
            feats, ds = self.encode_vision(params["visual"], mm)
            x, vis, rows = splice_vision(
                x, input_ids, feats,
                (self.config.image_token_id, self.config.video_token_id))
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
        return self._run_text(params["text"], x, cache, cos, sin, ds, vis,
                              rows, from_cache)

    def _run_text(self, tp: dict, x: torch.Tensor, cache: dict, cos, sin,
                  ds, vis, rows, from_cache: bool) -> torch.Tensor:
        """The Qwen3 layers one by one (K/V written at [pos, pos + S)),
        deepstack level i added after layer i < n_ds."""
        text = self.text
        S = x.shape[1]
        pos = cache["pos"]
        positions = pos.long() + torch.arange(S, device=x.device)
        is_prefill = S > 1
        valid_len = None if is_prefill else (pos + 1).reshape(-1)
        n_ds = 0 if ds is None else ds.shape[0]
        for li, lp in enumerate(text._layer_views(tp["layers"])):
            x = text._layer(lp, li, x, cos, sin, cache, is_prefill,
                            from_cache, positions, valid_len)
            if li < n_ds:
                x = inject_deepstack(x, ds[li], vis, rows)
        return rms_norm(x, tp["norm"]["w"], self.config.text.rms_norm_eps)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.logits(params["text"], hidden)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The greedy head kernel over the text head on the card; logits +
        fast_argmax on the CPU (Qwen3Model.greedy_token)."""
        return self.text.greedy_token(params["text"], hidden)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of a Qwen3VLForConditionalGeneration checkpoint: the
        tower under visual. or model.visual., the decoder under model. or
        model.language_model."""
        vt = ("visual." if "visual.patch_embed.proj.weight" in src
              else "model.visual.")
        visual = self.tower.load_params(src, dtype, vt)
        text_prefix = ("model.language_model."
                       if "model.language_model.embed_tokens.weight" in src
                       else "model.")
        text = self.text.load_params(src, dtype=dtype, prefix=text_prefix)
        return {"visual": visual, "text": text}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters: the text decoder's, then the tower's,
        drawn from one generator."""
        text = self.text.init_random(generator, dtype, scale)
        visual = self.tower.init_random(generator,
                                        self.config.text.hidden_size, dtype,
                                        scale)
        return {"visual": visual, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's QWEN3VL_PARTITION_RULES: the text decoder's are Qwen3's (their
# regexes match under "text."); in the tower the MLPs and the mergers
# (main and deepstack) shard over tp, fc1 (w and b) by columns and fc2 by
# rows; the fused-qkv attention stays replicated.
QWEN3VL_PARTITION_RULES = (
    *QWEN3_PARTITION_RULES,
    (r"visual\.blocks\.\d+\.fc1\.w", (None, "tp")),
    (r"visual\.blocks\.\d+\.fc1\.b", ("tp",)),
    (r"visual\.blocks\.\d+\.fc2\.w", ("tp", None)),
    (r"merger.*\.fc1\.w", (None, "tp")),
    (r"merger.*\.fc1\.b", ("tp",)),
    (r"merger.*\.fc2\.w", ("tp", None)),
)
QWEN3VL_CACHE_RULES = QWEN3_CACHE_RULES
Qwen3VLModel.partition_rules = QWEN3VL_PARTITION_RULES
Qwen3VLModel.cache_rules = QWEN3VL_CACHE_RULES


#: the tp check of a VL config (text, tower MLP, merger width)
check_tp = check_vl_tp
