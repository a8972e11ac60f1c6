"""Qwen2.5-VL: windowed ViT vision tower + Qwen2 text decoder with M-RoPE
(counterpart of aha_tpu/models/qwen2_5vl.py).

- patch embedding as one matmul over the flattened conv3d weight;
- vision blocks: fused qkv, rms norms, SwiGLU MLP with biases, 2-D rotary
  over the (h, w) patch coordinates; window attention, with full-image
  attention at `fullatt_block_indexes` — both through segment_attention
  (the segment-flash kernel on the card), seg ids per permuted patch;
- the 2x2 patch merger into the text hidden size;
- the text model: LlamaModel in its Qwen2 form (q/k/v bias) over the 5-D
  cache, with M-RoPE sections; image features spliced at the image-token
  positions; `rope_delta` kept in the cache for decode positions.

Everything that depends only on the image grids (window permutation,
segment ids, rotary coordinates, M-RoPE text positions, rope_delta) is
computed on the host in numpy, once per request, as in the JAX package.
The linears, the patch embedding and the merger stay torch.matmul.

Tensor parallelism (`mesh` with tp > 1, parallel/), by
QWEN2_5VL_PARTITION_RULES: the text model is the sharded LlamaModel
(models/llama.py); in the windowed tower's gated MLPs gate / up (w and
b) are column-sharded and down row-sharded, in the merger mlp0 (w and b)
column- and mlp2 row-sharded (each row-sharded product reduced in f32,
its bias added once); the fused-qkv window and full attention stay
replicated, as in the JAX rules.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.core.engine import mm_to  # noqa: F401 — re-exported
from aha_tpu_torch.models.llama import (LLAMA_CACHE_RULES,
                                        LLAMA_PARTITION_RULES, LlamaConfig,
                                        LlamaModel)
from aha_tpu_torch.ops.attention import segment_attention
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import (apply_rope, gather_rope, mrope_cos_sin,
                                    mrope_sections, vision_cos_sin,
                                    vision_inv_freq)
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_vl_tp


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_chans: int = 3
    out_hidden_size: int = 2048
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    tokens_per_second: int = 4

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_dict(cls, d: dict) -> "VisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: tuple(v) if isinstance(v, list) else v
             for k, v in d.items() if k in names}
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Qwen2_5VLConfig:
    vision: VisionConfig
    text: LlamaConfig
    mrope_section: tuple[int, ...] = (16, 24, 24)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    rms_norm_eps: float = 1e-6

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen2_5VLConfig":
        vision = VisionConfig.from_dict(d.get("vision_config", {}))
        # original checkpoints keep text fields top-level; newer HF exports
        # nest them under text_config — merge both views
        text_d = {**d, **d.get("text_config", {})}
        text = LlamaConfig.from_dict({**text_d, "qkv_bias": True})
        rope_scaling = text_d.get("rope_scaling") or {}
        mrope = tuple(rope_scaling.get("mrope_section", (16, 24, 24)))
        return cls(
            vision=vision, text=text, mrope_section=mrope,
            image_token_id=d.get("image_token_id", 151655),
            video_token_id=d.get("video_token_id", 151656),
            vision_start_token_id=d.get("vision_start_token_id", 151652),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6))

    @classmethod
    def from_file(cls, model_dir: str) -> "Qwen2_5VLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


#: Qwen/Qwen2.5-VL-3B-Instruct's published text decoder (its config.json);
#: VisionConfig's defaults are its tower
QWEN2_5VL_3B_TEXT = dict(
    vocab_size=151936, hidden_size=2048, intermediate_size=11008,
    num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=2,
    rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=128000,
    tie_word_embeddings=True, qkv_bias=True)


def qwen2_5vl_3b(depth: int = 32, layers: int = 36,
                 fullatt: tuple[int, ...] = (7, 15, 23, 31),
                 **tokens) -> Qwen2_5VLConfig:
    """Qwen2.5-VL-3B-Instruct's geometry, its depths cut to `depth` vision
    blocks (full attention at `fullatt`) and `layers` text layers."""
    return Qwen2_5VLConfig(
        vision=VisionConfig(depth=depth, fullatt_block_indexes=fullatt),
        text=LlamaConfig(**{**QWEN2_5VL_3B_TEXT,
                            "num_hidden_layers": layers}),
        mrope_section=(16, 24, 24), **tokens)


# ---------------------------------------------------------------------------
# Host-side geometry: window permutation, segments, rotary ids, M-RoPE ids
# ---------------------------------------------------------------------------


def vision_geometry(grid_thw: list[tuple[int, int, int]], cfg: VisionConfig
                    ) -> dict[str, np.ndarray]:
    """All grid-dependent indices, computed once per request on the host.

    Returns (over the merge-unit axis N_units = N_patches / merge²):
      window_index  (N_units,)  permutation applied before the blocks
      inverse_index (N_units,)  undo permutation after the merger
      window_seg    (N_patches,) window id per *permuted* patch
      full_seg      (N_patches,) image id per *permuted* patch
      pos_hw        (N_patches, 2) (h, w) coords per *permuted* patch
    """
    m = cfg.spatial_merge_size
    unit = m * m
    win = cfg.window_size // m // cfg.patch_size  # merge-units per window side

    window_index = []
    window_sizes_units = []  # units per window, in permuted order
    full_sizes_units = []
    pos_hw_units = []  # (N_units, unit, 2) pre-permutation
    base = 0
    for (t, h, w) in grid_thw:
        lh, lw = h // m, w // m
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = (-lh) % win
        pad_w = (-lw) % win
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = idx
        nwh, nww = (lh + pad_h) // win, (lw + pad_w) // win
        padded = padded.reshape(t, nwh, win, nww, win).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nwh * nww, win, win)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        keep = flat[flat != -100]
        window_index.append(keep + base)
        window_sizes_units.extend(int(s) for s in seqlens if s > 0)
        full_sizes_units.append(t * lh * lw)

        # (h, w) coords per patch in merge-unit order
        hpos = np.arange(h)[:, None] * np.ones(w, np.int64)[None]
        wpos = np.ones(h, np.int64)[:, None] * np.arange(w)[None]

        def unitize(a):
            a = a.reshape(lh, m, lw, m).transpose(0, 2, 1, 3).reshape(-1)
            return np.tile(a, t)

        pos_hw_units.append(
            np.stack([unitize(hpos), unitize(wpos)], -1).reshape(-1, unit, 2))
        base += t * lh * lw

    window_index = np.concatenate(window_index)
    inverse_index = np.argsort(window_index, kind="stable")
    pos_hw = np.concatenate(pos_hw_units)  # (N_units, unit, 2)
    pos_hw = pos_hw[window_index].reshape(-1, 2)  # permuted patch order

    window_seg = np.repeat(np.arange(len(window_sizes_units)),
                           np.asarray(window_sizes_units) * unit)
    # full segments: image id per unit in ORIGINAL order → permute
    full_per_unit = np.repeat(np.arange(len(full_sizes_units)),
                              full_sizes_units)
    full_seg = np.repeat(full_per_unit[window_index], unit)
    return {
        "window_index": window_index.astype(np.int32),
        "inverse_index": inverse_index.astype(np.int32),
        "window_seg": window_seg.astype(np.int32),
        "full_seg": full_seg.astype(np.int32),
        "pos_hw": pos_hw.astype(np.int32),
    }


def get_rope_index(input_ids: list[int], grid_thw: list[tuple[int, int, int]],
                   cfg: Qwen2_5VLConfig,
                   second_per_grid_ts: list[float] | None = None
                   ) -> tuple[np.ndarray, int]:
    """(3, S) M-RoPE position ids + rope_delta, single sequence (HF
    Qwen2_5_VL.get_rope_index)."""
    m = cfg.vision.spatial_merge_size
    tokens_per_second = cfg.vision.tokens_per_second
    ids = np.asarray(input_ids)
    S = len(ids)
    pos = np.zeros((3, S), np.int64)
    img_i = 0
    current = 0
    vision_tokens = (cfg.image_token_id, cfg.video_token_id)
    i = 0
    while i < S:
        if ids[i] in vision_tokens:
            t, h, w = grid_thw[img_i]
            lh, lw = h // m, w // m
            n = t * lh * lw
            if ids[i] == cfg.video_token_id and second_per_grid_ts:
                # HF casts second_per_grid_t to the int64 range dtype before
                # multiplying, so the fractional part is truncated
                interval = int(second_per_grid_ts[img_i]) * tokens_per_second
            else:
                interval = 0.0
            t_idx = (np.arange(t)[:, None, None] * interval).astype(np.int64) \
                + current
            t_idx = np.broadcast_to(t_idx, (t, lh, lw))
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
    rope_delta = int(pos.max()) + 1 - S
    return pos, rope_delta


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Qwen2_5VLModel:
    """The model TextEngine drives; `mm` (prefill only) carries the patches
    and the host indices as tensors (models/qwen2_5vl_served.py builds
    it): patches (N, C·tp·p·p), window_index / inverse_index (N_units,),
    window_seg / full_seg (N,) int32, pos_hw (N, 2), position_ids (3, S),
    rope_delta an int.  Parameters: {"visual": ..., "text": LlamaModel's};
    the vision blocks are a list of per-block dicts."""

    def __init__(self, config: Qwen2_5VLConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        check_vl_tp(config, mesh.tp if mesh is not None else 1)
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
        return {**params, "text": LlamaModel.fuse_params(params["text"])}

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        cache = self.text.init_cache(batch, max_len, dtype)
        cache["rope_delta"] = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        return cache

    # -- vision tower --------------------------------------------------------

    def encode_vision(self, vp: dict, mm: dict) -> torch.Tensor:
        """patches (N, in_dim) [padded; pad rows have seg = -1] →
        (N_units, out_hidden) in original (pre-window) order."""
        v = self.config.vision
        eps = self.config.rms_norm_eps
        patches = mm["patches"]
        N = patches.shape[0]
        unit = v.spatial_merge_size ** 2
        w = vp["patch_embed"]["w"]
        x = patches.to(device=w.device, dtype=w.dtype) @ w
        # window permutation over merge units
        x = x.reshape(N // unit, unit, v.hidden_size)
        x = x[mm["window_index"].long()].reshape(N, v.hidden_size)
        cos, sin = vision_cos_sin(self.v_inv_freq, mm["pos_hw"])
        # pad rows carry seg = -1: their attention output is 0, and no
        # real row sees them
        wseg, fseg = mm["window_seg"], mm["full_seg"]
        H, hd = v.num_heads, v.head_dim
        for i, lp in enumerate(vp["blocks"]):
            seg = fseg if i in v.fullatt_block_indexes else wseg
            h = rms_norm(x, lp["norm1"]["w"], eps)
            qkv = nn.linear(lp["qkv"], h).reshape(N, 3, H, hd)
            # q/k come out of the rotary contiguous; v stays a strided view
            # of the qkv product, which the segment kernel reads in place
            q, k = apply_rope(qkv[:, 0][None], qkv[:, 1][None], cos, sin)
            attn = segment_attention(q, k, qkv[:, 2][None], seg)
            x = x + nn.linear(lp["proj"], attn.reshape(N, v.hidden_size))
            h = rms_norm(x, lp["norm2"]["w"], eps)
            x = x + tp_layers.swiglu_mlp(lp["mlp"], h, self.mesh)

        # merger: rmsnorm → (N_units, unit·D) → mlp
        x = rms_norm(x, vp["merger"]["ln_q"]["w"], eps)
        x = x.reshape(N // unit, unit * v.hidden_size)
        x = F.gelu(nn.linear(vp["merger"]["mlp0"], x), approximate="none")
        x = tp_layers.row_linear(vp["merger"]["mlp2"], x, self.mesh)
        return x[mm["inverse_index"].long()]

    # -- CausalLM ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: dict | None = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm`: encode the images, splice their features at the
        image-token positions and take M-RoPE positions (rope_delta stored
        in the cache).  Without: decode, or a text-only suffix prefill over
        a restored multimodal prefix, continues at pos + rope_delta; a
        text-only prefill takes plain positions and sets rope_delta to 0.
        `prompt_len` (a padded prefill's true length) is accepted and
        unused."""
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
        """The text model's greedy token (LlamaModel.greedy_token: the
        value-out head kernel and the ranks' combine under a mesh)."""
        return self.text.greedy_token(params["text"], hidden)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names of a Qwen2_5_VLForConditionalGeneration checkpoint →
        the port's layout on self.device: original checkpoints use visual. /
        model., post-refactor exports model.visual. / model.language_model.
        Under a mesh the tower's gate / up and mlp0 (w and b) are read as
        the rank's output rows, down and mlp2 as its input columns
        (io/weights.shard_getters)."""
        from aha_tpu_torch.io.weights import shard_getters

        v = self.config.vision
        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def norm(name):
            return {"w": get(name + ".weight")}

        vt = "visual."
        if vt + "patch_embed.proj.weight" not in src:
            vt = "model.visual."
        in_dim = v.in_chans * v.temporal_patch_size * v.patch_size ** 2
        pe = get(vt + "patch_embed.proj.weight")
        visual = {
            "patch_embed": {"w": pe.reshape(v.hidden_size, in_dim).t()
                            .contiguous()},
            "merger": {"ln_q": norm(vt + "merger.ln_q"),
                       "mlp0": lin(vt + "merger.mlp.0", 0),
                       "mlp2": lin(vt + "merger.mlp.2", 1)},
            "blocks": [],
        }
        for i in range(v.depth):
            p = f"{vt}blocks.{i}."
            visual["blocks"].append({
                "norm1": norm(p + "norm1"), "norm2": norm(p + "norm2"),
                "qkv": lin(p + "attn.qkv"), "proj": lin(p + "attn.proj"),
                "mlp": {"gate": lin(p + "mlp.gate_proj", 0),
                        "up": lin(p + "mlp.up_proj", 0),
                        "down": lin(p + "mlp.down_proj", 1)},
            })
        text_prefix = ("model.language_model."
                       if "model.language_model.embed_tokens.weight" in src
                       else "model.")
        text = self.text.load_params(src, dtype=dtype, prefix=text_prefix)
        return {"visual": visual, "text": text}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters (zero biases, unit norms): the text
        decoder's, then the tower's, drawn from one generator."""
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

        d = v.hidden_size
        unit = v.spatial_merge_size ** 2
        in_dim = v.in_chans * v.temporal_patch_size * v.patch_size ** 2
        visual = {
            "patch_embed": {"w": w(in_dim, d)},
            "merger": {"ln_q": {"w": full(1.0, d)},
                       "mlp0": lin(unit * d, unit * d),
                       "mlp2": lin(unit * d, self.config.text.hidden_size)},
            "blocks": [{
                "norm1": {"w": full(1.0, d)}, "norm2": {"w": full(1.0, d)},
                "qkv": lin(d, 3 * d), "proj": lin(d, d),
                "mlp": {"gate": lin(d, v.intermediate_size),
                        "up": lin(d, v.intermediate_size),
                        "down": lin(v.intermediate_size, d)},
            } for _ in range(v.depth)],
        }
        return {"visual": visual, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's QWEN2_5VL_PARTITION_RULES: the text decoder's are the llama
# ones (matched under "text."); in the windowed tower the gated MLPs and
# the merger shard over tp, the fused-qkv attention stays replicated.
QWEN2_5VL_PARTITION_RULES = (
    *LLAMA_PARTITION_RULES,
    (r"visual\.blocks\.\d+\.mlp\.(gate|up)\.w", (None, "tp")),
    (r"visual\.blocks\.\d+\.mlp\.(gate|up)\.b", ("tp",)),
    (r"visual\.blocks\.\d+\.mlp\.down\.w", ("tp", None)),
    (r"merger\.mlp0\.w", (None, "tp")),
    (r"merger\.mlp0\.b", ("tp",)),
    (r"merger\.mlp2\.w", ("tp", None)),
)
QWEN2_5VL_CACHE_RULES = LLAMA_CACHE_RULES
Qwen2_5VLModel.partition_rules = QWEN2_5VL_PARTITION_RULES
Qwen2_5VLModel.cache_rules = QWEN2_5VL_CACHE_RULES


#: the tp check of a VL config (text, tower MLP, merger width)
check_tp = check_vl_tp
