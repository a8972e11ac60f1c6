"""Parameterized llama-style decoder (counterpart of aha_tpu/models/llama.py):
the text backbone of Qwen2.5-VL (the qwen2 form, q/k/v bias), of
PaddleOCR-VL (ERNIE-4.5: q/k/v, o and MLP biases where its config sets
use_bias) and of the MiniCPM families (LongRoPE + mup scalings), with
optional qwen3-style qk-norm.  Flags in LlamaConfig select the variant; the forward is one code
path.

Parameters follow the port's Qwen3 layout (models/qwen3.py): layers
STACKED on a leading (L, ...) axis, linear weights (in, out), the head
vocab-major (V, K) — a tied head is the embedding tensor itself, not a
copy.  The KV cache is the JAX package's 5-D (L, B, S, Hkv, D) layout
(core/cache.py, flat=False), written in place at the device position
`cache["pos"]` — 0-dim for one stream, or (B,) for the continuous-batching
engine, where each slot's new row goes to its own position; the backbone
never advances it.  A decode step's attention is flash_decode_at_layer
(the split-KV decode kernel on the card, one slot or B with per-slot
lengths), prefill of ≥ 128 bucketed rows the flash prefill kernel; the
projections and MLP stay torch.matmul, as the JAX package leaves them to
XLA.

Tensor parallelism (`mesh` with tp > 1, parallel/), as Qwen3Model has
it: the model is one rank's, on its slice of the parameters
(LLAMA_PARTITION_RULES): Hq/tp query and Hkv/tp kv heads, I/tp MLP
columns and V/tp vocab rows; norms, the per-head q/k norms, the mup
scalings and the rope tables (LongRoPE's too) replicated.  A rank's q/k/v
and gate/up biases are the slices of its columns; o and down are
row-sharded (parallel/layers.row_linear: one f32 all_reduce each), their
biases (ERNIE's o_bias / mlp_bias) added once after the reduce, then the
residual scale.  The embedding is a masked lookup summed over the ranks;
logits are gathered, and the greedy token comes from the value-out head
kernel and the ranks' combine.  The cache is the rank's (L, B, S,
Hkv/tp, D) slice by LLAMA_CACHE_RULES; check_tp refuses a tp that does
not divide the heads, the MLP or the vocab.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.core.sampling import fast_argmax
from aha_tpu_torch.models.cache_attention import CacheAttention
from aha_tpu_torch.models.qwen3 import (fuse_decode_params, stack_layers,
                                        unstack_layers)
from aha_tpu_torch.ops.attention import causal_mask, sdpa
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import apply_rope, gather_rope, rope_table
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_text_tp


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: int | None = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    qkv_bias: bool = False          # qwen2-style q/k/v bias
    o_bias: bool = False            # ERNIE-4.5 with use_bias: o_proj bias
    mlp_bias: bool = False          # and gate/up/down biases
    qk_norm: bool = False           # qwen3-style per-head rms q/k norm
    # mup-style scalings (minicpm4); neutral defaults
    scale_emb: float = 1.0
    scale_depth: float | None = None   # residual scale = scale_depth/sqrt(L)
    dim_model_base: int | None = None  # hidden scale = 1/(d/dim_model_base)
    rope_scaling: Any = None           # {"short_factor": [...], ...} LongRoPE

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "LlamaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_file(cls, model_dir: str) -> "LlamaConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


def minicpm4_0_5b(layers: int = 24) -> LlamaConfig:
    """MiniCPM4-0.5B's backbone geometry (vocab 73448, hidden 1024,
    intermediate 3072, 24 layers cut to `layers`, 16 query heads over 2,
    head_dim 64, tied head) with the family's mup scalings (scale_emb 12,
    scale_depth 1.4, dim_model_base 256) and a LongRoPE rope_scaling of 32
    factors a side.  The published checkpoint's factors are not in the
    repository: these are a smooth stand-in (1.0 to 1.6 short, twice that
    long), used with seeded weights where no checkpoint is at hand."""
    short = [float(x) for x in np.linspace(1.0, 1.6, 32)]
    return LlamaConfig(
        vocab_size=73448, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=layers, num_attention_heads=16,
        num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=32768, tie_word_embeddings=True,
        scale_emb=12.0, scale_depth=1.4, dim_model_base=256,
        rope_scaling={"rope_type": "longrope", "short_factor": short,
                      "long_factor": [2.0 * x for x in short],
                      "original_max_position_embeddings": 32768})


def longrope_table(cfg: LlamaConfig, max_len: int,
                   device: torch.device | str = "cpu"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """LongRoPE: per-frequency ext factors (long_factor beyond the original
    context, short_factor within it) and a log-scaled amplitude; float32
    tables computed in float64."""
    rs = cfg.rope_scaling
    half = cfg.head_dim_ // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, half) / half))
    original = rs["original_max_position_embeddings"]
    factor = np.asarray(rs["long_factor"] if max_len > original
                        else rs["short_factor"], np.float64)
    scale = cfg.max_position_embeddings / original
    scaling_factor = math.sqrt(1.0 + math.log(scale) / math.log(original)) \
        if scale > 1.0 else 1.0
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq / factor)
    return (torch.from_numpy((np.cos(freqs) * scaling_factor)
                             .astype(np.float32)).to(device),
            torch.from_numpy((np.sin(freqs) * scaling_factor)
                             .astype(np.float32)).to(device))


class LlamaModel:
    """The model TextEngine (core/engine.py) and BatchEngine
    (core/batch_engine.py) drive."""

    #: decode accepts a per-slot (B,) cache["pos"] vector (continuous
    #: batching, core/batch_engine.py)
    supports_slot_decode = True
    #: pure K/V cache; prefill accepts from_cache=True (prefix caching)
    supports_prefix_cache = True
    #: pure K/V + position-gated reads: the cache can REWIND (pos -= k) with
    #: no state to unwind — speculative decoding verifies drafts then rolls
    #: back rejected rows for free (hybrids cannot: conv/rec state advanced
    #: by rejected tokens is unrecoverable)
    supports_token_rewind = True

    def __init__(self, config: LlamaConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = c = config
        self.device = torch.device(device)
        #: the tp mesh of this rank (None on one device)
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        tp = self.mesh.tp if self.mesh is not None else 1
        check_text_tp(c, tp)
        self.n_layers = c.num_hidden_layers
        self.n_heads = c.num_attention_heads // tp
        self.n_kv_heads = c.num_key_value_heads // tp
        self.head_dim = c.head_dim_
        max_rope_len = min(max_rope_len, c.max_position_embeddings)
        if c.rope_scaling and "short_factor" in c.rope_scaling:
            self.cos, self.sin = longrope_table(c, max_rope_len, self.device)
        else:
            self.cos, self.sin = rope_table(self.head_dim, max_rope_len,
                                            c.rope_theta, device=self.device)
        self.residual_scale = (c.scale_depth / math.sqrt(c.num_hidden_layers)
                               if c.scale_depth else 1.0)
        self.hidden_scale = (1.0 / (c.hidden_size / c.dim_model_base)
                             if c.dim_model_base else 1.0)
        # each layer owns its own slot of the 5-D K/V stack
        self.attn = CacheAttention(self.n_layers, self.device)
        self._views: tuple[Any, list[dict]] | None = None

    fuse_params = staticmethod(fuse_decode_params)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   per_slot_pos: bool = False) -> dict:
        """The 5-D cache of the whole model's kv heads; under a mesh, this
        rank's slice of it by LLAMA_CACHE_RULES."""
        return kv.init_kv_cache(self.n_layers, batch, max_len,
                                self.config.num_key_value_heads,
                                self.head_dim, dtype, self.device,
                                per_slot_pos, flat=False, mesh=self.mesh,
                                rules=self.cache_rules)

    # -- forward ------------------------------------------------------------

    def _layer_views(self, layers: dict) -> list[dict]:
        if self._views is None or self._views[0] is not layers:
            self._views = (layers, unstack_layers(layers))
        return self._views[1]

    def _qkv(self, lp: dict, h: torch.Tensor):
        """q (B, S, Hq, D), k/v (B, S, Hkv, D), qk-normed where the config
        says so."""
        c = self.config
        B, S, _ = h.shape
        D = self.head_dim
        nq, nkv = self.n_heads * D, self.n_kv_heads * D
        if "qkv" in lp:
            qkv = nn.linear(lp["qkv"], h)
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
        else:
            q, k, v = (nn.linear(lp["q"], h), nn.linear(lp["k"], h),
                       nn.linear(lp["v"], h))
        q = q.reshape(B, S, self.n_heads, D)
        k = k.reshape(B, S, self.n_kv_heads, D)
        v = v.reshape(B, S, self.n_kv_heads, D)
        if c.qk_norm:
            q = rms_norm(q, lp["q_norm"]["w"], c.rms_norm_eps)
            k = rms_norm(k, lp["k_norm"]["w"], c.rms_norm_eps)
        return q, k, v

    def _mlp_residual(self, lp: dict, x: torch.Tensor,
                      attn: torch.Tensor) -> torch.Tensor:
        c = self.config
        B, S, _ = x.shape
        o = tp_layers.row_linear(lp["o"], attn.reshape(B, S, -1), self.mesh)
        x = x + o * self.residual_scale
        h = rms_norm(x, lp["ln2"]["w"], c.rms_norm_eps)
        mlp = tp_layers.swiglu_mlp(lp["mlp"], h, self.mesh)
        return x + mlp * self.residual_scale

    def _layer(self, lp: dict, li: int, x: torch.Tensor, cos, sin,
               cache: dict, from_cache: bool, positions: torch.Tensor,
               valid_len: torch.Tensor | None):
        """One decoder block; writes this layer's K/V rows into the cache
        in place at `positions` — (S,) rows shared by the batch, or (B,)
        one row per slot (per-slot decode, S = 1: the JAX scatter
        `kc.at[li, b_idx, pos].set(k[:, 0])`)."""
        h = rms_norm(x, lp["ln1"]["w"], self.config.rms_norm_eps)
        q, k, v = self._qkv(lp, h)
        q, k = apply_rope(q, k, cos, sin)
        attn = self.attn.attend(q, k, v, cache, li, positions, valid_len,
                                from_cache)
        return self._mlp_residual(lp, x, attn)

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 from_cache: bool = False, window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """Embeddings → final hidden.  `window` (the engine's bound on the
        live rows) is accepted and unused: no fused decode stack here; so
        is `prompt_len` (a padded prefill's true length): rows past it are
        never read."""
        x = self.embed(params, input_ids) * self.config.scale_emb
        return self.run_layers(params, x, cache, from_cache=from_cache)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embedding (before scale_emb): under a mesh the masked
        lookup in the rank's vocab rows, summed over the ranks."""
        if self.mesh is not None:
            return tp_layers.embedding(params["embed"], input_ids,
                                       self.config.vocab_size, self.mesh)
        return nn.embedding(params["embed"], input_ids)

    def run_layers(self, params: dict, x: torch.Tensor, cache: dict,
                   cos_sin: tuple[torch.Tensor, torch.Tensor] | None = None,
                   from_cache: bool = False) -> torch.Tensor:
        """Decoder stack over input embeddings → final-normed hidden times
        the hidden scale.  Writes K/V at [pos, pos + S) and leaves pos as it
        was.  `cos_sin` overrides the arange RoPE gather (M-RoPE wrappers
        such as Qwen2.5-VL).  A (B,) pos decodes one token per slot, each
        at its own position: rope rows gathered per slot, and a position
        past the cache (a slot stepped past its budget, as the batch
        engine's runahead does) clamped to the last row, where the JAX
        scatter drops it — that slot's outputs are discarded."""
        positions, rope_at, valid_len = self.attn.positions(
            cache, x.shape[1], self.cos.shape[0], x.device)
        cos, sin = cos_sin if cos_sin is not None else \
            gather_rope(self.cos, self.sin, rope_at)
        for li, lp in enumerate(self._layer_views(params["layers"])):
            x = self._layer(lp, li, x, cos, sin, cache, from_cache,
                            positions, valid_len)
        x = rms_norm(x, params["norm"]["w"], self.config.rms_norm_eps)
        return x * self.hidden_scale

    def run_layers_no_cache(self, params: dict, x: torch.Tensor,
                            mask: torch.Tensor | None = None
                            ) -> torch.Tensor:
        """Encoder-style pass: no KV cache, RoPE from position 0, an
        optional additive attention mask (default causal)."""
        B, S, _ = x.shape
        cos, sin = gather_rope(self.cos, self.sin,
                               torch.arange(S, device=x.device))
        if mask is None:
            mask = causal_mask(S, S, device=x.device)
        for lp in self._layer_views(params["layers"]):
            h = rms_norm(x, lp["ln1"]["w"], self.config.rms_norm_eps)
            q, k, v = self._qkv(lp, h)
            q, k = apply_rope(q, k, cos, sin)
            x = self._mlp_residual(lp, x, sdpa(q, k, v, mask))
        x = rms_norm(x, params["norm"]["w"], self.config.rms_norm_eps)
        return x * self.hidden_scale

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The head is vocab-major (V, K); under a mesh each rank's V/tp
        columns, gathered."""
        local = hidden @ params["lm_head"]["w"].t()
        if self.mesh is not None:
            return tp_layers.gathered_logits(local, self.config.vocab_size,
                                             self.mesh)
        return local

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy next token for ONE hidden state (0-dim int32 on the
        device).  Under a mesh: the value-out head kernel over this rank's
        vocab shard and the ranks' combine (parallel/layers.greedy_token),
        which spares the all_reduce of V floats a step; on one device
        logits + fast_argmax, the engines' path for a model without a
        head kernel."""
        if self.mesh is not None:
            return tp_layers.greedy_token(params["lm_head"]["w"], hidden,
                                          self.config.vocab_size, self.mesh)
        return fast_argmax(self.logits(params, hidden).float().reshape(-1))

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16,
                    prefix: str = "model.") -> dict:
        """HF checkpoint names under `prefix` → the port's layout on
        self.device.  `src` maps a tensor name to a CPU tensor
        (io/weights.py).  Under a mesh each sharded tensor is read as this
        rank's slice (`shard_getters`: a safetensors file reads only those
        bytes): q/k/v and gate/up by output rows with their biases, o and
        down by input columns (their biases whole), the embedding and
        the head by vocab rows."""
        from aha_tpu_torch.io.weights import shard_getters

        c = self.config
        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def norm(name):
            return {"w": get(name + ".weight")}

        layers = []
        for i in range(self.n_layers):
            p = f"{prefix}layers.{i}."
            lp = {
                "ln1": norm(p + "input_layernorm"),
                "ln2": norm(p + "post_attention_layernorm"),
                # q/k/v, gate/up split their outputs (HF rows), o and down
                # their inputs (HF columns)
                "q": lin(p + "self_attn.q_proj", 0),
                "k": lin(p + "self_attn.k_proj", 0),
                "v": lin(p + "self_attn.v_proj", 0),
                "o": lin(p + "self_attn.o_proj", 1),
                "mlp": {"gate": lin(p + "mlp.gate_proj", 0),
                        "up": lin(p + "mlp.up_proj", 0),
                        "down": lin(p + "mlp.down_proj", 1)},
            }
            if c.qk_norm:
                lp["q_norm"] = norm(p + "self_attn.q_norm")
                lp["k_norm"] = norm(p + "self_attn.k_norm")
            layers.append(lp)
        embed = get(prefix + "embed_tokens.weight", 0)
        if c.tie_word_embeddings and "lm_head.weight" not in src:
            head = embed
        else:
            head = get("lm_head.weight", 0)    # HF stores it (V, K)
        return {"embed": {"w": embed}, "layers": stack_layers(layers),
                "norm": norm(prefix + "norm"), "lm_head": {"w": head}}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (zero biases
        where the config has them — q/k/v, o, the MLP —, unit norms), drawn
        on the generator's device and moved to self.device."""
        c = self.config
        d, hd, L = c.hidden_size, self.head_dim, self.n_layers
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o, bias=False):
            p = {"w": w(L, i, o)}
            if bias:
                p["b"] = full(0.0, L, o)
            return p

        layers = {
            "ln1": {"w": full(1.0, L, d)}, "ln2": {"w": full(1.0, L, d)},
            "q": lin(d, self.n_heads * hd, c.qkv_bias),
            "k": lin(d, self.n_kv_heads * hd, c.qkv_bias),
            "v": lin(d, self.n_kv_heads * hd, c.qkv_bias),
            "o": lin(self.n_heads * hd, d, c.o_bias),
            "mlp": {"gate": lin(d, c.intermediate_size, c.mlp_bias),
                    "up": lin(d, c.intermediate_size, c.mlp_bias),
                    "down": lin(c.intermediate_size, d, c.mlp_bias)},
        }
        if c.qk_norm:
            layers["q_norm"] = {"w": full(1.0, L, hd)}
            layers["k_norm"] = {"w": full(1.0, L, hd)}
        embed = w(c.vocab_size, d)
        head = embed if c.tie_word_embeddings else w(c.vocab_size, d)
        return {"embed": {"w": embed}, "layers": layers,
                "norm": {"w": full(1.0, d)}, "lm_head": {"w": head}}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's LLAMA_PARTITION_RULES on the port's names and layouts: linear
# weights stacked (L, in, out) — q/k/v and gate/up split their output
# columns, o and down their input rows; the embedding and the head, both
# vocab-major (V, K) here (the JAX head is (K, V)), split the vocab.  The
# JAX rules leave the q/k/v and gate/up biases replicated for GSPMD to
# slice; a rank here holds the slice of its columns.  o and down biases,
# norms and q/k norms replicated.
LLAMA_PARTITION_RULES = (
    (r"layers\.(q|k|v)\.w", (None, None, "tp")),
    (r"layers\.(q|k|v)\.b", (None, "tp")),
    (r"layers\.o\.w", (None, "tp", None)),
    (r"layers\.mlp\.(gate|up)\.w", (None, None, "tp")),
    (r"layers\.mlp\.(gate|up)\.b", (None, "tp")),
    (r"layers\.mlp\.down\.w", (None, "tp", None)),
    # segment-anchored: must not catch vision towers' patch_embed/pos_embed
    (r"(^|\.)embed\.w", ("tp", None)),
    (r"lm_head\.w", ("tp", None)),
)
# the 5-D cache (L, B, S, Hkv, D): kv heads over tp, slots over dp (a dp
# replica's engine holds its share of slots itself, so a rank's tp-only
# mesh never applies it)
LLAMA_CACHE_RULES = ((r"^(k|v)$", (None, "dp", None, "tp", None)),)
LlamaModel.partition_rules = LLAMA_PARTITION_RULES
LlamaModel.cache_rules = LLAMA_CACHE_RULES


#: the tp check of a LlamaConfig (heads, MLP and vocab)
check_tp = check_text_tp
