"""LFM2 hybrid conv / attention decoder (counterpart of
aha_tpu/models/lfm2.py): gated short-conv token mixers alternating with
QK-norm attention per `layer_types` / `full_attn_idxs`, a SwiGLU
feed-forward (w1 / w3 / w2) in every layer, operator_norm / ffn_norm
pre-norms and embedding_norm as the final norm.

Parameters keep the JAX tree's per-layer list (the layer kinds differ),
linear weights (in, out), the conv taps (L, D), and a vocab-major (V, K)
head — a tied head is the embedding tensor itself.  State (core/cache.py):
the attention layers own consecutive slots (`attn_slot`) of the 5-D K/V
stack; the conv layers (`conv_slot`) a rolling window of the last
`conv_L_cache` gated inputs in `cache["conv"]` (Lc, B, L, D), placed at
the true prompt end under right-padding (`prompt_len`) and rolled in place
by every decode step (models/hybrid.py).  Prefill of ≥ 128 bucketed rows
runs the flash prefill kernel, each decode step the 5-D decode kernel (one
slot or B at per-slot lengths); the conv and the projections stay plain
torch, as the JAX package leaves them to XLA.  Not ported: the
tensor-parallel partition rules.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.models.cache_attention import CacheAttention
from aha_tpu_torch.models.hybrid import causal_conv
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import apply_rope, gather_rope, rope_table


@dataclasses.dataclass(frozen=True)
class Lfm2Config:
    vocab_size: int = 65536
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 128000
    norm_eps: float = 1e-5
    rope_theta: float = 1000000.0
    conv_L_cache: int = 3
    conv_bias: bool = False
    block_dim: int = 2048
    block_ff_dim: int = 10752
    block_ffn_dim_multiplier: float = 1.0
    block_multiple_of: int = 256
    block_auto_adjust_ff_dim: bool = True
    layer_types: tuple[str, ...] = ()
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def intermediate_size(self) -> int:
        """The feed-forward width: block_ff_dim, or auto-adjusted to
        multiplier · 2/3 of it, rounded up to block_multiple_of."""
        if not self.block_auto_adjust_ff_dim:
            return self.block_ff_dim
        inter = int(self.block_ffn_dim_multiplier
                    * (2 * self.block_ff_dim // 3))
        m = self.block_multiple_of
        return m * ((inter + m - 1) // m)

    @classmethod
    def from_dict(cls, d: dict) -> "Lfm2Config":
        """An HF config.json: the ff width as block_ff_dim or
        intermediate_size, the layer kinds as layer_types or
        full_attn_idxs, rope_theta flat or under rope_parameters."""
        d = dict(d)
        if "block_ff_dim" not in d and "intermediate_size" in d:
            d["block_ff_dim"] = d["intermediate_size"]
        layer_types = d.get("layer_types")
        if layer_types is None and d.get("full_attn_idxs") is not None:
            idxs = set(d["full_attn_idxs"])
            layer_types = ["full_attention" if i in idxs else "conv"
                           for i in range(d["num_hidden_layers"])]
        if layer_types is None:
            raise ValueError("lfm2 config needs layer_types or full_attn_idxs")
        d["layer_types"] = tuple(layer_types)
        if d.get("rope_theta") is None and "rope_parameters" in d:
            d["rope_theta"] = d["rope_parameters"]["rope_theta"]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_file(cls, model_dir: str) -> "Lfm2Config":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


#: LFM2-1.2B's attention layers (HF LiquidAI/LFM2-1.2B config.json)
LFM2_1_2B_ATTN = (2, 5, 8, 10, 12, 14)


def lfm2_1_2b(layers: int | None = None) -> Lfm2Config:
    """HF LiquidAI/LFM2-1.2B's config.json geometry: vocab 65536, hidden
    2048, 16 layers (attention at LFM2_1_2B_ATTN, conv elsewhere), 32/8
    heads (D 64), block_ff_dim 12288 auto-adjusted to 8192, conv_L_cache 3,
    rope_theta 1e6, norm_eps 1e-5, tied.  `layers` keeps the first ones
    (their kinds as published)."""
    n = 16 if layers is None else layers
    return Lfm2Config(
        vocab_size=65536, hidden_size=2048, num_hidden_layers=n,
        num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=128000, norm_eps=1e-5, rope_theta=1e6,
        conv_L_cache=3, block_dim=2048, block_ff_dim=12288,
        block_ffn_dim_multiplier=1.0, block_multiple_of=256,
        block_auto_adjust_ff_dim=True, tie_word_embeddings=True,
        layer_types=tuple("full_attention" if i in LFM2_1_2B_ATTN else "conv"
                          for i in range(n)))


class Lfm2Model:
    """The model TextEngine and BatchEngine drive."""

    #: decode accepts a per-slot (B,) cache["pos"]; the conv window is
    #: per slot and position-free
    supports_slot_decode = True
    #: prefill accepts from_cache=True over restored K/V rows and conv
    #: windows (an exact repeat never matches: the window cannot rewind)
    supports_prefix_cache = True

    def __init__(self, config: Lfm2Config, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu"):
        self.config = c = config
        self.device = torch.device(device)
        self.n_layers = c.num_hidden_layers
        self.n_heads = c.num_attention_heads
        self.n_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.layer_types = c.layer_types
        attn = [i for i, t in enumerate(c.layer_types)
                if t == "full_attention"]
        self.attn_slot = {i: j for j, i in enumerate(attn)}
        self.conv_slot = {i: j for j, i in enumerate(
            i for i in range(self.n_layers) if i not in self.attn_slot)}
        self.n_attn_layers = len(self.attn_slot)
        self.n_conv_layers = len(self.conv_slot)
        self.cos, self.sin = rope_table(
            c.head_dim, min(max_rope_len, c.max_position_embeddings),
            c.rope_theta, device=self.device)
        self.attn = CacheAttention(self.n_attn_layers, self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   per_slot_pos: bool = False) -> dict:
        c = self.config
        cache = kv.init_kv_cache(max(self.n_attn_layers, 1), batch, max_len,
                                 self.n_kv_heads, self.head_dim, dtype,
                                 self.device, per_slot_pos, flat=False)
        cache["conv"] = torch.zeros(
            (max(self.n_conv_layers, 1), batch, c.conv_L_cache,
             c.hidden_size), dtype=dtype, device=self.device)
        return cache

    # -- layer kinds --------------------------------------------------------

    def _attention(self, lp: dict, x: torch.Tensor, cos, sin, cache: dict,
                   slot: int, positions, valid_len,
                   from_cache: bool) -> torch.Tensor:
        c = self.config
        B, S, _ = x.shape
        D = self.head_dim
        q = nn.linear(lp["q"], x).reshape(B, S, self.n_heads, D)
        k = nn.linear(lp["k"], x).reshape(B, S, self.n_kv_heads, D)
        v = nn.linear(lp["v"], x).reshape(B, S, self.n_kv_heads, D)
        q = rms_norm(q, lp["q_norm"]["w"], c.norm_eps)
        k = rms_norm(k, lp["k_norm"]["w"], c.norm_eps)
        q, k = apply_rope(q, k, cos, sin)
        out = self.attn.attend(q, k, v, cache, slot, positions, valid_len,
                               from_cache)
        return nn.linear(lp["o"], out.reshape(B, S, -1))

    def _conv(self, lp: dict, x: torch.Tensor, state: torch.Tensor,
              prompt_len: int, from_cache: bool) -> torch.Tensor:
        """Gated short conv: in_proj → (b, c, x) thirds, the causal conv of
        b·x over the rolling window, c·(conv + bias) → out_proj."""
        b, cg, xg = nn.linear(lp["in_proj"], x).chunk(3, dim=-1)
        out = causal_conv(b * xg, lp["conv"]["w"], state, prompt_len,
                          from_cache)
        if "b" in lp["conv"]:
            out = out + lp["conv"]["b"]
        return nn.linear(lp["out_proj"], cg * out)

    # -- forward ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 prompt_len: int | None = None, from_cache: bool = False,
                 window: int | None = None,
                 inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Embeddings → final hidden; writes K/V rows at [pos, pos + S) and
        the conv windows in place, and leaves pos as it was.  `prompt_len`
        (a host int, default S) is a padded prefill's true length; `window`
        (the engine's bound on the live rows) is accepted and unused;
        `inputs_embeds` (B, S, D), where given, stands for the token
        embeddings (LFM2-VL's image features spliced in)."""
        c = self.config
        B, S = input_ids.shape
        prompt_len = S if prompt_len is None else prompt_len
        x = (inputs_embeds if inputs_embeds is not None
             else nn.embedding(params["embed"], input_ids))
        positions, rope_at, valid_len = self.attn.positions(
            cache, S, self.cos.shape[0], x.device)
        cos, sin = gather_rope(self.cos, self.sin, rope_at)
        for i, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["operator_norm"]["w"], c.norm_eps)
            if i in self.attn_slot:
                out = self._attention(lp, h, cos, sin, cache,
                                      self.attn_slot[i], positions,
                                      valid_len, from_cache)
            else:
                out = self._conv(lp, h, cache["conv"][self.conv_slot[i]],
                                 prompt_len, from_cache)
            x = x + out
            h = rms_norm(x, lp["ffn_norm"]["w"], c.norm_eps)
            x = x + nn.swiglu_mlp(lp["mlp"], h)
        return rms_norm(x, params["embedding_norm"]["w"], c.norm_eps)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The head is vocab-major (V, K)."""
        return hidden @ params["lm_head"]["w"].t()

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF checkpoint names → the port's tree on self.device.  The
        depthwise conv's (D, 1, L) weight becomes (L, D); lm_head is the
        embedding itself when the config ties it and the file has none."""
        c = self.config

        def get(name):
            return src[name].to(device=self.device, dtype=dtype)

        def lin(name):
            return {"w": get(name + ".weight").t().contiguous()}

        def norm(name):
            return {"w": get(name + ".weight")}

        layers = []
        for i in range(self.n_layers):
            p = f"model.layers.{i}."
            lp = {"operator_norm": norm(p + "operator_norm"),
                  "ffn_norm": norm(p + "ffn_norm"),
                  "mlp": {"gate": lin(p + "feed_forward.w1"),
                          "up": lin(p + "feed_forward.w3"),
                          "down": lin(p + "feed_forward.w2")}}
            if i in self.attn_slot:
                a = p + "self_attn."
                lp.update({"q": lin(a + "q_proj"), "k": lin(a + "k_proj"),
                           "v": lin(a + "v_proj"), "o": lin(a + "out_proj"),
                           "q_norm": norm(a + "q_layernorm"),
                           "k_norm": norm(a + "k_layernorm")})
            else:
                wconv = get(p + "conv.conv.weight")          # (D, 1, L)
                lp["conv"] = {"w": wconv[:, 0, :].t().contiguous()}
                if p + "conv.conv.bias" in src:
                    lp["conv"]["b"] = get(p + "conv.conv.bias")
                lp["in_proj"] = lin(p + "conv.in_proj")
                lp["out_proj"] = lin(p + "conv.out_proj")
            layers.append(lp)
        embed = get("model.embed_tokens.weight")
        head = (embed if c.tie_word_embeddings and "lm_head.weight" not in src
                else get("lm_head.weight"))
        return {"embed": {"w": embed}, "layers": layers,
                "embedding_norm": norm("model.embedding_norm"),
                "lm_head": {"w": head}}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (unit norms,
        tied head), drawn on the generator's device and moved to
        self.device."""
        c = self.config
        d, ff = c.hidden_size, c.intermediate_size
        kvd = self.n_kv_heads * self.head_dim
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return {"w": x.to(device=self.device, dtype=dtype)}

        def ones(n):
            return {"w": torch.ones(n, device=self.device, dtype=dtype)}

        layers = []
        for i in range(self.n_layers):
            lp = {"operator_norm": ones(d), "ffn_norm": ones(d),
                  "mlp": {"gate": w(d, ff), "up": w(d, ff),
                          "down": w(ff, d)}}
            if i in self.attn_slot:
                lp.update({"q": w(d, d), "k": w(d, kvd), "v": w(d, kvd),
                           "o": w(d, d), "q_norm": ones(self.head_dim),
                           "k_norm": ones(self.head_dim)})
            else:
                lp.update({"conv": w(c.conv_L_cache, d),
                           "in_proj": w(d, 3 * d), "out_proj": w(d, d)})
            layers.append(lp)
        embed = w(c.vocab_size, d)
        return {"embed": embed, "layers": layers,
                "embedding_norm": ones(d), "lm_head": {"w": embed["w"]}}
