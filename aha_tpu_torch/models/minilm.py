"""BERT encoder for sentence embeddings (counterpart of
aha_tpu/models/minilm.py; all-MiniLM-L6-v2).

Embeddings (word + position + token_type → LayerNorm), post-LN encoder
blocks with exact GELU, masked mean pooling, L2 norm; float32 throughout,
as the reference.  Parameters follow the JAX package's tree: `embeddings`
{word, position, token_type, ln} and `layers`, a LIST of per-layer dicts
(a BERT layer count is small; nothing is stacked), linear weights (in,
out) with biases, norms with biases.  Attention is D 32 with a padding
mask through `ops/attention.sdpa`, the counterpart of the reference's XLA
sdpa on every device (the reference runs no Pallas kernel here).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.ops.attention import sdpa
from aha_tpu_torch.ops.norms import l2_normalize


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Defaults are BertConfig's, all-MiniLM-L6-v2's widths."""
    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_dict(cls, d: dict) -> "BertConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_file(cls, model_dir: str) -> "BertConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


class BertModel:
    def __init__(self, config: BertConfig,
                 device: torch.device | str = "cpu"):
        self.config = config
        self.device = torch.device(device)
        self.head_dim = config.hidden_size // config.num_attention_heads

    def encode(self, params: dict, input_ids: torch.Tensor,
               attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, S) ids + (B, S) 0/1 mask → (B, S, D) hidden states."""
        c = self.config
        S = input_ids.shape[1]
        pe = params["embeddings"]
        x = (nn.embedding(pe["word"], input_ids)
             + pe["position"]["w"][None, :S]
             + pe["token_type"]["w"][0][None, None, :])
        x = nn.ln(pe["ln"], x, c.layer_norm_eps)
        mask = attention_mask[:, None, None, :] > 0       # True = attend
        for lp in params["layers"]:
            x = self._layer(lp, x, mask)
        return x

    def _layer(self, lp: dict, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        c = self.config
        B, S, D = x.shape
        H, hd = c.num_attention_heads, self.head_dim
        q = nn.linear(lp["q"], x).reshape(B, S, H, hd)
        k = nn.linear(lp["k"], x).reshape(B, S, H, hd)
        v = nn.linear(lp["v"], x).reshape(B, S, H, hd)
        attn = sdpa(q, k, v, mask).reshape(B, S, D)
        x = nn.ln(lp["attn_ln"], x + nn.linear(lp["attn_out"], attn),
                  c.layer_norm_eps)
        h = F.gelu(nn.linear(lp["ffn_in"], x), approximate="none")
        return nn.ln(lp["ffn_ln"], x + nn.linear(lp["ffn_out"], h),
                     c.layer_norm_eps)

    def embed(self, params: dict, input_ids: torch.Tensor,
              attention_mask: torch.Tensor) -> torch.Tensor:
        """Masked mean pool + L2 normalize."""
        hidden = self.encode(params, input_ids, attention_mask)
        m = attention_mask[..., None].to(hidden.dtype)
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
        return l2_normalize(pooled)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.float32) -> dict:
        """HF BertModel names (with or without a `bert.` prefix) → the
        tree on self.device.  `src` maps a tensor name to a CPU tensor
        (io/weights.py)."""
        prefix = "bert." if any(k.startswith("bert.")
                                for k in src.keys()) else ""

        def get(name):
            return src[name].to(device=self.device, dtype=dtype)

        def lin(name):             # HF (out, in) → (in, out), bias if any
            p = {"w": get(name + ".weight").t().contiguous()}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        def table(name):
            return {"w": get(name + ".weight")}

        e = prefix + "embeddings."
        layers = []
        for i in range(self.config.num_hidden_layers):
            p = f"{prefix}encoder.layer.{i}."
            layers.append({
                "q": lin(p + "attention.self.query"),
                "k": lin(p + "attention.self.key"),
                "v": lin(p + "attention.self.value"),
                "attn_out": lin(p + "attention.output.dense"),
                "attn_ln": norm(p + "attention.output.LayerNorm"),
                "ffn_in": lin(p + "intermediate.dense"),
                "ffn_out": lin(p + "output.dense"),
                "ffn_ln": norm(p + "output.LayerNorm"),
            })
        return {"embeddings": {"word": table(e + "word_embeddings"),
                               "position": table(e + "position_embeddings"),
                               "token_type": table(e + "token_type_embeddings"),
                               "ln": norm(e + "LayerNorm")},
                "layers": layers}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (zero
        biases, unit norms), drawn on the generator's device and moved to
        self.device."""
        c = self.config
        d = c.hidden_size
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def full(value, *shape):
            return torch.full(shape, value, device=self.device, dtype=dtype)

        def lin(i, o):
            return {"w": w(i, o), "b": full(0.0, o)}

        def norm():
            return {"w": full(1.0, d), "b": full(0.0, d)}

        layers = [{
            "q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
            "attn_out": lin(d, d), "attn_ln": norm(),
            "ffn_in": lin(d, c.intermediate_size),
            "ffn_out": lin(c.intermediate_size, d), "ffn_ln": norm(),
        } for _ in range(c.num_hidden_layers)]
        return {"embeddings": {"word": {"w": w(c.vocab_size, d)},
                               "position": {"w": w(c.max_position_embeddings,
                                                   d)},
                               "token_type": {"w": w(c.type_vocab_size, d)},
                               "ln": norm()},
                "layers": layers}
