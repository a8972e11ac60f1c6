"""GLM-ASR-Nano: conv-downsampled transformer audio encoder + Llama decoder
(counterpart of aha_tpu/models/glm_asr_nano.py).

Parity with src/models/glm_asr_nano/:
- encoder (model.rs:170-232): conv1 (k3 s1 p1) GELU → conv2 (k3 s2 p1)
  GELU → transformer layers with partial rotary (head_dim ×
  partial_rotary_factor channels) and LayerNorm pre-norms → final
  LayerNorm;
- the 4-frame merge into merge_factor·hidden and the two-linear projector
  into the text hidden size (model.rs:233-260);
- the decoder: the port's LlamaModel, the audio rows spliced at
  audio_token_id.

The encoder casts the mel to its weights' dtype, as the JAX model does
(bfloat16 served on the card); its attention is plain sdpa (no Pallas
kernel in the reference).  Every GELU is jax.nn.gelu's default, the tanh
form (GELU_APPROXIMATE), as in Qwen3-ASR's encoder.

Tensor parallelism (`mesh` with tp > 1, parallel/): the rules are llama's
(GLM_ASR_NANO_PARTITION_RULES), so the decoder is the sharded LlamaModel
under "text."; the encoder and the projector run whole on every rank —
their "audio.layers.<i>.*" paths match no llama rule, and the JAX mesh
replicates them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.io.weights import Renamed, take_linear, take_norm
from aha_tpu_torch.models.llama import (LLAMA_CACHE_RULES,
                                        LLAMA_PARTITION_RULES, LlamaConfig,
                                        LlamaModel, check_tp as llama_tp)
from aha_tpu_torch.models.qwen3_asr import splice
from aha_tpu_torch.ops.attention import sdpa
from aha_tpu_torch.ops.conv import conv1d
from aha_tpu_torch.ops.norms import layer_norm
from aha_tpu_torch.ops.rope import apply_partial_rope, rope_table

#: the GELU of the encoder and projector: jax.nn.gelu's default
GELU_APPROXIMATE = "tanh"


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate=GELU_APPROXIMATE)


@dataclasses.dataclass(frozen=True)
class GlmAsrAudioConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: int = 12
    head_dim: int = 64
    num_mel_bins: int = 128
    partial_rotary_factor: float = 0.5
    rope_theta: float = 10000.0

    @classmethod
    def from_dict(cls, d: dict) -> "GlmAsrAudioConfig":
        d = dict(d)
        rp = d.get("rope_parameters") or {}
        d.setdefault("rope_theta", rp.get("rope_theta", 10000.0))
        if "partial_rotary_factor" not in d:
            d["partial_rotary_factor"] = rp.get("partial_rotary_factor", 0.5)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class GlmAsrNanoConfig:
    audio: GlmAsrAudioConfig
    text: LlamaConfig
    audio_token_id: int = 59260
    merge_factor: int = 4

    @classmethod
    def from_file(cls, model_dir: str) -> "GlmAsrNanoConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            d = json.load(f)
        audio = GlmAsrAudioConfig.from_dict(d.get("audio_config", {}))
        td = dict(d.get("text_config", d))
        rp = td.get("rope_parameters") or {}
        td.setdefault("rope_theta", rp.get("rope_theta", 10000.0))
        return cls(audio=audio, text=LlamaConfig.from_dict(td),
                   audio_token_id=d.get("audio_token_id", 59260))


def audio_token_length(mel_frames: int, merge_factor: int = 4) -> int:
    """mel frames → spliced token count (processor.rs:187-204)."""
    l1 = mel_frames            # k3 s1 p1
    l2 = (l1 - 1) // 2 + 1     # k3 s2 p1
    return (l2 - merge_factor) // merge_factor + 1


class GlmAsrNanoModel:
    """The model TextEngine drives; `mm` (prefill only) = {"mel": (nw,
    n_mel, F) float32 windows, "gather": (n_tok,) indices into the
    flattened window tokens}.  Parameters: {"audio": the encoder (layers a
    list of dicts, convs OIH) and projector, "text": LlamaModel's}."""

    def __init__(self, config: GlmAsrNanoConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.text = LlamaModel(config.text, max_rope_len=max_rope_len,
                               device=self.device, mesh=mesh)
        #: the tp mesh of this rank (None on one device)
        self.mesh = self.text.mesh
        self.n_layers = self.text.n_layers
        a = config.audio
        self.rotary_dim = int(a.head_dim * a.partial_rotary_factor)
        self.a_cos, self.a_sin = rope_table(self.rotary_dim, 4096,
                                            a.rope_theta, device=self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return self.text.init_cache(batch, max_len, dtype)

    @staticmethod
    def fuse_params(params: dict) -> dict:
        """The decoder's [q|k|v] and [gate|up] fused (bit-identical); the
        encoder untouched."""
        return {**params, "text": LlamaModel.fuse_params(params["text"])}

    # -- audio encoder ---------------------------------------------------------

    def encode_audio(self, ap: dict, mel: torch.Tensor) -> torch.Tensor:
        """(nw, n_mel, F) → (nw * F / 8, text_hidden) flattened window
        tokens, in the weights' dtype."""
        a = self.config.audio
        x = mel.to(ap["conv1"]["w"].dtype)
        x = gelu(conv1d(ap["conv1"], x, stride=1, padding=1))
        x = gelu(conv1d(ap["conv2"], x, stride=2, padding=1))
        x = x.transpose(1, 2)                       # (nw, T, hidden)
        nw, T, _ = x.shape
        cos, sin = self.a_cos[:T], self.a_sin[:T]
        H, Hkv, hd = a.num_attention_heads, a.num_key_value_heads, a.head_dim
        for lp in ap["layers"]:
            h = layer_norm(x, lp["ln1"]["w"], lp["ln1"].get("b"))
            q = nn.linear(lp["q"], h).reshape(nw, T, H, hd)
            k = nn.linear(lp["k"], h).reshape(nw, T, Hkv, hd)
            v = nn.linear(lp["v"], h).reshape(nw, T, Hkv, hd)
            q, k = apply_partial_rope(q, k, cos, sin, self.rotary_dim)
            attn = sdpa(q, k, v, None).reshape(nw, T, H * hd)
            x = x + nn.linear(lp["o"], attn)
            h = layer_norm(x, lp["ln2"]["w"], lp["ln2"].get("b"))
            x = x + nn.linear(lp["fc2"], gelu(nn.linear(lp["fc1"], h)))
        x = layer_norm(x, ap["norm"]["w"], ap["norm"].get("b"))
        m = self.config.merge_factor
        x = x.reshape(nw, T // m, m * a.hidden_size)
        x = gelu(nn.linear(ap["proj1"], x))
        x = nn.linear(ap["proj2"], x)
        return x.reshape(nw * (T // m), -1)

    # -- CausalLM ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: Any = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm` (a prefill): encode the windows, gather the valid
        tokens in host order and splice them at the audio-token positions.
        `window` and `prompt_len` are accepted and unused."""
        x = self.text.embed(params["text"], input_ids)
        if mm is not None:
            feats = self.encode_audio(params["audio"], mm["mel"])
            feats = feats[mm["gather"].long()]
            x = splice(x, input_ids[0] == self.config.audio_token_id, feats)
        return self.text.run_layers(params["text"], x, cache,
                                    from_cache=from_cache)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.logits(params["text"], hidden)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.greedy_token(params["text"], hidden)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names (audio_tower. / multi_modal_projector. /
        language_model., each perhaps under "model.") → the port's layout
        on self.device."""
        a = self.config.audio
        dev = self.device
        at = ("audio_tower." if "audio_tower.conv1.weight" in src
              else "model.audio_tower.")

        def lin(name):
            return take_linear(src, name, dev, dtype)

        def norm(name):
            return take_norm(src, name, dev, dtype)

        def conv(name):
            return {k: src[f"{name}.{n}"].to(device=dev, dtype=dtype)
                    for k, n in (("w", "weight"), ("b", "bias"))}

        audio = {"conv1": conv(at + "conv1"), "conv2": conv(at + "conv2"),
                 "norm": norm(at + "norm"), "layers": []}
        for i in range(a.num_hidden_layers):
            p = f"{at}layers.{i}."
            audio["layers"].append({
                "ln1": norm(p + "input_layernorm"),
                "ln2": norm(p + "post_attention_layernorm"),
                "q": lin(p + "self_attn.q_proj"),
                "k": lin(p + "self_attn.k_proj"),
                "v": lin(p + "self_attn.v_proj"),
                "o": lin(p + "self_attn.o_proj"),
                "fc1": lin(p + "mlp.fc1"), "fc2": lin(p + "mlp.fc2"),
            })
        mp = ("multi_modal_projector."
              if "multi_modal_projector.linear_1.weight" in src
              else "model.multi_modal_projector.")
        audio["proj1"] = lin(mp + "linear_1")
        audio["proj2"] = lin(mp + "linear_2")
        lm = ("language_model."
              if "language_model.model.embed_tokens.weight" in src
              else "model.language_model.")

        def rename(name):
            if name == "lm_head.weight":
                return (lm + name) if (lm + name) in src else name
            return lm + name

        text = self.text.load_params(Renamed(src, rename), dtype=dtype)
        return {"audio": audio, "text": text}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (zero biases,
        unit norms), drawn on the generator's device."""
        a = self.config.audio
        text = self.text.init_random(generator, dtype, scale)
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def zeros(n):
            return torch.zeros(n, device=self.device, dtype=dtype)

        def lin(i, o):
            return {"w": w(i, o), "b": zeros(o)}

        def norm(d):
            return {"w": torch.ones(d, device=self.device, dtype=dtype),
                    "b": zeros(d)}

        d, th = a.hidden_size, self.config.text.hidden_size
        qd, kvd = (a.num_attention_heads * a.head_dim,
                   a.num_key_value_heads * a.head_dim)
        audio = {
            "conv1": {"w": w(d, a.num_mel_bins, 3), "b": zeros(d)},
            "conv2": {"w": w(d, d, 3), "b": zeros(d)},
            "norm": norm(d),
            "proj1": lin(self.config.merge_factor * d, 2 * th),
            "proj2": lin(2 * th, th),
            "layers": [{
                "ln1": norm(d), "ln2": norm(d),
                "q": lin(d, qd), "k": lin(d, kvd), "v": lin(d, kvd),
                "o": lin(qd, d), "fc1": lin(d, a.intermediate_size),
                "fc2": lin(a.intermediate_size, d),
            } for _ in range(a.num_hidden_layers)],
        }
        return {"audio": audio, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params): the JAX
# package's GLM_ASR_NANO_PARTITION_RULES, llama's — they match the decoder
# under "text." and no path of the encoder or the projector.
GLM_ASR_NANO_PARTITION_RULES = LLAMA_PARTITION_RULES
GLM_ASR_NANO_CACHE_RULES = LLAMA_CACHE_RULES
GlmAsrNanoModel.partition_rules = GLM_ASR_NANO_PARTITION_RULES
GlmAsrNanoModel.cache_rules = GLM_ASR_NANO_CACHE_RULES


def check_tp(config: GlmAsrNanoConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the decoder,
    naming the dimension (the encoder is replicated)."""
    llama_tp(config.text, tp)
