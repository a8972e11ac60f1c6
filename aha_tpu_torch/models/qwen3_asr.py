"""Qwen3-ASR: whisper-style audio encoder + Qwen3 "thinker" decoder
(counterpart of aha_tpu/models/qwen3_asr.py).

Parity with src/models/qwen3_asr/: the conv2d-downsampled chunked encoder
(three stride-2 3x3 convs per 100-frame window, sinusoidal PE per chunk,
18 bidirectional layers with a key-padding mask on the real output rows,
then ln_post, proj1, GELU, proj2 into the text hidden size), the audio
features spliced at <|audio_pad|> tokens by cumulative index, and the
port's Qwen3Model as the decoder (the thinker's M-RoPE degenerates to
plain RoPE for text positions).

The encoder computes in the mel's float32 with its weights promoted, as
the JAX package's type promotion has it for a float32 mel against
bfloat16 weights; its attention is the plain masked sdpa, as in the
reference (no Pallas kernel).  Every GELU is the tanh form: `jax.nn.gelu`
defaults to approximate=True, so the reference computes that (ROADMAP
queue 3 lists it as a departure the port copies), and GELU_APPROXIMATE
pins it.  Decode steps are the Qwen3 decoder's: the fused decode stack
and the greedy head kernel on the card.

Tensor parallelism (`mesh` with tp > 1, parallel/), by
QWEN3_ASR_PARTITION_RULES: the thinker is the sharded Qwen3Model
(models/qwen3.py) under "text."; in every encoder layer q / k / v (with
their biases) and fc1 are column-sharded — a rank attends its H/tp heads
— and o and fc2 row-sharded, their f32 partial sums reduced once each
(parallel/layers.row_linear) and their biases added once; the convs,
ln_post and the projections run whole on every rank.  check_tp refuses a
tp that does not divide the decoder, the encoder's heads (14 at the
published width: tp 4 is refused) or its FFN.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.io.weights import Renamed, shard_getters
from aha_tpu_torch.models.qwen3 import (QWEN3_CACHE_RULES,
                                        QWEN3_PARTITION_RULES, Qwen3Config,
                                        Qwen3Model, fuse_decode_params)
from aha_tpu_torch.ops.attention import sdpa
from aha_tpu_torch.ops.audio_feats import sinusoidal_pe_cat
from aha_tpu_torch.ops.conv import conv2d
from aha_tpu_torch.ops.norms import layer_norm
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_divides, text_dims

#: the GELU of the encoder: jax.nn.gelu's default, the tanh form
GELU_APPROXIMATE = "tanh"


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate=GELU_APPROXIMATE)


@dataclasses.dataclass(frozen=True)
class Qwen3ASRAudioConfig:
    d_model: int = 896
    encoder_attention_heads: int = 14
    encoder_ffn_dim: int = 3584
    encoder_layers: int = 18
    num_mel_bins: int = 128
    downsample_hidden_size: int = 480
    n_window: int = 50
    output_dim: int = 1024
    conv_chunksize: int = 500
    activation_function: str = "gelu"

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3ASRAudioConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class Qwen3ASRConfig:
    audio: Qwen3ASRAudioConfig
    text: Qwen3Config
    audio_token_id: int = 151646

    @classmethod
    def from_file(cls, model_dir: str) -> "Qwen3ASRConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            d = json.load(f)
        thinker = d.get("thinker_config", d)
        audio = Qwen3ASRAudioConfig.from_dict(thinker.get("audio_config", {}))
        text = Qwen3Config.from_dict(thinker.get("text_config", {}))
        token = (thinker.get("audio_token_id")
                 or d.get("audio_token_id") or 151646)
        return cls(audio=audio, text=text, audio_token_id=token)


def get_feat_extract_output_lengths(audio_len: int) -> int:
    """mel frames → audio tokens after the 3 stride-2 convs, per 100-frame
    chunk (processor.rs:187-195): 13 tokens per full chunk."""
    leave = audio_len % 100
    full = (audio_len // 100) * 13
    if leave > 0:
        f = (leave - 1) // 2 + 1
        f = (f - 1) // 2 + 1
        f = (f - 1) // 2 + 1
        return f + full
    return full


def splice(x: torch.Tensor, mask: torch.Tensor,
           feats: torch.Tensor) -> torch.Tensor:
    """The audio rows in order at the positions `mask` (S,) sets in a
    batch-1 prompt's embeddings x (1, S, H): row i of `feats` at the i-th
    such position (the cumulative index, clipped as the reference clips
    it)."""
    idx = (torch.cumsum(mask.long(), 0) - 1).clamp(0, feats.shape[0] - 1)
    return torch.where(mask[None, :, None], feats[idx][None].to(x.dtype), x)


class Qwen3ASRModel:
    """The model TextEngine drives; `mm` (prefill only) = {"mel": (1,
    n_mel, F) float32 with F a multiple of 100 and the frames past the
    real length zeroed, "n_out": the real output rows (an int)}.
    Parameters: {"audio": the encoder (its layers a list of per-layer
    dicts, convs OIHW, linears (in, out)), "text": Qwen3Model's}."""

    def __init__(self, config: Qwen3ASRConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        check_tp(config, mesh.tp if mesh is not None else 1)
        self.text = Qwen3Model(config.text, max_rope_len=max_rope_len,
                               device=self.device, mesh=mesh)
        #: the tp mesh of this rank (None on one device)
        self.mesh = self.text.mesh
        self.n_layers = self.text.n_layers
        a = config.audio
        self.pe_chunk = torch.from_numpy(
            sinusoidal_pe_cat(13, a.d_model)).to(self.device)
        self.audio_head_dim = a.d_model // a.encoder_attention_heads
        #: the encoder heads this rank attends
        self.audio_heads = a.encoder_attention_heads // (
            self.mesh.tp if self.mesh is not None else 1)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return self.text.init_cache(batch, max_len, dtype)

    # -- audio encoder -------------------------------------------------------

    def encode_audio(self, ap: dict, mel: torch.Tensor,
                     n_valid_out: int) -> torch.Tensor:
        """mel (1, n_mel, T), T a multiple of 100, frames beyond the real
        length zeroed (the reference zero-pads the last chunk,
        model.rs:171-186) → (T // 100 * 13, output_dim) in mel's dtype."""
        a = self.config.audio
        _, n_mel, T = mel.shape
        chunk = a.n_window * 2
        if T % chunk:
            raise ValueError(f"mel frames {T} are not a multiple of {chunk}")
        n_chunks = T // chunk
        # (1, n_mel, T) → (n_chunks, 1, n_mel, chunk)
        x = mel[0].t().reshape(n_chunks, chunk, n_mel).transpose(1, 2)
        x = x[:, None]
        for i in (1, 2, 3):
            x = gelu(conv2d(ap[f"conv{i}"], x, stride=2, padding=1))
        b, c, f, t = x.shape                  # t == 13 for chunk 100
        x = x.permute(0, 3, 1, 2).reshape(b, t, c * f)
        x = nn.linear_promoted(ap["conv_out"], x)   # (chunks, 13, d_model)
        x = x + self.pe_chunk[None].to(x.dtype)
        x = x.reshape(1, n_chunks * t, a.d_model)

        S = x.shape[1]
        mask = torch.where(torch.arange(S, device=x.device) < n_valid_out,
                           0.0, torch.finfo(torch.float32).min)
        mask = mask[None, None, None, :]
        H, hd = self.audio_heads, self.audio_head_dim
        for lp in ap["layers"]:
            h = layer_norm(x, lp["ln1"]["w"], lp["ln1"].get("b"))
            q = nn.linear_promoted(lp["q"], h).reshape(1, S, H, hd)
            k = nn.linear_promoted(lp["k"], h).reshape(1, S, H, hd)
            v = nn.linear_promoted(lp["v"], h).reshape(1, S, H, hd)
            attn = sdpa(q, k, v, mask).reshape(1, S, H * hd)
            x = x + tp_layers.row_linear(lp["o"], attn, self.mesh,
                                         promoted=True)
            h = layer_norm(x, lp["ln2"]["w"], lp["ln2"].get("b"))
            x = x + tp_layers.row_linear(
                lp["fc2"], gelu(nn.linear_promoted(lp["fc1"], h)), self.mesh,
                promoted=True)
        x = layer_norm(x, ap["ln_post"]["w"], ap["ln_post"].get("b"))
        x = gelu(nn.linear_promoted(ap["proj1"], x))
        return nn.linear_promoted(ap["proj2"], x)[0]

    # -- CausalLM ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: Any = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm` (a prefill): encode the audio and splice its rows at
        the audio-token positions.  `window` admits the Qwen3 fused decode
        stack on a decode step; `prompt_len` is unused."""
        x = self.text.embed(params["text"], input_ids)
        if mm is not None:
            feats = self.encode_audio(params["audio"], mm["mel"],
                                      int(mm["n_out"]))
            x = splice(x, input_ids[0] == self.config.audio_token_id, feats)
        return self.text.run_layers(params["text"], x, cache,
                                    from_cache=from_cache, window=window)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.logits(params["text"], hidden)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.greedy_token(params["text"], hidden)

    @staticmethod
    def fuse_params(params: dict) -> dict:
        """The decoder's [q|k|v] and [gate|up] fused (bit-identical); the
        audio tower untouched."""
        return {**params, "text": fuse_decode_params(params["text"])}

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names (thinker.audio_tower. / thinker.model. /
        thinker.lm_head., or the same without "thinker.") → the port's
        layout on self.device.  Under a mesh each sharded tensor is read
        as this rank's slice (io/weights.shard_getters): the encoder's
        q / k / v / fc1 by output rows with their biases, o / fc2 by input
        columns; the decoder as Qwen3Model reads it."""
        a = self.config.audio
        at = "thinker.audio_tower."
        if at + "conv2d1.weight" not in src:
            at = "audio_tower."
        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def norm(name):
            p = {"w": get(name + ".weight")}
            if name + ".bias" in src:
                p["b"] = get(name + ".bias")
            return p

        layers = []
        for i in range(a.encoder_layers):
            p = f"{at}layers.{i}."
            layers.append({
                "ln1": norm(p + "self_attn_layer_norm"),
                "ln2": norm(p + "final_layer_norm"),
                "q": lin(p + "self_attn.q_proj", 0),
                "k": lin(p + "self_attn.k_proj", 0),
                "v": lin(p + "self_attn.v_proj", 0),
                "o": lin(p + "self_attn.out_proj", 1),
                "fc1": lin(p + "fc1", 0), "fc2": lin(p + "fc2", 1),
            })
        audio = {"layers": layers, "ln_post": norm(at + "ln_post"),
                 "conv_out": lin(at + "conv_out"),
                 "proj1": lin(at + "proj1"), "proj2": lin(at + "proj2")}
        for i in (1, 2, 3):
            audio[f"conv{i}"] = {k: get(f"{at}conv2d{i}.{n}")
                                 for k, n in (("w", "weight"),
                                              ("b", "bias"))}
        prefix = ("thinker.model."
                  if "thinker.model.embed_tokens.weight" in src else "model.")
        head = ("thinker.lm_head.weight"
                if "thinker.lm_head.weight" in src else "lm_head.weight")
        text = self.text.load_params(
            Renamed(src, lambda n: head if n == "lm_head.weight" else n),
            dtype=dtype, prefix=prefix)
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

        d, h = a.d_model, a.downsample_hidden_size
        layers = [{
            "ln1": norm(d), "ln2": norm(d),
            "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
            "fc1": lin(d, a.encoder_ffn_dim), "fc2": lin(a.encoder_ffn_dim, d),
        } for _ in range(a.encoder_layers)]
        f_after = ((a.num_mel_bins + 1) // 2 + 1) // 2
        f_after = (f_after + 1) // 2
        audio = {
            "layers": layers, "ln_post": norm(d),
            "conv_out": {"w": w(h * f_after, d)},
            "proj1": lin(d, d), "proj2": lin(d, a.output_dim),
            "conv1": {"w": w(h, 1, 3, 3), "b": zeros(h)},
            "conv2": {"w": w(h, h, 3, 3), "b": zeros(h)},
            "conv3": {"w": w(h, h, 3, 3), "b": zeros(h)},
        }
        return {"audio": audio, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's QWEN3_ASR_PARTITION_RULES: the thinker's are Qwen3's (matched
# under "text."); in the encoder's layers q / k / v and fc1 split their
# output columns (biases with them), o and fc2 their input rows.
QWEN3_ASR_PARTITION_RULES = (
    *QWEN3_PARTITION_RULES,
    (r"audio\.layers\.\d+\.(q|k|v|fc1)\.w", (None, "tp")),
    (r"audio\.layers\.\d+\.(q|k|v|fc1)\.b", ("tp",)),
    (r"audio\.layers\.\d+\.(o|fc2)\.w", ("tp", None)),
)
QWEN3_ASR_CACHE_RULES = QWEN3_CACHE_RULES
Qwen3ASRModel.partition_rules = QWEN3_ASR_PARTITION_RULES
Qwen3ASRModel.cache_rules = QWEN3_ASR_CACHE_RULES


def check_tp(config: Qwen3ASRConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the thinker's
    dimensions or the encoder's heads or FFN (the JAX mesh replicates
    them), naming the dimension."""
    a = config.audio
    check_divides(tp, {**text_dims(config.text),
                       "audio encoder_attention_heads":
                       a.encoder_attention_heads,
                       "audio encoder_ffn_dim": a.encoder_ffn_dim})
