"""Fun-ASR-Nano: SANM (FSMN-memory) encoder + adaptor + Qwen3 LLM
(counterpart of aha_tpu/models/fun_asr_nano.py).

Parity with src/models/fun_asr_nano/model.rs:
- SANM attention (forward_simple, :147-176): one fused q|k|v projection;
  the value stream, zeroed at pad rows, also feeds a zero-padded depthwise
  FSMN conv (the "memory"), added with v to the attention output;
- SenseVoiceEncoderSmall (:336-432): x·√d + sinusoidal PE, `encoders0`
  mapping lfr_m·n_mels → hidden without the attention residual, then the
  uniform blocks, after_norm, the tp blocks, tp_norm;
- AudioAdaptor (:531-578): k-frame stack → linear/relu/linear → attention
  blocks (relu MLPs);
- the LLM: the port's Qwen3Model, the audio rows spliced where
  fbank_mask is set; the token count from the reference's olens formula
  (`fun_asr_token_length`).

Every attention of the encoder and the adaptor (72 a request at the
default geometry) goes through ops.attention.segment_attention, the
segment kernel's wrapper (D 128): pad rows have seg −1.  The JAX CPU form
lets pad rows attend each other where the port gives them 0; the real
rows agree because v is zeroed at pad rows and the adaptor zeroes them
before stacking.  The towers compute in the speech's float32 with their
weights promoted (the JAX package's type promotion), but q/k/v reach the
kernel in the parameters' dtype — bfloat16 on the card, which is all the
kernel takes: q and k as strided thirds of the fused product, v the
zeroed copy.  The FSMN memory is F.conv1d with one group a channel, its
taps in torch's depthwise layout (D, 1, K).

Frontend (kaldi fbank ×32768, LFR 7/6) is host numpy
(ops/audio_feats.kaldi_fbank / apply_lfr).

Tensor parallelism (`mesh` with tp > 1, parallel/): the rules are Qwen3's
alone (FUN_ASR_NANO_PARTITION_RULES), so only the LLM shards — the
sharded Qwen3Model under "text." —, and the encoder and the adaptor run
whole on every rank, as the JAX mesh replicates them.
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
from aha_tpu_torch.models.qwen3 import (QWEN3_CACHE_RULES,
                                        QWEN3_PARTITION_RULES, Qwen3Config,
                                        Qwen3Model, check_tp as qwen3_tp,
                                        fuse_decode_params)
from aha_tpu_torch.models.qwen3_asr import splice
from aha_tpu_torch.ops.attention import segment_attention
from aha_tpu_torch.ops.audio_feats import sinusoidal_pe_cat
from aha_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class FunAsrEncoderConfig:
    output_size: int = 512
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 50
    tp_blocks: int = 20
    kernel_size: int = 11
    sanm_shfit: int = 0
    n_mels: int = 80
    lfr_m: int = 7
    lfr_n: int = 6

    @property
    def input_size(self) -> int:
        return self.lfr_m * self.n_mels

    @classmethod
    def from_dict(cls, enc: dict, frontend: dict) -> "FunAsrEncoderConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in {**frontend, **enc}.items() if k in names}
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FunAsrAdaptorConfig:
    downsample_rate: int = 2
    encoder_dim: int = 512
    llm_dim: int = 1024
    ffn_dim: int = 2048
    n_layer: int = 2
    attention_heads: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "FunAsrAdaptorConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class FunAsrNanoConfig:
    """Defaults: the JAX package's (no published config.json is in the
    repository): a 512-wide encoder of 50 + 20 SANM blocks at 4 heads of
    128, the adaptor to 1024 (8 heads of 128), Qwen3-0.6B as the LLM."""
    encoder: FunAsrEncoderConfig = FunAsrEncoderConfig()
    adaptor: FunAsrAdaptorConfig = FunAsrAdaptorConfig()
    llm: Qwen3Config = Qwen3Config()

    @classmethod
    def from_file(cls, model_dir: str) -> "FunAsrNanoConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            d = json.load(f)
        enc = FunAsrEncoderConfig.from_dict(d.get("audio_encoder_conf", {}),
                                            d.get("frontend_conf", {}))
        ada = FunAsrAdaptorConfig.from_dict(d.get("audio_adaptor_conf", {}))
        llm_path = os.path.join(model_dir, "llm_config.json")
        if os.path.exists(llm_path):
            with open(llm_path) as f:
                llm = Qwen3Config.from_dict(json.load(f))
        else:
            llm = Qwen3Config.from_dict(d.get("llm_conf", {}))
        return cls(encoder=enc, adaptor=ada, llm=llm)


def fun_asr_token_length(t_lfr: int) -> int:
    """LFR frames → spliced token count (processor.rs:100-103)."""
    olens = 1 + (t_lfr - 3 + 2) // 2
    olens = 1 + (olens - 3 + 2) // 2
    return (olens - 1) // 2 + 1


class FunAsrNanoModel:
    """The model TextEngine drives; `mm` (prefill only) = {"speech": (1,
    T_lfr, D_in) float32, "seg": (T_lfr,) int32 (0 real, −1 pad),
    "gather": (n_tok,) the adaptor rows spliced, "fbank_mask": (S,) bool
    over the padded prompt}.  Parameters: {"audio": the encoder and
    adaptor (blocks as lists of dicts), "text": Qwen3Model's} — the JAX
    tree keeps the LLM under "llm"."""

    def __init__(self, config: FunAsrNanoConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu", mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.text = Qwen3Model(config.llm, max_rope_len=max_rope_len,
                               device=self.device, mesh=mesh)
        #: the tp mesh of this rank (None on one device)
        self.mesh = self.text.mesh
        self.n_layers = self.text.n_layers
        self.pe = torch.from_numpy(sinusoidal_pe_cat(
            4096, config.encoder.input_size)).to(self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return self.text.init_cache(batch, max_len, dtype)

    # -- SANM encoder ----------------------------------------------------------

    @staticmethod
    def fsmn_memory(v: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
        """The FSMN memory of v (B, T, D): its zero-padded depthwise conv
        with `taps` (D, 1, K) — left (K − 1) // 2 rows of padding, the rest
        on the right — plus v."""
        K = taps.shape[-1]
        left = (K - 1) // 2
        vp = F.pad(v.transpose(1, 2), (left, K - 1 - left))
        mem = F.conv1d(vp, taps.to(v.dtype), groups=v.shape[-1])
        return mem.transpose(1, 2) + v

    def _sanm_block(self, lp: dict, x: torch.Tensor, seg: torch.Tensor,
                    valid: torch.Tensor, heads: int,
                    in_eq_hidden: bool) -> torch.Tensor:
        """EncoderLayerSANM.forward_simple (model.rs:317-334)."""
        B, T, _ = x.shape
        h = layer_norm(x, lp["ln1"]["w"], lp["ln1"].get("b"))
        qkv = nn.linear_promoted(lp["qkv"], h)
        dim = qkv.shape[-1] // 3
        hd = dim // heads
        # zero pad-row values so the FSMN conv sees the reference's zero
        # padding at the sequence boundary
        v = torch.where(valid, qkv[..., 2 * dim:], 0.0)
        mem = self.fsmn_memory(v, lp["fsmn"]["w"])
        # the kernel reads q and k in place: thirds of one product
        kdt = lp["qkv"]["w"].dtype
        qkv_k = qkv.to(kdt)
        q = qkv_k[..., :dim].reshape(B, T, heads, hd)
        k = qkv_k[..., dim:2 * dim].reshape(B, T, heads, hd)
        attn = segment_attention(q, k, v.to(kdt).reshape(B, T, heads, hd),
                                 seg)
        out = nn.linear_promoted(lp["out"],
                                 attn.reshape(B, T, dim).to(x.dtype)) + mem
        x = (x + out) if in_eq_hidden else out
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"].get("b"))
        h = torch.relu(nn.linear_promoted(lp["fc1"], h))
        return x + nn.linear_promoted(lp["fc2"], h)

    def _ada_block(self, lp: dict, x: torch.Tensor,
                   seg: torch.Tensor) -> torch.Tensor:
        a = self.config.adaptor
        B, Ta, _ = x.shape
        heads = a.attention_heads
        hd = a.llm_dim // heads
        kdt = lp["q"]["w"].dtype
        h = layer_norm(x, lp["ln1"]["w"], lp["ln1"].get("b"))
        q, k, v = (nn.linear_promoted(lp[n], h).to(kdt).reshape(
            B, Ta, heads, hd) for n in "qkv")
        attn = segment_attention(q, k, v, seg).reshape(B, Ta, a.llm_dim)
        x = x + nn.linear_promoted(lp["out"], attn.to(x.dtype))
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"].get("b"))
        return x + nn.linear_promoted(
            lp["fc2"], torch.relu(nn.linear_promoted(lp["fc1"], h)))

    def encode_audio(self, ap: dict, speech: torch.Tensor,
                     seg: torch.Tensor) -> torch.Tensor:
        """(1, T_lfr, D_in) → (adaptor rows, llm_dim) in speech's dtype;
        the rows of pad frames are not meaningful."""
        e, a = self.config.encoder, self.config.adaptor
        T = speech.shape[1]
        seg = seg.to(device=speech.device, dtype=torch.int32)
        valid = (seg >= 0)[None, :, None]
        x = speech * (e.output_size ** 0.5)
        x = x + self.pe[:T][None].to(x.dtype)
        x = torch.where(valid, x, 0.0)
        heads = e.attention_heads
        x = self._sanm_block(ap["encoders0"], x, seg, valid, heads, False)
        for lp in ap["encoders"]:
            x = self._sanm_block(lp, x, seg, valid, heads, True)
        x = layer_norm(x, ap["after_norm"]["w"], ap["after_norm"].get("b"))
        for lp in ap["tp_encoders"]:
            x = self._sanm_block(lp, x, seg, valid, heads, True)
        x = layer_norm(x, ap["tp_norm"]["w"], ap["tp_norm"].get("b"))

        # adaptor: k-stack → linear/relu/linear → attention blocks (pad
        # rows zeroed so boundary chunks stack zeros like the reference)
        x = torch.where(valid, x, 0.0)
        k = a.downsample_rate
        pad = (-T) % k
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            seg = F.pad(seg, (0, pad), value=-1)
        B, Tp, D = x.shape
        x = x.reshape(B, Tp // k, D * k)
        x = torch.relu(nn.linear_promoted(ap["ada1"], x))
        x = nn.linear_promoted(ap["ada2"], x)
        ada_seg = seg[::k].contiguous()  # a chunk follows its first frame
        for lp in ap["ada_blocks"]:
            x = self._ada_block(lp, x, ada_seg)
        return x[0]

    # -- CausalLM ------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 mm: Any = None, from_cache: bool = False,
                 window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """With `mm` (a prefill): encode the speech, gather its spliced
        rows and put them where fbank_mask is set.  `window` admits the
        Qwen3 fused decode stack on a decode step."""
        x = self.text.embed(params["text"], input_ids)
        if mm is not None:
            feats = self.encode_audio(params["audio"], mm["speech"],
                                      mm["seg"])
            feats = feats[mm["gather"].long()]
            x = splice(x, mm["fbank_mask"][:input_ids.shape[1]], feats)
        return self.text.run_layers(params["text"], x, cache,
                                    from_cache=from_cache, window=window)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.logits(params["text"], hidden)

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.text.greedy_token(params["text"], hidden)

    @staticmethod
    def fuse_params(params: dict) -> dict:
        """The LLM's [q|k|v] and [gate|up] fused (bit-identical); the
        encoder and adaptor untouched."""
        return {**params, "text": fuse_decode_params(params["text"])}

    # -- parameters ---------------------------------------------------------

    def _sanm_params(self, src, p: str, dtype) -> dict:
        dev = self.device

        def lin(name):
            return take_linear(src, name, dev, dtype)

        def norm(name):
            return take_norm(src, name, dev, dtype)

        return {
            "ln1": norm(p + "norm1"), "ln2": norm(p + "norm2"),
            "qkv": lin(p + "self_attn.linear_q_k_v"),
            "out": lin(p + "self_attn.linear_out"),
            # torch's depthwise Conv1d weight (D, 1, K), as stored
            "fsmn": {"w": src[p + "self_attn.fsmn_block.weight"].to(
                device=dev, dtype=dtype)},
            "fc1": lin(p + "feed_forward.w_1"),
            "fc2": lin(p + "feed_forward.w_2"),
        }

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF names (audio_encoder. / audio_adaptor. / llm.model. /
        llm.lm_head.) → the port's layout on self.device."""
        e, a = self.config.encoder, self.config.adaptor
        dev = self.device
        enc = "audio_encoder."
        audio = {
            "encoders0": self._sanm_params(src, enc + "encoders0.0.", dtype),
            "encoders": [self._sanm_params(src, f"{enc}encoders.{i}.", dtype)
                         for i in range(e.num_blocks - 1)],
            "tp_encoders": [self._sanm_params(src, f"{enc}tp_encoders.{i}.",
                                              dtype)
                            for i in range(e.tp_blocks)],
            "after_norm": take_norm(src, enc + "after_norm", dev, dtype),
            "tp_norm": take_norm(src, enc + "tp_norm", dev, dtype),
            "ada1": take_linear(src, "audio_adaptor.linear1", dev, dtype),
            "ada2": take_linear(src, "audio_adaptor.linear2", dev, dtype),
            "ada_blocks": [],
        }
        for i in range(a.n_layer):
            p = f"audio_adaptor.blocks.{i}."
            blk = {"ln1": take_norm(src, p + "norm1", dev, dtype),
                   "ln2": take_norm(src, p + "norm2", dev, dtype)}
            for key, name in (("q", "self_attn.linear_q"),
                              ("k", "self_attn.linear_k"),
                              ("v", "self_attn.linear_v"),
                              ("out", "self_attn.linear_out"),
                              ("fc1", "feed_forward.w_1"),
                              ("fc2", "feed_forward.w_2")):
                blk[key] = take_linear(src, p + name, dev, dtype)
            audio["ada_blocks"].append(blk)

        def rename(name):
            if name == "lm_head.weight":
                return ("llm.lm_head.weight" if "llm.lm_head.weight" in src
                        else name)
            return "llm." + name

        text = self.text.load_params(Renamed(src, rename), dtype=dtype)
        return {"audio": audio, "text": text}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (zero biases,
        unit norms), drawn on the generator's device."""
        e, a = self.config.encoder, self.config.adaptor
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

        def sanm(in_dim):
            d = e.output_size
            return {"ln1": norm(in_dim), "ln2": norm(d),
                    "qkv": lin(in_dim, 3 * d), "out": lin(d, d),
                    "fsmn": {"w": w(d, 1, e.kernel_size)},
                    "fc1": lin(d, e.linear_units),
                    "fc2": lin(e.linear_units, d)}

        L = a.llm_dim
        audio = {
            "encoders0": sanm(e.input_size),
            "encoders": [sanm(e.output_size) for _ in range(e.num_blocks - 1)],
            "tp_encoders": [sanm(e.output_size) for _ in range(e.tp_blocks)],
            "after_norm": norm(e.output_size),
            "tp_norm": norm(e.output_size),
            "ada1": lin(e.output_size * a.downsample_rate, a.ffn_dim),
            "ada2": lin(a.ffn_dim, L),
            "ada_blocks": [{
                "ln1": norm(L), "ln2": norm(L),
                "q": lin(L, L), "k": lin(L, L), "v": lin(L, L),
                "out": lin(L, L), "fc1": lin(L, L // 4),
                "fc2": lin(L // 4, L),
            } for _ in range(a.n_layer)],
        }
        return {"audio": audio, "text": text}


# Tensor-parallel partition rules (parallel/mesh.shard_params): the JAX
# package's FUN_ASR_NANO_PARTITION_RULES, Qwen3's — they match the LLM
# under "text." and no path of the encoder or the adaptor.
FUN_ASR_NANO_PARTITION_RULES = QWEN3_PARTITION_RULES
FUN_ASR_NANO_CACHE_RULES = QWEN3_CACHE_RULES
FunAsrNanoModel.partition_rules = FUN_ASR_NANO_PARTITION_RULES
FunAsrNanoModel.cache_rules = FUN_ASR_NANO_CACHE_RULES


def check_tp(config: FunAsrNanoConfig, tp: int) -> None:
    """Refuse, before loading, a tp that does not divide the LLM, naming
    the dimension (the towers are replicated)."""
    qwen3_tp(config.llm, tp)
