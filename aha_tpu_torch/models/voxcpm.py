"""VoxCPM text-to-speech: a hierarchical LM with local diffusion over
AudioVAE latents (counterpart of aha_tpu/models/voxcpm.py, the same names
and parameter tree).

- VoxMiniCPM: MiniCPM4-style transformer over input embeds (vocab 0 for
  the local blocks), mup residual scale scale_depth/√L, LongRoPE tables
  (`vox_longrope_table`, the port's `longrope_table` over the reference's
  defaults), no-rope and kv_channels options, causal or bidirectional.
  `forward_with_cache` writes the 5-D (L, B, S, Hkv, D) cache in place at
  `cache["pos"]` (a device scalar, so a step never syncs the host): a
  prompt of S > 1 rows attends plainly (masked sdpa, as the reference);
  a one-row step reads layer `li` through `attention_decode_at`, row 8's
  decode kernel on the card, in the cache's dtype (float32 as served,
  bf16 when the weights are).
- VoxCPMLocEnc (patch encoder: in_proj, a CLS token, bidirectional
  blocks) and VoxCPMLocDiT (flow estimator: sinusoidal t / dt embeddings
  through two MLPs; v1 [mu + t, cond, x] tokens, v2 [mu tokens, t, cond,
  x]), both plain sdpa.
- UnifiedCFM: the cosine-sway t schedule and the Euler solver with the
  CFG pair on the batch axis and CFG-zero-star.
- ScalarQuantizationLayer, SingleChineseTokenizer.
- VoxCPMModel: `build_context`, the prefill, the per-patch decode step
  (DiT CFM → stop logits → LocEnc feedback → one base-LM and one
  residual-LM step) and `inference`'s host loop with the reference's stop
  rule.  The step takes its noise `z`: `inference` draws it from a
  `torch.Generator` seeded by `seed` on the CPU (so the card and the CPU
  draw the same noise), or takes the caller's (`noise`).

Linear layers compute in the activation's dtype with the weight cast to it
(`nn.linear_promoted`): the type promotion of the JAX package, whose
bf16 weights meet float32 masks and noise.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import types
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core.nn import linear_promoted as linear
from aha_tpu_torch.io.weights import take_linear, take_norm
from aha_tpu_torch.models.llama import longrope_table
from aha_tpu_torch.ops.attention import attention_decode_at, causal_mask, sdpa
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import apply_rope

# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VoxLMConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    num_hidden_layers: int = 24
    kv_channels: int | None = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 32768
    rope_scaling: Any = None
    vocab_size: int = 0
    scale_emb: float = 12.0
    dim_model_base: int = 256
    scale_depth: float = 1.4
    use_mup: bool = True
    no_rope: bool = False

    @property
    def head_dim(self) -> int:
        return self.kv_channels or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "VoxLMConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in names}
        if d.get("no_rope") is None:
            d["no_rope"] = False
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class VoxCPMConfig:
    architecture: str
    lm: VoxLMConfig
    patch_size: int
    feat_dim: int
    sq_latent_dim: int
    sq_scale: int
    residual_lm_num_layers: int
    residual_lm_no_rope: bool
    encoder: VoxLMConfig   # the LocEnc's mini-config
    dit: VoxLMConfig       # the LocDiT's mini-config
    audio_vae: dict | None
    max_length: int
    dtype: str

    @classmethod
    def from_file(cls, model_dir: str) -> "VoxCPMConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, d: dict) -> "VoxCPMConfig":
        lm = VoxLMConfig.from_dict(d["lm_config"])

        def sub(block):
            # the local blocks inherit the LM's config with their own dims
            # and vocab 0
            return dataclasses.replace(
                lm, hidden_size=block["hidden_dim"],
                intermediate_size=block["ffn_dim"],
                num_attention_heads=block["num_heads"],
                num_hidden_layers=block["num_layers"],
                kv_channels=block.get("kv_channels"),
                num_key_value_heads=block["num_heads"], vocab_size=0)

        return cls(
            architecture=d.get("architecture", "voxcpm"), lm=lm,
            patch_size=d["patch_size"], feat_dim=d["feat_dim"],
            sq_latent_dim=d["scalar_quantization_latent_dim"],
            sq_scale=d["scalar_quantization_scale"],
            residual_lm_num_layers=d["residual_lm_num_layers"],
            residual_lm_no_rope=bool(d.get("residual_lm_no_rope")),
            encoder=sub(d["encoder_config"]), dit=sub(d["dit_config"]),
            audio_vae=d.get("audio_vae_config"),
            max_length=d.get("max_length", 4096),
            dtype=d.get("dtype", "bfloat16"))

    @property
    def is_v2(self) -> bool:
        return self.architecture.lower() == "voxcpm2"


def vox_longrope_table(cfg: VoxLMConfig, max_len: int,
                       device: torch.device | str = "cpu"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The LongRoPE table with the reference's defaults: no rope_scaling is
    plain RoPE, the long factors only where given and past the original
    context, and factors of another width than head_dim / 2 (a local block
    inheriting the LM's) plain RoPE.  The arithmetic is the port's
    `longrope_table`'s."""
    half = cfg.head_dim // 2
    rs = cfg.rope_scaling or {}
    original = rs.get("original_max_position_embeddings",
                      cfg.max_position_embeddings)
    factor = (rs.get("long_factor") if max_len > original
              and rs.get("long_factor") else rs.get("short_factor"))
    if factor is None or len(factor) != half:
        factor = [1.0] * half
    shim = types.SimpleNamespace(
        head_dim_=cfg.head_dim, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_position_embeddings,
        rope_scaling={"original_max_position_embeddings": original,
                      "short_factor": factor, "long_factor": factor})
    return longrope_table(shim, max_len, device)


# ---------------------------------------------------------------------------
# VoxMiniCPM
# ---------------------------------------------------------------------------


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


class VoxMiniCPM:
    def __init__(self, cfg: VoxLMConfig, max_rope_len: int = 4096,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.no_rope:
            self.cos = self.sin = None
        else:
            self.cos, self.sin = vox_longrope_table(cfg, max_rope_len,
                                                    self.device)
        self.res_scale = (cfg.scale_depth / math.sqrt(cfg.num_hidden_layers)
                          if cfg.use_mup else 1.0)
        # the layer index of each attention_decode_at call, a device scalar
        self._layer_ids = torch.arange(cfg.num_hidden_layers,
                                       dtype=torch.int32, device=self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32) -> dict:
        c = self.cfg
        shape = (c.num_hidden_layers, batch, max_len, c.num_key_value_heads,
                 c.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _rope(self, pos, S: int):
        if self.cos is None:
            return None, None
        rows = torch.arange(S, device=self.device) + pos
        return self.cos[rows], self.sin[rows]

    def _layer(self, lp: dict, x: torch.Tensor, cos, sin, mask,
               cache: dict | None = None, li: int = 0,
               rows: torch.Tensor | None = None,
               valid: torch.Tensor | None = None) -> torch.Tensor:
        """`cache`: the whole (L, B, S, Hkv, D) cache, written in place at
        `rows` of layer `li`; a one-row step attends rows [0, valid)."""
        c = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        h = rms_norm(x, lp["ln1"]["w"], c.rms_norm_eps)
        q = linear(lp["q"], h).reshape(B, S, H, hd)
        k = linear(lp["k"], h).reshape(B, S, Hkv, hd)
        v = linear(lp["v"], h).reshape(B, S, Hkv, hd)
        if cos is not None:
            q, k = apply_rope(q, k, cos, sin)
        if cache is not None:
            kc, vc = cache["k"], cache["v"]
            # activations may be float32 where the cache holds the
            # weights' dtype: cast at the write, as the reference does
            kc[li].index_copy_(1, rows, k.to(kc.dtype))
            vc[li].index_copy_(1, rows, v.to(vc.dtype))
            if S == 1:
                attn = attention_decode_at(q, kc, vc, self._layer_ids[li],
                                           valid)
            else:
                attn = sdpa(q, kc[li], vc[li], mask)
        else:
            attn = sdpa(q, k, v, mask)
        x = x + linear(lp["o"], attn.reshape(B, S, H * hd)) * self.res_scale
        h = rms_norm(x, lp["ln2"]["w"], c.rms_norm_eps)
        return x + _mlp(lp["mlp"], h) * self.res_scale

    def forward(self, params: dict, x: torch.Tensor, pos: int = 0,
                causal: bool = False) -> torch.Tensor:
        """No-cache forward over embeds (B, S, hidden)."""
        S = x.shape[1]
        cos, sin = self._rope(pos, S)
        mask = (causal_mask(S, S, device=x.device) if causal and S > 1
                else None)
        for lp in params["layers"]:
            x = self._layer(lp, x, cos, sin, mask)
        return rms_norm(x, params["norm"]["w"], self.cfg.rms_norm_eps)

    def forward_with_cache(self, params: dict, x: torch.Tensor,
                           cache: dict) -> tuple[torch.Tensor, dict]:
        """Causal forward appending to the cache at cache["pos"]; the cache's
        k/v are written in place and returned with pos + S."""
        S = x.shape[1]
        pos = cache["pos"]
        cos, sin = self._rope(pos, S)
        rows = torch.arange(S, device=x.device) + pos
        kv_len = cache["k"].shape[2]
        mask = causal_mask(S, kv_len, q_offset=pos) if S > 1 else None
        valid = (pos + 1).reshape(1) if S == 1 else None
        for i, lp in enumerate(params["layers"]):
            x = self._layer(lp, x, cos, sin, mask, cache, i, rows, valid)
        x = rms_norm(x, params["norm"]["w"], self.cfg.rms_norm_eps)
        return x, {"k": cache["k"], "v": cache["v"], "pos": pos + S}

    # -- params ----------------------------------------------------------------

    def load_params(self, src, prefix: str, dtype=torch.float32) -> dict:
        c = self.cfg
        dev = self.device

        def lin(n):
            return take_linear(src, n, dev, dtype)

        layers = []
        for i in range(c.num_hidden_layers):
            p = f"{prefix}layers.{i}."
            layers.append({
                "ln1": take_norm(src, p + "input_layernorm", dev, dtype),
                "ln2": take_norm(src, p + "post_attention_layernorm", dev,
                                 dtype),
                "q": lin(p + "self_attn.q_proj"),
                "k": lin(p + "self_attn.k_proj"),
                "v": lin(p + "self_attn.v_proj"),
                "o": lin(p + "self_attn.o_proj"),
                "mlp": {"gate": lin(p + "mlp.gate_proj"),
                        "up": lin(p + "mlp.up_proj"),
                        "down": lin(p + "mlp.down_proj")},
            })
        params = {"layers": layers,
                  "norm": take_norm(src, prefix + "norm", dev, dtype)}
        if c.vocab_size > 0:
            params["embed"] = {"w": src[prefix + "embed_tokens.weight"].to(
                device=dev, dtype=dtype)}
        return params

    def init_random(self, generator: torch.Generator, scale: float = 0.02,
                    dtype=torch.float32) -> dict:
        c = self.cfg
        d, hd = c.hidden_size, c.head_dim

        def w(*shape):
            return _randn(generator, shape, scale, self.device, dtype)

        def ones():
            return torch.ones(d, device=self.device, dtype=dtype)

        layers = [{
            "ln1": {"w": ones()}, "ln2": {"w": ones()},
            "q": {"w": w(d, c.num_attention_heads * hd)},
            "k": {"w": w(d, c.num_key_value_heads * hd)},
            "v": {"w": w(d, c.num_key_value_heads * hd)},
            "o": {"w": w(c.num_attention_heads * hd, d)},
            "mlp": {"gate": {"w": w(d, c.intermediate_size)},
                    "up": {"w": w(d, c.intermediate_size)},
                    "down": {"w": w(c.intermediate_size, d)}},
        } for _ in range(c.num_hidden_layers)]
        params = {"layers": layers, "norm": {"w": ones()}}
        if c.vocab_size > 0:
            params["embed"] = {"w": w(c.vocab_size, d)}
        return params


def _randn(generator: torch.Generator, shape, scale: float, device,
           dtype) -> torch.Tensor:
    """N(0, scale) drawn from `generator` on its own device, then moved."""
    t = torch.randn(shape, generator=generator, device=generator.device)
    return (t * scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Local blocks
# ---------------------------------------------------------------------------


def scalar_quantize(p: dict, x: torch.Tensor, scale: int) -> torch.Tensor:
    """ScalarQuantizationLayer: tanh → round(x·scale)/scale → out_proj."""
    h = torch.tanh(linear(p["in_proj"], x))
    h = torch.round(h * scale) / scale
    return linear(p["out_proj"], h)


def sinusoidal_time_emb(t: torch.Tensor, dim: int,
                        scale: float = 1000.0) -> torch.Tensor:
    """t (B,) → (B, dim): [sin, cos] of t·scale over a geometric ladder."""
    half = dim // 2
    emb = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                    * (-math.log(10000.0) / (half - 1)))
    ang = t[:, None] * scale * emb[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def timestep_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["linear_2"], F.silu(linear(p["linear_1"], x)))


def _lin_params(generator, i: int, o: int, scale: float, device, dtype,
                bias: bool = True) -> dict:
    out = {"w": _randn(generator, (i, o), scale, device, dtype)}
    if bias:
        out["b"] = torch.zeros(o, device=device, dtype=dtype)
    return out


class VoxCPMLocEnc:
    """Patch encoder."""

    def __init__(self, cfg: VoxLMConfig, feat_dim: int,
                 device: torch.device | str = "cpu"):
        self.encoder = VoxMiniCPM(cfg, max_rope_len=64, device=device)
        self.feat_dim = feat_dim
        self.hidden = cfg.hidden_size
        self.device = torch.device(device)

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, P, feat_dim) → CLS outputs (B, T, hidden)."""
        B, T, P, _ = x.shape
        h = linear(p["in_proj"], x)
        cls = p["special_token"].expand(B, T, 1, self.hidden)
        h = torch.cat([cls, h.to(cls.dtype)], dim=2)
        h = h.reshape(B * T, P + 1, self.hidden)
        out = self.encoder.forward(p["encoder"], h, causal=False)
        return out[:, 0, :].reshape(B, T, self.hidden)

    def load_params(self, src, prefix: str, dtype=torch.float32) -> dict:
        return {
            "special_token": src[prefix + "special_token"].to(
                device=self.device, dtype=dtype).reshape(self.hidden),
            "in_proj": take_linear(src, prefix + "in_proj", self.device,
                                   dtype),
            "encoder": self.encoder.load_params(src, prefix + "encoder.",
                                                dtype),
        }

    def init_random(self, generator: torch.Generator, scale: float = 0.02,
                    dtype=torch.float32) -> dict:
        return {
            "special_token": _randn(generator, (self.hidden,), scale,
                                    self.device, dtype),
            "in_proj": _lin_params(generator, self.feat_dim, self.hidden,
                                   scale, self.device, dtype),
            "encoder": self.encoder.init_random(generator, scale, dtype),
        }


class VoxCPMLocDiT:
    """Flow estimator."""

    def __init__(self, cfg: VoxLMConfig, feat_dim: int,
                 device: torch.device | str = "cpu"):
        self.decoder = VoxMiniCPM(cfg, max_rope_len=128, device=device)
        self.feat_dim = feat_dim
        self.hidden = cfg.hidden_size
        self.version = 2 if cfg.kv_channels else 1
        self.device = torch.device(device)

    def forward(self, p: dict, x: torch.Tensor, mu: torch.Tensor,
                t: torch.Tensor, cond: torch.Tensor,
                dt: torch.Tensor) -> torch.Tensor:
        """x / cond (B, feat_dim, P); mu (B, k·hidden); t / dt (B,) →
        (B, feat_dim, P)."""
        B = x.shape[0]
        xt = linear(p["in_proj"], x.transpose(1, 2))          # (B, P, H)
        ct = linear(p["cond_proj"], cond.transpose(1, 2))
        prefix = ct.shape[1]
        temb = timestep_mlp(p["time_mlp"], sinusoidal_time_emb(t, self.hidden))
        temb = temb + timestep_mlp(p["delta_time_mlp"],
                                   sinusoidal_time_emb(dt, self.hidden))
        if self.version == 2:
            mu_t = mu.reshape(B, -1, self.hidden)
            h = _cat([mu_t, temb[:, None], ct, xt], 1)
            out = self.decoder.forward(p["decoder"], h, causal=False)
            out = out[:, mu_t.shape[1] + 1 + prefix:]
        else:
            h = _cat([(mu + temb)[:, None], ct, xt], 1)
            out = self.decoder.forward(p["decoder"], h, causal=False)
            out = out[:, 1 + prefix:]
        return linear(p["out_proj"], out).transpose(1, 2)

    def load_params(self, src, prefix: str, dtype=torch.float32) -> dict:
        def lin(n):
            return take_linear(src, prefix + n, self.device, dtype)

        return {
            "in_proj": lin("in_proj"), "cond_proj": lin("cond_proj"),
            "out_proj": lin("out_proj"),
            "time_mlp": {"linear_1": lin("time_mlp.linear_1"),
                         "linear_2": lin("time_mlp.linear_2")},
            "delta_time_mlp": {"linear_1": lin("delta_time_mlp.linear_1"),
                               "linear_2": lin("delta_time_mlp.linear_2")},
            "decoder": self.decoder.load_params(src, prefix + "decoder.",
                                                dtype),
        }

    def init_random(self, generator: torch.Generator, scale: float = 0.02,
                    dtype=torch.float32) -> dict:
        H = self.hidden

        def lin(i, o):
            return _lin_params(generator, i, o, scale, self.device, dtype)

        return {
            "in_proj": lin(self.feat_dim, H),
            "cond_proj": lin(self.feat_dim, H),
            "out_proj": lin(H, self.feat_dim),
            "time_mlp": {"linear_1": lin(H, H), "linear_2": lin(H, H)},
            "delta_time_mlp": {"linear_1": lin(H, H), "linear_2": lin(H, H)},
            "decoder": self.decoder.init_random(generator, scale, dtype),
        }


def _cat(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """torch.cat in the widest of the parts' dtypes (jnp.concatenate's
    promotion)."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts], dim=dim)


def cfm_sway_t_span(n_timesteps: int, sway: float = 1.0,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """The cosine-sway schedule over linspace(1 → 0), float32."""
    t = torch.linspace(1.0, 0.0, n_timesteps + 1, device=device)
    return t + sway * (torch.cos(t * (math.pi / 2)) - 1.0 + t)


def cfm_solve_euler(dit: VoxCPMLocDiT, p: dict, z: torch.Tensor,
                    t_span: torch.Tensor, mu: torch.Tensor,
                    cond: torch.Tensor, cfg_value: float,
                    use_cfg_zero_star: bool = True) -> torch.Tensor:
    """Euler steps of the CFG pair (batch 2B: conditioned, then mu zeroed);
    CFG-zero-star skips the first max(1, ⌊4% of the steps⌋) and scales the
    unconditioned velocity by st* = ⟨pos, neg⟩ / ‖neg‖²."""
    n = t_span.shape[0] - 1
    zero_init = max(1, int(n * 0.04)) if use_cfg_zero_star else 0
    B = z.shape[0]
    x = z
    t = t_span[0]
    for step in range(1, n + 1):
        dt = t - t_span[step]
        if step <= zero_init:
            dphi = torch.zeros_like(x)
        else:
            x_in = torch.cat([x, x], dim=0)
            mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
            t_in = t.expand(2 * B)
            dt_in = torch.zeros(2 * B, dtype=x.dtype, device=x.device)
            cond_in = torch.cat([cond, cond], dim=0)
            both = dit.forward(p, x_in, mu_in, t_in, cond_in, dt_in)
            dphi, neg = both[:B], both[B:]
            if use_cfg_zero_star:
                pos_f = dphi.reshape(B, -1)
                neg_f = neg.reshape(B, -1)
                st = (pos_f * neg_f).sum(-1, keepdim=True) / (
                    neg_f.square().sum(-1, keepdim=True) + 1e-8)
                st = st.reshape(B, 1, 1)
            else:
                st = torch.ones((B, 1, 1), dtype=x.dtype, device=x.device)
            base = neg * st
            dphi = base + (dphi - base) * cfg_value
        x = x - dphi * dt
        t = t - dt
    return x


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


def _is_cjk(ch: str) -> bool:
    return 0x4E00 <= ord(ch) <= 0x9FFF


class SingleChineseTokenizer:
    """BPE encode, then split multi-character pure-CJK tokens into single
    characters."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
        self.multichar = {
            t for t in self.tok.get_vocab(False)
            if len(t) >= 2 and all(_is_cjk(c) for c in t)}

    def encode(self, text: str) -> list[int]:
        enc = self.tok.encode(text, add_special_tokens=False)
        out = []
        for token in enc.tokens:
            clean = token.replace("▁", "")
            if clean in self.multichar:
                out.extend(clean)
            else:
                out.append(token)
        ids = [self.tok.token_to_id(t) for t in out]
        return [i for i in ids if i is not None]


# ---------------------------------------------------------------------------
# VoxCPMModel
# ---------------------------------------------------------------------------

AUDIO_START_TOKEN = 101
REF_AUDIO_START_TOKEN = 103
REF_AUDIO_END_TOKEN = 104


class VoxCPMModel:
    def __init__(self, config: VoxCPMConfig, latent_dim: int,
                 device: torch.device | str = "cpu"):
        c = config
        self.config = c
        self.latent_dim = latent_dim
        self.device = torch.device(device)
        self.base_lm = VoxMiniCPM(c.lm, max_rope_len=c.max_length,
                                  device=device)
        res_cfg = dataclasses.replace(
            c.lm, num_hidden_layers=c.residual_lm_num_layers, vocab_size=0,
            no_rope=c.residual_lm_no_rope)
        self.residual_lm = VoxMiniCPM(res_cfg, max_rope_len=c.max_length,
                                      device=device)
        self.feat_encoder = VoxCPMLocEnc(c.encoder, c.feat_dim, device)
        self.feat_dit = VoxCPMLocDiT(c.dit, c.feat_dim, device)

    # -- context assembly (host) -----------------------------------------------

    def build_context(self, text_ids: Sequence[int],
                      prompt_feat: np.ndarray | None):
        """(text_token, text_mask, audio_feat, audio_mask) as numpy;
        prompt_feat: (T_audio, P, latent) VAE latents of a voice prompt."""
        P, D = self.config.patch_size, self.latent_dim
        ids = np.asarray(list(text_ids) + [AUDIO_START_TOKEN], np.int32)
        tlen = len(ids)
        if prompt_feat is not None and len(prompt_feat):
            alen = len(prompt_feat)
            text_token = np.concatenate([ids, np.zeros(alen, np.int32)])
            audio_feat = np.concatenate(
                [np.zeros((tlen, P, D), np.float32),
                 np.asarray(prompt_feat, np.float32)])
            text_mask = np.concatenate([np.ones(tlen, np.float32),
                                        np.zeros(alen, np.float32)])
            audio_mask = 1.0 - text_mask
        else:
            text_token = ids
            audio_feat = np.zeros((tlen, P, D), np.float32)
            text_mask = np.ones(tlen, np.float32)
            audio_mask = np.zeros(tlen, np.float32)
        return text_token, text_mask, audio_feat, audio_mask

    # -- the prefill and the per-patch step ---------------------------------------

    def _embed_scale(self) -> float:
        c = self.config.lm
        return c.scale_emb if c.use_mup else 1.0

    def prefill(self, params: dict, text_token: torch.Tensor,
                text_mask: torch.Tensor, audio_feat: torch.Tensor,
                audio_mask: torch.Tensor, cache_b: dict, cache_r: dict):
        """The context (batch 1) through both LMs → (lm_hidden, res_hidden,
        the last audio_feat patch, cache_b, cache_r)."""
        feat_embed = self.feat_encoder.forward(params["feat_encoder"],
                                               audio_feat)
        feat_embed = linear(params["enc_to_lm_proj"], feat_embed)
        text_embed = (params["base_lm"]["embed"]["w"][text_token.long()]
                      * self._embed_scale())
        tm, am = text_mask[..., None], audio_mask[..., None]
        combined = tm * text_embed + am * feat_embed
        enc, cache_b = self.base_lm.forward_with_cache(params["base_lm"],
                                                       combined, cache_b)
        fsq = scalar_quantize(params["fsq_layer"], enc, self.config.sq_scale)
        enc = fsq * am + enc * tm
        if self.config.is_v2:
            fused = linear(params["fusion_concat_proj"],
                           _cat([enc, am * feat_embed], -1))
        else:
            fused = enc + am * feat_embed
        res, cache_r = self.residual_lm.forward_with_cache(
            params["residual_lm"], fused, cache_r)
        return enc[:, -1], res[:, -1], audio_feat[:, -1], cache_b, cache_r

    def decode_step(self, params: dict, lm_hidden: torch.Tensor,
                    res_hidden: torch.Tensor, prev_feat: torch.Tensor,
                    cache_b: dict, cache_r: dict, z: torch.Tensor,
                    n_timesteps: int, cfg_value: float):
        """One audio patch given its noise z (B, latent, P): DiT CFM → stop
        logits → LocEnc feedback → one base-LM and one residual-LM step.
        Returns (pred_feat (B, P, latent), stop_flag (a device scalar),
        lm_next, res_next, cache_b, cache_r)."""
        c = self.config
        d1 = linear(params["lm_to_dit_proj"], lm_hidden)
        d2 = linear(params["res_to_dit_proj"], res_hidden)
        mu = _cat([d1, d2], -1) if c.is_v2 else d1 + d2
        cond = prev_feat.transpose(1, 2)                   # (B, D, P)
        t_span = cfm_sway_t_span(n_timesteps, device=cond.device)
        pred = cfm_solve_euler(self.feat_dit, params["feat_dit"],
                               z.to(cond.dtype), t_span, mu, cond, cfg_value)
        pred_feat = pred.transpose(1, 2)                   # (B, P, D)

        stop = F.silu(linear(params["stop_proj"], lm_hidden))
        stop_flag = torch.argmax(linear(params["stop_head"], stop), -1)[0]

        curr = self.feat_encoder.forward(params["feat_encoder"],
                                         pred_feat[:, None])
        curr = linear(params["enc_to_lm_proj"], curr)
        lm_next, cache_b = self.base_lm.forward_with_cache(
            params["base_lm"], curr, cache_b)
        lm_next = scalar_quantize(params["fsq_layer"], lm_next[:, 0],
                                  c.sq_scale)
        if c.is_v2:
            res_in = linear(params["fusion_concat_proj"],
                            _cat([lm_next, curr[:, 0]], -1))
        else:
            res_in = lm_next + curr[:, 0]
        res_next, cache_r = self.residual_lm.forward_with_cache(
            params["residual_lm"], res_in[:, None], cache_r)
        return (pred_feat, stop_flag, lm_next, res_next[:, 0], cache_b,
                cache_r)

    def noise_shape(self) -> tuple[int, int, int]:
        return (1, self.latent_dim, self.config.patch_size)

    @torch.no_grad()
    def inference(self, params: dict, text_token, text_mask, audio_feat,
                  audio_mask, min_len: int, max_len: int, n_timesteps: int,
                  cfg_value: float, seed: int = 0,
                  noise: Sequence | None = None,
                  on_patch=None) -> np.ndarray:
        """Predicted latents (T_pred·P, latent_dim) as numpy: the host loop
        over patches, stopping after patch i > min_len whose stop flag is 1.
        Patch i's noise is noise[i] when given, else the i-th draw of
        (1, latent, P) from a CPU torch.Generator seeded by `seed`.
        `on_patch(i)` is called after each patch's step is queued (a
        timing hook)."""
        dev = self.device
        T = len(text_token)
        cache_len = T + max_len + 8
        # the cache's dtype follows the weights' (bf16 weights write bf16
        # K/V)
        dt = params["enc_to_lm_proj"]["w"].dtype
        cache_b = self.base_lm.init_cache(1, cache_len, dt)
        cache_r = self.residual_lm.init_cache(1, cache_len, dt)

        def on_dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype)[None].to(dev)

        lm_hidden, res_hidden, prev_feat, cache_b, cache_r = self.prefill(
            params, on_dev(text_token, torch.int32),
            on_dev(text_mask, torch.float32),
            on_dev(audio_feat, torch.float32),
            on_dev(audio_mask, torch.float32), cache_b, cache_r)
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        patches = []
        for i in range(max_len):
            z = (torch.from_numpy(np.array(noise[i], np.float32))
                 if noise is not None else
                 torch.randn(self.noise_shape(), generator=gen))
            (pred_feat, stop_flag, lm_hidden, res_hidden, cache_b,
             cache_r) = self.decode_step(params, lm_hidden, res_hidden,
                                         prev_feat, cache_b, cache_r,
                                         z.reshape(self.noise_shape()).to(dev),
                                         n_timesteps, cfg_value)
            if on_patch is not None:
                on_patch(i)
            patches.append(pred_feat[0].float())
            prev_feat = pred_feat
            if i > min_len and int(stop_flag) == 1:
                break
        pred = torch.cat(patches, dim=0).cpu().numpy()    # (T_pred·P, D)
        return pred.reshape(-1, self.latent_dim)

    # -- loading -------------------------------------------------------------------

    def load_params(self, src, dtype=torch.float32) -> dict:
        c = self.config
        dev = self.device

        def lin(n):
            return take_linear(src, n, dev, dtype)

        params = {
            "base_lm": self.base_lm.load_params(src, "base_lm.", dtype),
            "residual_lm": self.residual_lm.load_params(src, "residual_lm.",
                                                        dtype),
            "feat_encoder": self.feat_encoder.load_params(
                src, "feat_encoder.", dtype),
            "feat_dit": self.feat_dit.load_params(
                src, "feat_decoder.estimator.", dtype),
            "fsq_layer": {"in_proj": lin("fsq_layer.in_proj"),
                          "out_proj": lin("fsq_layer.out_proj")},
            "enc_to_lm_proj": lin("enc_to_lm_proj"),
            "lm_to_dit_proj": lin("lm_to_dit_proj"),
            "res_to_dit_proj": lin("res_to_dit_proj"),
            "stop_proj": lin("stop_proj"),
            "stop_head": lin("stop_head"),
        }
        if c.is_v2:
            params["fusion_concat_proj"] = lin("fusion_concat_proj")
        return params

    def init_random(self, generator: torch.Generator, scale: float = 0.02,
                    dtype=torch.float32) -> dict:
        """Seeded weights of the JAX tree's shapes (the embedding at least
        128 rows), drawn from `generator` on its device."""
        c = self.config
        dev = self.device

        def lin(i, o, bias=True):
            return _lin_params(generator, i, o, scale, dev, dtype, bias)

        H, Hd = c.lm.hidden_size, c.dit.hidden_size
        base = self.base_lm.init_random(generator, scale, dtype)
        base["embed"] = {"w": _randn(generator, (max(c.lm.vocab_size, 128),
                                                 H), scale, dev, dtype)}
        params = {
            "base_lm": base,
            "residual_lm": self.residual_lm.init_random(generator, scale,
                                                        dtype),
            "feat_encoder": self.feat_encoder.init_random(generator, scale,
                                                          dtype),
            "feat_dit": self.feat_dit.init_random(generator, scale, dtype),
            "fsq_layer": {"in_proj": lin(H, c.sq_latent_dim),
                          "out_proj": lin(c.sq_latent_dim, H)},
            "enc_to_lm_proj": lin(c.encoder.hidden_size, H),
            "lm_to_dit_proj": lin(H, Hd),
            "res_to_dit_proj": lin(H, Hd),
            "stop_proj": lin(H, H),
            "stop_head": lin(H, 2, bias=False),
        }
        if c.is_v2:
            params["fusion_concat_proj"] = lin(2 * H, H)
        return params
