"""Qwen3.5 hybrid text decoder (counterpart of the text half of
aha_tpu/models/qwen3_5.py): GatedDeltaNet linear attention interleaved
with gated full attention.

- GatedDeltaNet: the input projections (split, or one fused [qkv|z|b|a]
  matrix) → causal depthwise conv (K = 4) with SiLU → per-head
  L2-normalized q / k, beta = sigmoid(b), per-head decay g =
  −exp(A_log)·softplus(a + dt_bias); the chunked gated delta rule for
  prefill, its recurrent step for decode; the gated RMSNorm with silu(z),
  out_proj.
- full attention: q_proj emits the query and its gate, zero-centred q / k
  norms (w + 1, folded at load), partial rotary over `rotary_dim` channels,
  sigmoid(gate) on the attention output.
- decoder: zero-centred input / post norms (folded), a dense SwiGLU MLP,
  layer kinds per `full_attention_interval`.

Parameters keep the JAX tree's per-layer list, linear weights (in, out),
the conv taps (K, conv_dim), `a_log` / `dt_bias` in float32, and a
vocab-major (V, K) head (tied: the embedding tensor itself).  State
(core/cache.py): the attention layers own `attn_slot` slots of the 5-D K/V
stack; the GatedDeltaNet layers own `lin_slot` slots of `cache["conv"]`
(Ll, B, K, conv_dim), the last K pre-conv inputs, and of `cache["rec"]`
(Ll, B, Hv, Dk, Dv), the float32 recurrent state, both written in place;
`cache["rope_delta"]` is kept at 0 for text, as the JAX cache keeps it.
Under right-padding (`prompt_len`) the padded rows are no-ops: input 0,
g = 0, beta = 0.  The delta rule is plain torch in float32 on every
device, as the JAX package computes it outside any Pallas kernel; the
attention layers run the flash prefill kernel (≥ 128 bucketed rows) and
the 5-D decode kernel.  With a `vl_config` that has a vision tower (every
published Qwen3.5 checkpoint's), the model carries Qwen3-VL's deepstack
tower (models/qwen3vl.py): a multimodal prefill splices its features at
the placeholder tokens, takes interleaved M-RoPE positions over the
partial rotary table (rope_delta kept in the cache for later positions)
and adds deepstack level i after layer i.  A GGUF file's parameters
(io/gguf_models.load_qwen3_5_gguf) keep their linears on the quantized
grids: the fusion concatenates parts of one grid, zero-pads [q|k|v] and
[qkv|z|b|a] to 128 columns as the JAX package does, and the blocks slice
every part at explicit ends.  Not ported: the tensor-parallel rules.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.nn.functional as F

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.models.cache_attention import CacheAttention
from aha_tpu_torch.models.hybrid import causal_conv
from aha_tpu_torch.models.qwen3 import _fuse_out_axis
from aha_tpu_torch.models.qwen3vl import (Qwen3VLVisionConfig,
                                          Qwen3VLVisionTower,
                                          inject_deepstack, splice_vision)
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.quant_matmul import is_quantized, pad_quant_cols
from aha_tpu_torch.ops.rope import (apply_rope, gather_rope, mrope_cos_sin,
                                    mrope_interleaved_sections, rope_table)

#: the chunked delta rule's chunk length
CHUNK = 64


@dataclasses.dataclass(frozen=True)
class Qwen3_5TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000000.0
    partial_rotary_factor: float = 0.25
    max_position_embeddings: int = 262144
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    full_attention_interval: int = 4
    layer_types: tuple[str, ...] = ()
    linear_num_value_heads: int = 16
    linear_num_key_heads: int = 8
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4

    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(self, "layer_types", tuple(
                "full_attention"
                if (i + 1) % self.full_attention_interval == 0
                else "linear_attention"
                for i in range(self.num_hidden_layers)))

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3_5TextConfig":
        """A text config dict; rope_theta and partial_rotary_factor flat
        or under rope_parameters / rope_scaling."""
        d = dict(d)
        rp = d.get("rope_parameters") or d.get("rope_scaling") or {}
        d.setdefault("rope_theta", rp.get("rope_theta", 10000000.0))
        d.setdefault("partial_rotary_factor",
                     rp.get("partial_rotary_factor", 0.25))
        if d.get("layer_types"):
            d["layer_types"] = tuple(d["layer_types"])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_file(cls, model_dir: str) -> "Qwen3_5TextConfig":
        """config.json's `text_config` where it has one (a VL
        checkpoint's), else the file itself."""
        with open(os.path.join(model_dir, "config.json")) as f:
            d = json.load(f)
        return cls.from_dict(d.get("text_config", d))


@dataclasses.dataclass(frozen=True)
class Qwen3_5Config:
    """A whole config.json: the text config and, where the file has a
    `vision_config`, the Qwen3-VL tower with its M-RoPE sections and
    token ids."""
    text: Qwen3_5TextConfig
    vision: Qwen3VLVisionConfig | None = None
    mrope_section: tuple[int, ...] = (8, 4, 4)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652

    @classmethod
    def from_file(cls, model_dir: str) -> "Qwen3_5Config":
        with open(os.path.join(model_dir, "config.json")) as f:
            d = json.load(f)
        text_d = d.get("text_config", d)
        vision = (Qwen3VLVisionConfig.from_dict(d["vision_config"])
                  if "vision_config" in d else None)
        rp = text_d.get("rope_parameters") or text_d.get("rope_scaling") or {}
        return cls(text=Qwen3_5TextConfig.from_dict(text_d), vision=vision,
                   mrope_section=tuple(rp.get("mrope_section", (8, 4, 4))),
                   image_token_id=d.get("image_token_id", 151655),
                   video_token_id=d.get("video_token_id", 151656),
                   vision_start_token_id=d.get("vision_start_token_id",
                                               151652))


# -- the gated delta rule (float32 throughout) -----------------------------


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def chunk_gated_delta_rule(q, k, v, g, beta, state0, chunk: int = CHUNK):
    """Chunked prefill: q / k (B, S, H, Dk) L2-normalized, v (B, S, H,
    Dv), g / beta (B, S, H), state0 (B, H, Dk, Dv), all float32 →
    (out (B, S, H, Dv), final state).  Each chunk's unit-lower-triangular
    system T = (I − A)⁻¹ is one batched solve_triangular; the chunks run
    in a loop carrying the state (the JAX function's lax.scan)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        q, k, v, g, beta = (F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
                            for a in (q, k, v, g, beta))
    N = (S + pad) // chunk

    def to_chunks(a):            # (B, Sp, H, D) → (N, B, H, C, D)
        return a.reshape(B, N, chunk, H, -1).permute(1, 0, 3, 2, 4)

    qc = to_chunks(q) * Dk ** -0.5
    kc, vc = to_chunks(k), to_chunks(v)
    gc = to_chunks(g[..., None])[..., 0].cumsum(-1)         # (N, B, H, C)
    bc = to_chunks(beta[..., None])[..., 0]
    dev = q.device
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    strict = tril.tril(-1)
    decay = torch.where(tril, (gc[..., :, None] - gc[..., None, :]).exp(),
                        0.0)
    kb, vb = kc * bc[..., None], vc * bc[..., None]
    A = torch.where(strict, -(kb @ kc.transpose(-1, -2)) * decay, 0.0)
    eye = torch.eye(chunk, device=dev, dtype=q.dtype)
    T = torch.linalg.solve_triangular(eye - A, eye.expand_as(A),
                                      upper=False, unitriangular=True)
    v_t = T @ vb
    k_cumdecay = T @ (kb * gc.exp()[..., None])
    state, outs = state0, []
    for i in range(N):
        q_i, k_i, g_i = qc[i], kc[i], gc[i]
        attn = torch.where(tril, (q_i @ k_i.transpose(-1, -2)) * decay[i],
                           0.0)
        v_new = v_t[i] - k_cumdecay[i] @ state
        outs.append((q_i * g_i.exp()[..., None]) @ state + attn @ v_new)
        g_last = g_i[..., -1:]
        state = state * g_last.exp()[..., None] + (
            k_i * (g_last - g_i).exp()[..., None]).transpose(-1, -2) @ v_new
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, N * chunk, H,
                                                           Dv)
    return out[:, :S], state


def recurrent_gated_delta_rule(q, k, v, g, beta, state):
    """One decode token: q / k (B, 1, H, Dk) L2-normalized → (out (B, 1,
    H, Dv), state)."""
    q0 = q[:, 0] * q.shape[-1] ** -0.5
    k0, v0 = k[:, 0], v[:, 0]
    state = state * g[:, 0].exp()[..., None, None]
    kv_mem = torch.einsum("bhdv,bhd->bhv", state, k0)
    delta = (v0 - kv_mem) * beta[:, 0][..., None]
    state = state + torch.einsum("bhd,bhv->bhdv", k0, delta)
    return torch.einsum("bhdv,bhd->bhv", state, q0)[:, None], state


# -- the model -------------------------------------------------------------


def fuse_qwen3_5_decode_params(params: dict) -> dict:
    """Per layer: full attention's [q(+gate)|k|v], GatedDeltaNet's four
    input projections [qkv|z|b|a], and the MLP's [gate|up], each one
    matrix — bit-identical splits, fewer weight streams and quant-kernel
    launches a step (the JAX fuse_qwen3_5_decode_params).  Quantized
    [q|k|v] and [qkv|z|b|a] are zero-padded to 128 columns
    (pad_quant_cols; b and a are only Hv wide), which the blocks slice
    off; [gate|up] is not padded, so that its halves stay gate and up and
    the fused quantized MLP takes it.  Parts whose grids differ (a Q8_0
    ssm_beta beside a Q4_K attn_qkv) stay separate."""
    layers = params.get("layers")
    if not isinstance(layers, (list, tuple)):
        return params

    def fuse(lp, names, into, pad):
        fused = _fuse_out_axis([lp[n] for n in names])
        if fused is None:
            return lp
        return {**{k: v for k, v in lp.items() if k not in names},
                into: pad_quant_cols(fused) if pad else fused}

    out = []
    for lp in layers:
        if "q" in lp:
            lp = fuse(lp, ("q", "k", "v"), "qkv", True)
        if "in_proj_qkv" in lp:
            lp = fuse(lp, ("in_proj_qkv", "in_proj_z", "in_proj_b",
                           "in_proj_a"), "in_proj", True)
        if "gate" in lp["mlp"]:
            lp = {**lp, "mlp": fuse(lp["mlp"], ("gate", "up"), "gateup",
                                    False)}
        out.append(lp)
    return {**params, "layers": out}


def qwen3_5_text_default(layers: int | None = None) -> Qwen3_5TextConfig:
    """The JAX package's default Qwen3_5TextConfig() (hidden 1024, 24
    layers, 6 of them gated attention at 16/2 heads of 128 with partial
    rotary 0.25, GatedDeltaNet 8 key / 16 value heads of 128, conv K 4,
    intermediate 4096, vocab 151936, tied) — the reference's defaults, not
    a checked published config.json.  `layers` keeps the first ones (their
    kinds as in the full stack)."""
    full = Qwen3_5TextConfig()
    if layers is None:
        return full
    return dataclasses.replace(full, num_hidden_layers=layers,
                               layer_types=full.layer_types[:layers])


def qwen3_5_vl_default(layers: int | None = None, depth: int = 27,
                       deepstack: tuple[int, ...] = (8, 16, 24)
                       ) -> Qwen3_5Config:
    """qwen3_5_text_default(layers) with the JAX package's default Qwen3-VL
    tower (27 blocks at 1152, 16 heads of 72) cut to `depth` blocks
    (deepstack after `deepstack`), its output at the decoder's width, and
    Qwen3_5Config's default M-RoPE sections (8, 4, 4)."""
    text = qwen3_5_text_default(layers)
    return Qwen3_5Config(text=text, vision=Qwen3VLVisionConfig(
        depth=depth, out_hidden_size=text.hidden_size,
        deepstack_visual_indexes=deepstack))


class Qwen3_5Model:
    """The decoder TextEngine and BatchEngine drive; with a `vl_config`
    whose `vision` is set, also the Qwen3-VL tower (parameters under
    "visual")."""

    #: decode accepts a per-slot (B,) cache["pos"]; the conv / recurrent
    #: states are per slot and position-free
    supports_slot_decode = True
    #: prefill accepts from_cache=True over restored K/V rows and rolling
    #: state (an exact repeat never matches: the state cannot rewind)
    supports_prefix_cache = True

    fuse_params = staticmethod(fuse_qwen3_5_decode_params)

    def __init__(self, config: Qwen3_5TextConfig, max_rope_len: int = 8192,
                 device: torch.device | str = "cpu",
                 vl_config: Qwen3_5Config | None = None):
        self.config = c = config
        self.device = torch.device(device)
        self.n_layers = c.num_hidden_layers
        self.layer_types = c.layer_types
        attn = [i for i, t in enumerate(c.layer_types)
                if t == "full_attention"]
        self.attn_slot = {i: j for j, i in enumerate(attn)}
        self.lin_slot = {i: j for j, i in enumerate(
            i for i in range(self.n_layers) if i not in self.attn_slot)}
        self.n_attn, self.n_lin = len(self.attn_slot), len(self.lin_slot)
        self.rotary_dim = int(c.head_dim * c.partial_rotary_factor)
        self.cos, self.sin = rope_table(
            self.rotary_dim, min(max_rope_len, c.max_position_embeddings),
            c.rope_theta, device=self.device)
        self.conv_dim = (2 * c.linear_num_key_heads * c.linear_key_head_dim
                         + c.linear_num_value_heads * c.linear_value_head_dim)
        self.attn = CacheAttention(self.n_attn, self.device)
        self.vl = vl_config
        self.tower = None
        if vl_config is not None and vl_config.vision is not None:
            self.tower = Qwen3VLVisionTower(vl_config.vision, self.device)
            # interleaved M-RoPE over the PARTIAL rotary table
            self.sections = torch.from_numpy(mrope_interleaved_sections(
                self.cos.shape[-1], vl_config.mrope_section)).to(self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   per_slot_pos: bool = False) -> dict:
        c = self.config
        cache = kv.init_kv_cache(max(self.n_attn, 1), batch, max_len,
                                 c.num_key_value_heads, c.head_dim, dtype,
                                 self.device, per_slot_pos, flat=False)
        n = max(self.n_lin, 1)
        cache["conv"] = torch.zeros(
            (n, batch, c.linear_conv_kernel_dim, self.conv_dim),
            dtype=dtype, device=self.device)
        cache["rec"] = torch.zeros(
            (n, batch, c.linear_num_value_heads, c.linear_key_head_dim,
             c.linear_value_head_dim), dtype=torch.float32,
            device=self.device)
        cache["rope_delta"] = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        return cache

    # -- gated full attention -------------------------------------------------

    def _full_attn(self, lp: dict, x: torch.Tensor, cos, sin, cache: dict,
                   slot: int, positions, valid_len,
                   from_cache: bool) -> torch.Tensor:
        c = self.config
        B, S, _ = x.shape
        H, hd, Hkv = c.num_attention_heads, c.head_dim, c.num_key_value_heads
        if "qkv" in lp:
            qkv = nn.linear(lp["qkv"], x)
            nq2, nkv = H * 2 * hd, Hkv * hd
            qg, k, v = (qkv[..., :nq2], qkv[..., nq2:nq2 + nkv],
                        qkv[..., nq2 + nkv:nq2 + 2 * nkv])
        else:
            qg, k, v = (nn.linear(lp["q"], x), nn.linear(lp["k"], x),
                        nn.linear(lp["v"], x))
        qg = qg.reshape(B, S, H, 2 * hd)
        q, gate = qg[..., :hd], qg[..., hd:].reshape(B, S, H * hd)
        q = rms_norm(q, lp["q_norm"]["w"], c.rms_norm_eps)
        k = rms_norm(k.reshape(B, S, Hkv, hd), lp["k_norm"]["w"],
                     c.rms_norm_eps)
        v = v.reshape(B, S, Hkv, hd)
        rd = self.rotary_dim                     # rotate the first rd
        q_rot, k_rot = apply_rope(q[..., :rd], k[..., :rd], cos, sin)
        q = torch.cat([q_rot, q[..., rd:]], dim=-1)
        k = torch.cat([k_rot, k[..., rd:]], dim=-1)
        out = self.attn.attend(q, k, v, cache, slot, positions, valid_len,
                               from_cache)
        out = out.reshape(B, S, H * hd) * torch.sigmoid(gate)
        return nn.linear(lp["o"], out)

    # -- GatedDeltaNet --------------------------------------------------------

    def _linear_attn(self, lp: dict, x: torch.Tensor, slot: int,
                     cache: dict, valid: torch.Tensor | None,
                     prompt_len: int, from_cache: bool) -> torch.Tensor:
        """`valid` (S,) bool marks a padded prefill's real rows (None: all
        real).  A fresh prefill reads neither state; from_cache continues
        both (the conv window's left context, the delta rule's state)."""
        c = self.config
        B, S, _ = x.shape
        Hk, Hv = c.linear_num_key_heads, c.linear_num_value_heads
        Dk, Dv = c.linear_key_head_dim, c.linear_value_head_dim
        key_dim = Hk * Dk
        if valid is not None:
            x = torch.where(valid[None, :, None], x, 0.0)
        if "in_proj" in lp:
            proj = nn.linear(lp["in_proj"], x)
            zend = self.conv_dim + Hv * Dv
            mixed, z = proj[..., :self.conv_dim], proj[..., self.conv_dim:zend]
            b = proj[..., zend:zend + Hv]
            a = proj[..., zend + Hv:zend + 2 * Hv]
        else:
            mixed = nn.linear(lp["in_proj_qkv"], x)
            z = nn.linear(lp["in_proj_z"], x)
            b, a = nn.linear(lp["in_proj_b"], x), nn.linear(lp["in_proj_a"], x)
        z = z.reshape(B, S, Hv, Dv)
        mixed = F.silu(causal_conv(mixed, lp["conv"]["w"],
                                   cache["conv"][slot], prompt_len,
                                   from_cache))
        q = _l2norm(mixed[..., :key_dim].reshape(B, S, Hk, Dk).float())
        k = _l2norm(mixed[..., key_dim:2 * key_dim].reshape(B, S, Hk, Dk)
                    .float())
        v = mixed[..., 2 * key_dim:].reshape(B, S, Hv, Dv).float()
        if Hv // Hk > 1:
            q = q.repeat_interleave(Hv // Hk, dim=2)
            k = k.repeat_interleave(Hv // Hk, dim=2)
        beta = torch.sigmoid(b.float())
        g = -lp["a_log"].float().exp() * F.softplus(
            a.float() + lp["dt_bias"].float())
        if valid is not None:                    # padded rows: no decay,
            g = torch.where(valid[None, :, None], g, 0.0)   # no write
            beta = torch.where(valid[None, :, None], beta, 0.0)
        rec = cache["rec"][slot]
        if S > 1:
            state0 = rec if from_cache else torch.zeros_like(rec)
            out, state = chunk_gated_delta_rule(q, k, v, g, beta, state0)
        else:
            out, state = recurrent_gated_delta_rule(q, k, v, g, beta, rec)
        rec.copy_(state)
        # gated RMSNorm over Dv with silu(z) (Qwen3_5RMSNormGated)
        out = rms_norm(out.to(x.dtype), lp["norm"]["w"], c.rms_norm_eps)
        out = out * F.silu(z.to(out.dtype))
        return nn.linear(lp["out_proj"], out.reshape(B, S, Hv * Dv))

    # -- forward --------------------------------------------------------------

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 prompt_len: int | None = None, from_cache: bool = False,
                 window: int | None = None,
                 mm: dict | None = None) -> torch.Tensor:
        """Embeddings → final hidden; writes K/V rows at [pos, pos + S) and
        the rolling state in place, and leaves pos as it was.  Decode and a
        from_cache chunk take rope positions at pos + rope_delta; a fresh
        prefill at pos, and sets rope_delta to 0 — or, with `mm` (the
        Qwen3-VL inputs, models/qwen3vl_served.build_mm), the vision
        features at the placeholder tokens, interleaved M-RoPE positions
        and mm's rope_delta, deepstack level i added after layer i; `mm`
        on a model without a tower raises.  `prompt_len` (a host int, default S) is a padded
        prefill's true length; `window` is accepted and unused."""
        c = self.config
        B, S = input_ids.shape
        prompt_len = S if prompt_len is None else prompt_len
        fresh = S > 1 and not from_cache
        if fresh:
            cache["rope_delta"].zero_()
        x = nn.embedding(params["embed"], input_ids)
        positions, rope_at, valid_len = self.attn.positions(
            cache, S, self.cos.shape[0], x.device,
            offset=None if fresh else cache["rope_delta"])
        ds = vis = rows = None
        if mm is not None:
            if self.tower is None:
                raise ValueError("image or video inputs given to a Qwen3.5 "
                                 "model without a vision tower")
            feats, ds = self.tower.encode(params["visual"], mm)
            x, vis, rows = splice_vision(
                x, input_ids, feats,
                (self.vl.image_token_id, self.vl.video_token_id))
            cos, sin = mrope_cos_sin(self.cos, self.sin,
                                     mm["position_ids"][:, :S], self.sections)
            cache["rope_delta"].fill_(int(mm["rope_delta"]))
        else:
            cos, sin = gather_rope(self.cos, self.sin, rope_at)
        valid = (torch.arange(S, device=x.device) < prompt_len
                 if S > 1 and prompt_len < S else None)
        for i, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["ln1"]["w"], c.rms_norm_eps)
            if i in self.attn_slot:
                out = self._full_attn(lp, h, cos, sin, cache,
                                      self.attn_slot[i], positions,
                                      valid_len, from_cache)
            else:
                out = self._linear_attn(lp, h, self.lin_slot[i], cache,
                                        valid, prompt_len, from_cache)
            x = x + out
            h = rms_norm(x, lp["ln2"]["w"], c.rms_norm_eps)
            x = x + nn.swiglu_mlp(lp["mlp"], h)
            if ds is not None and i < ds.shape[0]:
                x = inject_deepstack(x, ds[i], vis, rows)
        return rms_norm(x, params["norm"]["w"], c.rms_norm_eps)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """A dense head is vocab-major (V, K); a quantized one (a GGUF
        file's) goes through nn.linear, the quant-matmul kernel at decode
        M on the card (the JAX model's nn.linear over its head)."""
        head = params["lm_head"]
        if is_quantized(head):
            return nn.linear(head, hidden)
        return hidden @ head["w"].t()

    # -- parameters -----------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16,
                    prefix: str = "model.") -> dict:
        """HF checkpoint names → the port's tree on self.device: a VL
        checkpoint's decoder under `model.language_model.` (its tower,
        under `visual.` or `model.visual.`, read only by a model with
        one), the zero-centred norms folded to
        w + 1, the depthwise conv's (D, 1, K) weight as (K, D), A_log and
        dt_bias in float32, the gated norm as stored; lm_head is the
        embedding itself when the config ties it and the file has none."""
        if f"{prefix}embed_tokens.weight" not in src and \
                "model.language_model.embed_tokens.weight" in src:
            prefix = "model.language_model."
        c = self.config

        def get(name, dt=dtype):
            return src[name].to(device=self.device, dtype=dt)

        def lin(name):
            return {"w": get(name + ".weight").t().contiguous()}

        def centred(name):
            return {"w": get(name + ".weight") + 1.0}

        layers = []
        for i in range(self.n_layers):
            p = f"{prefix}layers.{i}."
            lp = {"ln1": centred(p + "input_layernorm"),
                  "ln2": centred(p + "post_attention_layernorm"),
                  "mlp": {"gate": lin(p + "mlp.gate_proj"),
                          "up": lin(p + "mlp.up_proj"),
                          "down": lin(p + "mlp.down_proj")}}
            if i in self.attn_slot:
                a = p + "self_attn."
                lp.update({"q": lin(a + "q_proj"), "k": lin(a + "k_proj"),
                           "v": lin(a + "v_proj"), "o": lin(a + "o_proj"),
                           "q_norm": centred(a + "q_norm"),
                           "k_norm": centred(a + "k_norm")})
            else:
                la = p + "linear_attn."
                wconv = get(la + "conv1d.weight")            # (D, 1, K)
                lp.update({
                    "in_proj_qkv": lin(la + "in_proj_qkv"),
                    "in_proj_z": lin(la + "in_proj_z"),
                    "in_proj_b": lin(la + "in_proj_b"),
                    "in_proj_a": lin(la + "in_proj_a"),
                    "out_proj": lin(la + "out_proj"),
                    "conv": {"w": wconv[:, 0, :].t().contiguous()},
                    "dt_bias": get(la + "dt_bias", torch.float32),
                    "a_log": get(la + "A_log", torch.float32),
                    "norm": {"w": get(la + "norm.weight")}})
            layers.append(lp)
        embed = get(prefix + "embed_tokens.weight")
        head = (embed if c.tie_word_embeddings and "lm_head.weight" not in src
                else get("lm_head.weight"))
        params = {"embed": {"w": embed}, "layers": layers,
                  "norm": centred(prefix + "norm"), "lm_head": {"w": head}}
        if self.tower is not None:
            vt = ("visual." if "visual.patch_embed.proj.weight" in src
                  else "model.visual.")
            params["visual"] = self.tower.load_params(src, dtype, vt)
        return params

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry (unit folded
        norms, zero A_log and dt_bias as the JAX init has them, tied head),
        drawn on the generator's device and moved to self.device."""
        c = self.config
        d, ff = c.hidden_size, c.intermediate_size
        H, hd, Hkv = c.num_attention_heads, c.head_dim, c.num_key_value_heads
        Hv, Dv = c.linear_num_value_heads, c.linear_value_head_dim
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return {"w": x.to(device=self.device, dtype=dtype)}

        def ones(n):
            return {"w": torch.ones(n, device=self.device, dtype=dtype)}

        def zeros32(n):
            return torch.zeros(n, device=self.device, dtype=torch.float32)

        layers = []
        for i in range(self.n_layers):
            lp = {"ln1": ones(d), "ln2": ones(d),
                  "mlp": {"gate": w(d, ff), "up": w(d, ff),
                          "down": w(ff, d)}}
            if i in self.attn_slot:
                lp.update({"q": w(d, H * hd * 2), "k": w(d, Hkv * hd),
                           "v": w(d, Hkv * hd), "o": w(H * hd, d),
                           "q_norm": ones(hd), "k_norm": ones(hd)})
            else:
                lp.update({"in_proj_qkv": w(d, self.conv_dim),
                           "in_proj_z": w(d, Hv * Dv),
                           "in_proj_b": w(d, Hv), "in_proj_a": w(d, Hv),
                           "out_proj": w(Hv * Dv, d),
                           "conv": w(c.linear_conv_kernel_dim, self.conv_dim),
                           "dt_bias": zeros32(Hv), "a_log": zeros32(Hv),
                           "norm": ones(Dv)})
            layers.append(lp)
        embed = w(c.vocab_size, d)
        params = {"embed": embed, "layers": layers, "norm": ones(d),
                  "lm_head": {"w": embed["w"]}}
        if self.tower is not None:
            params["visual"] = self.tower.init_random(generator, d, dtype,
                                                      scale)
        return params
