"""Qwen3 dense text model (counterpart of aha_tpu/models/qwen3.py).

QK-norm GQA attention + SwiGLU MLP, tied embeddings optional.  Parameters
are a dict of tensors with the layers STACKED on a leading (L, ...) axis,
linear weights (in, out) as in the JAX package, and the head stored
vocab-major (V, K) — a tied head is the embedding tensor itself.

The KV cache (core/cache.py) is written in place at the device position
`cache["pos"]` — 0-dim for one stream, or (B,) for the continuous-batching
engine, where each slot's row goes to its own position; the backbone never
advances it (the engine does).  An int8 cache is quantized on write
(per-row, per-kv-head scales) and read by the q8 decode kernel; prefill
attends over the full-precision fresh block, as in the JAX package.  A
batch-1 bf16 decode step whose caller bounds the live rows by `window` ≤
MAX_WINDOW (2048) runs the whole stack as ONE fused kernel
(ops/fused_layer.py), as the JAX package does; deeper steps, batched steps
and int8 caches run the per-op chain, whose attention is a decode kernel.
The greedy head runs its kernel (ops/lm_head.py), prefill of prompts of ≥
128 bucketed rows the flash prefill kernel (ops/flash_attention.py);
outside the fused step the projections and the MLP stay torch.matmul.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.ops.attention import (attention_decode_at,
                                         attention_decode_at_q8,
                                         attention_prefill,
                                         attention_prefill_at,
                                         attention_prefill_at_q8,
                                         quantize_kv_rows)
from aha_tpu_torch.ops.fused_layer import (MAX_WINDOW, fused_decode_stack,
                                           fused_stack_supported)
from aha_tpu_torch.ops.lm_head import head_argmax
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.rope import apply_rope, gather_rope, rope_table


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    """Defaults are Qwen/Qwen3-0.6B's published config."""
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 40960
    tie_word_embeddings: bool = True
    attention_bias: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_file(cls, model_dir: str) -> "Qwen3Config":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_dict(json.load(f))


def unstack_layers(layers: dict) -> list[dict]:
    """(L, ...) stacked layer dict → one dict of views per layer."""
    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return [pick(layers, i) for i in range(len(layers["ln1"]["w"]))]


class Qwen3Model:
    """The model TextEngine (core/engine.py) and BatchEngine
    (core/batch_engine.py) drive."""

    def __init__(self, config: Qwen3Config, max_rope_len: int = 32768,
                 device: torch.device | str = "cpu"):
        self.config = c = config
        self.device = torch.device(device)
        self.n_layers = c.num_hidden_layers
        self.n_heads = c.num_attention_heads
        self.n_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.cos, self.sin = rope_table(
            c.head_dim, min(max_rope_len, c.max_position_embeddings),
            c.rope_theta, device=self.device)
        # layer indices as device scalars: the decode kernel reads its layer
        self._layer_ids = torch.arange(self.n_layers, dtype=torch.int32,
                                       device=self.device)
        self._views: tuple[Any, list[dict]] | None = None
        self._slots: torch.Tensor | None = None

    # -- cache --------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   per_slot_pos: bool = False) -> dict:
        return kv.init_kv_cache(self.n_layers, batch, max_len,
                                self.n_kv_heads, self.head_dim, dtype,
                                self.device, per_slot_pos)

    # -- forward ------------------------------------------------------------

    def _layer_views(self, layers: dict) -> list[dict]:
        if self._views is None or self._views[0] is not layers:
            self._views = (layers, unstack_layers(layers))
        return self._views[1]

    def _layer(self, lp: dict, li: int, x: torch.Tensor, cos, sin,
               cache: dict, is_prefill: bool, from_cache: bool,
               positions: torch.Tensor, valid_len: torch.Tensor | None):
        """One decoder block; writes this layer's K/V rows into the cache
        in place at `positions` — (S,) rows shared by the batch, or (B,)
        one row per slot (per-slot decode, S = 1)."""
        c = self.config
        B, S, _ = x.shape
        D = self.head_dim
        h = rms_norm(x, lp["ln1"]["w"], c.rms_norm_eps)
        nq, nkv = self.n_heads * D, self.n_kv_heads * D
        if "qkv" in lp:
            qkv = nn.linear(lp["qkv"], h)
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
        else:
            q, k, v = (nn.linear(lp["q"], h), nn.linear(lp["k"], h),
                       nn.linear(lp["v"], h))
        q = rms_norm(q.reshape(B, S, self.n_heads, D), lp["q_norm"]["w"],
                     c.rms_norm_eps)
        k = rms_norm(k.reshape(B, S, self.n_kv_heads, D), lp["k_norm"]["w"],
                     c.rms_norm_eps)
        v = v.reshape(B, S, self.n_kv_heads, D)
        q, k = apply_rope(q, k, cos, sin)

        quant = kv.is_quantized(cache)
        rows = {"k": k, "v": v}
        if quant:
            (rows["k"], rows["k_scale"]), (rows["v"], rows["v_scale"]) = (
                quantize_kv_rows(k), quantize_kv_rows(v))
        per_slot = cache["pos"].ndim == 1
        for name, new in rows.items():
            dst = cache[name][li]              # (B, S_cache, HD | Hkv)
            new = new.reshape(B, S, -1).to(dst.dtype)
            if per_slot:                       # row b at positions[b]
                dst[self._slot_ids(B, x.device), positions] = new[:, 0]
            else:
                dst.index_copy_(1, positions, new)
        layer = self._layer_ids[li]
        scales = (cache["k_scale"], cache["v_scale"]) if quant else ()
        if is_prefill and from_cache:
            attn = (attention_prefill_at_q8 if quant else
                    attention_prefill_at)(q, cache["k"], cache["v"], *scales,
                                          layer, cache["pos"])
        elif is_prefill:
            attn = attention_prefill(q, k, v, causal=True)
        else:
            attn = (attention_decode_at_q8 if quant else
                    attention_decode_at)(q, cache["k"], cache["v"], *scales,
                                         layer, valid_len)
        x = x + nn.linear(lp["o"], attn.reshape(B, S, nq))
        h = rms_norm(x, lp["ln2"]["w"], c.rms_norm_eps)
        return x + nn.swiglu_mlp(lp["mlp"], h)

    def _slot_ids(self, B: int, device) -> torch.Tensor:
        if self._slots is None or self._slots.shape[0] != B:
            self._slots = torch.arange(B, device=device)
        return self._slots

    def _use_fused_stack(self, params: dict, x: torch.Tensor, cache: dict,
                         window: int | None) -> bool:
        """The JAX package's gate for the one-launch decode stack
        (aha_tpu/models/qwen3.py _use_fused_layer): one bf16 token of
        batch 1 over a flat bf16 cache with a scalar pos, fused parameters
        the kernel covers, at most MAX_WINDOW live rows, and
        AHA_FUSED_LAYER not "0".  The kernel reads the live length on the
        device; `window` is the caller's host bound on it."""
        if window is None or window > MAX_WINDOW \
                or os.environ.get("AHA_FUSED_LAYER", "1") != "1":
            return False
        B, S, _ = x.shape
        c = self.config
        return (B == 1 and S == 1 and x.dtype == torch.bfloat16
                and cache["k"].dtype == torch.bfloat16
                and cache["pos"].ndim == 0
                and fused_stack_supported(params["layers"], c.hidden_size,
                                          self.n_heads, self.n_kv_heads,
                                          self.head_dim,
                                          c.intermediate_size))

    def run_layers(self, params: dict, x: torch.Tensor, cache: dict,
                   from_cache: bool = False,
                   window: int | None = None) -> torch.Tensor:
        """Decoder stack over input embeddings → final-normed hidden.
        Writes K/V at [pos, pos + S) and leaves pos as it was.  `window`:
        a host bound on the live cache rows after this call (decode only),
        which admits the fused decode stack.  A (B,) pos decodes one token
        per slot, each at its own position: rope rows gathered per slot,
        and a position past the cache (a slot stepped past its budget, as
        the batch engine's runahead does) clamped to the last row, where
        the JAX scatter drops it — that slot's outputs are discarded."""
        B, S, _ = x.shape
        pos = cache["pos"]
        if pos.ndim == 0:
            positions = pos.long() + torch.arange(S, device=x.device)
            cos, sin = gather_rope(self.cos, self.sin, positions)
        else:
            if S != 1:
                raise ValueError("per-slot positions take one token per slot")
            last = min(kv.cache_max_len(cache), self.cos.shape[0]) - 1
            positions = pos.long().clamp(max=last)
            cos, sin = gather_rope(self.cos, self.sin, positions[:, None])
        eps = self.config.rms_norm_eps
        if self._use_fused_stack(params, x, cache, window):
            x = fused_decode_stack(x, params["layers"], pos,
                                   torch.cat([cos, cos], -1),
                                   torch.cat([sin, sin], -1),
                                   cache["k"], cache["v"], eps)
            return rms_norm(x, params["norm"]["w"], eps)
        is_prefill = S > 1
        valid_len = None if is_prefill else (pos + 1).reshape(-1)
        for li, lp in enumerate(self._layer_views(params["layers"])):
            x = self._layer(lp, li, x, cos, sin, cache, is_prefill,
                            from_cache, positions, valid_len)
        return rms_norm(x, params["norm"]["w"], eps)

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 from_cache: bool = False,
                 window: int | None = None) -> torch.Tensor:
        x = nn.embedding(params["embed"], input_ids)
        return self.run_layers(params, x, cache, from_cache=from_cache,
                               window=window)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ params["lm_head"]["w"].t()

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy next token for ONE hidden state (0-dim int32 on the
        device): the fused head GEMV + argmax kernel on the card, logits +
        fast_argmax on the CPU.  Raises for more than one row."""
        return head_argmax(params["lm_head"]["w"], hidden)

    def forward_hidden(self, params: dict,
                       input_ids: torch.Tensor) -> torch.Tensor:
        """Cache-free full forward returning final hidden states."""
        cache = self.init_cache(input_ids.shape[0], input_ids.shape[1],
                                params["embed"]["w"].dtype)
        return self.backbone(params, input_ids, cache)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16) -> dict:
        """HF checkpoint names → the port's layout on self.device.  `src`
        maps a tensor name to a CPU tensor (io/weights.py)."""
        def get(name):
            return src[name].to(device=self.device, dtype=dtype)

        def lin(name):             # HF (out, in) → (in, out)
            return {"w": get(name + ".weight").t().contiguous()}

        def norm(name):
            return {"w": get(name + ".weight")}

        layers = []
        for i in range(self.n_layers):
            p = f"model.layers.{i}."
            layers.append({
                "ln1": norm(p + "input_layernorm"),
                "ln2": norm(p + "post_attention_layernorm"),
                "q": lin(p + "self_attn.q_proj"),
                "k": lin(p + "self_attn.k_proj"),
                "v": lin(p + "self_attn.v_proj"),
                "o": lin(p + "self_attn.o_proj"),
                "q_norm": norm(p + "self_attn.q_norm"),
                "k_norm": norm(p + "self_attn.k_norm"),
                "mlp": {"gate": lin(p + "mlp.gate_proj"),
                        "up": lin(p + "mlp.up_proj"),
                        "down": lin(p + "mlp.down_proj")},
            })
        embed = get("model.embed_tokens.weight")
        if self.config.tie_word_embeddings and "lm_head.weight" not in src:
            head = embed
        else:
            head = get("lm_head.weight")       # HF stores it (V, K)
        return {"embed": {"w": embed}, "layers": stack_layers(layers),
                "norm": norm("model.norm"), "lm_head": {"w": head}}

    def init_random(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    scale: float = 0.02) -> dict:
        """Seeded random parameters at this config's geometry, drawn on
        the generator's device and moved to self.device."""
        c = self.config
        d, hd, L = c.hidden_size, c.head_dim, self.n_layers
        gdev = generator.device

        def w(*shape):
            x = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * scale
            return x.to(device=self.device, dtype=dtype)

        def ones(*shape):
            return torch.ones(shape, device=self.device, dtype=dtype)

        layers = {
            "ln1": {"w": ones(L, d)}, "ln2": {"w": ones(L, d)},
            "q": {"w": w(L, d, self.n_heads * hd)},
            "k": {"w": w(L, d, self.n_kv_heads * hd)},
            "v": {"w": w(L, d, self.n_kv_heads * hd)},
            "o": {"w": w(L, self.n_heads * hd, d)},
            "q_norm": {"w": ones(L, hd)}, "k_norm": {"w": ones(L, hd)},
            "mlp": {"gate": {"w": w(L, d, c.intermediate_size)},
                    "up": {"w": w(L, d, c.intermediate_size)},
                    "down": {"w": w(L, c.intermediate_size, d)}},
        }
        embed = w(c.vocab_size, d)
        head = embed if c.tie_word_embeddings else w(c.vocab_size, d)
        return {"embed": {"w": embed}, "layers": layers,
                "norm": {"w": ones(d)}, "lm_head": {"w": head}}


def stack_layers(layers: list[dict]) -> dict:
    """One dict per layer → the (L, ...) stacked dict."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([l[k] for l in layers]) for k in first}
    return torch.stack(layers)


def fuse_decode_params(params: dict) -> dict:
    """Concatenate each layer's q/k/v (and gate/up) weights into single
    [q|k|v] / [gate|up] matrices on the output axis: fewer, larger weight
    streams for the batch-1 decode step.  Column blocks of a product are
    independent, so outputs are bit-identical to the separate products."""
    layers = params.get("layers")
    if not isinstance(layers, dict) or "q" not in layers:
        return params
    layers = dict(layers)
    layers["qkv"] = {"w": torch.cat([layers.pop(n)["w"] for n in "qkv"],
                                    dim=-1)}
    mlp = dict(layers["mlp"])
    if "gate" in mlp:
        mlp["gateup"] = {"w": torch.cat([mlp.pop("gate")["w"],
                                         mlp.pop("up")["w"]], dim=-1)}
        layers["mlp"] = mlp
    return {**params, "layers": layers}


Qwen3Model.fuse_params = staticmethod(fuse_decode_params)


def load_stop_token_ids(model_dir: str) -> list[int]:
    """eos ids from generation_config.json (falls back to config.json)."""
    for name in ("generation_config.json", "config.json"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                eos = json.load(f).get("eos_token_id")
            if eos is not None:
                return list(eos) if isinstance(eos, list) else [eos]
    return []
