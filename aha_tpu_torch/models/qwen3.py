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
batch-1 decode step over a bf16 cache whose caller bounds the live rows by
`window` ≤ MAX_WINDOW (2048) runs the whole stack as ONE fused kernel
(ops/fused_layer.py), as the JAX package does: the bf16 stack for dense
weights, the quantized stack for GGUF-grid ones; deeper steps, batched
steps and int8 caches run the per-op chain, whose attention is a decode
kernel.  The greedy head runs its kernel (ops/lm_head.py), prefill of
prompts of ≥ 128 bucketed rows the flash prefill kernel
(ops/flash_attention.py); outside the fused step dense projections and the
MLP stay torch.matmul.  On the per-op chain, GGUF block-quantized
parameters (io/gguf_models.py, or pack_params) take the quant-matmul
kernels at ≤ 64 rows on the card, the MLP the fused quantized SwiGLU, and a
quantized head the head's quantized bodies (greedy) or the quant-matmul
kernel (logits).

Tensor parallelism (`mesh` with tp > 1, parallel/): the model is one
rank's, built on its slice of the parameters (`shard_params` by
QWEN3_PARTITION_RULES): Hq/tp query and Hkv/tp kv heads, I/tp MLP
columns and V/tp vocab rows, norms (and the per-head q/k norms)
replicated; check_tp refuses a tp that does not divide them.  o and down
are row-sharded (parallel/layers.row_linear: one f32 all_reduce each),
the embedding is a masked lookup summed over the
ranks, the tied head gives gathered logits, and the greedy token comes
from the value-out head kernel and the ranks' combine.  The cache holds
the rank's kv heads only: `init_cache` allocates the rank's slice of the
whole model's cache by QWEN3_CACHE_RULES.  Under a mesh the decode is
the per-op chain: the fused stack never runs, as the JAX gate (`mesh is
None`) has it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.core.sampling import fast_argmax
from aha_tpu_torch.ops.attention import (attention_decode_at,
                                         attention_decode_at_q8,
                                         attention_prefill,
                                         attention_prefill_at,
                                         attention_prefill_at_q8,
                                         quantize_kv_rows)
from aha_tpu_torch.ops.fused_layer import (MAX_WINDOW, fused_decode_stack,
                                           fused_decode_stack_q8,
                                           fused_stack_q8_supported,
                                           fused_stack_supported)
from aha_tpu_torch.ops.lm_head import head_argmax
from aha_tpu_torch.ops.norms import rms_norm
from aha_tpu_torch.ops.quant_matmul import concat_columns, pack_rows
from aha_tpu_torch.ops.rope import apply_rope, gather_rope, rope_table
from aha_tpu_torch.parallel import layers as tp_layers
from aha_tpu_torch.parallel.mesh import check_text_tp


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

    #: decode accepts a per-slot (B,) cache["pos"] vector — the contract the
    #: continuous-batching engine (core/batch_engine.py) needs
    supports_slot_decode = True
    #: pure K/V cache; prefill accepts from_cache=True (prefix caching)
    supports_prefix_cache = True
    #: decode reads an int8 KV cache (init_cache(dtype=torch.int8); serve
    #: with AHA_KV_INT8=1) — halves long-context cache bandwidth
    supports_kv_int8 = True
    #: pure K/V + position-gated reads: the cache can REWIND (pos -= k) with
    #: no state to unwind — speculative decoding verifies drafts then rolls
    #: back rejected rows for free (hybrids cannot: conv/rec state advanced
    #: by rejected tokens is unrecoverable)
    supports_token_rewind = True

    def __init__(self, config: Qwen3Config, max_rope_len: int = 32768,
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
        self.head_dim = c.head_dim
        self.cos, self.sin = rope_table(
            c.head_dim, min(max_rope_len, c.max_position_embeddings),
            c.rope_theta, device=self.device)
        # layer indices as device scalars: the decode kernel reads its layer
        self._layer_ids = torch.arange(self.n_layers, dtype=torch.int32,
                                       device=self.device)
        self._views: tuple[Any, list[dict]] | None = None
        # arange(B) per slot count, kept: a captured decode block binds it
        self._slots: dict[int, torch.Tensor] = {}

    # -- cache --------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   per_slot_pos: bool = False) -> dict:
        """The cache of the whole model's kv heads; under a mesh, this
        rank's slice of it by QWEN3_CACHE_RULES."""
        return kv.init_kv_cache(self.n_layers, batch, max_len,
                                self.config.num_key_value_heads,
                                self.head_dim, dtype, self.device,
                                per_slot_pos, mesh=self.mesh,
                                rules=self.cache_rules)

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
        h = attn.reshape(B, S, nq)
        x = x + tp_layers.row_linear(lp["o"], h, self.mesh)
        h = rms_norm(x, lp["ln2"]["w"], c.rms_norm_eps)
        return x + tp_layers.swiglu_mlp(lp["mlp"], h, self.mesh)

    def _slot_ids(self, B: int, device) -> torch.Tensor:
        if B not in self._slots:
            self._slots[B] = torch.arange(B, device=device)
        return self._slots[B]

    def _use_fused_stack(self, params: dict, x: torch.Tensor, cache: dict,
                         window: int | None) -> str | None:
        """The JAX package's gate for the one-launch decode stack
        (aha_tpu/models/qwen3.py _use_fused_layer): one bf16 token of
        batch 1 over a flat bf16 cache with a scalar pos, at most MAX_WINDOW
        live rows, and AHA_FUSED_LAYER not "0"; then "bf16" for fused dense
        parameters the bf16 kernel covers, "q8" for fused GGUF-grid ones
        the quantized kernel covers, else None (the per-op chain).  The
        kernels read the live length on the device; `window` is the
        caller's host bound on it."""
        if window is None or window > MAX_WINDOW or self.mesh is not None \
                or os.environ.get("AHA_FUSED_LAYER", "1") != "1":
            return None
        B, S, _ = x.shape
        if not (B == 1 and S == 1 and x.dtype == torch.bfloat16
                and cache["k"].dtype == torch.bfloat16
                and cache["pos"].ndim == 0):
            return None
        c = self.config
        geo = (params["layers"], c.hidden_size, self.n_heads,
               self.n_kv_heads, self.head_dim, c.intermediate_size)
        if fused_stack_supported(*geo):
            return "bf16"
        if fused_stack_q8_supported(*geo):
            return "q8"
        return None

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
        mode = self._use_fused_stack(params, x, cache, window)
        if mode:
            stack = fused_decode_stack if mode == "bf16" else \
                fused_decode_stack_q8
            x = stack(x, params["layers"], pos, torch.cat([cos, cos], -1),
                      torch.cat([sin, sin], -1), cache["k"], cache["v"], eps)
            return rms_norm(x, params["norm"]["w"], eps)
        is_prefill = S > 1
        valid_len = None if is_prefill else (pos + 1).reshape(-1)
        for li, lp in enumerate(self._layer_views(params["layers"])):
            x = self._layer(lp, li, x, cos, sin, cache, is_prefill,
                            from_cache, positions, valid_len)
        return rms_norm(x, params["norm"]["w"], eps)

    def backbone(self, params: dict, input_ids: torch.Tensor, cache: dict,
                 from_cache: bool = False, window: int | None = None,
                 prompt_len: int | None = None) -> torch.Tensor:
        """`prompt_len` (the true length of a padded prefill) is accepted
        and unused: rows past it are never read."""
        x = self.embed(params, input_ids)
        return self.run_layers(params, x, cache, from_cache=from_cache,
                               window=window)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return tp_layers.embedding(params["embed"], input_ids,
                                       self.config.vocab_size, self.mesh)
        return nn.embedding(params["embed"], input_ids)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """A dense head is vocab-major (V, K); a quantized head goes
        through nn.linear (the quant-matmul kernel at ≤ 64 rows on the
        card)."""
        head = params["lm_head"]
        if self.mesh is not None:
            return tp_layers.gathered_logits(hidden @ head["w"].t(),
                                             self.config.vocab_size,
                                             self.mesh)
        if "w" in head:
            return hidden @ head["w"].t()
        return nn.linear(head, hidden)

    def logits_f32(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits of every row whose sums are never rounded to bf16, as
        the greedy head compares them (head_argmax): a dense bf16 head on
        the card is one GEMM with an f32 output; otherwise logits() in
        f32.  A speculative round takes its targets from these, so that
        they tie where greedy_token ties, not at bf16's spacing."""
        w = params["lm_head"].get("w")
        if w is not None and hidden.is_cuda and hidden.dtype == torch.bfloat16 \
                and self.mesh is None:
            return torch.mm(hidden.reshape(-1, hidden.shape[-1]), w.t(),
                            out_dtype=torch.float32).reshape(
                                *hidden.shape[:-1], -1)
        return self.logits(params, hidden).float()

    def greedy_token(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy next token for ONE hidden state (0-dim int32 on the
        device): the fused head GEMV + argmax kernel on the card, logits +
        fast_argmax on the CPU, as the JAX model's non-TPU branch (which
        is, for a dense head, the kernel's plain version).  Raises for more
        than one row.  Under a mesh: the value-out kernel over this rank's
        vocab shard and the ranks' combine (parallel/layers.py)."""
        if self.mesh is not None:
            return tp_layers.greedy_token(params["lm_head"]["w"], hidden,
                                          self.config.vocab_size, self.mesh)
        if hidden.is_cuda:
            return head_argmax(params["lm_head"], hidden)
        if hidden.numel() != hidden.shape[-1]:
            raise ValueError("greedy_token takes one hidden row, got "
                             f"{tuple(hidden.shape)}")
        return fast_argmax(self.logits(params, hidden).float().reshape(-1))

    def forward_hidden(self, params: dict,
                       input_ids: torch.Tensor) -> torch.Tensor:
        """Cache-free full forward returning final hidden states."""
        cache = self.init_cache(input_ids.shape[0], input_ids.shape[1],
                                params["embed"]["w"].dtype)
        return self.backbone(params, input_ids, cache)

    # -- parameters ---------------------------------------------------------

    def load_params(self, src, dtype: torch.dtype = torch.bfloat16,
                    prefix: str = "model.") -> dict:
        """HF checkpoint names under `prefix` ("model.language_model." for
        a Qwen3-VL checkpoint's decoder) → the port's layout on
        self.device.  `src` maps a tensor name to a CPU tensor
        (io/weights.py).  Under a mesh each tensor is read as this rank's
        slice (`shard_getters`: a safetensors file reads only those bytes)."""
        from aha_tpu_torch.io.weights import shard_getters

        get, lin = shard_getters(src, self.device, dtype, self.mesh)

        def norm(name):
            return {"w": get(name + ".weight")}

        layers = []
        for i in range(self.n_layers):
            p = f"{prefix}layers.{i}."
            layers.append({
                "ln1": norm(p + "input_layernorm"),
                "ln2": norm(p + "post_attention_layernorm"),
                # q/k/v, gate/up split their outputs (HF rows), o and down
                # their inputs (HF columns)
                "q": lin(p + "self_attn.q_proj", 0),
                "k": lin(p + "self_attn.k_proj", 0),
                "v": lin(p + "self_attn.v_proj", 0),
                "o": lin(p + "self_attn.o_proj", 1),
                "q_norm": norm(p + "self_attn.q_norm"),
                "k_norm": norm(p + "self_attn.k_norm"),
                "mlp": {"gate": lin(p + "mlp.gate_proj", 0),
                        "up": lin(p + "mlp.up_proj", 0),
                        "down": lin(p + "mlp.down_proj", 1)},
            })
        embed = get(prefix + "embed_tokens.weight", 0)
        if self.config.tie_word_embeddings and "lm_head.weight" not in src:
            head = embed
        else:
            head = get("lm_head.weight", 0)   # HF stores it (V, K)
        return {"embed": {"w": embed}, "layers": stack_layers(layers),
                "norm": norm(prefix + "norm"), "lm_head": {"w": head}}

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


def _fuse_out_axis(parts: list[dict]) -> dict | None:
    """Concatenate weight dicts on the output (column) axis, as the JAX
    package's _fuse_out_axis does: dense "w" (in, out) on its last axis, the
    quantized grids through ops/quant_matmul.concat_columns.  Column blocks
    of a product are independent and both grids scale per column, so the
    concat is bit-identical to separate products.  None for what must stay
    separate: mixed grids (a Q6_K tensor packed int8 beside Q4_K ones packed
    4-bit — llama.cpp mixes formats per tensor), unequal K, biases on some
    parts only, or biased quantized dicts."""
    if all("w" in p for p in parts):
        fused = {"w": torch.cat([p["w"] for p in parts], dim=-1)}
        if "b" in parts[0]:
            if not all("b" in p for p in parts):
                return None
            fused["b"] = torch.cat([p["b"] for p in parts], dim=-1)
        return fused
    return concat_columns(parts)


def fuse_decode_params(params: dict) -> dict:
    """Concatenate each layer's q/k/v (and gate/up) weights into single
    [q|k|v] / [gate|up] matrices on the output axis: fewer, larger weight
    streams for the decode step, dense or quantized.  Outputs are
    bit-identical to the separate products; layers whose parts cannot fuse
    (_fuse_out_axis) keep them separate."""
    layers = params.get("layers")
    if (not isinstance(layers, dict) or "q" not in layers
            or not isinstance(layers.get("mlp"), dict)):
        return params
    layers = dict(layers)
    fused = _fuse_out_axis([layers["q"], layers["k"], layers["v"]])
    if fused is not None:
        for name in "qkv":
            layers.pop(name)
        layers["qkv"] = fused
    mlp = layers["mlp"]
    if "gate" in mlp:
        gu = _fuse_out_axis([mlp["gate"], mlp["up"]])
        if gu is not None:
            mlp = {k: v for k, v in mlp.items() if k not in ("gate", "up")}
            layers["mlp"] = {**mlp, "gateup": gu}
    return {**params, "layers": layers}


Qwen3Model.fuse_params = staticmethod(fuse_decode_params)


def pack_params(params: dict, grid: str) -> dict:
    """A parameter tree with every decoder linear and the head packed on
    one GGUF grid ("q8" or "q4"), as a GGUF file of one format would give
    them: the stacked (L, in, out) "w" of each linear becomes (L, N, ...)
    grid tensors, the vocab-major head (V, K) a (V, ...) one; the embedding
    and norms stay dense.  Packs on the parameters' device."""
    q4 = {"q8": False, "q4": True}[grid]

    def walk(tree):
        out = {}
        for name, p in tree.items():
            if isinstance(p, dict) and "w" in p and p["w"].ndim == 3:
                out[name] = pack_rows(p["w"].transpose(-1, -2), q4)
            elif isinstance(p, dict):
                out[name] = walk(p)
            else:
                out[name] = p
        return out

    return {**params, "layers": walk(params["layers"]),
            "lm_head": pack_rows(params["lm_head"]["w"], q4)}


# Tensor-parallel partition rules (parallel/mesh.shard_params), the JAX
# package's QWEN3_PARTITION_RULES on the port's names and layouts: linear
# weights stacked (L, in, out) as there — q/k/v and gate/up split their
# output columns, o and down their input rows; the embedding and the head,
# both vocab-major (V, K) here (the JAX head is (K, V)), split the vocab;
# norms replicated.
QWEN3_PARTITION_RULES = (
    (r"layers\.(q|k|v)\.w", (None, None, "tp")),
    (r"layers\.o\.w", (None, "tp", None)),
    (r"layers\.mlp\.(gate|up)\.w", (None, None, "tp")),
    (r"layers\.mlp\.down\.w", (None, "tp", None)),
    (r"(^|\.)embed\.w", ("tp", None)),
    (r"lm_head\.w", ("tp", None)),
)

# KV cache (core/cache.py layouts): the flat rows (L, B, S, Hkv·D) split
# their last axis over tp — a contiguous Hkv·D/tp slice is one head group;
# the int8 layout's (L, B, S, Hkv) scales split their kv heads the same way,
# so each rank's scales sit with its rows (Qwen3Model.init_cache allocates
# a rank's slice by these).  The slot axis B splits over dp as in the JAX
# rules; a dp replica's engine holds its batch_slots/dp slots itself, so
# the tp-only mesh of a rank never applies it.
QWEN3_CACHE_RULES = (
    (r"^(k|v)$", (None, "dp", None, "tp")),
    (r"^(k|v)_scale$", (None, "dp", None, "tp")),
)
Qwen3Model.cache_rules = QWEN3_CACHE_RULES


#: the tp check of a Qwen3Config (heads, MLP and vocab)
check_tp = check_text_tp


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
