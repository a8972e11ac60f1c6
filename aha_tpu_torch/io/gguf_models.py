"""Load a GGUF Qwen3 into the port (counterpart of
aha_tpu/io/gguf_models.py's qwen3 path).

llama.cpp tensor naming (token_embd, blk.N.attn_q, …) mapped into the
port's parameter tree: decoder linears stay block-quantized on the port's
grids (ops/quant_matmul.py: sub-5-bit formats on the 4-bit grid, the rest
on int8), embeddings and norms are dequantized, and the head follows the
stored type (`_lm_head`).  The qwen35 and mmproj loaders come with their
families.
"""

from __future__ import annotations

import torch

from aha_tpu_torch.io.gguf import GGUFFile
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model, stack_layers
from aha_tpu_torch.ops.quant_matmul import (Q4_TYPES, from_gguf_tensor,
                                            pack_rows)
from aha_tpu_torch.utils.device import device as default_device
from aha_tpu_torch.utils.device import get_dtype


def _meta(gguf: GGUFFile, arch: str, key: str, default=None):
    return gguf.metadata.get(f"{arch}.{key}", default)


def qwen3_config_from_gguf(gguf: GGUFFile) -> Qwen3Config:
    arch = gguf.metadata.get("general.architecture", "qwen3")
    n_embd = int(_meta(gguf, arch, "embedding_length"))
    n_head = int(_meta(gguf, arch, "attention.head_count"))
    return Qwen3Config(
        vocab_size=int(gguf.tensors["token_embd.weight"].shape[0]),
        hidden_size=n_embd,
        intermediate_size=int(_meta(gguf, arch, "feed_forward_length")),
        num_hidden_layers=int(_meta(gguf, arch, "block_count")),
        num_attention_heads=n_head,
        num_key_value_heads=int(_meta(gguf, arch, "attention.head_count_kv",
                                      n_head)),
        head_dim=int(_meta(gguf, arch, "attention.key_length",
                           n_embd // n_head)),
        rms_norm_eps=float(_meta(gguf, arch,
                                 "attention.layer_norm_rms_epsilon", 1e-6)),
        rope_theta=float(_meta(gguf, arch, "rope.freq_base", 1000000.0)),
        max_position_embeddings=int(_meta(gguf, arch, "context_length",
                                          40960)),
        tie_word_embeddings="output.weight" not in gguf.tensors,
    )


def _dense(gguf: GGUFFile, name: str, dtype, device) -> torch.Tensor:
    return torch.from_numpy(gguf.dequantize(name)).to(device=device,
                                                      dtype=dtype)


def _qlin(gguf: GGUFFile, name: str, device) -> dict:
    return from_gguf_tensor(gguf, name, device)


# float-stored GGML types (F32=0, F16=1, BF16=30): requantizing these
# through the int8 grid would LOSE precision the checkpoint ships
_FLOAT_GGML_TYPES = {0, 1, 30}


def _lm_head(gguf: GGUFFile, embed: torch.Tensor, dtype, device) -> dict:
    """Output head, vocab-major.  A quantized stored head stays quantized
    (llama.cpp quantizes output.weight too: it is the largest weight, and
    batch-1 decode reads it every step); a head stored in f16/f32/bf16
    keeps its precision as a dense (V, K) `w`; a tied model reuses a
    float-stored embedding itself, and packs a quantized one's
    dequantized rows on the grid of its type."""
    if "output.weight" in gguf.tensors:
        if gguf.tensors["output.weight"].ggml_type in _FLOAT_GGML_TYPES:
            return {"w": _dense(gguf, "output.weight", dtype, device)}
        return _qlin(gguf, "output.weight", device)
    et = gguf.tensors["token_embd.weight"].ggml_type
    if et in _FLOAT_GGML_TYPES:
        return {"w": embed}
    return pack_rows(embed.float(), et in Q4_TYPES)


def load_qwen3_gguf(path: str, dtype: torch.dtype | None = None,
                    max_rope_len: int = 8192,
                    device: torch.device | str | None = None
                    ) -> tuple[Qwen3Model, dict, GGUFFile]:
    """(model, params, gguf) from a qwen3-architecture .gguf file, on
    `device` — by default the port's device (utils/device.py: the card,
    which must be visible, unless `AHA_DEVICE` names another) — with dense
    tensors in `dtype` (by default that device's compute dtype).  Layers are stacked (L, ...) as the JAX loader stacks them,
    which takes one grid per tensor name across the layers: a file whose
    layers store the same tensor in formats of different grids (Q4_K_M's
    Q6_K `attn_v` / `ffn_down` in some layers, Q4_K in the others) is
    refused with a ValueError, as the JAX loader's tree stacking refuses
    it."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype if dtype is not None else get_dtype(device)
    gguf = GGUFFile(path)
    config = qwen3_config_from_gguf(gguf)
    model = Qwen3Model(config, max_rope_len=max_rope_len, device=device)

    def norm(name):
        return {"w": _dense(gguf, name, dtype, device)}

    layers = []
    for i in range(config.num_hidden_layers):
        b = f"blk.{i}."
        layers.append({
            "ln1": norm(b + "attn_norm.weight"),
            "ln2": norm(b + "ffn_norm.weight"),
            "q": _qlin(gguf, b + "attn_q.weight", device),
            "k": _qlin(gguf, b + "attn_k.weight", device),
            "v": _qlin(gguf, b + "attn_v.weight", device),
            "o": _qlin(gguf, b + "attn_output.weight", device),
            "q_norm": norm(b + "attn_q_norm.weight"),
            "k_norm": norm(b + "attn_k_norm.weight"),
            "mlp": {
                "gate": _qlin(gguf, b + "ffn_gate.weight", device),
                "up": _qlin(gguf, b + "ffn_up.weight", device),
                "down": _qlin(gguf, b + "ffn_down.weight", device),
            },
        })
    _same_grids(layers)
    embed = _dense(gguf, "token_embd.weight", dtype, device)
    params = {"embed": {"w": embed}, "layers": stack_layers(layers),
              "norm": norm("output_norm.weight"),
              "lm_head": _lm_head(gguf, embed, dtype, device)}
    return model, params, gguf


def _same_grids(layers: list[dict]) -> None:
    def keys(tree, prefix=""):
        out = set()
        for k, v in tree.items():
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
            else:
                out.add(prefix + k)
        return out

    first = keys(layers[0])
    for i, lp in enumerate(layers[1:], 1):
        if keys(lp) != first:
            raise ValueError(
                f"layer {i} stores {sorted(keys(lp) ^ first)} on another "
                "quantization grid than layer 0: the layers cannot stack "
                "(a mixed-format file such as Q4_K_M)")
