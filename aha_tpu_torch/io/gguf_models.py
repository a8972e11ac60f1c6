"""Load GGUF checkpoints into the port (counterpart of
aha_tpu/io/gguf_models.py): the qwen3 map, the qwen35 map (Qwen3.5's
hybrid decoder) and the clip mmproj of Qwen3-VL's deepstack tower, which
Qwen3.5 GGUF image chat loads beside the decoder.

llama.cpp tensor naming (token_embd, blk.N.attn_q, …) mapped into the
port's parameter trees: decoder linears stay block-quantized on the port's
grids (ops/quant_matmul.py: sub-5-bit formats on the 4-bit grid, the rest
on int8), embeddings and norms are dequantized, and the head follows the
stored type (`_lm_head`).  The mmproj tower is dequantized whole.
"""

from __future__ import annotations

import numpy as np
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


def _placed(device, dtype) -> tuple[torch.device, torch.dtype]:
    """The loaders' device (the port's by default: the card unless
    AHA_DEVICE names another) and dtype (that device's compute dtype by
    default)."""
    device = torch.device(device) if device is not None else default_device()
    return device, dtype if dtype is not None else get_dtype(device)


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
    device, dtype = _placed(device, dtype)
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


# -- qwen35 -----------------------------------------------------------------


def qwen3_5_config_from_gguf(gguf: GGUFFile):
    """The qwen35 arch's metadata → Qwen3_5TextConfig: ssm.group_count →
    linear key heads, ssm.time_step_rank → linear value heads,
    ssm.state_size → linear head dims, rope.dimension_count / head_dim →
    the partial rotary factor (aha_tpu/io/gguf_models.py:137)."""
    from aha_tpu_torch.models.qwen3_5 import Qwen3_5TextConfig

    arch = gguf.metadata.get("general.architecture", "qwen35")
    n_embd = int(_meta(gguf, arch, "embedding_length"))
    n_head = int(_meta(gguf, arch, "attention.head_count"))
    head_dim = int(_meta(gguf, arch, "attention.key_length",
                         n_embd // n_head))
    return Qwen3_5TextConfig(
        vocab_size=int(gguf.tensors["token_embd.weight"].shape[0]),
        hidden_size=n_embd,
        intermediate_size=int(_meta(gguf, arch, "feed_forward_length")),
        num_hidden_layers=int(_meta(gguf, arch, "block_count")),
        num_attention_heads=n_head,
        num_key_value_heads=int(_meta(gguf, arch, "attention.head_count_kv",
                                      n_head)),
        head_dim=head_dim,
        rms_norm_eps=float(_meta(gguf, arch,
                                 "attention.layer_norm_rms_epsilon", 1e-6)),
        rope_theta=float(_meta(gguf, arch, "rope.freq_base", 10000000.0)),
        partial_rotary_factor=int(_meta(gguf, arch, "rope.dimension_count",
                                        head_dim // 4)) / head_dim,
        max_position_embeddings=int(_meta(gguf, arch, "context_length",
                                          262144)),
        full_attention_interval=int(_meta(gguf, arch,
                                          "full_attention_interval", 4)),
        linear_num_key_heads=int(_meta(gguf, arch, "ssm.group_count")),
        linear_num_value_heads=int(_meta(gguf, arch, "ssm.time_step_rank")),
        linear_key_head_dim=int(_meta(gguf, arch, "ssm.state_size")),
        linear_value_head_dim=int(_meta(gguf, arch, "ssm.state_size")),
        linear_conv_kernel_dim=int(_meta(gguf, arch, "ssm.conv_kernel", 4)),
        tie_word_embeddings="output.weight" not in gguf.tensors,
    )


def _qwen3_5_params(gguf: GGUFFile, config, dtype, device) -> dict:
    """The qwen35 map's decoder tree, one dict a layer (each layer keeps
    its own grids, so a Q4_K_M file's mixed formats load).  GGUF norm
    weights are already uncentred (the converter folds the +1), so unlike
    the HF loader nothing is folded here.  ssm_conv1d (D, 1, K) becomes
    the (K, D) taps, kept in float32 with ssm_dt.bias and ssm_a, as the
    JAX loader keeps them; ssm_a is read into a_log as stored
    (aha_tpu/io/gguf_models.py:225; ROADMAP queue 3)."""
    def norm(name):
        return {"w": _dense(gguf, name, dtype, device)}

    def f32(name):
        return _dense(gguf, name, torch.float32, device)

    layers = []
    for i, kind in enumerate(config.layer_types):
        b = f"blk.{i}."
        lp = {"ln1": norm(b + "attn_norm.weight"),
              "ln2": norm(b + "post_attention_norm.weight"),
              "mlp": {"gate": _qlin(gguf, b + "ffn_gate.weight", device),
                      "up": _qlin(gguf, b + "ffn_up.weight", device),
                      "down": _qlin(gguf, b + "ffn_down.weight", device)}}
        if kind == "full_attention":
            lp.update({"q": _qlin(gguf, b + "attn_q.weight", device),
                       "k": _qlin(gguf, b + "attn_k.weight", device),
                       "v": _qlin(gguf, b + "attn_v.weight", device),
                       "o": _qlin(gguf, b + "attn_output.weight", device),
                       "q_norm": norm(b + "attn_q_norm.weight"),
                       "k_norm": norm(b + "attn_k_norm.weight")})
        else:
            conv = f32(b + "ssm_conv1d.weight")             # (D, 1, K)
            lp.update({
                "in_proj_qkv": _qlin(gguf, b + "attn_qkv.weight", device),
                "in_proj_z": _qlin(gguf, b + "attn_gate.weight", device),
                "in_proj_b": _qlin(gguf, b + "ssm_beta.weight", device),
                "in_proj_a": _qlin(gguf, b + "ssm_alpha.weight", device),
                "out_proj": _qlin(gguf, b + "ssm_out.weight", device),
                "conv": {"w": conv[:, 0, :].t().contiguous()},
                "dt_bias": f32(b + "ssm_dt.bias"),
                "a_log": f32(b + "ssm_a"),
                "norm": norm(b + "ssm_norm.weight")})
        layers.append(lp)
    embed = _dense(gguf, "token_embd.weight", dtype, device)
    return {"embed": {"w": embed}, "layers": layers,
            "norm": norm("output_norm.weight"),
            "lm_head": _lm_head(gguf, embed, dtype, device)}


def load_qwen3_5_gguf(path: str, dtype: torch.dtype | None = None,
                      max_rope_len: int = 8192,
                      device: torch.device | str | None = None) -> tuple:
    """(model, params, gguf) from a qwen35-architecture .gguf file, on
    `device` (by default the port's device: the card unless AHA_DEVICE
    names another) with dense tensors in `dtype` (by default that
    device's compute dtype).  Tensor names as the reference's
    new_from_gguf: attn_q (query and gate) / attn_k / attn_v / attn_output
    and attn_{q,k}_norm on the full-attention layers; attn_qkv / attn_gate
    / ssm_{beta,alpha,out,conv1d,dt,a,norm} on the GatedDeltaNet layers;
    attn_norm / post_attention_norm everywhere."""
    from aha_tpu_torch.models.qwen3_5 import Qwen3_5Model

    device, dtype = _placed(device, dtype)
    gguf = GGUFFile(path)
    config = qwen3_5_config_from_gguf(gguf)
    model = Qwen3_5Model(config, max_rope_len=max_rope_len, device=device)
    return model, _qwen3_5_params(gguf, config, dtype, device), gguf


# -- the clip mmproj of Qwen3-VL's tower --------------------------------------


def qwen3vl_vision_config_from_mmproj(gguf: GGUFFile):
    """clip.vision.* metadata → Qwen3VLVisionConfig: the deepstack taps from
    the is_deepstack_layers array, out_hidden_size from mm.2's output
    width (aha_tpu/io/gguf_models.py:246)."""
    from aha_tpu_torch.models.qwen3vl import Qwen3VLVisionConfig

    m = gguf.metadata
    hidden = int(m["clip.vision.embedding_length"])
    patch = int(m["clip.vision.patch_size"])
    image = int(m["clip.vision.image_size"])
    is_ds = m.get("clip.vision.is_deepstack_layers") or []
    return Qwen3VLVisionConfig(
        depth=int(m["clip.vision.block_count"]),
        hidden_size=hidden,
        intermediate_size=int(m.get("clip.vision.feed_forward_length",
                                    4 * hidden)),
        num_heads=int(m["clip.vision.attention.head_count"]),
        out_hidden_size=int(gguf.tensors["mm.2.weight"].shape[0]),
        patch_size=patch,
        spatial_merge_size=int(m.get("clip.vision.spatial_merge_size", 2)),
        temporal_patch_size=2,
        num_position_embeddings=(image // patch) ** 2,
        deepstack_visual_indexes=tuple(
            i for i, b in enumerate(is_ds) if b))


def load_qwen3vl_tower_mmproj(path: str, dtype: torch.dtype | None = None,
                              device: torch.device | str | None = None
                              ) -> tuple:
    """(vision_config, visual_params) from an mmproj .gguf, every tensor
    dequantized to `dtype` at load (the tower runs once an image, inside a
    prefill: no quant kernel runs in it).  The patch embedding ships as
    two temporal slices, v.patch_embd.weight (t = 0) and .weight.1 (t =
    1), put back together as the (hidden, 3, 2, p, p) kernel."""
    device, dtype = _placed(device, dtype)
    gguf = GGUFFile(path)
    vcfg = qwen3vl_vision_config_from_mmproj(gguf)

    def tensor(name):
        return _dense(gguf, name, dtype, device)

    def lin(name):
        p = {"w": tensor(name + ".weight").t().contiguous()}
        if name + ".bias" in gguf:
            p["b"] = tensor(name + ".bias")
        return p

    def norm(name):
        p = {"w": tensor(name + ".weight")}
        if name + ".bias" in gguf:
            p["b"] = tensor(name + ".bias")
        return p

    pe = gguf.dequantize("v.patch_embd.weight")
    if "v.patch_embd.weight.1" in gguf:
        pe = np.stack([pe, gguf.dequantize("v.patch_embd.weight.1")], axis=2)
    else:
        pe = pe[:, :, None]
    pe = torch.from_numpy(pe.reshape(vcfg.hidden_size, -1).T.copy())
    visual = {
        "patch_embed": {"w": pe.to(device=device, dtype=dtype),
                        "b": tensor("v.patch_embd.bias")},
        "pos_embed": {"w": tensor("v.position_embd.weight")},
        "blocks": [{"norm1": norm(f"v.blk.{i}.ln1"),
                    "norm2": norm(f"v.blk.{i}.ln2"),
                    "qkv": lin(f"v.blk.{i}.attn_qkv"),
                    "proj": lin(f"v.blk.{i}.attn_out"),
                    "fc1": lin(f"v.blk.{i}.ffn_up"),
                    "fc2": lin(f"v.blk.{i}.ffn_down")}
                   for i in range(vcfg.depth)],
        "merger": {"norm": norm("v.post_ln"), "fc1": lin("mm.0"),
                   "fc2": lin("mm.2")},
        "ds_mergers": [{"norm": norm(f"v.deepstack.{i}.norm"),
                        "fc1": lin(f"v.deepstack.{i}.fc1"),
                        "fc2": lin(f"v.deepstack.{i}.fc2")}
                       for i in vcfg.deepstack_visual_indexes],
    }
    return vcfg, visual


def _token_id(gguf: GGUFFile, token: str, default: int) -> int:
    """`token`'s index in the file's token list, else `default`."""
    toks = gguf.metadata.get("tokenizer.ggml.tokens") or []
    try:
        return toks.index(token)
    except ValueError:
        return default


def load_qwen3_5_gguf_vl(path: str, mmproj_path: str,
                         dtype: torch.dtype | None = None,
                         max_rope_len: int = 8192,
                         device: torch.device | str | None = None) -> tuple:
    """(model, params, gguf, vl_config): the Qwen3.5 decoder from the model
    file and Qwen3-VL's deepstack tower from the mmproj, under
    params["visual"]; the M-RoPE sections from
    qwen35.rope.dimension_sections without its last entry, the vision
    token ids from the file's token list (aha_tpu/io/gguf_models.py:338)."""
    from aha_tpu_torch.models.qwen3_5 import Qwen3_5Config, Qwen3_5Model

    device, dtype = _placed(device, dtype)
    gguf = GGUFFile(path)
    config = qwen3_5_config_from_gguf(gguf)
    params = _qwen3_5_params(gguf, config, dtype, device)
    vcfg, params["visual"] = load_qwen3vl_tower_mmproj(mmproj_path, dtype,
                                                       device)
    sections = list(gguf.metadata.get("qwen35.rope.dimension_sections")
                    or [8, 4, 4, 0])[:-1]
    vl_config = Qwen3_5Config(
        text=config, vision=vcfg, mrope_section=tuple(sections),
        image_token_id=_token_id(gguf, "<|image_pad|>", 151655),
        video_token_id=_token_id(gguf, "<|video_pad|>", 151656),
        vision_start_token_id=_token_id(gguf, "<|vision_start|>", 151652))
    model = Qwen3_5Model(config, max_rope_len=max_rope_len, device=device,
                         vl_config=vl_config)
    return model, params, gguf, vl_config
