"""Checkpoints → torch tensors (counterpart of aha_tpu/io/weights.py).

`open_weights(path)` resolves a model directory the way the JAX package
does (sharded index → *.safetensors → *.pth / *.bin) and returns a
read-only mapping from checkpoint tensor name to a CPU tensor; .pth and
.bin files are read with `torch.load(..., map_location="cpu",
weights_only=True)`, PyTorch's own reader, which takes the place of the
JAX package's pure-Python pickle reader (aha_tpu/io/torch_pickle.py);
model loaders move each tensor to the device and dtype they need
(models/qwen2_5vl.py takes both HF prefix sets of a
Qwen2_5_VLForConditionalGeneration checkpoint; `Renamed` gives a loader
its names over another prefix set).  The save_hf_* writers are the
loaders' inverses, for checkpoints made from seeded weights.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import torch

from aha_tpu_torch.core.nn import tree_at
from aha_tpu_torch.models import siglip


class SafetensorsSource:
    def __init__(self, paths: list[str]):
        from safetensors import safe_open

        self._files = [safe_open(p, framework="pt", device="cpu")
                       for p in paths]
        self._index = {k: i for i, f in enumerate(self._files)
                       for k in f.keys()}

    def keys(self) -> list[str]:
        return list(self._index)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._files[self._index[name]].get_tensor(name)

    def read_part(self, name: str, dim: int, index: int,
                  parts: int) -> torch.Tensor:
        """Part `index` of `parts` equal parts of `name` along `dim`,
        reading only those bytes of the file."""
        sl = self._files[self._index[name]].get_slice(name)
        shape = sl.get_shape()
        n = shape[dim] // parts
        idx = [slice(None)] * len(shape)
        idx[dim] = slice(index * n, (index + 1) * n)
        return sl[tuple(idx)]


class TorchPickleSource:
    """.pth / .bin checkpoints through torch.load (tensors only; a
    {"state_dict": {...}} wrapper is unwrapped, as the JAX reader's torch
    fallback does)."""

    def __init__(self, paths: list[str]):
        self._tensors: dict[str, torch.Tensor] = {}
        for p in paths:
            sd = torch.load(p, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and isinstance(sd.get("state_dict"),
                                                   dict):
                sd = sd["state_dict"]
            self._tensors.update({k: t for k, t in sd.items()
                                  if isinstance(t, torch.Tensor)})

    def keys(self) -> list[str]:
        return list(self._tensors)

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._tensors[name]


class Renamed:
    """A read-only view of a weight source under other names: `rename`
    maps a name the loader asks for to the one the checkpoint holds (names
    it does not map pass through)."""

    def __init__(self, src, rename):
        self.src, self.rename = src, rename

    def __contains__(self, name: str) -> bool:
        return self.rename(name) in self.src

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.src[self.rename(name)]

    def read_part(self, name: str, dim: int, index: int,
                  parts: int) -> torch.Tensor:
        """A tp rank's part of `name`, read alone where the source can."""
        return read_shard(self.src, self.rename(name), dim, index, parts)


def read_shard(src, name: str, dim: int, index: int,
               parts: int) -> torch.Tensor:
    """Part `index` of `parts` equal parts of tensor `name` along `dim`: a
    tensor-parallel rank's slice, read alone where the source can
    (safetensors), else cut from the whole tensor."""
    read_part = getattr(src, "read_part", None)
    if read_part is not None:
        return read_part(name, dim, index, parts)
    t = src[name]
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).contiguous()


def shard_getters(src, device, dtype, mesh=None):
    """(get, lin) over checkpoint `src`, each tensor on `device` in `dtype`.
    get(name, dim=None, chunks=1): the tensor, or under a tp `mesh` this
    rank's slice along `dim` (`read_shard`; dim None: whole); `chunks` > 1
    reads a fused tensor of that many equal blocks along `dim` as the
    rank's part of each block, side by side (GLM-OCR's [gate | up]).
    lin(name, dim=None, chunks=1): HF's `name.weight` (out, in) as the
    port's (in, out), with its bias where the checkpoint has one; dim 0
    splits the output columns (the bias with them), dim 1 the input rows
    (the bias whole: it is added once after the ranks' reduce)."""
    def get(name: str, dim: int | None = None,
            chunks: int = 1) -> torch.Tensor:
        if mesh is None or dim is None:
            t = src[name]
        else:
            parts = [read_shard(src, name, dim, c * mesh.tp + mesh.tp_rank,
                                chunks * mesh.tp) for c in range(chunks)]
            t = parts[0] if chunks == 1 else torch.cat(parts, dim)
        return t.to(device=device, dtype=dtype)

    def lin(name: str, dim: int | None = None, chunks: int = 1) -> dict:
        p = {"w": get(name + ".weight", dim, chunks).t().contiguous()}
        if name + ".bias" in src:
            p["b"] = get(name + ".bias", 0 if dim == 0 else None, chunks)
        return p

    return get, lin


def take_linear(src, name: str, device, dtype) -> dict:
    """HF's `name.weight` (out, in) as the port's (in, out), with its bias
    where the checkpoint has one."""
    p = {"w": src[name + ".weight"].to(device=device, dtype=dtype)
         .t().contiguous()}
    if name + ".bias" in src:
        p["b"] = src[name + ".bias"].to(device=device, dtype=dtype)
    return p


def take_norm(src, name: str, device, dtype) -> dict:
    """A norm's weight, and its bias where the checkpoint has one."""
    p = {"w": src[name + ".weight"].to(device=device, dtype=dtype)}
    if name + ".bias" in src:
        p["b"] = src[name + ".bias"].to(device=device, dtype=dtype)
    return p


def open_weights(path: str) -> SafetensorsSource | TorchPickleSource:
    if os.path.isfile(path):
        if path.endswith(".safetensors"):
            return SafetensorsSource([path])
        return TorchPickleSource([path])
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            shards = sorted({os.path.join(path, v)
                             for v in json.load(f)["weight_map"].values()})
        return SafetensorsSource(shards)
    st = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st:
        return SafetensorsSource(st)
    pth = sorted(glob.glob(os.path.join(path, "*.pth"))
                 + glob.glob(os.path.join(path, "*.bin")))
    if pth:
        return TorchPickleSource(pth)
    raise FileNotFoundError(f"no safetensors/pth/bin weights under {path}")


def _hf_linear(out: dict, name: str, p: dict) -> None:
    """A (in, out) linear as HF's `name.weight` (out, in) and its bias."""
    out[name + ".weight"] = p["w"].t().contiguous().cpu()
    if "b" in p:
        out[name + ".bias"] = p["b"].cpu()


def _hf_decoder(params: dict, prefix: str = "model.") -> dict:
    """HF names of a stacked decoder tree (Qwen3's or LlamaModel's; the
    inverse of their load_params): norms, q/k/v/o with any biases and
    qk-norms, the MLP, the embedding, and lm_head unless tied."""
    lay = params["layers"]
    out = {prefix + "embed_tokens.weight":
           params["embed"]["w"].contiguous().cpu(),
           prefix + "norm.weight": params["norm"]["w"].cpu()}
    if params["lm_head"]["w"] is not params["embed"]["w"]:
        out["lm_head.weight"] = params["lm_head"]["w"].contiguous().cpu()
    for i in range(lay["ln1"]["w"].shape[0]):
        p = f"{prefix}layers.{i}."
        out[p + "input_layernorm.weight"] = lay["ln1"]["w"][i].cpu()
        out[p + "post_attention_layernorm.weight"] = lay["ln2"]["w"][i].cpu()
        for name in "qkvo":
            _hf_linear(out, f"{p}self_attn.{name}_proj",
                       {k: t[i] for k, t in lay[name].items()})
        for name in ("q_norm", "k_norm"):
            if name in lay:
                out[f"{p}self_attn.{name}.weight"] = lay[name]["w"][i].cpu()
        for name in ("gate", "up", "down"):
            _hf_linear(out, f"{p}mlp.{name}_proj",
                       {k: t[i] for k, t in lay["mlp"][name].items()})
    return out


def _save(tensors: dict, path: str) -> None:
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in tensors.items()},
              os.path.join(path, "model.safetensors"))


def save_hf_qwen3(params: dict, path: str) -> None:
    """Write the port's Qwen3 parameters, or LlamaModel's (a MiniCPM
    checkpoint's names), as an HF-named safetensors file (the inverse of
    their load_params): a checkpoint made from seeded weights for serving
    without a download."""
    _save(_hf_decoder(params), path)


def save_hf_bert(params: dict, path: str) -> None:
    """Write the port's BertModel parameters with HF BertModel's names
    (the inverse of BertModel.load_params)."""
    e = params["embeddings"]
    out = {f"embeddings.{n}_embeddings.weight": e[n]["w"].contiguous().cpu()
           for n in ("word", "position", "token_type")}

    def norm(name: str, p: dict) -> None:
        out[name + ".weight"], out[name + ".bias"] = p["w"].cpu(), \
            p["b"].cpu()

    norm("embeddings.LayerNorm", e["ln"])
    for i, lp in enumerate(params["layers"]):
        p = f"encoder.layer.{i}."
        for name, key in (("attention.self.query", "q"),
                          ("attention.self.key", "k"),
                          ("attention.self.value", "v"),
                          ("attention.output.dense", "attn_out"),
                          ("intermediate.dense", "ffn_in"),
                          ("output.dense", "ffn_out")):
            _hf_linear(out, p + name, lp[key])
        norm(p + "attention.output.LayerNorm", lp["attn_ln"])
        norm(p + "output.LayerNorm", lp["ffn_ln"])
    _save(out, path)


def save_hf_qwen2_5vl(params: dict, path: str) -> None:
    """Write the port's Qwen2.5-VL parameters (unfused) with the HF names
    of an original Qwen2_5_VLForConditionalGeneration checkpoint
    (visual. / model.; the inverse of Qwen2_5VLModel.load_params)."""
    vp = params["visual"]
    pe = vp["patch_embed"]["w"]                     # (in_dim, d)
    # HF keeps the conv3d weight (d, C, tp, p, p); the loader flattens it
    out = {"visual.patch_embed.proj.weight": pe.t().contiguous().cpu(),
           "visual.merger.ln_q.weight": vp["merger"]["ln_q"]["w"].cpu()}
    _hf_linear(out, "visual.merger.mlp.0", vp["merger"]["mlp0"])
    _hf_linear(out, "visual.merger.mlp.2", vp["merger"]["mlp2"])
    for i, blk in enumerate(vp["blocks"]):
        p = f"visual.blocks.{i}."
        out[p + "norm1.weight"] = blk["norm1"]["w"].cpu()
        out[p + "norm2.weight"] = blk["norm2"]["w"].cpu()
        _hf_linear(out, p + "attn.qkv", blk["qkv"])
        _hf_linear(out, p + "attn.proj", blk["proj"])
        for name in ("gate", "up", "down"):
            _hf_linear(out, f"{p}mlp.{name}_proj", blk["mlp"][name])
    out.update(_hf_decoder(params["text"]))
    _save(out, path)


def _hf_qwen3vl_tower(vp: dict, vt: str) -> dict:
    """HF names of the Qwen3-VL tower under `vt` (the inverse of
    Qwen3VLVisionTower.load_params): the patch embedding flat (d, in_dim)
    as save_hf_qwen2_5vl writes it (the loader reshapes HF's conv3d
    weight to that), LayerNorms with biases, the mergers' linear_fc1 /
    linear_fc2."""
    pe = vp["patch_embed"]["w"]                     # (in_dim, d)
    out = {vt + "patch_embed.proj.weight": pe.t().contiguous().cpu(),
           vt + "patch_embed.proj.bias": vp["patch_embed"]["b"].cpu(),
           vt + "pos_embed.weight": vp["pos_embed"]["w"].contiguous().cpu()}

    def norm(name: str, p: dict) -> None:
        out[name + ".weight"] = p["w"].cpu()
        if "b" in p:
            out[name + ".bias"] = p["b"].cpu()

    def merger(prefix: str, mp: dict) -> None:
        norm(prefix + "norm", mp["norm"])
        _hf_linear(out, prefix + "linear_fc1", mp["fc1"])
        _hf_linear(out, prefix + "linear_fc2", mp["fc2"])

    merger(vt + "merger.", vp["merger"])
    for i, mp in enumerate(vp["ds_mergers"]):
        merger(f"{vt}deepstack_merger_list.{i}.", mp)
    for i, blk in enumerate(vp["blocks"]):
        p = f"{vt}blocks.{i}."
        norm(p + "norm1", blk["norm1"])
        norm(p + "norm2", blk["norm2"])
        _hf_linear(out, p + "attn.qkv", blk["qkv"])
        _hf_linear(out, p + "attn.proj", blk["proj"])
        _hf_linear(out, p + "mlp.linear_fc1", blk["fc1"])
        _hf_linear(out, p + "mlp.linear_fc2", blk["fc2"])
    return out


def save_hf_qwen3vl(params: dict, path: str) -> None:
    """Write the port's (unfused) Qwen3-VL parameters with the names of a
    published Qwen3VLForConditionalGeneration checkpoint (model.visual. /
    model.language_model., lm_head unless tied; the inverse of
    Qwen3VLModel.load_params)."""
    out = _hf_qwen3vl_tower(params["visual"], "model.visual.")
    out.update(_hf_decoder(params["text"], prefix="model.language_model."))
    _save(out, path)


def _hf_head(out: dict, params: dict, prefix: str = "model.") -> None:
    """The embedding, and lm_head unless it is the embedding itself."""
    out[prefix + "embed_tokens.weight"] = \
        params["embed"]["w"].contiguous().cpu()
    if params["lm_head"]["w"] is not params["embed"]["w"]:
        out["lm_head.weight"] = params["lm_head"]["w"].contiguous().cpu()


def _hf_conv(w: torch.Tensor) -> torch.Tensor:
    """Conv taps (L, D) → torch's depthwise Conv1d weight (D, 1, L)."""
    return w.t().contiguous()[:, None, :].cpu()


def _hf_lfm2(params: dict, prefix: str = "model.") -> dict:
    """HF LFM2 names of an Lfm2Model tree's decoder under `prefix` (the
    inverse of Lfm2Model.load_params); lm_head unless tied."""
    out = {prefix + "embedding_norm.weight":
           params["embedding_norm"]["w"].cpu()}
    _hf_head(out, params, prefix)
    for i, lp in enumerate(params["layers"]):
        p = f"{prefix}layers.{i}."
        out[p + "operator_norm.weight"] = lp["operator_norm"]["w"].cpu()
        out[p + "ffn_norm.weight"] = lp["ffn_norm"]["w"].cpu()
        for name, key in (("w1", "gate"), ("w3", "up"), ("w2", "down")):
            _hf_linear(out, f"{p}feed_forward.{name}", lp["mlp"][key])
        if "q" in lp:
            for name, key in (("q_proj", "q"), ("k_proj", "k"),
                              ("v_proj", "v"), ("out_proj", "o")):
                _hf_linear(out, f"{p}self_attn.{name}", lp[key])
            out[p + "self_attn.q_layernorm.weight"] = lp["q_norm"]["w"].cpu()
            out[p + "self_attn.k_layernorm.weight"] = lp["k_norm"]["w"].cpu()
        else:
            out[p + "conv.conv.weight"] = _hf_conv(lp["conv"]["w"])
            if "b" in lp["conv"]:
                out[p + "conv.conv.bias"] = lp["conv"]["b"].cpu()
            _hf_linear(out, p + "conv.in_proj", lp["in_proj"])
            _hf_linear(out, p + "conv.out_proj", lp["out_proj"])
    return out


def save_hf_lfm2(params: dict, path: str) -> None:
    """Write the port's (unfused) Lfm2Model parameters with HF LFM2 names
    (the inverse of Lfm2Model.load_params)."""
    _save(_hf_lfm2(params), path)


def _hf_norm(out: dict, name: str, p: dict) -> None:
    """A norm's weight, and its bias where it has one."""
    out[name + ".weight"] = p["w"].cpu()
    if "b" in p:
        out[name + ".bias"] = p["b"].cpu()


def _hf_siglip_layers(out: dict, prefix: str, layers: list) -> None:
    """SigLIP encoder blocks under `prefix` (the inverse of
    models/siglip.block_params)."""
    for i, lp in enumerate(layers):
        for key, name in siglip.BLOCK_NORMS:
            _hf_norm(out, f"{prefix}{i}.{name}", lp[key])
        for key, name in siglip.BLOCK_LINEARS:
            _hf_linear(out, f"{prefix}{i}.{name}", lp[key])


def save_hf_paddleocr_vl(params: dict, path: str) -> None:
    """Write the port's (unfused) PaddleOCR-VL parameters with the names
    of a published checkpoint (the inverse of PaddleOCRVLModel.load_params):
    the tower under visual.vision_model. with its patch embedding as the
    (d, 3, p, p) conv weight, the projector under mlp_AR., the ERNIE
    decoder under model. (biases where it has them)."""
    vp = params["visual"]
    vm = "visual.vision_model."
    pe = vp["patch_embed"]["w"]                     # (3·p·p, d)
    p = int(round((pe.shape[0] // 3) ** 0.5))
    out = {vm + "embeddings.patch_embedding.weight":
           pe.t().reshape(pe.shape[1], 3, p, p).contiguous().cpu(),
           vm + "embeddings.patch_embedding.bias":
           vp["patch_embed"]["b"].cpu(),
           vm + "embeddings.position_embedding.weight":
           vp["pos_embed"]["w"].contiguous().cpu()}
    _hf_norm(out, vm + "post_layernorm", vp["post_ln"])
    _hf_norm(out, "mlp_AR.pre_norm", vp["proj"]["pre_norm"])
    _hf_linear(out, "mlp_AR.linear_1", vp["proj"]["fc1"])
    _hf_linear(out, "mlp_AR.linear_2", vp["proj"]["fc2"])
    _hf_siglip_layers(out, vm + "encoder.layers.", vp["layers"])
    out.update(_hf_decoder(params["text"]))
    _save(out, path)


def save_hf_lfm2vl(params: dict, path: str) -> None:
    """Write the port's (unfused) LFM2-VL parameters with the names of an
    Lfm2VlForConditionalGeneration checkpoint (the inverse of
    Lfm2VLModel.load_params): the decoder under model.language_model.,
    the tower under model.vision_tower.vision_model., the projector under
    model.multi_modal_projector."""
    out = _hf_lfm2(params, "model.language_model.")
    vp = params["visual"]
    vt = "model.vision_tower.vision_model."
    _hf_linear(out, vt + "embeddings.patch_embedding",
               vp["patch_embedding"])
    out[vt + "embeddings.position_embedding.weight"] = \
        vp["pos_table"].contiguous().cpu()
    _hf_norm(out, vt + "post_layernorm", vp["post_ln"])
    _hf_siglip_layers(out, vt + "encoder.layers.", vp["layers"])
    mp = "model.multi_modal_projector."
    pj = params["projector"]
    if "ln" in pj:
        _hf_norm(out, mp + "layer_norm", pj["ln"])
    _hf_linear(out, mp + "linear_1", pj["l1"])
    _hf_linear(out, mp + "linear_2", pj["l2"])
    _save(out, path)


def save_hf_qwen3_5(params: dict, path: str,
                    prefix: str = "model.") -> None:
    """Write the port's (unfused) Qwen3_5Model parameters with HF Qwen3.5
    names under `prefix` ("model.language_model." for a VL checkpoint's
    decoder): the zero-centred norms unfolded to w − 1 (the inverse of
    Qwen3_5Model.load_params); a tree with a "visual" tower writes it
    under model.visual."""
    def centred(name: str, p: dict) -> None:
        out[name + ".weight"] = (p["w"] - 1.0).cpu()

    out = {}
    _hf_head(out, params, prefix)
    centred(prefix + "norm", params["norm"])
    for i, lp in enumerate(params["layers"]):
        p = f"{prefix}layers.{i}."
        centred(p + "input_layernorm", lp["ln1"])
        centred(p + "post_attention_layernorm", lp["ln2"])
        for name in ("gate", "up", "down"):
            _hf_linear(out, f"{p}mlp.{name}_proj", lp["mlp"][name])
        if "q" in lp:
            for name in "qkvo":
                _hf_linear(out, f"{p}self_attn.{name}_proj", lp[name])
            centred(p + "self_attn.q_norm", lp["q_norm"])
            centred(p + "self_attn.k_norm", lp["k_norm"])
        else:
            la = p + "linear_attn."
            for name in ("in_proj_qkv", "in_proj_z", "in_proj_b",
                         "in_proj_a", "out_proj"):
                _hf_linear(out, la + name, lp[name])
            out[la + "conv1d.weight"] = _hf_conv(lp["conv"]["w"])
            out[la + "dt_bias"] = lp["dt_bias"].cpu()
            out[la + "A_log"] = lp["a_log"].cpu()
            out[la + "norm.weight"] = lp["norm"]["w"].cpu()
    if "visual" in params:
        out.update(_hf_qwen3vl_tower(params["visual"], "model.visual."))
    _save(out, path)


def save_hf_deepseek_ocr(params: dict, path: str) -> None:
    """Write the port's DeepSeek-OCR (version 1) parameters with the names
    of a published checkpoint (the inverse of DeepseekOCRModel.load_params):
    SAM under model.sam_model., CLIP under model.vision_model. (its
    stacked layers one by one), the projector, image_newline and
    view_seperator, the decoder's dense and MoE layers (each routed expert
    on its own, the router under mlp.gate), the embedding, norm and
    lm_head."""
    out = {}

    def conv(name: str, p: dict) -> None:
        out[name + ".weight"] = p["w"].contiguous().cpu()
        if "b" in p:
            out[name + ".bias"] = p["b"].cpu()

    sm = "model.sam_model."
    sam = params["sam"]
    conv(sm + "patch_embed.proj", sam["patch"])
    out[sm + "pos_embed"] = sam["pos"].contiguous().cpu()
    for i, bp in enumerate(sam["blocks"]):
        b = f"{sm}blocks.{i}."
        _hf_norm(out, b + "norm1", bp["norm1"])
        _hf_norm(out, b + "norm2", bp["norm2"])
        _hf_linear(out, b + "attn.qkv", bp["attn"]["qkv"])
        _hf_linear(out, b + "attn.proj", bp["attn"]["proj"])
        for t in ("rel_pos_h", "rel_pos_w"):
            out[b + "attn." + t] = bp["attn"][t].contiguous().cpu()
        _hf_linear(out, b + "mlp.lin1", bp["lin1"])
        _hf_linear(out, b + "mlp.lin2", bp["lin2"])
    for j in range(4):
        conv(f"{sm}neck.{j}", sam[f"neck{j}"])
    conv(sm + "net_2", sam["net2"])
    conv(sm + "net_3", sam["net3"])
    cl = "model.vision_model."
    clip = params["clip"]
    out[cl + "embeddings.class_embedding"] = clip["cls"].cpu()
    out[cl + "embeddings.patch_embedding.weight"] = \
        clip["patch"]["w"].contiguous().cpu()
    out[cl + "embeddings.position_embedding.weight"] = \
        clip["pos"].contiguous().cpu()
    _hf_norm(out, cl + "pre_layrnorm", clip["pre_ln"])
    lay = clip["layers"]
    for i in range(lay["qkv"]["w"].shape[0]):
        b = f"{cl}transformer.layers.{i}."
        for key, name in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            _hf_norm(out, b + name, {k: t[i] for k, t in lay[key].items()})
        for key, name in (("qkv", "self_attn.qkv_proj"),
                          ("out", "self_attn.out_proj"), ("fc1", "mlp.fc1"),
                          ("fc2", "mlp.fc2")):
            _hf_linear(out, b + name, {k: t[i] for k, t in lay[key].items()})
    _hf_linear(out, "model.projector.layers", params["projector"])
    out["model.image_newline"] = params["image_newline"].cpu()
    out["model.view_seperator"] = params["view_seperator"].cpu()
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        _hf_norm(out, p + "input_layernorm", lp["ln1"])
        _hf_norm(out, p + "post_attention_layernorm", lp["ln2"])
        for name in "qkvo":
            _hf_linear(out, f"{p}self_attn.{name}_proj", lp[name])
        if "moe" in lp:
            moe = lp["moe"]
            out[p + "mlp.gate.weight"] = moe["gate"]["w"].t().contiguous().cpu()
            for name in ("gate", "up", "down"):
                w = moe["experts"][name]["w"]
                for e in range(w.shape[0]):
                    _hf_linear(out, f"{p}mlp.experts.{e}.{name}_proj",
                               {"w": w[e]})
                _hf_linear(out, f"{p}mlp.shared_experts.{name}_proj",
                           moe["shared"][name])
        else:
            for name in ("gate", "up", "down"):
                _hf_linear(out, f"{p}mlp.{name}_proj", lp["mlp"][name])
    out["model.embed_tokens.weight"] = params["embed"]["w"].contiguous().cpu()
    out["model.norm.weight"] = params["norm"]["w"].cpu()
    out["lm_head.weight"] = params["lm_head"]["w"].contiguous().cpu()
    _save(out, path)


def save_hf_qwen3_asr(params: dict, path: str) -> None:
    """Write the port's (unfused) Qwen3-ASR parameters with the names of a
    published checkpoint (the inverse of Qwen3ASRModel.load_params): the
    encoder under thinker.audio_tower. (convs OIHW), the decoder under
    thinker.model., thinker.lm_head unless tied."""
    at = "thinker.audio_tower."
    ap = params["audio"]
    out = {}
    for i, lp in enumerate(ap["layers"]):
        p = f"{at}layers.{i}."
        _hf_norm(out, p + "self_attn_layer_norm", lp["ln1"])
        _hf_norm(out, p + "final_layer_norm", lp["ln2"])
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("o", "out_proj")):
            _hf_linear(out, f"{p}self_attn.{name}", lp[key])
        _hf_linear(out, p + "fc1", lp["fc1"])
        _hf_linear(out, p + "fc2", lp["fc2"])
    for i in (1, 2, 3):
        out[f"{at}conv2d{i}.weight"] = ap[f"conv{i}"]["w"].contiguous().cpu()
        out[f"{at}conv2d{i}.bias"] = ap[f"conv{i}"]["b"].cpu()
    _hf_norm(out, at + "ln_post", ap["ln_post"])
    for name in ("conv_out", "proj1", "proj2"):
        _hf_linear(out, at + name, ap[name])
    dec = _hf_decoder(params["text"], prefix="thinker.model.")
    if "lm_head.weight" in dec:
        dec["thinker.lm_head.weight"] = dec.pop("lm_head.weight")
    out.update(dec)
    _save(out, path)


def save_hf_fun_asr_nano(params: dict, path: str) -> None:
    """Write the port's (unfused) Fun-ASR-Nano parameters with the names of
    a published checkpoint (the inverse of FunAsrNanoModel.load_params):
    the SANM encoder under audio_encoder. (each FSMN weight torch's
    depthwise (D, 1, K)), the adaptor under audio_adaptor., the LLM under
    llm.model., llm.lm_head unless tied."""
    ap = params["audio"]
    out = {}

    def sanm(p: str, lp: dict) -> None:
        _hf_norm(out, p + "norm1", lp["ln1"])
        _hf_norm(out, p + "norm2", lp["ln2"])
        _hf_linear(out, p + "self_attn.linear_q_k_v", lp["qkv"])
        _hf_linear(out, p + "self_attn.linear_out", lp["out"])
        out[p + "self_attn.fsmn_block.weight"] = \
            lp["fsmn"]["w"].contiguous().cpu()
        _hf_linear(out, p + "feed_forward.w_1", lp["fc1"])
        _hf_linear(out, p + "feed_forward.w_2", lp["fc2"])

    enc = "audio_encoder."
    sanm(enc + "encoders0.0.", ap["encoders0"])
    for i, lp in enumerate(ap["encoders"]):
        sanm(f"{enc}encoders.{i}.", lp)
    for i, lp in enumerate(ap["tp_encoders"]):
        sanm(f"{enc}tp_encoders.{i}.", lp)
    _hf_norm(out, enc + "after_norm", ap["after_norm"])
    _hf_norm(out, enc + "tp_norm", ap["tp_norm"])
    _hf_linear(out, "audio_adaptor.linear1", ap["ada1"])
    _hf_linear(out, "audio_adaptor.linear2", ap["ada2"])
    for i, lp in enumerate(ap["ada_blocks"]):
        p = f"audio_adaptor.blocks.{i}."
        _hf_norm(out, p + "norm1", lp["ln1"])
        _hf_norm(out, p + "norm2", lp["ln2"])
        for key, name in (("q", "self_attn.linear_q"),
                          ("k", "self_attn.linear_k"),
                          ("v", "self_attn.linear_v"),
                          ("out", "self_attn.linear_out"),
                          ("fc1", "feed_forward.w_1"),
                          ("fc2", "feed_forward.w_2")):
            _hf_linear(out, p + name, lp[key])
    dec = _hf_decoder(params["text"], prefix="llm.model.")
    if "lm_head.weight" in dec:
        dec["llm.lm_head.weight"] = dec.pop("lm_head.weight")
    out.update(dec)
    _save(out, path)


def _hf_vox_lm(out: dict, prefix: str, lp: dict) -> None:
    """A VoxMiniCPM tree (per-layer list) under its checkpoint names."""
    for i, layer in enumerate(lp["layers"]):
        p = f"{prefix}layers.{i}."
        _hf_norm(out, p + "input_layernorm", layer["ln1"])
        _hf_norm(out, p + "post_attention_layernorm", layer["ln2"])
        for name in "qkvo":
            _hf_linear(out, f"{p}self_attn.{name}_proj", layer[name])
        for name in ("gate", "up", "down"):
            _hf_linear(out, f"{p}mlp.{name}_proj", layer["mlp"][name])
    _hf_norm(out, prefix + "norm", lp["norm"])
    if "embed" in lp:
        out[prefix + "embed_tokens.weight"] = \
            lp["embed"]["w"].contiguous().cpu()


def _wn_split(out: dict, name: str, p: dict) -> None:
    """A conv as weight norm: v = w and g = ‖w‖ over all dims but 0 (folds
    back to w), and its bias."""
    w = p["w"].float().cpu()
    out[name + ".weight_v"] = w.contiguous()
    out[name + ".weight_g"] = w.square().sum(dim=(1, 2), keepdim=True).sqrt()
    if "b" in p:
        out[name + ".bias"] = p["b"].float().cpu()


def audio_vae_state_dict(vp: dict) -> dict:
    """The port's AudioVAE tree under the `.pth`'s weight-normed names (the
    inverse of AudioVAE.load_params)."""
    out = {}

    def unit(name, u):
        out[name + ".block.0.alpha"] = u["a0"].cpu()
        out[name + ".block.2.alpha"] = u["a2"].cpu()
        _wn_split(out, name + ".block.1",
                  {"w": u["w1"], **({"b": u["b1"]} if "b1" in u else {})})
        _wn_split(out, name + ".block.3",
                  {"w": u["w3"], **({"b": u["b3"]} if "b3" in u else {})})

    ep, dp = vp["encoder"], vp["decoder"]
    _wn_split(out, "encoder.block.0", ep["stem"])
    for i, bp in enumerate(ep["blocks"]):
        base = f"encoder.block.{i + 1}"
        for j, u in enumerate(bp["units"]):
            unit(f"{base}.block.{j}", u)
        out[f"{base}.block.3.alpha"] = bp["a"].cpu()
        _wn_split(out, f"{base}.block.4", bp["down"])
    _wn_split(out, "encoder.fc_mu", ep["fc_mu"])
    _wn_split(out, "decoder.model.0", dp["stem"])
    _wn_split(out, "decoder.model.1", dp["in"])
    for i, bp in enumerate(dp["blocks"]):
        base = f"decoder.model.{i + 2}"
        out[f"{base}.block.0.alpha"] = bp["a"].cpu()
        _wn_split(out, f"{base}.block.1", bp["up"])
        for j, u in enumerate(bp["units"]):
            unit(f"{base}.block.{j + 2}", u)
        if "sr_scale" in bp:
            sr = f"decoder.sr_cond_model.{i + 2}"
            out[sr + ".scale_embed.weight"] = bp["sr_scale"].cpu()
            out[sr + ".bias_embed.weight"] = bp["sr_bias"].cpu()
    n_up = len(dp["blocks"])
    out[f"decoder.model.{n_up + 2}.alpha"] = dp["a_out"].cpu()
    _wn_split(out, f"decoder.model.{n_up + 3}", dp["out"])
    return out


def save_hf_voxcpm(params: dict, vae_params: dict, config: dict,
                   path: str) -> None:
    """Write the port's VoxCPM and AudioVAE parameters as VoxCPM-0.5B's
    files (the inverse of VoxCPMServed.load): config.json, the model's
    pytorch_model.bin and the VAE's weight-normed audiovae.pth, each a
    {"state_dict": ...} pickle; the tokenizer.json is the caller's."""
    out = {}
    _hf_vox_lm(out, "base_lm.", params["base_lm"])
    _hf_vox_lm(out, "residual_lm.", params["residual_lm"])
    fe = params["feat_encoder"]
    out["feat_encoder.special_token"] = \
        fe["special_token"].reshape(1, 1, -1).contiguous().cpu()
    _hf_linear(out, "feat_encoder.in_proj", fe["in_proj"])
    _hf_vox_lm(out, "feat_encoder.encoder.", fe["encoder"])
    fd = params["feat_dit"]
    est = "feat_decoder.estimator."
    for name in ("in_proj", "cond_proj", "out_proj"):
        _hf_linear(out, est + name, fd[name])
    for name in ("time_mlp", "delta_time_mlp"):
        for sub in ("linear_1", "linear_2"):
            _hf_linear(out, f"{est}{name}.{sub}", fd[name][sub])
    _hf_vox_lm(out, est + "decoder.", fd["decoder"])
    for name in ("in_proj", "out_proj"):
        _hf_linear(out, f"fsq_layer.{name}", params["fsq_layer"][name])
    for name in ("enc_to_lm_proj", "lm_to_dit_proj", "res_to_dit_proj",
                 "stop_proj", "stop_head", "fusion_concat_proj"):
        if name in params:
            _hf_linear(out, name, params[name])
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    torch.save({"state_dict": out}, os.path.join(path, "pytorch_model.bin"))
    torch.save({"state_dict": audio_vae_state_dict(vae_params)},
               os.path.join(path, "audiovae.pth"))


def _hf_conv2d(out: dict, name: str, p: dict) -> None:
    out[name + ".weight"] = p["w"].contiguous().cpu()
    if "b" in p:
        out[name + ".bias"] = p["b"].cpu()


def _hf_bn(out: dict, name: str, p: dict) -> None:
    for key, hf in (("w", "weight"), ("b", "bias"), ("mean", "running_mean"),
                    ("var", "running_var")):
        out[f"{name}.{hf}"] = p[key].cpu()


def rmbg2_0_state_dict(params: dict) -> dict:
    """The port's BiRefNet tree under the checkpoint's names (the inverse
    of BiRefNet.load_params)."""
    out = {}
    bb = params["bb"]
    _hf_conv2d(out, "bb.patch_embed.proj", bb["patch"])
    _hf_norm(out, "bb.patch_embed.norm", bb["patch_norm"])
    for i, lp in enumerate(bb["layers"]):
        for j, bp in enumerate(lp["blocks"]):
            b = f"bb.layers.{i}.blocks.{j}."
            _hf_norm(out, b + "norm1", bp["norm1"])
            _hf_norm(out, b + "norm2", bp["norm2"])
            _hf_linear(out, b + "attn.qkv", bp["attn"]["qkv"])
            _hf_linear(out, b + "attn.proj", bp["attn"]["proj"])
            out[b + "attn.relative_position_bias_table"] = \
                bp["attn"]["rel_bias_table"].contiguous().cpu()
            _hf_linear(out, b + "mlp.fc1", bp["fc1"])
            _hf_linear(out, b + "mlp.fc2", bp["fc2"])
        if "downsample" in lp:
            _hf_norm(out, f"bb.layers.{i}.downsample.norm",
                     lp["downsample"]["norm"])
            _hf_linear(out, f"bb.layers.{i}.downsample.reduction",
                       lp["downsample"]["reduction"])
        _hf_norm(out, f"bb.norm{i}", bb["norms"][i])

    def aspp_mod(n, p):
        for key, hf in (("offset", "offset_conv"),
                        ("modulator", "modulator_conv"),
                        ("conv", "regular_conv")):
            _hf_conv2d(out, f"{n}.atrous_conv.{hf}", p[key])
        _hf_bn(out, n + ".bn", p["bn"])

    def dec_blk(n, p):
        _hf_conv2d(out, n + ".conv_in", p["conv_in"])
        _hf_bn(out, n + ".bn_in", p["bn_in"])
        a = p["dec_att"]
        aspp_mod(n + ".dec_att.aspp1", a["aspp1"])
        for i in range(3):
            aspp_mod(f"{n}.dec_att.aspp_deforms.{i}", a[f"deform{i}"])
        _hf_conv2d(out, n + ".dec_att.global_avg_pool.1", a["pool_conv"])
        _hf_bn(out, n + ".dec_att.global_avg_pool.2", a["pool_bn"])
        _hf_conv2d(out, n + ".dec_att.conv1", a["conv1"])
        _hf_bn(out, n + ".dec_att.bn1", a["bn1"])
        _hf_conv2d(out, n + ".conv_out", p["conv_out"])
        _hf_bn(out, n + ".bn_out", p["bn_out"])

    dec_blk("squeeze_module.0", params["squeeze"])
    d = params["decoder"]
    for i in (5, 4, 3, 2, 1):
        _hf_conv2d(out, f"decoder.ipt_blk{i}.conv1", d[f"ipt_blk{i}"]["conv1"])
        _hf_conv2d(out, f"decoder.ipt_blk{i}.conv_out",
                 d[f"ipt_blk{i}"]["conv_out"])
    for i in (4, 3, 2, 1):
        dec_blk(f"decoder.decoder_block{i}", d[f"block{i}"])
    _hf_conv2d(out, "decoder.conv_out1.0", d["conv_out1"])
    for i in (4, 3, 2):
        _hf_conv2d(out, f"decoder.lateral_block{i}.conv", d[f"lateral{i}"])
        _hf_conv2d(out, f"decoder.gdt_convs_{i}.0", d[f"gdt{i}"]["conv"])
        _hf_bn(out, f"decoder.gdt_convs_{i}.1", d[f"gdt{i}"]["bn"])
        _hf_conv2d(out, f"decoder.gdt_convs_attn_{i}.0", d[f"gdt{i}"]["attn"])
    return out


def save_hf_rmbg2_0(params: dict, swin, path: str) -> None:
    """Write the port's BiRefNet parameters as an RMBG-2.0 checkpoint:
    model.safetensors under the reference's names and a config.json with
    the Swin fields (`swin` a models/rmbg2_0.SwinConfig)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"patch_size": swin.patch_size,
                   "embed_dim": swin.embed_dim, "depths": list(swin.depths),
                   "num_heads": list(swin.num_heads),
                   "window_size": swin.window_size}, f)
    _save(rmbg2_0_state_dict(params), path)


#: the chat template written with a HunyuanOCR checkpoint made here: each
#: message's parts in turn, an image part as the image marker the
#: processor expands, a text part as its text
HUNYUAN_CHAT_TEMPLATE = (
    "{%- for message in messages -%}"
    "{%- if message.content is string -%}{{ message.content }}"
    "{%- else -%}{%- for part in message.content -%}"
    "{%- if part.type == 'text' -%}{{ part.text }}"
    "{%- elif part.type in ('image_url', 'image') -%}"
    "<｜hy_place▁holder▁no▁102｜>{%- endif -%}"
    "{%- endfor -%}{%- endif -%}"
    "{%- endfor -%}")


def _write_side_files(path: str, config: dict, tokenizer,
                      generation: dict | None, preprocessor: dict | None,
                      chat_template: str | None = None) -> None:
    """config.json, generation_config.json, preprocessor_config.json, the
    tokenizer (a `tokenizers.Tokenizer`) as tokenizer.json and, where
    given, a chat template in tokenizer_config.json."""
    os.makedirs(path, exist_ok=True)
    files = {"config.json": config,
             "generation_config.json": generation or {},
             "preprocessor_config.json": preprocessor or {}}
    if chat_template is not None:
        files["tokenizer_config.json"] = {"chat_template": chat_template}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    tokenizer.save(os.path.join(path, "tokenizer.json"))


def hunyuan_ocr_config_json(cfg) -> dict:
    """A models/hunyuan_ocr.HunyuanOCRConfig as the checkpoint's
    config.json: the decoder's fields top-level, rope_scaling's alpha and
    xdrope_section, vision_config."""
    d = dataclasses.asdict(cfg)
    vision = d.pop("vision")
    alpha, section = d.pop("rope_alpha"), d.pop("xdrope_section")
    return {**d, "rope_scaling": {"alpha": alpha,
                                  "xdrope_section": list(section)},
            "vision_config": vision}


def save_hf_hunyuan_ocr(params: dict, cfg, tokenizer, path: str,
                        generation: dict | None = None,
                        preprocessor: dict | None = None) -> None:
    """Write the port's HunyuanOCR parameters as a checkpoint under the
    reference's names (the inverse of HunyuanOCRModel.load_params: the
    tower under vit. with its patch conv (d, 3, p, p) and a zero CLS row
    before the position table, the decoder under model., the head tied)
    with config.json (`cfg` a HunyuanOCRConfig), generation_config.json,
    preprocessor_config.json, the tokenizer and HUNYUAN_CHAT_TEMPLATE."""
    vp = params["visual"]
    out = {}
    pe = vp["patch"]["w"]                          # (3·p·p, d)
    p = int(round((pe.shape[0] // 3) ** 0.5))
    out["vit.embeddings.patch_embedding.weight"] = \
        pe.t().reshape(pe.shape[1], 3, p, p).contiguous().cpu()
    out["vit.embeddings.patch_embedding.bias"] = vp["patch"]["b"].cpu()
    table = vp["pos_embed"]
    out["vit.embeddings.position_embedding.weight"] = torch.cat(
        [torch.zeros_like(table[:1]), table]).contiguous().cpu()
    blocks = vp["blocks"]
    for i in range(blocks["q"]["w"].shape[0]):
        b = f"vit.layers.{i}."
        at = tree_at(blocks, i)
        _hf_norm(out, b + "input_layernorm", at["ln1"])
        _hf_norm(out, b + "post_attention_layernorm", at["ln2"])
        for name in "qkvo":
            _hf_linear(out, f"{b}self_attn.{name}_proj", at[name])
        _hf_linear(out, b + "mlp.dense_h_to_4h", at["fc1"])
        _hf_linear(out, b + "mlp.dense_4h_to_h", at["fc2"])
    pc, pp = "vit.perceive.", vp["perceive"]
    _hf_norm(out, pc + "before_rms", pp["before_rms"])
    _hf_norm(out, pc + "after_rms", pp["after_rms"])
    out[pc + "proj.0.weight"] = pp["proj0"]["w"].contiguous().cpu()
    out[pc + "proj.0.bias"] = pp["proj0"]["b"].cpu()
    w2 = pp["proj2"]["w"]                          # (2D, 4D)
    out[pc + "proj.2.weight"] = w2.t().reshape(
        w2.shape[1], w2.shape[0], 1, 1).contiguous().cpu()
    out[pc + "proj.2.bias"] = pp["proj2"]["b"].cpu()
    _hf_linear(out, pc + "mlp", pp["mlp"])
    for name in ("image_newline", "image_begin", "image_end"):
        out[pc + name] = pp[name].cpu()
    for i, lp in enumerate(params["layers"]):
        b = f"model.layers.{i}."
        _hf_norm(out, b + "input_layernorm", lp["ln1"])
        _hf_norm(out, b + "post_attention_layernorm", lp["ln2"])
        for name in "qkvo":
            _hf_linear(out, f"{b}self_attn.{name}_proj", lp[name])
        _hf_norm(out, b + "self_attn.query_layernorm", lp["q_norm"])
        _hf_norm(out, b + "self_attn.key_layernorm", lp["k_norm"])
        for name in ("gate", "up", "down"):
            _hf_linear(out, f"{b}mlp.{name}_proj", lp["mlp"][name])
    out["model.embed_tokens.weight"] = params["embed"]["w"].contiguous().cpu()
    _hf_norm(out, "model.norm", params["norm"])
    _write_side_files(path, hunyuan_ocr_config_json(cfg), tokenizer,
                      generation, preprocessor, HUNYUAN_CHAT_TEMPLATE)
    _save(out, path)


def glm_ocr_config_json(cfg) -> dict:
    """A models/glm_ocr.GlmOcrConfig as the checkpoint's config.json:
    vision_config, text_config with its rope under rope_parameters, the
    image token ids."""
    text = dataclasses.asdict(cfg.text)
    rope = {"rope_type": "default",
            "mrope_section": list(text.pop("mrope_section")),
            "partial_rotary_factor": text.pop("partial_rotary_factor"),
            "rope_theta": text.pop("rope_theta")}
    if text["head_dim"] is None:
        text.pop("head_dim")
    return {"model_type": "glm_ocr",
            "vision_config": dataclasses.asdict(cfg.vision),
            "text_config": {**text, "rope_parameters": rope},
            "image_token_id": cfg.image_token_id,
            "image_start_token_id": cfg.image_start_token_id,
            "image_end_token_id": cfg.image_end_token_id}


def save_hf_glm_ocr(params: dict, cfg, tokenizer, path: str,
                    generation: dict | None = None,
                    preprocessor: dict | None = None) -> None:
    """Write the port's GLM-OCR parameters as a checkpoint under the
    reference's names (the inverse of GlmOcrModel.load_params: the tower
    under model.visual. with its patch conv (d, 3, tp, p, p), the decoder
    under model.language_model., lm_head unless tied) with config.json
    (`cfg` a GlmOcrConfig), generation_config.json,
    preprocessor_config.json and the tokenizer (the prompt frame is
    fixed: no chat template)."""
    v = cfg.vision
    vp, tp = params["visual"], params["text"]
    vs, ts = "model.visual.", "model.language_model."
    out = {}
    pw = vp["patch"]["w"]                          # (3·tp·p·p, d)
    out[vs + "patch_embed.proj.weight"] = pw.t().reshape(
        pw.shape[1], v.in_channels, v.temporal_patch_size, v.patch_size,
        v.patch_size).contiguous().cpu()
    if "b" in vp["patch"]:
        out[vs + "patch_embed.proj.bias"] = vp["patch"]["b"].cpu()
    _hf_norm(out, vs + "post_conv_layernorm", vp["post_conv_norm"])
    out[vs + "embeddings.position_embedding.weight"] = \
        vp["pos_embed"].contiguous().cpu()
    blocks = vp["blocks"]
    for i in range(blocks["qkv"]["w"].shape[0]):
        b, at = f"{vs}blocks.{i}.", tree_at(blocks, i)
        _hf_norm(out, b + "norm1", at["norm1"])
        _hf_norm(out, b + "norm2", at["norm2"])
        _hf_linear(out, b + "attn.qkv", at["qkv"])
        _hf_linear(out, b + "attn.proj", at["proj"])
        for name in ("gate", "up", "down"):
            _hf_linear(out, f"{b}mlp.{name}_proj", at["mlp"][name])
    _hf_norm(out, vs + "post_layernorm", vp["post_norm"])
    out[vs + "downsample.weight"] = vp["downsample"]["w"].contiguous().cpu()
    out[vs + "downsample.bias"] = vp["downsample"]["b"].cpu()
    mg = vp["merger"]
    _hf_linear(out, vs + "merger.proj", mg["proj"])
    _hf_norm(out, vs + "merger.post_projection_norm", mg["post_norm"])
    for name in ("gate", "up", "down"):
        _hf_linear(out, f"{vs}merger.{name}_proj", mg[name])
    lay = tp["layers"]
    for i in range(lay["q"]["w"].shape[0]):
        b, at = f"{ts}layers.{i}.", tree_at(lay, i)
        for key, name in (("ln_in", "input_layernorm"),
                          ("ln_mid", "post_attention_layernorm"),
                          ("ln_post_attn", "post_self_attn_layernorm"),
                          ("ln_post_mlp", "post_mlp_layernorm")):
            _hf_norm(out, b + name, at[key])
        for key, name in (*((n, f"self_attn.{n}_proj") for n in "qkvo"),
                          ("gate_up", "mlp.gate_up_proj"),
                          ("down", "mlp.down_proj")):
            _hf_linear(out, b + name, at[key])
    out[ts + "embed_tokens.weight"] = tp["embed"]["w"].contiguous().cpu()
    _hf_norm(out, ts + "norm", tp["norm"])
    if tp["lm_head"]["w"] is not tp["embed"]["w"]:
        out["lm_head.weight"] = tp["lm_head"]["w"].contiguous().cpu()
    _write_side_files(path, glm_ocr_config_json(cfg), tokenizer, generation,
                      preprocessor)
    _save(out, path)
