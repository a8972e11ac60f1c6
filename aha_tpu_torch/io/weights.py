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

import glob
import json
import os

import torch

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
