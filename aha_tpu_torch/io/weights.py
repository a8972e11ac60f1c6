"""safetensors checkpoints → torch tensors (counterpart of
aha_tpu/io/weights.py, safetensors only).

`open_weights(path)` resolves a model directory the way the JAX package
does (sharded index → *.safetensors) and returns a read-only mapping from
checkpoint tensor name to a CPU tensor; model loaders move each tensor to
the device and dtype they need (models/qwen2_5vl.py takes both HF prefix
sets of a Qwen2_5_VLForConditionalGeneration checkpoint).  The save_hf_*
writers are the loaders' inverses, for checkpoints made from seeded
weights.
"""

from __future__ import annotations

import glob
import json
import os

import torch


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


def open_weights(path: str) -> SafetensorsSource:
    if os.path.isfile(path):
        return SafetensorsSource([path])
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            shards = sorted({os.path.join(path, v)
                             for v in json.load(f)["weight_map"].values()})
        return SafetensorsSource(shards)
    st = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st:
        return SafetensorsSource(st)
    raise FileNotFoundError(f"no safetensors weights under {path}")


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
