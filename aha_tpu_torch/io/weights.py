"""safetensors checkpoints → torch tensors (counterpart of
aha_tpu/io/weights.py, safetensors only).

`open_weights(path)` resolves a model directory the way the JAX package
does (sharded index → *.safetensors) and returns a read-only mapping from
checkpoint tensor name to a CPU tensor; model loaders move each tensor to
the device and dtype they need.
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


def save_hf_qwen3(params: dict, path: str) -> None:
    """Write the port's Qwen3 parameters as an HF-named safetensors file
    (the inverse of Qwen3Model.load_params): a checkpoint made from seeded
    weights for serving without a download."""
    from safetensors.torch import save_file

    def lin(w):                           # (in, out) → HF (out, in)
        return w.t().contiguous().cpu()

    lay = params["layers"]
    mlp = lay["mlp"]
    out = {"model.embed_tokens.weight": params["embed"]["w"].contiguous().cpu(),
           "model.norm.weight": params["norm"]["w"].cpu()}
    if params["lm_head"]["w"] is not params["embed"]["w"]:
        out["lm_head.weight"] = params["lm_head"]["w"].contiguous().cpu()
    for i in range(lay["ln1"]["w"].shape[0]):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": lay["ln1"]["w"][i].cpu(),
            p + "post_attention_layernorm.weight": lay["ln2"]["w"][i].cpu(),
            p + "self_attn.q_proj.weight": lin(lay["q"]["w"][i]),
            p + "self_attn.k_proj.weight": lin(lay["k"]["w"][i]),
            p + "self_attn.v_proj.weight": lin(lay["v"]["w"][i]),
            p + "self_attn.o_proj.weight": lin(lay["o"]["w"][i]),
            p + "self_attn.q_norm.weight": lay["q_norm"]["w"][i].cpu(),
            p + "self_attn.k_norm.weight": lay["k_norm"]["w"][i].cpu(),
            p + "mlp.gate_proj.weight": lin(mlp["gate"]["w"][i]),
            p + "mlp.up_proj.weight": lin(mlp["up"]["w"][i]),
            p + "mlp.down_proj.weight": lin(mlp["down"]["w"][i]),
        })
    save_file({k: v.contiguous() for k, v in out.items()},
              os.path.join(path, "model.safetensors"))
