"""Rank 0 of aha_tpu_torch's tensor-parallel groups over the ASR and OCR
families (Qwen3-ASR, Fun-ASR-Nano, GLM-ASR-Nano, PaddleOCR-VL,
HunyuanOCR, GLM-OCR, DeepSeek-OCR), for
tests/test_torch_parallel_asr_ocr.py: run as a child process on the CPU
(AHA_DEVICE=cpu), it starts gloo groups through
aha_tpu_torch.parallel.ranks and writes what each scenario produced to a
pickle, which the tests hold against aha_tpu.  It imports nothing of JAX:
the parameters arrive as numpy arrays, the configurations as the port's.

    python tests/parallel_asr_ocr_rank0.py models IN.pkl OUT.pkl
    python tests/parallel_asr_ocr_rank0.py served IN.pkl OUT.pkl

`models` starts a tp 2 and a tp 4 group, each over the models of the
spec whose tiny geometry that tp divides; `served` loads each served
model through `load_model(..., tp=2)`.
"""

import functools
import os
import pickle
import sys
import threading
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from aha_tpu_torch.core import cache as kv  # noqa: E402
from aha_tpu_torch.core.engine import mm_to  # noqa: E402
from aha_tpu_torch.io.convert import params_from_jax  # noqa: E402
from aha_tpu_torch.models.deepseek_ocr import DeepseekOCRModel  # noqa: E402
from aha_tpu_torch.models.fun_asr_nano import FunAsrNanoModel  # noqa: E402
from aha_tpu_torch.models.glm_asr_nano import GlmAsrNanoModel  # noqa: E402
from aha_tpu_torch.models.glm_ocr import GlmOcrModel  # noqa: E402
from aha_tpu_torch.models.hunyuan_ocr import HunyuanOCRModel  # noqa: E402
from aha_tpu_torch.models.paddleocr_vl import PaddleOCRVLModel  # noqa: E402
from aha_tpu_torch.models.qwen3_asr import Qwen3ASRModel  # noqa: E402
from aha_tpu_torch.ops.moe import moe_ffn  # noqa: E402
from aha_tpu_torch.parallel import ranks  # noqa: E402
from aha_tpu_torch.parallel.mesh import (MeshConfig,  # noqa: E402
                                         shard_params)

#: seconds any one request may take before rank 0 gives up
DEADLINE = 60.0
KINDS = {"qwen3_asr": Qwen3ASRModel, "fun_asr": FunAsrNanoModel,
         "glm_asr": GlmAsrNanoModel, "paddleocr_vl": PaddleOCRVLModel,
         "hunyuan_ocr": HunyuanOCRModel, "glm_ocr": GlmOcrModel,
         "deepseek_ocr": DeepseekOCRModel}


def build(models: dict, tp: int, mesh) -> dict:
    """A rank's models of `models` (name → (kind, config, numpy tree,
    tps)) that `tp` divides, each over its slice of the tree by its
    class's partition rules."""
    torch.set_num_threads(1)
    built = {}
    for name, (kind, cfg, tree, tps) in models.items():
        if tp not in tps:
            continue
        cls = KINDS[kind]
        model = cls(cfg, max_rope_len=512, mesh=mesh)
        built[name] = types.SimpleNamespace(
            model=model, params=params_from_jax(tree, mesh=mesh,
                                                rules=cls.partition_rules))
    return built


def parity(built: dict, name: str, ids: list, mm: dict,
           cache_len: int) -> list:
    """Every rank: a multimodal prefill of `ids` with `mm` (host arrays,
    moved to the rank's device) and one greedy decode step; the last
    prompt row's logits, the step's, and the greedy token of the step
    through the value-out head combine (aha_tpu's _tp_parity scenario)."""
    e = built[name]
    m = e.model
    with torch.no_grad():
        cache = m.init_cache(1, cache_len, torch.float32)
        h = m.backbone(e.params, torch.tensor([ids]), cache,
                       mm=mm_to(mm, m.device))
        lg = m.logits(e.params, h)[0, -1]
        kv.advance(cache, len(ids))
        tok = int(torch.argmax(lg))
        h2 = m.backbone(e.params, torch.tensor([[tok]]), cache)
        return [lg.numpy(), m.logits(e.params, h2)[0, 0].numpy(),
                int(m.greedy_token(e.params, h2))]


def expert_bytes(built: dict, name: str) -> list:
    """Every rank's bytes of routed experts and its first layer's expert
    count, gathered (each rank writes its row; the sum over the ranks)."""
    e = built[name]
    mesh = e.model.mesh
    layers = [lp for lp in e.params["layers"] if "moe" in lp]
    n = sum(t["w"].numel() * t["w"].element_size()
            for lp in layers for t in lp["moe"]["experts"].values())
    rows = torch.zeros((mesh.tp, 2), dtype=torch.float64)
    rows[mesh.tp_rank] = torch.tensor(
        [n, layers[0]["moe"]["experts"]["gate"]["w"].shape[0]],
        dtype=torch.float64)
    return mesh.all_reduce(rows).tolist()


def moe_drops(built: dict, p: dict, x, top_k: int, capacity: int) -> list:
    """Every rank: the planted MoE at `capacity` over its slice of `p`
    (experts by the expert axis, shared experts by columns / rows); the
    result summed over the ranks."""
    from aha_tpu_torch.models.deepseek_ocr import \
        DEEPSEEK_OCR_PARTITION_RULES

    def to_torch(t):
        return ({k: to_torch(v) for k, v in t.items()}
                if isinstance(t, dict) else torch.from_numpy(t))

    mesh = next(iter(built.values())).model.mesh
    local = shard_params({"layers": [{"moe": to_torch(p)}]}, mesh,
                         DEEPSEEK_OCR_PARTITION_RULES)["layers"][0]["moe"]
    with torch.no_grad():
        return moe_ffn(local, torch.from_numpy(x), top_k,
                       capacity=capacity, mesh=mesh).numpy()


def _within(fn):
    """fn() within DEADLINE, from a thread of its own."""
    out, errs = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(DEADLINE)
    if errs:
        raise errs[0]
    if not out:
        raise TimeoutError("a request passed its deadline")
    return out[0]


def models(spec: dict) -> dict:
    res = {}
    for tp in (2, 4):
        _, group = ranks.start(
            MeshConfig(tp=tp), functools.partial(build, spec["models"], tp),
            devices=["cpu"] * tp)
        try:
            for name, (ids, mm, cache_len) in spec["runs"].items():
                if tp in spec["models"][name][3]:
                    res[f"{name}/{tp}"] = _within(functools.partial(
                        group.call, parity, name, ids, mm, cache_len))
            res[f"experts/{tp}"] = group.call(expert_bytes, "deepseek_ocr")
            if tp == 2:
                res["moe_drops"] = group.call(moe_drops, *spec["moe"])
        finally:
            group.shutdown()
    return res


def served(spec: dict) -> dict:
    """Every served model of the spec through load_model(..., tp=2): its
    greedy reply, its engine's kind and the workers' pids (gone after the
    shutdown)."""
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    res = {}
    for key, (model_id, path, kw, body) in spec.items():
        s = load_model(model_id, path, tp=2, **kw)
        try:
            mes = ChatCompletionParameters.model_validate(body)
            res[key] = _within(
                lambda: s.generate(mes).choices[0].message.content)
            res[f"{key}/pids"] = s.ranks.pids
            res[f"{key}/engine"] = type(s.engine).__name__
        finally:
            s.shutdown()
    return res


if __name__ == "__main__":
    torch.set_num_threads(1)
    with open(sys.argv[2], "rb") as f:
        spec = pickle.load(f)
    result = {"models": models, "served": served}[sys.argv[1]](spec)
    with open(sys.argv[3], "wb") as f:
        pickle.dump(result, f)
