"""Rank 0 of aha_tpu_torch's tensor-parallel groups over the llama decoder,
Qwen3-VL, Qwen2.5-VL and the Qwen3 embedder, for
tests/test_torch_parallel_families.py: run as a child process on the CPU
(AHA_DEVICE=cpu), it starts gloo groups through
aha_tpu_torch.parallel.ranks and writes what each scenario produced to a
pickle, which the tests hold against aha_tpu.  It imports nothing of JAX:
the parameters arrive as numpy arrays, the configurations as the port's.

    python tests/parallel_families_rank0.py models IN.pkl OUT.pkl
    python tests/parallel_families_rank0.py served IN.pkl OUT.pkl

`models` starts a tp 2 and a tp 4 group over every model of the spec;
`served` loads each served model through `load_model(..., tp=2)`.
"""

import functools
import os
import pickle
import sys
import threading

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from aha_tpu_torch.core import cache as kv  # noqa: E402
from aha_tpu_torch.core.batch_engine import BatchEngine  # noqa: E402
from aha_tpu_torch.core.engine import TextEngine, mm_to  # noqa: E402
from aha_tpu_torch.core.sampling import SamplingConfig  # noqa: E402
from aha_tpu_torch.io.convert import params_from_jax  # noqa: E402
from aha_tpu_torch.models.llama import (  # noqa: E402
    LLAMA_PARTITION_RULES, LlamaModel)
from aha_tpu_torch.models.qwen2_5vl import (  # noqa: E402
    QWEN2_5VL_PARTITION_RULES, Qwen2_5VLModel)
from aha_tpu_torch.models.qwen3vl import (  # noqa: E402
    QWEN3VL_PARTITION_RULES, Qwen3VLModel)
from aha_tpu_torch.parallel import ranks  # noqa: E402
from aha_tpu_torch.parallel.mesh import MeshConfig  # noqa: E402

GREEDY = SamplingConfig()
#: seconds any one request may take before rank 0 gives up
DEADLINE = 60.0
KINDS = {"llama": (LlamaModel, LLAMA_PARTITION_RULES),
         "qwen3vl": (Qwen3VLModel, QWEN3VL_PARTITION_RULES),
         "qwen2_5vl": (Qwen2_5VLModel, QWEN2_5VL_PARTITION_RULES)}


def build(models: dict, batch: bool, mesh) -> dict:
    """A rank's float32 TextEngines, one a model of `models` (name →
    (kind, config, numpy tree)) over its slice; beside "minicpm", "warm"
    (a prefix store of 4) and, where `batch`, "batch", a 2-slot
    BatchEngine."""
    torch.set_num_threads(1)
    engines = {}
    kw = dict(eos_token_ids=[], max_seq_len=256, mesh=mesh,
              cache_dtype=torch.float32)
    for name, (kind, cfg, tree) in models.items():
        cls, rules = KINDS[kind]
        model = cls(cfg, max_rope_len=256, mesh=mesh)
        params = params_from_jax(tree, mesh=mesh, rules=rules)
        engines[name] = TextEngine(model, params, **kw)
        if name == "minicpm":
            engines["warm"] = TextEngine(model, params,
                                         prefix_cache_entries=4, **kw)
            if batch:
                engines["batch"] = BatchEngine(model, params, slots=2, **kw)
    return engines


def forward_logits(engines: dict, name: str, ids: list[int]):
    """Every rank: the prompt's logits through a fresh cache of model
    `name`'s shard; rank 0's (the gathered logits) as numpy."""
    e = engines[name]
    with torch.no_grad():
        cache = e.model.init_cache(1, len(ids), torch.float32)
        hidden = e.model.backbone(e.params, torch.tensor([ids]), cache)
        return e.model.logits(e.params, hidden).numpy()


def vl_parity(engines: dict, name: str, ids: list[int], mm: dict,
              cache_len: int) -> list:
    """Every rank: a multimodal prefill of `ids` with `mm` (host arrays,
    moved to the rank's device) and one greedy decode step; the last
    prompt row's logits and the step's, as numpy (aha_tpu's _tp_parity
    scenario)."""
    e = engines[name]
    m = e.model
    with torch.no_grad():
        cache = m.init_cache(1, cache_len, torch.float32)
        h = m.backbone(e.params, torch.tensor([ids]), cache,
                       mm=mm_to(mm, e.device))
        lg = m.logits(e.params, h)[0, -1]
        kv.advance(cache, len(ids))
        tok = int(torch.argmax(lg))
        h2 = m.backbone(e.params, torch.tensor([[tok]]), cache)
        return [lg.numpy(), m.logits(e.params, h2)[0, 0].numpy()]


def _threaded(fn, items: dict) -> dict:
    """fn(item) for every item from its own thread, each within
    DEADLINE."""
    out, errs = {}, []

    def one(k):
        try:
            out[k] = fn(items[k])
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(k,), daemon=True)
          for k in items]
    [t.start() for t in ts]
    [t.join(DEADLINE) for t in ts]
    if errs:
        raise errs[0]
    if len(out) != len(items):
        raise TimeoutError("a request passed its deadline")
    return out


def _within(fn):
    """fn() within DEADLINE."""
    return _threaded(lambda f: f(), {0: fn})[0]


def models(spec: dict) -> dict:
    res = {}
    for tp in (2, 4):
        eng, group = ranks.start(
            MeshConfig(tp=tp),
            functools.partial(build, spec["models"], tp == 2),
            devices=["cpu"] * tp)
        try:
            for name in spec["llama"]:
                res[f"forward/{name}/{tp}"] = group.call(
                    forward_logits, name, spec["ids"])
            for name, (ids, mm) in spec["vl"].items():
                res[f"vl/{name}/{tp}"] = group.call(vl_parity, name, ids,
                                                    mm, 64)
            cold, warm = eng["minicpm"], eng["warm"]
            res[f"cold/{tp}"] = [
                _within(lambda: cold.generate_tokens(p, GREEDY, 6))
                for p in (spec["base"], spec["ext"])]
            if tp == 2:
                res["warm"] = [
                    _within(lambda: warm.generate_tokens(p, GREEDY, 6))
                    for p in (spec["base"], spec["base"], spec["ext"])]
                res["warm_entries"] = len(warm._prefix_entries)
                res["batch"] = _threaded(
                    lambda p: eng["batch"].generate_tokens(p, GREEDY, 10),
                    dict(enumerate(spec["batch_prompts"])))
        finally:
            if "batch" in eng:
                eng["batch"].shutdown()
            group.shutdown()
    return res


def served(spec: dict) -> dict:
    """Every served model of the spec through load_model(..., tp=2): a chat
    reply each, the embedder's vectors and the reranker's scores, and the
    workers' pids (gone after the shutdown)."""
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    res = {}
    for key, (model_id, path, kw, body) in spec["chats"].items():
        s = load_model(model_id, path, tp=2, **kw)
        try:
            mes = ChatCompletionParameters.model_validate(body)
            res[key] = _within(
                lambda: s.generate(mes).choices[0].message.content)
            res[f"{key}/pids"] = s.ranks.pids
            res[f"{key}/engine"] = type(s.engine).__name__
        finally:
            s.shutdown()
    emb = load_model("Qwen/Qwen3-Embedding-0.6B", spec["qwen3_repo"], tp=2)
    try:
        res["embed"] = _within(lambda: emb.embed_arrays(spec["texts"]))
        res["embed/pids"] = emb.ranks.pids
    finally:
        emb.shutdown()
    rr = load_model("Qwen/Qwen3-Reranker-0.6B", spec["qwen3_repo"], tp=2)
    try:
        res["rerank"] = _within(lambda: rr.rerank(*spec["rerank"]))
    finally:
        rr.shutdown()
    return res


if __name__ == "__main__":
    torch.set_num_threads(1)
    with open(sys.argv[2], "rb") as f:
        spec = pickle.load(f)
    result = {"models": models, "served": served}[sys.argv[1]](spec)
    with open(sys.argv[3], "wb") as f:
        pickle.dump(result, f)
