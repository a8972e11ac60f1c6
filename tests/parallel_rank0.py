"""Rank 0 of aha_tpu_torch's tensor-parallel groups for
tests/test_torch_parallel.py: run as a child process on the CPU
(AHA_DEVICE=cpu), it starts gloo groups through
aha_tpu_torch.parallel.ranks and writes what each scenario produced to a
pickle, which the tests hold against aha_tpu.  It imports nothing of JAX:
the parameters arrive as numpy arrays.

    python tests/parallel_rank0.py scenarios IN.pkl OUT.pkl
    python tests/parallel_rank0.py lifecycle MODE PIDS.json

`lifecycle` starts a tp 2 group and writes its pids, then: `shutdown`
shuts it down and exits 0; `wait` sleeps (the test kills a process);
`serve` generates requests until the group fails.
"""

import functools
import itertools
import json
import os
import pickle
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from aha_tpu_torch.core.batch_engine import BatchEngine  # noqa: E402
from aha_tpu_torch.core.engine import TextEngine  # noqa: E402
from aha_tpu_torch.core.sampling import SamplingConfig  # noqa: E402
from aha_tpu_torch.io.convert import params_from_jax  # noqa: E402
from aha_tpu_torch.models.qwen3 import (  # noqa: E402
    QWEN3_PARTITION_RULES, Qwen3Config, Qwen3Model)
from aha_tpu_torch.parallel import ranks  # noqa: E402
from aha_tpu_torch.parallel.mesh import MeshConfig  # noqa: E402

GREEDY = SamplingConfig()
#: seconds any one request may take before rank 0 gives up
DEADLINE = 60.0


def build(geo: dict, tree: dict, kinds: tuple, mesh):
    """A rank's engines over its slice of `tree`: float32 TextEngines
    "cold" and "warm" (a prefix store of 4), "int8" (an int8 cache),
    "bf16" (bfloat16 parameters and cache), and "batch", a 2-slot float32
    BatchEngine."""
    torch.set_num_threads(1)
    model = Qwen3Model(Qwen3Config(**geo), max_rope_len=256, mesh=mesh)
    shard = functools.partial(params_from_jax, tree, mesh=mesh,
                              rules=QWEN3_PARTITION_RULES)
    params = {torch.float32: shard(dtype=torch.float32)}
    kw = dict(eos_token_ids=[], max_seq_len=256, mesh=mesh)
    engines = {}
    for name in kinds:
        if name == "batch":
            engines[name] = BatchEngine(model, params[torch.float32],
                                        slots=2, cache_dtype=torch.float32,
                                        **kw)
            continue
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        if dtype not in params:
            params[dtype] = shard(dtype=dtype)
        engines[name] = TextEngine(
            model, params[dtype],
            cache_dtype=torch.int8 if name == "int8" else dtype,
            prefix_cache_entries=4 if name == "warm" else 0, **kw)
    return engines


def forward_logits(engines: dict, ids: list[int]):
    """Every rank: the prompt's f32 logits through a fresh cache of the
    rank's shard; rank 0's (the gathered logits) as numpy."""
    e = next(iter(engines.values()))
    with torch.no_grad():
        cache = e.model.init_cache(1, len(ids), torch.float32)
        hidden = e.model.backbone(e.params, torch.tensor([ids]), cache)
        return e.model.logits(e.params, hidden).float().numpy()


def dump_cache(engines: dict, name: str, cache_len: int, rows: int,
               path: str) -> None:
    """Every rank writes the first `rows` k/v rows of engine `name`'s
    pooled cache of `cache_len` to `path`.rank<r>."""
    e = engines[name]
    cache = e._cache_pool[cache_len].cache
    torch.save({k: cache[k][:, :, :rows].clone() for k in ("k", "v")},
               f"{path}.rank{e.mesh.tp_rank}")


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


def _overlapped(engine, prompts: list, n: int) -> list:
    """Greedy streams of `prompts`, all open at once, one token of each in
    turn."""
    its = [engine.stream_tokens(p, GREEDY, n) for p in prompts]
    outs = [[] for _ in prompts]
    for toks in itertools.zip_longest(*its):
        for out, tok in zip(outs, toks):
            if tok is not None:
                out.append(tok)
    return outs


def scenarios(spec: dict) -> dict:
    geo, tree = spec["geo"], spec["tree"]
    res = {}
    t0 = time.perf_counter()
    eng, group = ranks.start(
        MeshConfig(tp=2),
        functools.partial(build, geo, tree,
                          ("cold", "warm", "int8", "bf16", "batch")),
        devices=["cpu", "cpu"])
    res["start_secs"] = time.perf_counter() - t0
    try:
        base, ext = spec["base"], spec["ext"]
        cold, warm = eng["cold"], eng["warm"]
        res["cold"] = [cold.generate_tokens(p, GREEDY, 6) for p in (base, ext)]
        res["warm"] = [warm.generate_tokens(p, GREEDY, 6)
                       for p in (base, base, ext)]
        res["warm_entries"] = len(warm._prefix_entries)
        res["int8"] = eng["int8"].generate_tokens(spec["int8_prompt"],
                                                  GREEDY, 12)
        res["bf16"] = eng["bf16"].generate_tokens(base, GREEDY, 16)
        res["batch"] = _threaded(
            lambda p: eng["batch"].generate_tokens(p, GREEDY, 10),
            dict(enumerate(spec["batch_prompts"])))
        res["forward2"] = group.call(forward_logits, spec["ids"])
        # a sampled request: every rank's cache must hold rank 0's tokens
        sampled = SamplingConfig(temperature=0.9, top_k=20, seed=11)
        toks = cold.generate_tokens(base, sampled, 12)
        res["sampled"] = toks
        rows = len(base) + len(toks) - 1
        group.call(dump_cache, "cold", 256, rows, spec["dump"])
        # a stream the host cuts short (a client gone): the group stays
        # in step for the next request
        it = cold.stream_tokens(base, GREEDY, 64)
        res["cut"] = [next(it) for _ in range(3)]
        it.close()
        res["after_cut"] = cold.generate_tokens(ext, GREEDY, 6)
        # two streams open at once, drawn in turn: every rank keeps each
        # request's cache apart
        res["overlap"] = _overlapped(cold, [base, ext], 6)
    finally:
        eng["batch"].shutdown()
        group.shutdown()

    eng, group = ranks.start(
        MeshConfig(tp=4), functools.partial(build, geo, tree, ("cold",)),
        devices=["cpu"] * 4)
    try:
        res["forward4"] = group.call(forward_logits, spec["ids"])
        res["cold4"] = eng["cold"].generate_tokens(spec["base"], GREEDY, 6)
    finally:
        group.shutdown()

    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    served = load_model("Qwen/Qwen3-0.6B", spec["repo"], max_seq_len=512,
                        tp=2)
    try:
        mes = ChatCompletionParameters.model_validate(spec["chat"])
        res["served"] = served.generate(mes).choices[0].message.content
        res["served_pids"] = served.ranks.pids
    finally:
        served.shutdown()
    return res


def lifecycle(mode: str, pids_path: str) -> int:
    geo = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=1, num_attention_heads=2,
               num_key_value_heads=2, head_dim=16)
    m = Qwen3Model(Qwen3Config(**geo))
    tree = {k: v for k, v in _numpy_tree(m.init_random(
        torch.Generator().manual_seed(0))).items()}
    eng, group = ranks.start(
        MeshConfig(tp=2), functools.partial(build, geo, tree, ("cold",)),
        devices=["cpu", "cpu"])
    with open(pids_path + ".tmp", "w") as f:
        json.dump({"rank0": os.getpid(), "workers": group.pids}, f)
    os.replace(pids_path + ".tmp", pids_path)
    if mode == "shutdown":
        group.shutdown()
        return 0
    if mode == "wait":
        time.sleep(600)
        return 0
    while True:                     # serve: until the group fails
        try:
            eng["cold"].generate_tokens(list(range(1, 40)), GREEDY, 16)
        except Exception as e:  # noqa: BLE001 — the failed request
            print(f"request failed: {e!r}", file=sys.stderr, flush=True)
            time.sleep(600)         # ranks.fail exits the process


def _numpy_tree(params: dict) -> dict:
    """The port's tree as the JAX package lays it out (the head (K, V))."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t.numpy()

    out = walk({k: v for k, v in params.items() if k != "lm_head"})
    out["lm_head"] = {"w": params["lm_head"]["w"].t().numpy()}
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "scenarios":
        with open(sys.argv[2], "rb") as f:
            spec = pickle.load(f)
        result = scenarios(spec)
        with open(sys.argv[3], "wb") as f:
            pickle.dump(result, f)
    else:
        sys.exit(lifecycle(sys.argv[2], sys.argv[3]))
