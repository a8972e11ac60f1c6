"""Generic text-chat served model: CausalLM + tokenizer + chat template
(counterpart of aha_tpu/models/text_served.py): Qwen3, the llama
families (minicpm4 / minicpm5) and the hybrids (lfm2, qwen3_5) share it,
each contributing only the function that builds its model.
`batch_slots > 1` serves through the continuous-batching BatchEngine, for
a model with `supports_slot_decode` (others are refused, as the reference
refuses them).  A model with
`supports_kv_int8` (Qwen3) takes get_cache_dtype() (AHA_KV_INT8=1 → int8)
on both engines; any other keeps its parameters' dtype, as the
reference's rule is.

`tp > 1` (the families whose wrappers pass `build_rank`: Qwen3, the
llama families minicpm4 / minicpm5, Qwen3-VL and Qwen2.5-VL) starts a
tensor-parallel group (parallel/ranks.py): this process is rank 0, each
rank builds its model on its card (`mesh_devices`) from its slice of the
checkpoint and its engine over it, and rank 0 schedules.  Every family
hands the engine a multimodal request's inputs as the host arrays it
built; the engine moves them to each rank's card (TextEngine._op_prompt).
`dp > 1` builds dp BatchEngine replicas in this process, one a card,
with batch_slots/dp slots each (parallel/replicas.py).  `shutdown()`
stops the engine's scheduler threads and the workers."""

from __future__ import annotations

import functools
import json
import os
from typing import Callable

import torch

from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.chat_template import ChatTemplate
from aha_tpu_torch.core.engine import TextEngine, embed_weight
from aha_tpu_torch.core.generate import GenerateModel, PrepareData
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.qwen3 import load_stop_token_ids
from aha_tpu_torch.parallel.replicas import ReplicaEngine
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import (device, get_cache_dtype, get_dtype,
                                        mesh_devices, use_device)


#: the serve options `load` takes, as `load_model` passes them on
SERVE_OPTIONS = ("batch_slots", "prefix_cache", "spec_tokens", "cuda_graphs",
                 "dp")

SPEC_WITH_SLOTS = (
    "--spec-tokens rides the single-stream engine; combine it with "
    "--batch-slots 1 (silently dropping it would belie the advertised "
    "speedup)")


TP_WITH_DP = ("--tp with --dp is not ported to aha_tpu_torch yet: each dp "
              "replica of a tp group needs a leader process of its own; "
              "serve with --tp N or with --dp D")


def check_dp(dp: int, batch_slots: int) -> None:
    """The reference's checks of --dp against the slots, with its words."""
    if dp <= 1:
        return
    if batch_slots <= 1:
        raise ValueError(
            "--dp shards continuous-batching slots across devices; "
            "combine it with --batch-slots N (N a multiple of dp)")
    if batch_slots % dp:
        raise ValueError(f"--batch-slots {batch_slots} must be a "
                         f"multiple of --dp {dp}")


def _cache_dtype(model, params: dict) -> torch.dtype:
    w = embed_weight(params)
    return (get_cache_dtype(w.device)
            if getattr(model, "supports_kv_int8", False) else w.dtype)


def make_engine(model, params: dict, eos: list[int], batch_slots: int,
                max_seq_len: int, prefix_cache: int, spec_tokens: int = 0,
                cuda_graphs: bool = True, mesh=None, replicas: int = 1):
    """The engine a served chat model runs on: a BatchEngine of
    `batch_slots` slots (each of `replicas` taking its share), else a
    TextEngine; over a rank's shard under a tp `mesh`."""
    kw = dict(eos_token_ids=eos, cache_dtype=_cache_dtype(model, params),
              max_seq_len=max_seq_len, prefix_cache_entries=prefix_cache,
              cuda_graphs=cuda_graphs)
    if mesh is not None:
        kw.update(mesh=mesh)
    if batch_slots > 1:
        return BatchEngine(model, params, slots=batch_slots // replicas,
                           **kw)
    return TextEngine(model, params, spec_tokens=spec_tokens, **kw)


def rank_engine(build_rank: Callable, eos: list[int], batch_slots: int,
                max_seq_len: int, prefix_cache: int, cuda_graphs: bool,
                mesh) -> TextEngine | BatchEngine:
    """A tp rank's engine (every rank runs this, a partial of it pickled
    to the workers): its model and slice from `build_rank(mesh)`."""
    model, params = build_rank(mesh)
    return make_engine(model, params, eos, batch_slots, max_seq_len,
                       prefix_cache, cuda_graphs=cuda_graphs, mesh=mesh)


def decoder_rank(model_cls: type, config_cls: type, path: str,
                 max_seq_len: int, mesh=None) -> tuple:
    """A tensor-parallel rank's model on its card and its slice of the
    checkpoint at `path` (read alone, io/weights.read_shard): the
    `build_rank` of a model class that takes a `mesh`.  With no mesh, the
    whole model on the default device: the `build_model` of a family
    whose model class reads its own checkpoint."""
    dev = mesh.device if mesh is not None else device()
    model = model_cls(config_cls.from_file(path), max_rope_len=max_seq_len,
                      device=dev, **({} if mesh is None else {"mesh": mesh}))
    return model, model.load_params(open_weights(path), dtype=get_dtype(dev))


def rank_builder(model_cls: type, config_cls: type, path: str,
                 max_seq_len: int, tp: int = 1,
                 check_tp: Callable | None = None) -> Callable:
    """The `build_rank` of a family whose model class takes a `mesh`
    (`decoder_rank` over the checkpoint at `path`), after `check_tp(config,
    tp)` refuses, before any weights load, a tp that does not divide it."""
    if tp > 1 and check_tp is not None:
        check_tp(config_cls.from_file(path), tp)
    return functools.partial(decoder_rank, model_cls, config_cls, path,
                             max_seq_len)


def load_generation_config(path: str) -> dict:
    p = os.path.join(path, "generation_config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def start_engine(entry: ModelEntry, path: str,
                 build_model: Callable[[str, int], tuple], eos: list[int],
                 max_seq_len: int = 8192, batch_slots: int = 1,
                 prefix_cache: int = 4, spec_tokens: int = 0,
                 cuda_graphs: bool = True, tp: int = 1, dp: int = 1,
                 build_rank: Callable | None = None) -> tuple:
    """(engine, the tp group's handle or None) of a served model: over tp
    ranks through `build_rank(mesh)` (this process rank 0), else on this
    process's card (one a dp replica) through `build_model(path,
    max_seq_len)` → (model, params).  The reference's checks of the
    options come first."""
    if batch_slots > 1 and spec_tokens > 0:
        raise ValueError(SPEC_WITH_SLOTS)
    check_dp(dp, batch_slots)
    if tp > 1 and dp > 1:
        raise ValueError(TP_WITH_DP)
    if tp > 1 and build_rank is None:
        raise ValueError(f"--tp: {entry.name}'s sharding is not ported "
                         "to aha_tpu_torch yet; serve it with --tp 1")
    if tp > 1:
        from aha_tpu_torch.parallel.mesh import MeshConfig
        from aha_tpu_torch.parallel.ranks import start

        return start(
            MeshConfig(tp=tp),
            functools.partial(rank_engine, build_rank, eos, batch_slots,
                              max_seq_len, prefix_cache, cuda_graphs),
            devices=mesh_devices(tp=tp))
    built = []
    for dev in mesh_devices(dp=dp) if dp > 1 else ():
        with use_device(dev):
            built.append(build_model(path, max_seq_len))
    built = built or [build_model(path, max_seq_len)]
    model = built[0][0]
    if batch_slots > 1 and not getattr(model, "supports_slot_decode",
                                       False):
        raise ValueError(
            f"{type(model).__name__} does not support per-slot "
            "batched decode; serve it with --batch-slots 1")
    engines = [make_engine(m, p, eos, batch_slots, max_seq_len,
                           prefix_cache, spec_tokens, cuda_graphs,
                           replicas=dp)
               for m, p in built]
    engine = engines[0] if dp == 1 else ReplicaEngine(engines)
    if isinstance(engine, TextEngine) and spec_tokens > 0 and \
            engine.spec_tokens == 0:
        print(f"--spec-tokens ignored: {type(model).__name__} "
              "carries rolling conv/recurrent state that cannot "
              "rewind past rejected drafts")
    return engine, None


class TextChatModel(GenerateModel, LoadedModel):
    """Chat LLM on the port's TextEngine or BatchEngine (GenerateModel first
    in the MRO so its generate/generate_stream win over LoadedModel's
    defaults)."""

    def __init__(self, entry: ModelEntry, engine: TextEngine | BatchEngine,
                 tokenizer: TokenizerModel, chat_template: ChatTemplate,
                 generation_config: dict, model_name: str):
        LoadedModel.__init__(self, entry)
        GenerateModel.__init__(self, engine=engine, tokenizer=tokenizer,
                               model_name=model_name)
        self.chat_template = chat_template
        self.generation_config = generation_config
        #: rank 0's handle on the tp workers (None on one device)
        self.ranks = None

    @classmethod
    def load_decoder(cls, entry: ModelEntry, path: str, model_cls: type,
                     config_cls: type, max_seq_len: int = 8192,
                     check_tp: Callable | None = None,
                     **kw) -> "TextChatModel":
        """`model_cls(config_cls.from_file(path))` on the default device with
        the checkpoint's safetensors weights, served through `load` with the
        serve options of `kw` (SERVE_OPTIONS and tp; anything else is
        ignored).  `check_tp(config, tp)` given: the model shards over
        `tp > 1` ranks (`decoder_rank`), after it refuses, before loading,
        a tp that does not divide the model."""
        build = functools.partial(decoder_rank, model_cls, config_cls)
        build_rank = (None if check_tp is None else rank_builder(
            model_cls, config_cls, path, max_seq_len, kw.get("tp", 1),
            check_tp))
        return cls.load(entry, path, build, max_seq_len=max_seq_len,
                        build_rank=build_rank,
                        **{k: v for k, v in kw.items()
                           if k in SERVE_OPTIONS + ("tp",)})

    @classmethod
    def load(cls, entry: ModelEntry, path: str,
             build_model: Callable[[str, int], tuple],
             max_seq_len: int = 8192, batch_slots: int = 1,
             prefix_cache: int = 4, spec_tokens: int = 0,
             cuda_graphs: bool = True,
             chat_template: ChatTemplate | None = None, tp: int = 1,
             dp: int = 1, build_rank: Callable | None = None
             ) -> "TextChatModel":
        """build_model(path, max_seq_len) → (model, params); `cuda_graphs`
        as the engines take it; `chat_template` in place of the
        checkpoint's (a family with a fixed prompt).  `tp > 1` needs
        `build_rank(mesh)` → (the rank's model, its slice); `dp > 1` builds
        one (model, params) a card through build_model."""
        engine, ranks = start_engine(
            entry, path, build_model, load_stop_token_ids(path),
            max_seq_len, batch_slots, prefix_cache, spec_tokens, cuda_graphs,
            tp, dp, build_rank)
        served = cls(entry, engine, TokenizerModel.init(path),
                     chat_template or ChatTemplate.init(path),
                     load_generation_config(path),
                     model_name=os.path.basename(path.rstrip("/"))
                     or entry.name)
        served.ranks = ranks
        # the server's chat gate admits this many chats at once
        served.concurrent_streams = max(1, batch_slots)
        return served

    def shutdown(self) -> None:
        """Stop the engine's scheduler threads and the tp workers."""
        stop = getattr(self.engine, "shutdown", None)
        if stop is not None:
            stop()
        if self.ranks is not None:
            self.ranks.shutdown()

    def get_temperature(self, t):
        return t if t is not None else self.generation_config.get("temperature")

    def get_top_p(self, p):
        return p if p is not None else self.generation_config.get("top_p")

    def get_top_k(self, k):
        return k if k is not None else self.generation_config.get("top_k")

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        enable_thinking = bool(mes.enable_thinking) or \
            (mes.metadata_value("enable_thinking") in ("true", "True", "1"))
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True,
            enable_thinking=enable_thinking,
            tools=[t.to_json_dict() for t in mes.tools] if mes.tools else None,
        )
        return PrepareData(input_ids=self.tokenizer.encode(rendered),
                           in_reasoning=self.is_in_reasoning(rendered))
