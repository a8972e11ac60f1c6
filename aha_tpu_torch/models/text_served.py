"""Generic text-chat served model: CausalLM + tokenizer + chat template
(counterpart of aha_tpu/models/text_served.py).  `batch_slots > 1` serves
through the continuous-batching BatchEngine.  A model with
`supports_kv_int8` (Qwen3) takes get_cache_dtype() (AHA_KV_INT8=1 → int8)
on both engines; any other keeps its parameters' dtype, as the
reference's rule is."""

from __future__ import annotations

import json
import os
from typing import Callable

from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.chat_template import ChatTemplate
from aha_tpu_torch.core.engine import TextEngine, embed_weight
from aha_tpu_torch.core.generate import GenerateModel, PrepareData
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.qwen3 import load_stop_token_ids
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import get_cache_dtype


SPEC_WITH_SLOTS = (
    "--spec-tokens rides the single-stream engine; combine it with "
    "--batch-slots 1 (silently dropping it would belie the advertised "
    "speedup)")


def load_generation_config(path: str) -> dict:
    p = os.path.join(path, "generation_config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


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

    @classmethod
    def load(cls, entry: ModelEntry, path: str,
             build_model: Callable[[str, int], tuple],
             max_seq_len: int = 8192, batch_slots: int = 1,
             prefix_cache: int = 4, spec_tokens: int = 0) -> "TextChatModel":
        """build_model(path, max_seq_len) → (model, params)."""
        if batch_slots > 1 and spec_tokens > 0:
            raise ValueError(SPEC_WITH_SLOTS)
        model, params = build_model(path, max_seq_len)
        w = embed_weight(params)
        cache_dtype = (get_cache_dtype(w.device)
                       if getattr(model, "supports_kv_int8", False)
                       else w.dtype)
        eos = load_stop_token_ids(path)
        if batch_slots > 1:
            engine = BatchEngine(model, params, eos_token_ids=eos,
                                 slots=batch_slots, cache_dtype=cache_dtype,
                                 max_seq_len=max_seq_len,
                                 prefix_cache_entries=prefix_cache)
        else:
            engine = TextEngine(model, params, eos_token_ids=eos,
                                max_seq_len=max_seq_len,
                                prefix_cache_entries=prefix_cache,
                                spec_tokens=spec_tokens,
                                cache_dtype=cache_dtype)
        served = cls(entry, engine, TokenizerModel.init(path),
                     ChatTemplate.init(path), load_generation_config(path),
                     model_name=os.path.basename(path.rstrip("/"))
                     or entry.name)
        # the server's chat gate admits this many chats at once
        served.concurrent_streams = max(1, batch_slots)
        return served

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
