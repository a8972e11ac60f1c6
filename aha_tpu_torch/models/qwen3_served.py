"""Qwen3 chat served model (counterpart of aha_tpu/models/qwen3_served.py's
Qwen3Chat; the embedding and reranker models are not ported yet)."""

from __future__ import annotations

from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from aha_tpu_torch.models.text_served import TextChatModel
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype


class Qwen3Chat(TextChatModel):
    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "Qwen3Chat":
        def build(path, max_seq_len):
            dev = device()
            model = Qwen3Model(Qwen3Config.from_file(path),
                               max_rope_len=max_seq_len, device=dev)
            return model, model.load_params(open_weights(path),
                                            dtype=get_dtype(dev))

        return super().load(entry, path, build, max_seq_len=max_seq_len,
                            batch_slots=kw.get("batch_slots", 1),
                            prefix_cache=kw.get("prefix_cache", 4),
                            spec_tokens=kw.get("spec_tokens", 0))
