"""Model factory: registry id → served model (counterpart of
aha_tpu/models/loader.py; only the Qwen3 chat family is ported)."""

from __future__ import annotations

from aha_tpu.models.base import LoadedModel
from aha_tpu.registry import lookup


def load_model(model_id: str, path: str, **kw) -> LoadedModel:
    entry = lookup(model_id)
    if entry.family != "qwen3":
        raise NotImplementedError(
            f"model family '{entry.family}' is not ported to aha_tpu_torch "
            "yet (the Qwen3 chat models are)")
    from aha_tpu_torch.models.qwen3_served import Qwen3Chat

    return Qwen3Chat.load(entry, path, **kw)
