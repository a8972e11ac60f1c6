"""Model factory: registry id → served model (counterpart of
aha_tpu/models/loader.py; only the Qwen3 chat family is ported)."""

from __future__ import annotations

from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.registry import lookup


def load_model(model_id: str, path: str, **kw) -> LoadedModel:
    """`batch_slots > 1` serves through the continuous-batching engine;
    combined with `spec_tokens > 0` it is refused before any weights load,
    as the JAX loader does.  `dp > 1` (sharded slots) is not ported."""
    from aha_tpu_torch.models.text_served import SPEC_WITH_SLOTS

    if kw.get("batch_slots", 1) > 1 and kw.get("spec_tokens", 0) > 0:
        raise ValueError(SPEC_WITH_SLOTS)
    if kw.pop("dp", 1) > 1:
        raise ValueError("--dp (continuous-batching slots sharded over "
                         "devices) is not ported to aha_tpu_torch yet; "
                         "serve with --dp 1")
    entry = lookup(model_id)
    if entry.family != "qwen3":
        raise NotImplementedError(
            f"model family '{entry.family}' is not ported to aha_tpu_torch "
            "yet (the Qwen3 chat models are)")
    from aha_tpu_torch.models.qwen3_served import Qwen3Chat

    return Qwen3Chat.load(entry, path, **kw)
