"""Qwen3.5 served models (counterpart of aha_tpu/models/qwen3_5_served.py):
text chat on the hybrid GatedDeltaNet decoder, and image and video chat
with Qwen3-VL's deepstack tower on that decoder.

A text-only config.json is served by Qwen3_5Chat on TextEngine, or on
BatchEngine with `batch_slots > 1`.  A config.json with a `vision_config`
(every published Qwen3.5 checkpoint has one) refuses `batch_slots > 1`
with the reference's words and is served single-stream by Qwen3_5VLChat:
Qwen3VLChat's processing (models/qwen3vl_served.py) over Qwen3_5Model
with the tower, on a TextEngine without a prefix store, as the JAX package
builds it.  The qwen35 GGUF map (`qwen3.5-gguf`) is not ported.
"""

from __future__ import annotations

from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.qwen3_5 import (Qwen3_5Config, Qwen3_5Model,
                                          Qwen3_5TextConfig)
from aha_tpu_torch.models.qwen3vl_served import Qwen3VLChat
from aha_tpu_torch.models.text_served import TextChatModel
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype

GGUF_NOT_PORTED = (
    "Qwen3.5 GGUF files (the qwen35 map, load_qwen3_5_gguf) are not ported "
    "to aha_tpu_torch yet (ROADMAP queue 1, \"GGUF, the rest\"); serve a "
    "safetensors checkpoint")

#: the reference's refusal of batch slots for a checkpoint with a vision
#: tower, word for word
VL_SLOTS = ("--batch-slots applies to text chat; this checkpoint has a "
            "vision tower and is served single-stream")


class Qwen3_5Chat(TextChatModel):
    """Text requests on the hybrid decoder."""


class Qwen3_5VLChat(Qwen3VLChat):
    """Image and video chat: Qwen3-VL's processing and geometry over the
    Qwen3.5 decoder (get_data reads only the config's vision and token
    fields, which Qwen3_5Config has as Qwen3VLConfig does)."""

    @staticmethod
    def build_model(path: str, max_seq_len: int) -> tuple:
        cfg = Qwen3_5Config.from_file(path)
        dev = device()
        model = Qwen3_5Model(cfg.text, max_rope_len=max_seq_len, device=dev,
                             vl_config=cfg)
        return model, model.load_params(open_weights(path),
                                        dtype=get_dtype(dev))

    @staticmethod
    def config_of(model) -> Qwen3_5Config:
        return model.vl


def load_qwen3_5(entry: ModelEntry, path: str, max_seq_len: int = 8192,
                 **kw) -> LoadedModel:
    """The reference's dispatch: a GGUF entry raises GGUF_NOT_PORTED; a
    checkpoint with a vision tower refuses `batch_slots > 1` (VL_SLOTS)
    before any weights load and is served by Qwen3_5VLChat; a text-only
    one by Qwen3_5Chat."""
    if entry.is_gguf:
        raise NotImplementedError(GGUF_NOT_PORTED)
    if Qwen3_5Config.from_file(path).vision is not None:
        if kw.get("batch_slots", 1) > 1:
            raise ValueError(VL_SLOTS)
        return Qwen3_5VLChat.load(entry, path, max_seq_len=max_seq_len, **kw)
    return Qwen3_5Chat.load_decoder(entry, path, Qwen3_5Model,
                                    Qwen3_5TextConfig,
                                    max_seq_len=max_seq_len, **kw)
