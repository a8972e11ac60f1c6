"""Qwen3.5 served models (counterpart of aha_tpu/models/qwen3_5_served.py):
text chat on the hybrid GatedDeltaNet decoder.

A text-only config.json is served on TextEngine, or on BatchEngine with
`batch_slots > 1`.  A config.json with a `vision_config` (every published
Qwen3.5 checkpoint has one) refuses `batch_slots > 1` with the
reference's words and is served single-stream for text: the decoder loads
from `model.language_model.*` and `model.visual.*` is left unread.  Its
image chat needs the Qwen3-VL deepstack tower, which is not ported: a
message with an image part raises IMAGE_NOT_PORTED (a video part
VIDEO_NOT_PORTED), as a request, not silently as text.  The qwen35 GGUF
map (`qwen3.5-gguf`) is not ported either.
"""

from __future__ import annotations

import json
import os

from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.qwen3_5 import Qwen3_5Model, Qwen3_5TextConfig
from aha_tpu_torch.models.text_served import TextChatModel
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.video import VIDEO_NOT_PORTED, extract_vision_parts

IMAGE_NOT_PORTED = (
    "image input on Qwen3.5 is not ported to aha_tpu_torch yet: it needs "
    "the Qwen3-VL deepstack vision tower and interleaved M-RoPE of "
    "aha_tpu/models/qwen3vl.py; the port serves this checkpoint's text "
    "decoder only")

GGUF_NOT_PORTED = (
    "Qwen3.5 GGUF files (the qwen35 map, load_qwen3_5_gguf) are not ported "
    "to aha_tpu_torch yet (ROADMAP queue 1, \"GGUF, the rest\"); serve a "
    "safetensors checkpoint")

#: the reference's refusal of batch slots for a checkpoint with a vision
#: tower, word for word
VL_SLOTS = ("--batch-slots applies to text chat; this checkpoint has a "
            "vision tower and is served single-stream")


class Qwen3_5Chat(TextChatModel):
    """Text requests on the hybrid decoder; an image or video part is
    refused."""

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        kinds = {kind for kind, _ in extract_vision_parts(mes)}
        if "video" in kinds:
            raise NotImplementedError(VIDEO_NOT_PORTED)
        if kinds:
            raise NotImplementedError(IMAGE_NOT_PORTED)
        return super().get_data(mes)


def load_qwen3_5(entry: ModelEntry, path: str, max_seq_len: int = 8192,
                 **kw) -> LoadedModel:
    """The reference's checks, then Qwen3_5Chat: a GGUF entry raises
    GGUF_NOT_PORTED; a checkpoint with a vision tower refuses
    `batch_slots > 1` (VL_SLOTS) before any weights load."""
    if entry.is_gguf:
        raise NotImplementedError(GGUF_NOT_PORTED)
    with open(os.path.join(path, "config.json")) as f:
        has_vision = "vision_config" in json.load(f)
    if has_vision and kw.get("batch_slots", 1) > 1:
        raise ValueError(VL_SLOTS)
    return Qwen3_5Chat.load_decoder(entry, path, Qwen3_5Model,
                                    Qwen3_5TextConfig,
                                    max_seq_len=max_seq_len, **kw)
