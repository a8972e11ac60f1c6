"""Qwen3.5 served models (counterpart of aha_tpu/models/qwen3_5_served.py):
text chat on the hybrid GatedDeltaNet decoder, and image and video chat
with Qwen3-VL's deepstack tower on that decoder.

A text-only config.json is served by Qwen3_5Chat on TextEngine, or on
BatchEngine with `batch_slots > 1`.  A config.json with a `vision_config`
(every published Qwen3.5 checkpoint has one) refuses `batch_slots > 1`
with the reference's words and is served single-stream by Qwen3_5VLChat:
Qwen3VLChat's processing (models/qwen3vl_served.py) over Qwen3_5Model
with the tower, on a TextEngine without a prefix store, as the JAX package
builds it.  The GGUF entry (`qwen3.5-gguf`) loads a qwen35 file, and with
an mmproj file the tower, through io/gguf_models.py
(`load_qwen3_5_gguf_chat`): tokenizer, chat template and eos from the
file's metadata, the name the file's basename.
"""

from __future__ import annotations

import os

from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.chat_template import ChatTemplate
from aha_tpu_torch.core.engine import TextEngine, embed_weight
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.qwen3_5 import (Qwen3_5Config, Qwen3_5Model,
                                          Qwen3_5TextConfig)
from aha_tpu_torch.models.qwen3vl_served import Qwen3VLChat
from aha_tpu_torch.models.text_served import TextChatModel
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype

#: the reference's refusal of batch slots for a checkpoint with a vision
#: tower, word for word
VL_SLOTS = ("--batch-slots applies to text chat; this checkpoint has a "
            "vision tower and is served single-stream")
#: the reference's refusals of the GGUF entry's options, word for word
GGUF_MMPROJ_SLOTS = ("--batch-slots applies to text chat; mmproj image "
                     "serving is single-stream")
GGUF_PARALLEL = ("GGUF serving is single-device for now; drop --tp/--dp "
                 "(quantized tensors are not mesh-sharded)")
GGUF_NO_TEMPLATE = "gguf file has no tokenizer.chat_template"


class Qwen3_5Chat(TextChatModel):
    """Text requests on the hybrid decoder."""


class Qwen3_5VLChat(Qwen3VLChat):
    """Image and video chat: Qwen3-VL's processing and geometry over the
    Qwen3.5 decoder (get_data reads only the config's vision and token
    fields, which Qwen3_5Config has as Qwen3VLConfig does).  Its sharding
    is not ported: the loader refuses --tp before this runs."""

    rank_model = None

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


def load_qwen3_5(entry: ModelEntry, path: str, gguf: str | None = None,
                 mmproj: str | None = None, max_seq_len: int = 8192,
                 **kw) -> LoadedModel:
    """The reference's dispatch: the GGUF entry refuses slots with an
    mmproj and --tp / --dp with its words, then loads the file
    (load_qwen3_5_gguf_chat); a checkpoint with a vision tower refuses
    `batch_slots > 1` (VL_SLOTS) before any weights load and is served by
    Qwen3_5VLChat; a text-only one by Qwen3_5Chat."""
    if entry.is_gguf:
        if kw.get("batch_slots", 1) > 1 and mmproj is not None:
            raise ValueError(GGUF_MMPROJ_SLOTS)
        if kw.get("tp", 1) > 1 or kw.get("dp", 1) > 1:
            raise ValueError(GGUF_PARALLEL)
        return load_qwen3_5_gguf_chat(
            entry, gguf, mmproj=mmproj, max_seq_len=max_seq_len,
            batch_slots=kw.get("batch_slots", 1),
            cuda_graphs=kw.get("cuda_graphs", True))
    if Qwen3_5Config.from_file(path).vision is not None:
        if kw.get("batch_slots", 1) > 1:
            raise ValueError(VL_SLOTS)
        return Qwen3_5VLChat.load(entry, path, max_seq_len=max_seq_len, **kw)
    return Qwen3_5Chat.load_decoder(entry, path, Qwen3_5Model,
                                    Qwen3_5TextConfig,
                                    max_seq_len=max_seq_len, **kw)


def load_qwen3_5_gguf_chat(entry: ModelEntry, gguf_path: str,
                           mmproj: str | None = None,
                           max_seq_len: int = 8192, batch_slots: int = 1,
                           cuda_graphs: bool = True) -> TextChatModel:
    """A qwen35 .gguf → chat on the port's device, the linears on the
    quantized grids; tokenizer, chat template and eos from the file's
    metadata.  With `mmproj` the Qwen3-VL tower loads from that file and
    Qwen3_5VLChat serves image and video chat on one stream; else
    Qwen3_5Chat on a TextEngine, or a BatchEngine of `batch_slots` slots.
    No prefix store, as the reference builds its engines
    (aha_tpu/models/qwen3_5_served.py:113-160)."""
    from aha_tpu_torch.io.gguf_models import (load_qwen3_5_gguf,
                                              load_qwen3_5_gguf_vl)

    vl_config = None
    if mmproj is not None:
        model, params, gf, vl_config = load_qwen3_5_gguf_vl(
            gguf_path, mmproj, max_rope_len=max_seq_len)
    else:
        model, params, gf = load_qwen3_5_gguf(gguf_path,
                                              max_rope_len=max_seq_len)
    eos = gf.eos_token_id()
    eos_ids = [eos] if eos is not None else []
    cache_dtype = embed_weight(params).dtype
    if batch_slots > 1:
        engine = BatchEngine(model, params, eos_token_ids=eos_ids,
                             slots=batch_slots, cache_dtype=cache_dtype,
                             max_seq_len=max_seq_len,
                             cuda_graphs=cuda_graphs)
    else:
        engine = TextEngine(model, params, eos_token_ids=eos_ids,
                            cache_dtype=cache_dtype, max_seq_len=max_seq_len,
                            cuda_graphs=cuda_graphs)
    tokenizer = TokenizerModel(gf.build_tokenizer())
    template = gf.chat_template()
    if template is None:
        raise ValueError(GGUF_NO_TEMPLATE)
    name = os.path.basename(gguf_path.rstrip("/")) or entry.name
    cls = Qwen3_5VLChat if vl_config is not None else Qwen3_5Chat
    served = cls(entry, engine, tokenizer, ChatTemplate.str_init(template),
                 {}, model_name=name)
    if vl_config is not None:
        served.vl_config = vl_config
    served.concurrent_streams = max(1, batch_slots)
    return served
