"""DeepSeek-OCR served model (counterpart of
aha_tpu/models/deepseek_ocr_served.py's DeepseekOCRChat).

No chat template: the messages' text is joined with newlines, the
`<image>` marker splits the prompt, and each image expands to its Gundam
layout's token count.  Metadata knobs (strings on the wire): base_size /
image_size, one of 512 / 640 / 1024 / 1280 (640 otherwise), and
crop_mode; version 2 pins base 1024 / image 768; crop_mode forces the
tile size (640, v2 768) on image_size.  One stream on a TextEngine
without a prefix store, eos = [eos, bos], as the JAX package builds it.

The JAX package pads the crop batch to CROP_BUCKETS and the gather index
to VIS_BUCKETS, static shapes for its jit; the port encodes the real
crops only and builds the gather index for them (crop_rows_total=None),
which gives the same rows at the image tokens.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.models.deepseek_ocr import (DeepseekOCRConfig,
                                               DeepseekOCRModel, check_tp,
                                               deepseek_vision_layout)
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              load_generation_config,
                                              rank_builder, start_engine)
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry

IMAGE_TOKEN = "<image>"
ALLOWED_SIZES = (512, 640, 1024, 1280)
#: pixels of a SAM patch times its 4x downsampling: one query a side each
QUERY_PX = 16 * 4


def _meta(mes, key, default):
    """A metadata knob: "true" / "false" → bool, digits → int, anything
    else the default."""
    v = (getattr(mes, "metadata", None) or {}).get(key)
    if v is None:
        return default
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("true", "false"):
            return s == "true"
        try:
            return int(s)
        except ValueError:
            return default
    return v


def image_views(img, version: int, base_size: int, image_size: int,
                crop_mode: bool) -> tuple[np.ndarray, list, dict, int]:
    """One image's views (processor.rs:54-201): (the global view (3, S,
    S), the crop tiles, its layout entry, its token count)."""
    from aha_tpu_torch.utils.image import (dynamic_preprocess,
                                           img_transform,
                                           resize_with_edge_padding)

    min_img_size = 768 if version == 2 else 640
    max_num = 6 if version == 2 else 9
    nq, nqb = image_size // QUERY_PX, base_size // QUERY_PX
    newline = version == 1
    if not crop_mode:
        if image_size <= min_img_size:
            from PIL import Image

            gview = img.resize((image_size, image_size), Image.BICUBIC)
        else:
            gview = resize_with_edge_padding(img, image_size, image_size)
        return (img_transform(gview), [],
                {"nq": nq, "nb": nq, "wr": 1, "hr": 1},
                nq * nq + (nq if newline else 0) + 1)
    crops = []
    w, h = img.size
    if h <= min_img_size and w <= min_img_size:
        wr, hr = 1, 1
    else:
        tiles, (wr, hr) = dynamic_preprocess(img, 2, max_num, min_img_size)
        if wr * hr > 1:
            crops = [img_transform(t) for t in tiles]
    gview = resize_with_edge_padding(img, base_size, base_size)
    n_tok = nqb * nqb + (nqb if newline else 0) + 1
    if wr > 1 or hr > 1:
        n_tok += (nq * wr + newline) * (nq * hr)
    return (img_transform(gview), crops,
            {"nq": min_img_size // QUERY_PX, "nb": nqb, "wr": wr, "hr": hr},
            n_tok)


def build_mm(views: list[tuple], version: int) -> dict:
    """The host inputs of one request's images (image_views' outputs), as
    numpy: "global" (n, 3, S, S), "crops" (c, 3, s, s) where any image was
    tiled, and "gather_idx", the token-order index over their projected
    rows, one entry an image token."""
    mm = {"global": np.stack([v[0] for v in views])}
    crops = [t for v in views for t in v[1]]
    if crops:
        mm["crops"] = np.stack(crops)
    mm["gather_idx"] = deepseek_vision_layout([v[2] for v in views], version)
    return mm


class DeepseekOCRChat(TextChatModel):
    ocr_model: DeepseekOCRModel

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "DeepseekOCRChat":
        """One stream on a TextEngine without a prefix store; `batch_slots
        > 1` is refused by the loader before this runs.  `tp > 1` shards
        the model over tp ranks, the routed experts expert-parallel
        (text_served.rank_builder), after check_tp refuses a tp that does
        not divide it."""
        tp = kw.get("tp", 1)
        lc = DeepseekOCRConfig.from_file(path).language
        engine, ranks = start_engine(
            entry, path, functools.partial(decoder_rank, DeepseekOCRModel,
                                           DeepseekOCRConfig),
            [lc.eos_token_id, lc.bos_token_id], max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(DeepseekOCRModel, DeepseekOCRConfig,
                                    path, max_seq_len, tp, check_tp))
        served = cls(entry, engine, TokenizerModel.init(path), None,
                     load_generation_config(path),
                     model_name=os.path.basename(path.rstrip("/"))
                     or entry.name)
        served.ranks = ranks
        served.ocr_model = engine.model
        return served

    def _prompt(self, mes: ChatCompletionParameters) -> str:
        """The messages' text, user turns followed by a newline
        (processor.rs:37-52)."""
        parts = []
        for i, m in enumerate(mes.messages):
            text = m.text()
            if text:
                parts.append(text + ("\n" if i % 2 == 0 else ""))
        return "".join(parts).strip()

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.image import extract_image_sources, load_image

        cfg = self.ocr_model.config
        version = cfg.version
        base_size = int(_meta(mes, "base_size", 640))
        image_size = int(_meta(mes, "image_size", 640))
        if base_size not in ALLOWED_SIZES:
            base_size = 640
        if image_size not in ALLOWED_SIZES:
            image_size = 640
        if version == 2:
            base_size, image_size = 1024, 768
        crop_mode = bool(_meta(mes, "crop_mode", False))
        if crop_mode:
            # tiles are always the minimum image size, and the crop views'
            # query count must match them
            image_size = 768 if version == 2 else 640

        prompt = self._prompt(mes)
        splits = prompt.split(IMAGE_TOKEN)
        sources = extract_image_sources(mes)
        ids = [cfg.language.bos_token_id]
        if not sources:
            ids += self.tokenizer.encode(prompt, add_special_tokens=False)
            return PrepareData(input_ids=ids)

        views = []
        for text_seq, src in zip(splits, sources):
            if text_seq:
                ids += self.tokenizer.encode(text_seq,
                                             add_special_tokens=False)
            views.append(image_views(load_image(src), version, base_size,
                                     image_size, crop_mode))
            ids += [cfg.image_token_id] * views[-1][3]
        if len(splits) > len(sources) and splits[-1]:
            ids += self.tokenizer.encode(splits[-1], add_special_tokens=False)
        dev = self.engine.device
        return PrepareData(input_ids=ids, mm={
            k: torch.from_numpy(v).to(dev)
            for k, v in build_mm(views, version).items()})
