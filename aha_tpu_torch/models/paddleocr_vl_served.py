"""PaddleOCR-VL served model: document OCR on the port's TextEngine
(counterpart of aha_tpu/models/paddleocr_vl_served.py's PaddleOCRVLChat).

Task prompts ("OCR:", "Table Recognition:", ...) come from the user
message; the chat template inserts <|IMAGE_PLACEHOLDER|>, expanded to one
token a merge unit.  Each image is smart-resized to the factor-28 grid
between preprocessor_config.json's min and max pixels, normalized with its
scalar mean / std, and patchified row-major; the patch buffer and every
grid index are padded to a patch bucket (256 ... 16384 patches: pad rows
carry seg = -1), the M-RoPE ids to the engine's prompt bucket.  One stream
without a prefix store, as the JAX package builds it.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.models.paddleocr_vl import (PaddleOCRVLConfig,
                                               PaddleOCRVLModel, check_tp,
                                               get_rope_index,
                                               paddle_vision_geometry)
# the same patch buckets (256 ... 16384) as Qwen2.5-VL's
from aha_tpu_torch.models.qwen2_5vl_served import (_pad, patch_bucket,
                                                    rope_ids_to_bucket)
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              rank_builder)
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry

IMAGE_PLACEHOLDER = "<|IMAGE_PLACEHOLDER|>"


def build_mm(patches_list: list[np.ndarray], grids: list[tuple],
             input_ids: list[int], cfg: PaddleOCRVLConfig) -> dict:
    """The host inputs of one image prefill, as numpy: the patches, their
    coordinates, 4-tap position indices, segments and the merge gather
    padded to the patch bucket, the (3, S) M-RoPE ids padded to the prompt
    bucket (positions continue past the prompt), and rope_delta."""
    geo = paddle_vision_geometry(grids, cfg.vision)
    patches = np.concatenate(patches_list).astype(np.float32)
    bucket = patch_bucket(patches.shape[0])
    mm = {"patches": _pad(patches, 0.0, bucket),
          "seg": _pad(geo["seg"], -1, bucket),
          "pos_hw": _pad(geo["pos_hw"], 0, bucket),
          "pos_idx": _pad(geo["pos_idx"], 0, bucket),
          "pos_w": _pad(geo["pos_w"], 0.0, bucket),
          "merge_gather": _pad(geo["merge_gather"], 0, bucket)}
    position_ids, rope_delta = get_rope_index(input_ids, grids, cfg)
    mm["position_ids"] = rope_ids_to_bucket(position_ids)
    mm["rope_delta"] = rope_delta
    return mm


class PaddleOCRVLChat(TextChatModel):
    vl_model: PaddleOCRVLModel
    #: preprocessor_config.json (min / max pixels, image mean / std)
    preprocessor: dict

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "PaddleOCRVLChat":
        """One stream on a TextEngine without a prefix store; `batch_slots
        > 1` is refused by the loader before this runs.  `tp > 1` shards
        the model over tp ranks (text_served.rank_builder), after check_tp
        refuses a tp that does not divide it."""
        tp = kw.get("tp", 1)
        build = functools.partial(decoder_rank, PaddleOCRVLModel,
                                  PaddleOCRVLConfig)
        served = super().load(
            entry, path, build, max_seq_len=max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(PaddleOCRVLModel, PaddleOCRVLConfig,
                                    path, max_seq_len, tp, check_tp))
        served.vl_model = served.engine.model
        pp = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
        served.preprocessor = pp
        return served

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.image import (extract_image_sources,
                                               load_image,
                                               preprocess_image_siglip)

        cfg = self.vl_model.config
        v = cfg.vision
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True)
        sources = extract_image_sources(mes)
        if not sources:
            return PrepareData(input_ids=self.tokenizer.encode(rendered))

        pp = self.preprocessor
        mean = pp.get("image_mean", [0.5] * 3)[0]
        std = pp.get("image_std", [0.5] * 3)[0]
        min_px = pp.get("min_pixels", 28 * 28)
        max_px = pp.get("max_pixels", 28 * 28 * 4096)
        patches_list, grids = [], []
        for src in sources:
            patches, grid = preprocess_image_siglip(
                load_image(src), patch_size=v.patch_size,
                merge_size=v.spatial_merge_size, min_pixels=min_px,
                max_pixels=max_px, mean=mean, std=std)
            patches_list.append(patches)
            grids.append(grid)
            n_units = grid[0] * grid[1] * grid[2] // v.spatial_merge_size ** 2
            rendered = rendered.replace(IMAGE_PLACEHOLDER,
                                        "<|tmp_ph|>" * n_units, 1)
        rendered = rendered.replace("<|tmp_ph|>", IMAGE_PLACEHOLDER)
        input_ids = self.tokenizer.encode(rendered)
        mm = build_mm(patches_list, grids, input_ids, cfg)
        return PrepareData(input_ids=input_ids,
                           mm=mm)
