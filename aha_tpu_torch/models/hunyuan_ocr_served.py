"""HunyuanOCR served model: document OCR on the port's TextEngine
(counterpart of aha_tpu/models/hunyuan_ocr_served.py's HunyuanOCRChat).

The checkpoint's chat template renders the messages; each image marker
`<｜hy_place▁holder▁no▁102｜>` expands to ph·(pw + 1) + 2 tokens through
the no-799 placeholder (the reference's trick: the expansion is written
as placeholders first, then turned back into image markers).  Each image
is smart-resized to the factor patch · merge grid between
preprocessor_config.json's min and max pixels with PIL's bicubic,
normalized with its mean / std (0.5 / 0.5 by default) and patchified
row-major; the patches are padded to a patch bucket (256 ... 9,216) with a
key mask, the 4-channel position ids to the engine's prompt bucket.  A
request whose images give more patches than the largest bucket is refused
with a ValueError before anything reaches the card (the JAX package's
padding fails on it with a numpy broadcast error).  Sampling defaults
come from generation_config.json (generate.rs:68-78).  One stream without
a prefix store, as the JAX package builds it.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from aha_tpu_torch.core.engine import bucket_for
from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.core.chat_template import ChatTemplate
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.models.hunyuan_ocr import (HunyuanOCRConfig,
                                              HunyuanOCRModel, check_tp,
                                              hunyuan_pos_weights,
                                              hunyuan_position_ids,
                                              hunyuan_vision_geometry)
from aha_tpu_torch.models.qwen3 import load_stop_token_ids
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              load_generation_config,
                                              rank_builder, start_engine)
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry

IMAGE_TOKEN = "<｜hy_place▁holder▁no▁102｜>"
PLACEHOLDER = "<｜hy_place▁holder▁no▁799｜>"
PATCH_BUCKETS = (256, 512, 1024, 2048, 4096, 9216)


def patch_bucket(n: int) -> int:
    """The smallest bucket of `n` patches; past the largest, a ValueError
    naming both (the JAX package takes the largest and then fails to pad
    into it)."""
    for b in PATCH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"the request's images give {n} patches; the largest "
                     f"patch bucket is {PATCH_BUCKETS[-1]}: send a smaller "
                     f"image or lower max_pixels")


def build_mm(patches_list: list[np.ndarray],
             grids: list[tuple[int, int, int]], input_ids: list[int],
             cfg: HunyuanOCRConfig, merge: int | None = None) -> dict:
    """The host inputs of one image prefill, as numpy (the grids a tuple):
    the patches padded to their bucket with an additive key mask, each
    image's two 1-D position-resize weights stacked over the images, the
    merge-unit and token gathers (units padded to bucket / m²), and the
    (4, S) position ids padded to the prompt bucket (the padded columns
    continue the sequence channel on all four).  Raises past the largest
    patch bucket.  `merge`: preprocessor_config's merge_size (the
    tower's by default)."""
    v = cfg.vision
    m = merge or v.spatial_merge_size
    patches = np.concatenate(patches_list).astype(np.float32)
    n = patches.shape[0]
    bucket = patch_bucket(n)
    padded = np.zeros((bucket, patches.shape[1]), np.float32)
    padded[:n] = patches
    weights = hunyuan_pos_weights(grids, v.table_grid)
    n_units = sum((gh // m) * (gw // m) for _, gh, gw in grids)
    unit_gather, token_gather = hunyuan_vision_geometry(
        grids, m, max(bucket // (m * m), n_units))
    pmask = np.zeros((1, 1, 1, bucket), np.float32)
    pmask[..., n:] = np.finfo(np.float32).min
    position_ids = hunyuan_position_ids(input_ids, grids, m,
                                        cfg.image_token_id)
    extra = bucket_for(len(input_ids)) - position_ids.shape[1]
    if extra > 0:
        cont = position_ids[0, -1] + 1 + np.arange(extra)
        position_ids = np.concatenate(
            [position_ids, np.broadcast_to(cont, (4, extra))], axis=1)
    return {"patches": padded,
            "pos_wh": np.concatenate([wh for wh, _ in weights]),
            "pos_ww": np.concatenate([ww for _, ww in weights]),
            "grids": tuple(tuple(int(x) for x in g) for g in grids),
            "patch_mask": pmask, "unit_gather": unit_gather,
            "token_gather": token_gather, "position_ids": position_ids}


def image_patches(img, v, pp: dict) -> tuple[np.ndarray, tuple[int, int,
                                                               int]]:
    """One image → its row-major (gh·gw, 3·p·p) float32 patches and grid
    (1, gh, gw): smart resize at factor patch · merge within
    preprocessor_config's pixel limits (PIL bicubic), mean / std
    normalization."""
    from PIL import Image

    from aha_tpu_torch.utils.image import smart_resize

    mean = np.asarray(pp.get("image_mean", [0.5] * 3), np.float32)
    std = np.asarray(pp.get("image_std", [0.5] * 3), np.float32)
    merge = pp.get("merge_size", v.spatial_merge_size)
    psz = pp.get("patch_size", v.patch_size)
    factor = psz * merge
    min_px = pp.get("min_pixels", factor * factor)
    max_px = pp.get("max_pixels", 16384 * 28 * 28)
    w, h = img.size
    h2, w2 = smart_resize(h, w, factor, min_px, max_px)
    img = img.resize((w2, h2), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = ((arr - mean) / std).transpose(2, 0, 1)
    gh, gw = h2 // psz, w2 // psz
    # row-major patches (processor.rs:75-112)
    x = arr.reshape(3, gh, psz, gw, psz).transpose(1, 3, 0, 2, 4)
    return x.reshape(gh * gw, -1).astype(np.float32), (1, gh, gw)


class HunyuanOCRChat(TextChatModel):
    hy_model: HunyuanOCRModel
    #: preprocessor_config.json (pixel limits, mean / std, patch, merge)
    preprocessor: dict

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "HunyuanOCRChat":
        """One stream on a TextEngine without a prefix store, on the
        device rule's card in its dtype (bf16 there); `batch_slots > 1` is
        refused by the loader before this runs.  `tp > 1` shards the model
        over tp ranks (text_served.rank_builder), after check_tp refuses
        a tp that does not divide it."""
        tp = kw.get("tp", 1)
        engine, ranks = start_engine(
            entry, path, functools.partial(decoder_rank, HunyuanOCRModel,
                                           HunyuanOCRConfig),
            load_stop_token_ids(path), max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(HunyuanOCRModel, HunyuanOCRConfig, path,
                                    max_seq_len, tp, check_tp))
        served = cls(entry, engine, TokenizerModel.init(path),
                     ChatTemplate.init(path), load_generation_config(path),
                     model_name=os.path.basename(path.rstrip("/"))
                     or entry.name)
        served.ranks = ranks
        served.hy_model = engine.model
        pp = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
        served.preprocessor = pp
        return served

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.image import extract_image_sources, load_image

        cfg = self.hy_model.config
        merge = self.preprocessor.get("merge_size",
                                      cfg.vision.spatial_merge_size)
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True)
        sources = extract_image_sources(mes)
        if not sources:
            return PrepareData(input_ids=self.tokenizer.encode(rendered))
        patches_list, grids = [], []
        for src in sources:
            patches, grid = image_patches(load_image(src), cfg.vision,
                                          self.preprocessor)
            patches_list.append(patches)
            grids.append(grid)
            n_tok = (grid[1] // merge) * (grid[2] // merge + 1) + 2
            rendered = rendered.replace(IMAGE_TOKEN, PLACEHOLDER * n_tok, 1)
        rendered = rendered.replace(PLACEHOLDER, IMAGE_TOKEN)
        ids = self.tokenizer.encode(rendered)
        mm = build_mm(patches_list, grids, ids, cfg, merge)
        return PrepareData(input_ids=ids, mm=mm)
