"""GLM-OCR served model: document OCR on the port's TextEngine
(counterpart of aha_tpu/models/glm_ocr_served.py's GlmOcrChat).

The prompt is the reference's fixed frame with hard-coded ids
(processor.rs:158-186): `[gMASK] <sop> <|user|> \\n`, each image as
<|begin_of_image|> <|image|> x units <|end_of_image|>, the user turns'
text (or "Extract all text from this image."), `<|assistant|> \\n`.  Each
image is smart-resized with PIL's Lanczos at factor patch · merge within
the preprocessor's pixel budget divided by temporal_patch_size (the
video rule at t = 2), normalized with its mean / std (CLIP's by default)
and cut by `patchify_qwen_vl` into merge-blocked patches; the patches and
their cos / sin and position-resample rows are padded to a patch bucket
(256 ... 9,216) with a key mask, the M-RoPE ids to the prompt bucket;
rope_delta rides along.  A request whose images give more patches than
the largest bucket is refused with a ValueError before anything reaches
the card.  One stream without a prefix store, as the JAX package builds
it.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from aha_tpu_torch.core.engine import bucket_for
from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.models.glm_ocr import (GlmOcrConfig, GlmOcrModel,
                                          check_tp,
                                          glm_pos_resample_matrix,
                                          glm_rope_index,
                                          glm_vision_geometry,
                                          glm_vision_rope)
# the same patch buckets (256 ... 9,216) and refusal as HunyuanOCR's
from aha_tpu_torch.models.hunyuan_ocr_served import patch_bucket
from aha_tpu_torch.models.qwen3 import load_stop_token_ids
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              load_generation_config,
                                              rank_builder, start_engine)
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry

GMASK, SOP, USER, NL, ASSISTANT = 59248, 59250, 59253, 10, 59254
DEFAULT_PROMPT = "Extract all text from this image."


def build_mm(patches_list: list[np.ndarray],
             grids: list[tuple[int, int, int]], input_ids: list[int],
             cfg: GlmOcrConfig) -> dict:
    """The host inputs of one image prefill, as numpy: the blocked patches,
    their vision cos / sin and position-resample rows padded to the patch
    bucket with an additive key mask, the (3, S) M-RoPE ids padded to the
    prompt bucket (the padded columns continue past the largest id) and
    rope_delta (an int).  Raises past the largest patch bucket."""
    v = cfg.vision
    patches = np.concatenate(patches_list).astype(np.float32)
    n = patches.shape[0]
    bucket = patch_bucket(n)
    geom = glm_vision_geometry(grids, v)
    cos, sin = glm_vision_rope(geom["h"], geom["w"], v)
    resample = glm_pos_resample_matrix(geom, grids,
                                       v.image_size // v.patch_size)

    def pad(a):
        out = np.zeros((bucket,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out

    pmask = np.zeros((1, 1, 1, bucket), np.float32)
    pmask[..., n:] = np.finfo(np.float32).min
    position_ids, rope_delta = glm_rope_index(input_ids, grids, cfg)
    extra = bucket_for(len(input_ids)) - position_ids.shape[1]
    if extra > 0:
        cont = position_ids.max() + 1 + np.arange(extra)
        position_ids = np.concatenate(
            [position_ids, np.broadcast_to(cont, (3, extra))], axis=1)
    return {"patches": pad(patches), "vis_cos": pad(cos),
            "vis_sin": pad(sin), "pos_resample": pad(resample),
            "patch_mask": pmask, "position_ids": position_ids,
            "rope_delta": int(rope_delta)}


def image_patches(img, v, pp: dict) -> tuple[np.ndarray, tuple[int, int,
                                                               int]]:
    """One image → its merge-blocked patches and grid (t, gh, gw): smart
    resize (Lanczos) at factor patch · merge within the pixel budget over
    temporal_patch_size, mean / std normalization, `patchify_qwen_vl`."""
    from PIL import Image

    from aha_tpu_torch.utils.image import patchify_qwen_vl, smart_resize

    size = pp.get("size", {})
    factor = pp.get("patch_size", v.patch_size) * pp.get(
        "merge_size", v.spatial_merge_size)
    mean = np.asarray(pp.get("image_mean", [0.48145466, 0.4578275,
                                            0.40821073]), np.float32)
    std = np.asarray(pp.get("image_std", [0.26862954, 0.26130258,
                                          0.27577711]), np.float32)
    min_px = size.get("shortest_edge", 12544)
    max_px = size.get("longest_edge", 9633792)
    tps = pp.get("temporal_patch_size", v.temporal_patch_size)
    w, h = img.size
    # video_smart_resize at t = tps: the pixel budget scaled by the frames
    h2, w2 = smart_resize(h, w, factor, min_px // tps, max_px // tps)
    img = img.resize((w2, h2), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    arr = ((arr - mean) / std).transpose(2, 0, 1)
    return patchify_qwen_vl(arr[None], v.patch_size, v.spatial_merge_size,
                            tps)


class GlmOcrChat(TextChatModel):
    glm_model: GlmOcrModel
    #: preprocessor_config.json (size limits, mean / std, patch, merge)
    preprocessor: dict

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "GlmOcrChat":
        """One stream on a TextEngine without a prefix store, on the
        device rule's card in its dtype (bf16 there); the fixed prompt
        frame needs no chat template; `batch_slots > 1` is refused by the
        loader before this runs.  `tp > 1` shards the model over tp ranks
        (text_served.rank_builder), after check_tp refuses a tp that does
        not divide it."""
        tp = kw.get("tp", 1)
        engine, ranks = start_engine(
            entry, path, functools.partial(decoder_rank, GlmOcrModel,
                                           GlmOcrConfig),
            load_stop_token_ids(path), max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(GlmOcrModel, GlmOcrConfig, path,
                                    max_seq_len, tp, check_tp))
        served = cls(entry, engine, TokenizerModel.init(path), None,
                     load_generation_config(path),
                     model_name=os.path.basename(path.rstrip("/"))
                     or entry.name)
        served.ranks = ranks
        served.glm_model = engine.model
        pp = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
        served.preprocessor = pp
        return served

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.image import extract_image_sources, load_image

        cfg = self.glm_model.config
        v = cfg.vision
        sources = extract_image_sources(mes)
        prompt = " ".join(m.text() for m in mes.messages
                          if m.role == "user" and m.text()).strip()
        text = self.tokenizer.encode(prompt or DEFAULT_PROMPT,
                                     add_special_tokens=False)
        if not sources:
            return PrepareData(input_ids=[GMASK, SOP, USER, NL] + text
                               + [ASSISTANT, NL])
        patches_list, grids = [], []
        ids = [GMASK, SOP, USER, NL]
        m = v.spatial_merge_size
        for src in sources:
            patches, grid = image_patches(load_image(src), v,
                                          self.preprocessor)
            patches_list.append(patches)
            grids.append(grid)
            ids += ([cfg.image_start_token_id]
                    + [cfg.image_token_id] * (grid[0] * (grid[1] // m)
                                              * (grid[2] // m))
                    + [cfg.image_end_token_id])
        ids += text + [ASSISTANT, NL]
        mm = build_mm(patches_list, grids, ids, cfg)
        return PrepareData(input_ids=ids, mm=mm)
