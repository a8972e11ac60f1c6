"""Qwen2.5-VL served model: image chat on the port's TextEngine
(counterpart of aha_tpu/models/qwen2_5vl_served.py's Qwen2_5VLChat).

Qwen-VL processing: smart resize to the factor-28 grid, CLIP
normalization, <|image_pad|> expanded to the number of merge units per
image.  A video part (utils/video.py) is sampled at 2 fps (4 to 64
frames), resized under a budget counted over its frames, patchified in
temporal pairs and its <|video_pad|> expanded the same way; its temporal
M-RoPE interval is `second_per_grid_ts` (temporal_patch_size / fps),
which also enters the content digest.  The patch buffer and every
grid-derived index are padded to a patch bucket (256 … 16384 patches: pad
rows carry seg = -1), and the M-RoPE position ids to the engine's prompt
bucket, as in the JAX package.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os

import numpy as np

from aha_tpu_torch.core.engine import bucket_for
from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLConfig, Qwen2_5VLModel,
                                            check_tp, get_rope_index,
                                            vision_geometry)
from aha_tpu_torch.models.text_served import TextChatModel, decoder_rank
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype

IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"
PATCH_BUCKETS = (256, 512, 1024, 2048, 4096, 6400, 9216, 16384)
MIN_PIXELS = 56 * 56
MAX_PIXELS = 14 * 14 * 4 * 1280


def patch_bucket(n: int) -> int:
    for b in PATCH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"the request's images give {n} patches; the largest "
                     f"patch bucket is {PATCH_BUCKETS[-1]}")


def _pad(a: np.ndarray, fill, size: int) -> np.ndarray:
    out = np.full((size,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


def rope_ids_to_bucket(position_ids: np.ndarray) -> np.ndarray:
    """(3, S) M-RoPE ids padded to the engine's prompt bucket: the padded
    positions continue past the prompt's largest."""
    extra = bucket_for(position_ids.shape[1]) - position_ids.shape[1]
    if extra <= 0:
        return position_ids
    cont = position_ids.max() + 1 + np.arange(extra)
    return np.concatenate([position_ids, np.broadcast_to(cont, (3, extra))],
                          axis=1)


def expand_image(rendered: str, src: str, v, min_pixels: int,
                 max_pixels: int) -> tuple[str, np.ndarray, tuple]:
    """One image part: loaded and preprocessed on the Qwen-VL grid of the
    vision config `v`, the prompt's first <|image_pad|> expanded to one
    "<|placeholder|>" a merge unit (get_data turns them back into
    <|image_pad|> after every part is placed).  Returns the prompt, the
    patches and the grid."""
    from aha_tpu_torch.utils.image import load_image, preprocess_image_qwen_vl

    patches, grid = preprocess_image_qwen_vl(
        load_image(src), patch_size=v.patch_size,
        merge_size=v.spatial_merge_size,
        temporal_patch_size=v.temporal_patch_size, min_pixels=min_pixels,
        max_pixels=max_pixels)
    n_units = grid[0] * grid[1] * grid[2] // v.spatial_merge_size ** 2
    return (rendered.replace(IMAGE_PAD, "<|placeholder|>" * n_units, 1),
            patches, grid)


def build_mm(patches_list: list[np.ndarray], grids: list[tuple],
             input_ids: list[int], cfg: Qwen2_5VLConfig,
             second_per_grid_ts: list[float] | None = None) -> dict:
    """The host inputs of one multimodal prefill, as numpy: the patches and
    grid indices padded to their patch bucket, the (3, S) M-RoPE position
    ids padded to the prompt bucket (positions continue past the prompt),
    and rope_delta.  `second_per_grid_ts` (one a grid; 0.0 for an image)
    spaces a video's temporal positions."""
    v = cfg.vision
    unit = v.spatial_merge_size ** 2
    geo = vision_geometry(grids, v)
    patches = np.concatenate(patches_list)
    n_real = patches.shape[0]
    bucket = patch_bucket(n_real)
    mm = {
        "patches": _pad(patches.astype(np.float32), 0.0, bucket),
        "window_index": _pad(geo["window_index"], 0, bucket // unit),
        "inverse_index": _pad(geo["inverse_index"], 0, bucket // unit),
        "window_seg": _pad(geo["window_seg"], -1, bucket),
        "full_seg": _pad(geo["full_seg"], -1, bucket),
        "pos_hw": _pad(geo["pos_hw"], 0, bucket),
    }
    position_ids, rope_delta = get_rope_index(
        input_ids, grids, cfg, second_per_grid_ts=second_per_grid_ts)
    mm["position_ids"] = rope_ids_to_bucket(position_ids)
    mm["rope_delta"] = rope_delta
    return mm


def mm_digest(patches_list: list[np.ndarray], grids: list[tuple],
              second_per_grid_ts: list[float] | None = None) -> str:
    """Digest of the vision CONTENT (decoded patches, grids and each grid's
    temporal seconds), not of the source URL: a mutable URL must not hit
    stale cached KV, and the same frames at another source fps take other
    M-RoPE positions."""
    h = hashlib.sha256(np.ascontiguousarray(
        np.concatenate(patches_list)).tobytes())
    ts = second_per_grid_ts or [0.0] * len(grids)
    for grid, t in zip(grids, ts):
        h.update(repr((tuple(grid), float(t))).encode())
    return h.hexdigest()


class Qwen2_5VLChat(TextChatModel):
    vl_model: Qwen2_5VLModel
    #: the resize bounds (preprocessor_config.json's, else Qwen-VL's)
    min_pixels: int = MIN_PIXELS
    max_pixels: int = MAX_PIXELS

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "Qwen2_5VLChat":
        """One stream on the TextEngine (`batch_slots > 1` is refused:
        the continuous-batching engine takes text models only).  `tp > 1`
        shards the model over tp ranks (decoder_rank), after check_tp
        refuses a tp that does not divide it (the JAX package's
        aha_tpu/models/qwen2_5vl_served.py:57-72)."""
        if kw.get("batch_slots", 1) > 1:
            raise ValueError("--batch-slots > 1 serves text models; "
                             "Qwen2.5-VL runs one stream (--batch-slots 1)")
        tp = kw.get("tp", 1)
        if tp > 1:
            check_tp(Qwen2_5VLConfig.from_file(path), tp)

        def build(path, max_seq_len):
            dev = device()
            model = Qwen2_5VLModel(Qwen2_5VLConfig.from_file(path),
                                   max_rope_len=max_seq_len, device=dev)
            return model, model.load_params(open_weights(path),
                                            dtype=get_dtype(dev))

        served = super().load(entry, path, build, max_seq_len=max_seq_len,
                              prefix_cache=kw.get("prefix_cache", 4),
                              spec_tokens=kw.get("spec_tokens", 0),
                              cuda_graphs=kw.get("cuda_graphs", True),
                              tp=tp, build_rank=functools.partial(
                                  decoder_rank, Qwen2_5VLModel,
                                  Qwen2_5VLConfig, path, max_seq_len))
        pp = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
        served.vl_model = served.engine.model
        served.min_pixels = pp.get("min_pixels", MIN_PIXELS)
        served.max_pixels = pp.get("max_pixels", MAX_PIXELS)
        return served

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.video import (extract_vision_parts,
                                               load_video_frames,
                                               preprocess_video_qwen_vl,
                                               sample_frames)

        cfg = self.vl_model.config
        v = cfg.vision
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True,
            enable_thinking=bool(mes.enable_thinking))
        parts = extract_vision_parts(mes)
        if not parts:
            return PrepareData(input_ids=self.tokenizer.encode(rendered),
                               in_reasoning=self.is_in_reasoning(rendered))

        merge_len = v.spatial_merge_size ** 2
        patches_list, grids, second_per_grid_ts = [], [], []
        for kind, src in parts:
            if kind == "image":
                rendered, patches, grid = expand_image(
                    rendered, src, v, self.min_pixels, self.max_pixels)
                second_per_grid_ts.append(0.0)
            else:
                frames, src_fps = load_video_frames(src)
                frames, _, fps = sample_frames(frames, src_fps,
                                               target_fps=2.0, min_frames=4,
                                               max_frames=64)
                patches, grid = preprocess_video_qwen_vl(
                    frames, v.patch_size, v.spatial_merge_size,
                    v.temporal_patch_size, self.min_pixels,
                    self.max_pixels * 4)
                n_units = grid[0] * grid[1] * grid[2] // merge_len
                rendered = rendered.replace(
                    VIDEO_PAD, "<|vplaceholder|>" * n_units, 1)
                # the temporal M-RoPE interval (HF Qwen2.5-VL's)
                second_per_grid_ts.append(v.temporal_patch_size / fps)
            patches_list.append(patches)
            grids.append(grid)
        rendered = rendered.replace("<|placeholder|>", IMAGE_PAD)
        rendered = rendered.replace("<|vplaceholder|>", VIDEO_PAD)
        input_ids = self.tokenizer.encode(rendered)
        mm = build_mm(patches_list, grids, input_ids, cfg,
                      second_per_grid_ts)
        return PrepareData(
            input_ids=input_ids, mm=mm,
            in_reasoning=self.is_in_reasoning(rendered),
            mm_key=mm_digest(patches_list, grids, second_per_grid_ts),
            mm_token_ids=(cfg.image_token_id, cfg.video_token_id))
