"""Qwen3-VL served model: image and video chat on the port's TextEngine
(counterpart of aha_tpu/models/qwen3vl_served.py's Qwen3VLChat).

Qwen-VL processing on the factor-32 grid (patch 16 x merge 2), CLIP
normalization, <|image_pad|> expanded per merge unit.  A video is sampled
at 2 fps (4 to `max_video_frames` frames), resized under a budget counted
over its frames, and laid out as timestamped frames — "<t seconds>"
then <|vision_start|>, the frame's <|video_pad|> tokens, <|vision_end|>
for each temporal pair — so the rope index sees one (1, h, w) grid a
frame.  The patch buffer and its indices are padded to a patch bucket
(pad rows carry seg = -1), the M-RoPE ids to the engine's prompt bucket,
and the content digest (patches and grids) keys the prefix store of an
engine that has one; the served engine has none, as the JAX package
builds it.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os

import numpy as np

from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.qwen2_5vl_served import (_pad, expand_image,
                                                    patch_bucket,
                                                    rope_ids_to_bucket)
from aha_tpu_torch.models.qwen3vl import (Qwen3VLConfig, Qwen3VLModel,
                                          check_tp, get_rope_index_qwen3vl,
                                          vision_geometry_qwen3vl)
from aha_tpu_torch.models.text_served import TextChatModel, decoder_rank
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype

IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
MIN_PIXELS = 32 * 32 * 4
MAX_PIXELS = 16 * 16 * 4 * 1280


def build_mm(patches_list: list[np.ndarray], grids: list[tuple],
             input_ids: list[int], cfg) -> dict:
    """The host inputs of one multimodal prefill, as numpy: the patches,
    frame segments, rotary coordinates and 4-tap position indices padded
    to their patch bucket, the (3, S) M-RoPE ids padded to the prompt
    bucket (positions continue past the prompt), and rope_delta.  `grids`
    lists a video as its per-frame (1, h, w) grids; `cfg` is a
    Qwen3VLConfig or any config with its vision and token fields
    (Qwen3.5's)."""
    geo = vision_geometry_qwen3vl(grids, cfg.vision)
    patches = np.concatenate(patches_list)
    bucket = patch_bucket(patches.shape[0])
    mm = {"patches": _pad(patches.astype(np.float32), 0.0, bucket),
          "seg": _pad(geo["seg"], -1, bucket),
          "pos_hw": _pad(geo["pos_hw"], 0, bucket),
          "pos_idx": _pad(geo["pos_idx"], 0, bucket),
          "pos_w": _pad(geo["pos_w"], 0.0, bucket)}
    position_ids, rope_delta = get_rope_index_qwen3vl(input_ids, grids, cfg)
    mm["position_ids"] = rope_ids_to_bucket(position_ids)
    mm["rope_delta"] = rope_delta
    return mm


def mm_digest(patches_list: list[np.ndarray], grids: list[tuple]) -> str:
    """Digest of the vision CONTENT (decoded patches and grids), not of the
    source URL: a mutable URL must not hit stale cached KV."""
    h = hashlib.sha256(np.ascontiguousarray(
        np.concatenate(patches_list)).tobytes())
    for grid in grids:
        h.update(repr(tuple(grid)).encode())
    return h.hexdigest()


def video_placeholder(stamps: list[float], grid: tuple, merge_len: int
                      ) -> str:
    """One timestamped vision block a temporal pair of frames."""
    frame_seqlen = grid[1] * grid[2] // merge_len
    return "".join(f"<{stamps[t]:.1f} seconds>" + VISION_START
                   + "<|vplaceholder|>" * frame_seqlen + VISION_END
                   for t in range(grid[0]))


class Qwen3VLChat(TextChatModel):
    """Image and video chat.  `vl_config` holds the vision and token fields
    get_data reads (a Qwen3VLConfig, or Qwen3.5's config)."""
    vl_config: Qwen3VLConfig
    #: the resize bounds (preprocessor_config.json's, else Qwen3-VL's)
    min_pixels: int = MIN_PIXELS
    max_pixels: int = MAX_PIXELS
    max_video_frames: int = 64

    @staticmethod
    def build_model(path: str, max_seq_len: int) -> tuple:
        """(model, params) of the checkpoint on the default device."""
        dev = device()
        model = Qwen3VLModel(Qwen3VLConfig.from_file(path),
                             max_rope_len=max_seq_len, device=dev)
        return model, model.load_params(open_weights(path),
                                        dtype=get_dtype(dev))

    @staticmethod
    def config_of(model) -> Qwen3VLConfig:
        return model.config

    #: the model class a tp rank builds over its slice (None: the
    #: checkpoint's sharding is not ported)
    rank_model: type | None = Qwen3VLModel

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "Qwen3VLChat":
        """One stream on a TextEngine without a prefix store (the JAX
        package builds it so); `batch_slots > 1` is refused by the loader
        before this runs.  `tp > 1` shards the model over tp ranks
        (decoder_rank), after check_tp refuses a tp that does not divide
        it (the JAX package's aha_tpu/models/qwen3vl_served.py:61-74)."""
        tp = kw.get("tp", 1)
        build_rank = None
        if cls.rank_model is not None:
            if tp > 1:
                check_tp(Qwen3VLConfig.from_file(path), tp)
            build_rank = functools.partial(decoder_rank, cls.rank_model,
                                           Qwen3VLConfig, path, max_seq_len)
        served = super().load(entry, path, cls.build_model,
                              max_seq_len=max_seq_len, prefix_cache=0,
                              cuda_graphs=kw.get("cuda_graphs", True),
                              tp=tp, build_rank=build_rank)
        served.vl_config = cls.config_of(served.engine.model)
        served.read_preprocessor(path)
        return served

    def read_preprocessor(self, path: str) -> None:
        """min / max pixels from preprocessor_config.json where it gives
        them (a 0 or missing value keeps the default)."""
        pp = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
        self.min_pixels = pp.get("min_pixels") or MIN_PIXELS
        self.max_pixels = pp.get("max_pixels") or MAX_PIXELS

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.video import (extract_vision_parts,
                                               load_video_frames,
                                               preprocess_video_qwen_vl,
                                               sample_frames,
                                               video_timestamps)

        cfg = self.vl_config
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
        patches_list, grids = [], []
        for kind, src in parts:
            if kind == "image":
                rendered, patches, grid = expand_image(
                    rendered, src, v, self.min_pixels, self.max_pixels)
                patches_list.append(patches)
                grids.append(grid)
                continue
            frames, src_fps = load_video_frames(src)
            frames, idx, fps = sample_frames(
                frames, src_fps, target_fps=2.0, min_frames=4,
                max_frames=self.max_video_frames)
            patches, grid = preprocess_video_qwen_vl(
                frames, v.patch_size, v.spatial_merge_size,
                v.temporal_patch_size, self.min_pixels, self.max_pixels * 4)
            ph = video_placeholder(
                video_timestamps(idx, fps, v.temporal_patch_size), grid,
                merge_len)
            three = VISION_START + VIDEO_PAD + VISION_END
            if three in rendered:
                rendered = rendered.replace(three, ph, 1)
            else:
                rendered = rendered.replace(VIDEO_PAD, ph, 1)
            # each timestamped frame is its own vision block: the rope
            # index takes the video as per-frame (1, h, w) grids
            patches_list.append(patches)
            grids.extend([(1, grid[1], grid[2])] * grid[0])
        rendered = rendered.replace("<|placeholder|>", IMAGE_PAD)
        rendered = rendered.replace("<|vplaceholder|>", VIDEO_PAD)
        input_ids = self.tokenizer.encode(rendered)
        mm = build_mm(patches_list, grids, input_ids, cfg)
        return PrepareData(
            input_ids=input_ids, mm=mm,
            in_reasoning=self.is_in_reasoning(rendered),
            mm_key=mm_digest(patches_list, grids),
            mm_token_ids=(cfg.image_token_id, cfg.video_token_id))
