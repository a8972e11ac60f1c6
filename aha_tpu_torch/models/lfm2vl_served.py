"""LFM2-VL served model: image chat on the hybrid decoder (counterpart of
aha_tpu/models/lfm2vl_served.py's Lfm2VLChat).

Processor parity with src/models/lfm2vl/processor.rs: smart resize to the
patch · downsample grid bounded by [min, max]_image_tokens, SigLIP
normalization (mean / std 0.5), NaViT packing (flattened patches, a pixel
mask, per-image shapes), "<image>" expanded once per projected unit.
Tiling: when the image exceeds max_image_tokens · tolerance and
do_image_splitting is on, it is cut into tile_size tiles on the closest
aspect grid (2 to 10 tiles) plus a thumbnail, and "<image>" expands to
<|image_start|> <|img_row_r_col_c|> tokens... <|img_thumbnail|> tokens...
<|image_end|>.  Row / column markers go to ANY split grid (the upstream HF
processor's rule, as the JAX package follows it; the reference's Rust
processor marks only grids of more than one row and column).  The packed
batch is padded to a patch bucket (64 ... 4096 rows an image).  One
stream without a prefix store, as the JAX package builds it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.lfm2vl import (Lfm2VLConfig, Lfm2VLModel,
                                         resize_pos_embeddings,
                                         unshuffle_gather)
from aha_tpu_torch.models.text_served import TextChatModel
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype

IMAGE_TOKEN = "<image>"
PATCH_BUCKETS = (64, 256, 1024, 4096)


def patch_bucket(n: int) -> int:
    for b in PATCH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"an image of {n} patches; the largest patch bucket "
                     f"is {PATCH_BUCKETS[-1]}")


def patchify(img, patch_size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """An exact-size image, SigLIP-normalized (mean / std 0.5) → (patches
    (N, ps²·3) row-major, each patch (ps, ps, 3) flat, (gh, gw))."""
    ps = patch_size
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    h, w = arr.shape[:2]
    gh, gw = h // ps, w // ps
    patches = arr.reshape(gh, ps, gw, ps, 3).transpose(0, 2, 1, 3, 4)
    return patches.reshape(gh * gw, ps * ps * 3).astype(np.float32), (gh, gw)


def resize_and_split(img, c: Lfm2VLConfig, ip: dict):
    """(list of (patches, (gh, gw)), rows, cols, the unsplit image's grid)
    (processor.rs:109-187): smart resize within the token budget; an image
    past max_image_tokens · tolerance tiled on the closest aspect grid,
    with a thumbnail."""
    from PIL import Image

    from aha_tpu_torch.utils.image import (crop_img,
                                           find_closest_aspect_ratio,
                                           generate_target_ratios,
                                           smart_resize)

    ps, f = c.vision.patch_size, c.downsample_factor
    unit = ps * f
    token_pixels = unit * unit
    tolerance = ip.get("max_pixels_tolerance", 2.0)
    max_pixel_num = int(c.max_image_tokens * token_pixels * tolerance)
    hb = max(ps, round(img.height / unit) * unit)
    wb = max(ps, round(img.width / unit) * unit)
    too_large = hb * wb > max_pixel_num
    h, w = smart_resize(img.height, img.width, factor=unit,
                        min_pixels=c.min_image_tokens * token_pixels,
                        max_pixels=c.max_image_tokens * token_pixels)
    if not (too_large and ip.get("do_image_splitting", True)):
        return ([patchify(img.resize((w, h), Image.BICUBIC), ps)], 1, 1,
                (h // ps, w // ps))
    tile = ip.get("tile_size", 512)
    ratios = generate_target_ratios(ip.get("min_tiles", 2),
                                    ip.get("max_tiles", 10))
    cols, rows = find_closest_aspect_ratio(
        img.width / img.height, ratios, img.width, img.height, tile)
    tiles = crop_img(img, rows, cols, tile)
    out = [patchify(t, ps) for t in tiles]
    if ip.get("use_thumbnail", True) and len(tiles) != 1:
        out.append(patchify(img.resize((w, h), Image.BICUBIC), ps))
    return out, rows, cols, (h // ps, w // ps)


def image_placeholder(entries: list, rows: int, cols: int,
                      thumb: tuple[int, int], f: int) -> str:
    """The text one "<image>" expands to: <|image_start|>, then each tile's
    row / column marker and placeholders and the thumbnail's (a split
    image), or the image's placeholders; <|image_end|>."""
    sub = "<|image_start|>"
    tokens_for_image = (thumb[0] // f) * (thumb[1] // f)
    if rows * cols > 1:
        tile_units = (entries[0][1][0] // f) * (entries[0][1][1] // f)
        for r in range(rows):
            for cc in range(cols):
                sub += (f"<|img_row_{r + 1}_col_{cc + 1}|>"
                        + "<|placeholder|>" * tile_units)
        if len(entries) > rows * cols:
            sub += "<|img_thumbnail|>" + "<|placeholder|>" * tokens_for_image
    else:
        sub += "<|placeholder|>" * tokens_for_image
    return sub + "<|image_end|>"


def build_mm(per_image: list[np.ndarray], shapes: list[tuple[int, int]],
             table: np.ndarray, c: Lfm2VLConfig) -> dict:
    """The packed NaViT batch as numpy: every image (tile) a row of the
    patch bucket of the largest, its pixel mask, its host-resized position
    embeddings, and the projector's unshuffle gather."""
    n_padded = patch_bucket(max(len(p) for p in per_image))
    B = len(per_image)
    pixels = np.zeros((B, n_padded, per_image[0].shape[1]), np.float32)
    mask = np.zeros((B, n_padded), bool)
    pos = np.zeros((B, n_padded, table.shape[1]), np.float32)
    for i, (p, (gh, gw)) in enumerate(zip(per_image, shapes)):
        pixels[i, :len(p)] = p
        mask[i, :len(p)] = True
        pos[i] = resize_pos_embeddings(table, gh, gw, n_padded)
    return {"pixels": pixels, "pixel_mask": mask, "pos_embeds": pos,
            "gather": unshuffle_gather(shapes, n_padded,
                                       c.downsample_factor)}


class Lfm2VLChat(TextChatModel):
    vl_model: Lfm2VLModel
    #: processor_config.json's image_processor (or preprocessor_config.json)
    image_processor: dict
    #: the tower's learned position table on the host, float32
    pos_table: np.ndarray

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "Lfm2VLChat":
        """One stream on a TextEngine without a prefix store; `batch_slots
        > 1` is refused by the loader before this runs."""
        def build(path, max_seq_len):
            dev = device()
            model = Lfm2VLModel(Lfm2VLConfig.from_file(path),
                                max_rope_len=max_seq_len, device=dev)
            return model, model.load_params(open_weights(path),
                                            dtype=get_dtype(dev))

        served = super().load(entry, path, build, max_seq_len=max_seq_len,
                              prefix_cache=0,
                              cuda_graphs=kw.get("cuda_graphs", True))
        served.vl_model = served.engine.model
        ip = {}
        for name, key in (("processor_config.json", "image_processor"),
                          ("preprocessor_config.json", None)):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p) as fh:
                    d = json.load(fh)
                ip = d.get(key, d) if key else d
                if ip:
                    break
        served.image_processor = ip
        served.pos_table = served.engine.params["visual"]["pos_table"] \
            .float().cpu().numpy()
        return served

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        from aha_tpu_torch.utils.image import extract_image_sources, load_image

        c = self.vl_model.config
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True,
            enable_thinking=bool(mes.enable_thinking))
        sources = extract_image_sources(mes)
        if not sources:
            return PrepareData(input_ids=self.tokenizer.encode(rendered),
                               in_reasoning=self.is_in_reasoning(rendered))
        per_image, shapes = [], []
        for src in sources:
            entries, rows, cols, thumb = resize_and_split(
                load_image(src), c, self.image_processor)
            for patches, shape in entries:
                per_image.append(patches)
                shapes.append(shape)
            rendered = rendered.replace(
                IMAGE_TOKEN, image_placeholder(entries, rows, cols, thumb,
                                               c.downsample_factor), 1)
        rendered = rendered.replace("<|placeholder|>", IMAGE_TOKEN)
        input_ids = self.tokenizer.encode(rendered)
        mm = build_mm(per_image, shapes, self.pos_table, c)
        return PrepareData(input_ids=input_ids,
                           mm=mm,
                           in_reasoning=self.is_in_reasoning(rendered))
