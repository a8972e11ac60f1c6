"""RMBG-2.0 served model: /images/remove_background and the chat endpoint
→ RGBA PNG data URLs (counterpart of aha_tpu/models/rmbg2_0_served.py).

Each input image is resized to `size` × `size` (PIL bicubic, 1024 by
default), normalised with the ImageNet mean and std, run through BiRefNet
in float32 on the port's device (the card unless AHA_DEVICE asks for the
CPU), and its matte, scaled to 0..255, resized back to the image's size
(bicubic) becomes the alpha channel of the original pixels.  The reply is
one assistant message with an `image` part per input; streaming is
refused.
"""

from __future__ import annotations

import base64
import io
import json
import os
import time
import uuid

import numpy as np
import torch

from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.base import LoadedModel, UnsupportedOperation
from aha_tpu_torch.models.rmbg2_0 import BiRefNet, SwinConfig
from aha_tpu_torch.params import (ChatCompletionChoice,
                                  ChatCompletionParameters,
                                  ChatCompletionResponse, ChatMessage)
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
#: the Swin fields a config.json may set
SWIN_FIELDS = ("patch_size", "embed_dim", "depths", "num_heads",
               "window_size")


def swin_config(path: str) -> SwinConfig:
    """The Swin-L defaults, with the fields of the directory's config.json
    where it has one."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return SwinConfig()
    with open(cfg_path) as f:
        d = json.load(f)
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in d.items() if k in SWIN_FIELDS}
    return SwinConfig(**fields) if fields else SwinConfig()


class RMBG2Served(LoadedModel):
    def __init__(self, entry: ModelEntry, model: BiRefNet, params: dict,
                 model_name: str, size: int = 1024):
        super().__init__(entry)
        self.model = model
        self.params = params
        self.model_name = model_name
        self.size = size

    @classmethod
    def load(cls, entry: ModelEntry, path: str, **kw) -> "RMBG2Served":
        dev = device()
        model = BiRefNet(swin_config(path), device=dev)
        params = model.load_params(open_weights(path), dtype=torch.float32)
        return cls(entry, model, params,
                   model_name=os.path.basename(path.rstrip("/"))
                   or entry.name, size=kw.get("size", 1024))

    # -- inference -------------------------------------------------------------

    def pixels(self, img) -> torch.Tensor:
        """A PIL image → the (1, 3, size, size) normalised float32 input on
        the model's device."""
        from PIL import Image

        resized = img.resize((self.size, self.size), Image.BICUBIC)
        arr = np.asarray(resized, np.float32) / 255.0
        arr = ((arr - IMAGENET_MEAN) / IMAGENET_STD).transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr))[None].to(
            self.model.device)

    def matte(self, pixels: torch.Tensor) -> np.ndarray:
        """(1, 3, size, size) → the (size, size) float32 matte."""
        with torch.no_grad():
            out = self.model.forward(self.params, pixels)
        return out[0, 0].float().cpu().numpy()

    def remove_background(self, sources: list[str]) -> list[bytes]:
        """RGBA PNG bytes per input image source."""
        from PIL import Image

        from aha_tpu_torch.utils.image import load_image

        out = []
        for src in sources:
            img = load_image(src)
            w, h = img.size
            matte = self.matte(self.pixels(img))
            alpha = np.clip(matte * 255.0, 0, 255).astype(np.uint8)
            alpha_img = Image.fromarray(alpha, "L").resize((w, h),
                                                           Image.BICUBIC)
            rgba = img.convert("RGBA")
            rgba.putalpha(alpha_img)
            buf = io.BytesIO()
            rgba.save(buf, "PNG")
            out.append(buf.getvalue())
        return out

    # -- LoadedModel -----------------------------------------------------------

    def generate(self, mes: ChatCompletionParameters) -> ChatCompletionResponse:
        from aha_tpu_torch.utils.image import extract_image_sources

        pngs = self.remove_background(extract_image_sources(mes))
        parts = [{"type": "image",
                  "image_url": {"url": "data:image/png;base64,"
                                + base64.b64encode(png).decode()}}
                 for png in pngs]
        return ChatCompletionResponse(
            id=str(uuid.uuid4()),
            choices=[ChatCompletionChoice(
                index=0,
                message=ChatMessage(role="assistant", content=parts),
                finish_reason="stop")],
            created=int(time.time()), model=self.model_name, usage=None)

    def generate_stream(self, mes: ChatCompletionParameters):
        raise UnsupportedOperation(
            f"{self.model_name} model not support stream")
