"""Helpers of the port's VL chat tests: the test tokenizer with the four
vision special tokens, a chat template that renders image and video parts,
and seeded PNG / .npz frame-stack data URLs."""

import base64
import io
import json
import os

import numpy as np

from tests.fixtures import CHAT_TEMPLATE, build_tokenizer

#: the chat template's content loop, rendering image and video parts
VISION_TEMPLATE = (
    "{% if message.content is string %}{{ message.content }}"
    "{% else %}{% for part in message.content %}"
    "{% if part.type == 'text' %}{{ part.text }}"
    "{% elif part.type == 'image_url' %}"
    "<|vision_start|><|image_pad|><|vision_end|>"
    "{% elif part.type == 'video_url' %}"
    "<|vision_start|><|video_pad|><|vision_end|>{% endif %}"
    "{% endfor %}{% endif %}")


def vision_tokenizer(path: str):
    """The test tokenizer with the four vision special tokens, saved."""
    from tokenizers import AddedToken

    tok = build_tokenizer(path)
    tok.add_special_tokens([AddedToken(t, special=True) for t in
                            ("<|vision_start|>", "<|image_pad|>",
                             "<|vision_end|>", "<|video_pad|>")])
    tok.save(os.path.join(path, "tokenizer.json"))
    return tok


def write_template(path: str, tok) -> None:
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT_TEMPLATE.replace(
            "{{ message.content }}", VISION_TEMPLATE)}, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [tok.token_to_id("<|im_end|>")]}, f)


def png_data_url(w=64, h=64, seed=0) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def npz_data_url(n=8, side=64, fps=2.0, seed=0) -> str:
    """An .npz frame stack (n, side, side, 3) uint8 with its fps."""
    frames = np.random.default_rng(seed).integers(0, 255, (n, side, side, 3),
                                                  dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, frames=frames, fps=fps)
    return ("data:application/octet-stream;base64,"
            + base64.b64encode(buf.getvalue()).decode())
