"""Device & dtype selection (counterpart of aha_tpu/utils/device.py).

The compute dtype follows the device: bfloat16 on CUDA (the tensor cores'
native low-precision type), float32 on the CPU (the parity tests), with
`AHA_DTYPE` overriding both.  `AHA_DEVICE` picks the device; asking for
CUDA where there is none raises instead of silently running on the CPU.
`AHA_KV_INT8=1` stores the KV cache in int8 (core/cache.py).
"""

from __future__ import annotations

import os

import torch

_DTYPE_MAP = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "f16": torch.float16,
}


def device() -> torch.device:
    """`AHA_DEVICE` if set, else cuda:0 when a card is visible, else cpu."""
    name = os.environ.get("AHA_DEVICE")
    if not name:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"AHA_DEVICE={name} but torch sees no CUDA device")
    return dev


def get_dtype(dev: torch.device | None = None) -> torch.dtype:
    override = os.environ.get("AHA_DTYPE")
    if override:
        return _DTYPE_MAP[override.lower()]
    dev = dev if dev is not None else device()
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def get_cache_dtype(dev: torch.device | None = None) -> torch.dtype:
    """KV-cache storage dtype: int8 rows with per-(row, kv-head) scales
    under `AHA_KV_INT8=1` (half the bytes a long-context decode step
    reads), else the compute dtype."""
    if os.environ.get("AHA_KV_INT8") == "1":
        return torch.int8
    return get_dtype(dev)


def default_save_dir() -> str:
    """Model weight root — the same ~/.aha layout as aha_tpu."""
    return os.environ.get("AHA_HOME", os.path.expanduser("~/.aha"))
