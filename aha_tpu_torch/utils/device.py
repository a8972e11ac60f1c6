"""Device & dtype selection (counterpart of aha_tpu/utils/device.py).

The compute dtype follows the device: bfloat16 on CUDA (the tensor cores'
native low-precision type), float32 on the CPU (the parity tests), with
`AHA_DTYPE` overriding both.  The port's entry points run on the card:
with `AHA_DEVICE` unset the device is cuda, and a machine where torch sees
no card raises rather than serve on the CPU.  `AHA_DEVICE=cpu` is the way
to ask for the CPU (the parity tests do); any other value names a device.
`AHA_KV_INT8=1` stores the KV cache in int8 (core/cache.py).

A mesh's ranks and replicas take one card each (`mesh_devices`): a host
with fewer cards than tp·dp is refused before anything loads, and a rank
never falls back to the CPU; `use_device` makes `device()` another card's
for what is built inside it (a dp replica's model and weights).
`AHA_MESH_DEVICES` (e.g. "cuda:0,cuda:0") lists a mesh's devices instead:
a card listed twice takes two ranks, which then talk over gloo
(parallel/ranks.start), to try --tp on a host with fewer cards.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

_DTYPE_MAP = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "f16": torch.float16,
}


_override = threading.local()


def device() -> torch.device:
    """`AHA_DEVICE` if set, else cuda; a cuda device where torch sees no
    card raises RuntimeError.  Inside `use_device(d)`: d."""
    forced = getattr(_override, "device", None)
    if forced is not None:
        return forced
    name = os.environ.get("AHA_DEVICE") or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: torch sees no CUDA device; "
                           "set AHA_DEVICE=cpu to run on the CPU")
    return dev


@contextlib.contextmanager
def use_device(dev: torch.device):
    """`device()` is `dev` in this thread until the block ends."""
    before = getattr(_override, "device", None)
    _override.device = torch.device(dev)
    try:
        yield
    finally:
        _override.device = before


def mesh_devices(tp: int = 1, dp: int = 1) -> list[torch.device]:
    """The devices of a tp·dp mesh, one a rank or replica: cuda:0 …
    cuda:tp·dp − 1 on the card, the CPU tp·dp times under AHA_DEVICE=cpu,
    or the first tp·dp that AHA_MESH_DEVICES lists.  A host with fewer
    cards (or a list with fewer devices) raises ValueError naming both
    counts; without a card `device()` raises as ever."""
    n = tp * dp
    listed = os.environ.get("AHA_MESH_DEVICES")
    if listed:
        devs = [torch.device(d.strip()) for d in listed.split(",")
                if d.strip()]
        if len(devs) < n:
            raise ValueError(f"--tp {tp} --dp {dp} needs {n} devices, one a "
                             f"rank or replica; AHA_MESH_DEVICES lists "
                             f"{len(devs)}")
        return devs[:n]
    dev = device()
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"--tp {tp} --dp {dp} needs {n} cards, one a rank "
                         f"or replica; this host has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors: the launch plans' unit."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
