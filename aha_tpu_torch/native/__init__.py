"""The native host dequant of GGUF blocks (the port's copy of
aha_tpu/native; the port imports nothing of aha_tpu).

`dequant.cpp` is compiled at first use with `g++ -O3 -shared -fPIC
-fopenmp` into the port's build directory (ops/kernels.build_dir(), the
repository's `build/aha_tpu_torch/` unless AHA_TORCH_BUILD_DIR names
another), named by a hash of the source and flags, and loaded with ctypes.
Where it cannot build or load (no compiler, AHA_NO_NATIVE set) `dequant`
returns None and io/gguf.py takes its numpy path; the port logs that
fallback once, where the JAX package falls back without a word.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from aha_tpu_torch.ops.kernels import build_dir

#: ggml type name → (exported symbol, bytes per block, elements per block)
BLOCK_SPECS = {
    "q8_0": ("dequant_q8_0", 34, 32),
    "q4_0": ("dequant_q4_0", 18, 32),
    "q4_1": ("dequant_q4_1", 20, 32),
    "q5_0": ("dequant_q5_0", 22, 32),
    "iq4_nl": ("dequant_iq4_nl", 18, 32),
    "q4_k": ("dequant_q4_k", 144, 256),
    "q6_k": ("dequant_q6_k", 210, 256),
    "q5_k": ("dequant_q5_k", 176, 256),
    "q2_k": ("dequant_q2_k", 84, 256),
    "q3_k": ("dequant_q3_k", 110, 256),
}
#: no -march=native: the build directory may be copied to another host
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")
SOURCE = Path(__file__).with_name("dequant.cpp")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return build_dir() / f"libaha_dequant_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library, compiled unless a build of this source is there;
    raises where g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.build-{os.getpid()}")
    r = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed: {r.stderr.strip()[-2000:]}")
    os.replace(tmp, so)          # atomic against concurrent builds
    return so


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, or None (logged once) where it is unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("AHA_NO_NATIVE"):
            _log.warning("AHA_NO_NATIVE is set: GGUF blocks are "
                         "dequantized with numpy")
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
            for sym, _, _ in BLOCK_SPECS.values():
                fn = getattr(lib, sym)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p]
                fn.restype = None
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _log.warning("the native GGUF dequant is unavailable (%s): "
                         "blocks are dequantized with numpy", e)
            return None
        _lib = lib
    return _lib


def dequant(type_name: str, raw: np.ndarray) -> np.ndarray | None:
    """Whole ggml blocks (uint8) of `type_name` → float32 (n_elems,), or
    None where the type has no native routine or the library is
    unavailable (the caller takes the numpy path)."""
    spec = BLOCK_SPECS.get(type_name)
    if spec is None:
        return None
    lib = get_lib()
    if lib is None:
        return None
    sym, block_bytes, block_elems = spec
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size % block_bytes:
        return None
    n_blocks = raw.size // block_bytes
    out = np.empty(n_blocks * block_elems, np.float32)
    getattr(lib, sym)(raw.ctypes.data, n_blocks, out.ctypes.data)
    return out
