"""Build and bind the hand-written CUDA kernels (`aha_tpu_torch/csrc/*.cu`).

nvcc compiles every source into ONE shared library with a plain C
interface (no PyTorch headers: seconds, not minutes), loaded with ctypes:
one nvcc process per source, all started together, then one link.
The library is built at first use into `build/aha_tpu_torch/` at the
repository root (`AHA_TORCH_BUILD_DIR` overrides it), named by a hash of
the sources and flags, so an edited kernel rebuilds and an unchanged one is
reused by later processes.  Nothing is compiled when this module is
imported: the CPU tests import it on machines with no nvcc.

Every C entry launches on the stream it is given, allocates nothing, does
not synchronise, and returns `cudaGetLastError()`; `check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
#: C entry → argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "aha_decode_attention": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "aha_decode_attention_q8": [_P] * 7 + [_I] + [_P] * 4 + [_I] * 7
                               + [_F, _I, _P],
    "aha_head_argmax": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "aha_head_argmax_parts": [_I],
    "aha_flash_prefill": [_P, _P, _P, _P] + [_LL] * 12
                         + [_I, _I, _I, _I, _I, _I, _I, _F, _P],
    "aha_fused_decode_stack": [_P] * 16 + [_I] * 7 + [_F, _F, _I, _P],
    "aha_error_string": [_I],
}

_lib: ctypes.CDLL | None = None
#: ptxas report of the build this process made (empty if it found one)
build_log = ""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    env = os.environ.get("AHA_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / "aha_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"libaha_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their stderr, or raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs = []
    for cmd, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                               f"{cmd[-1]}:\n{err[-8000:]}")
        logs.append(err)
    return logs


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    srcs = [p for p in sources() if p.suffix == ".cu"]
    objs = [out.parent / f"{tag}.{p.stem}.o" for p in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                         for p, o in zip(srcs, objs)])
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_log = "".join(logs)
    os.replace(tmp, out)     # atomic: two processes building at once agree
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "aha_error_string" else _I
        _lib = so
    return _lib


def require(cond: bool, what: str) -> None:
    """A wrapper's check of what its kernel takes: raise, never fall back."""
    if not cond:
        raise ValueError(what)


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().aha_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
