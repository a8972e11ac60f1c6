"""PID-file helpers of the server (the port's copy of the part of
aha_tpu/server/process.py that the server uses): `<port>.pid` under
$XDG_RUNTIME_DIR/aha or ~/.aha/run, as the reference's
src/server/process.rs:45-70 keeps them.
"""

from __future__ import annotations

import os
from pathlib import Path


def get_pid_dir() -> Path:
    runtime_dir = os.environ.get("XDG_RUNTIME_DIR")
    if runtime_dir:
        d = Path(runtime_dir) / "aha"
    else:
        d = Path(os.path.expanduser("~")) / ".aha" / "run"
    d.mkdir(parents=True, exist_ok=True)
    return d


def create_pid_file(pid: int, port: int) -> None:
    (get_pid_dir() / f"{port}.pid").write_text(f"{pid}\n")


def cleanup_pid_file(port: int) -> None:
    p = get_pid_dir() / f"{port}.pid"
    if p.exists():
        p.unlink()
