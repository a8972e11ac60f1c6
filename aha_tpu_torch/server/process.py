"""Service processes: PID files and discovery (the port's copy of
aha_tpu/server/process.py): `<port>.pid` under $XDG_RUNTIME_DIR/aha or
~/.aha/run, as the reference's src/server/process.rs:45-70 keeps them;
`find_aha_services` reads the PID files first (removing stale ones), then
every process whose command line runs the port's server
(`python -m aha_tpu_torch serv`).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

#: command-line fragments of the port's server processes
_AHA_MARKERS = ("aha_tpu_torch serv",)


@dataclasses.dataclass
class ServiceInfo:
    service_id: str
    pid: int
    model: str | None
    port: int
    address: str = "127.0.0.1"
    status: str = "running"


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


def _cmdline(proc) -> str:
    import psutil

    try:
        return " ".join(proc.cmdline())
    except (psutil.NoSuchProcess, psutil.AccessDenied, psutil.ZombieProcess):
        return ""


def _is_aha_cmdline(cmd: str) -> bool:
    return any(m in cmd for m in _AHA_MARKERS)


def is_aha_process(pid: int) -> bool:
    import psutil

    try:
        cmd = _cmdline(psutil.Process(pid))
    except psutil.NoSuchProcess:
        return False
    return _is_aha_cmdline(cmd)


def find_aha_services() -> list[ServiceInfo]:
    """The running servers: one per live PID file (`<pid>@<port>`; a file
    whose process is gone or is no server is removed), then each other
    server process found by its command line (`<pid>@0`)."""
    import psutil

    services: list[ServiceInfo] = []
    for path in sorted(get_pid_dir().glob("*.pid")):
        try:
            port = int(path.stem)
            pid = int(path.read_text().strip())
        except (ValueError, OSError):
            continue
        if port == 0:
            continue
        if is_aha_process(pid):
            services.append(ServiceInfo(service_id=f"{pid}@{port}", pid=pid,
                                        model=None, port=port))
        else:
            try:
                path.unlink()
            except OSError:
                pass
    known = {s.pid for s in services}
    for proc in psutil.process_iter():
        if proc.pid not in known and _is_aha_cmdline(_cmdline(proc)):
            services.append(ServiceInfo(service_id=f"{proc.pid}@0",
                                        pid=proc.pid, model=None, port=0))
    return services
