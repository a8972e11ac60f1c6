"""Request traces on torch.profiler (the port's counterpart of
aha_tpu/utils/profiling.py, which writes jax.profiler traces).

- `configure(profile_dir=..., profile_port=...)`: called once by `serv
  --profile-dir D --profile-port P`, with AHA_PROFILE_DIR /
  AHA_PROFILE_PORT as fallbacks.
- `request_trace(name)`: the server wraps each request in it; with a
  profile directory it writes one `<name>.<pid>.<ms>.<n>.pt.trace.json`
  there (CPU and CUDA activities; open it in Perfetto or TensorBoard),
  else it does nothing.
- `annotate(name)` / `step_annotation(name, step)`: record_function
  ranges that label the engine's prefill and decode blocks in a trace.
- `--profile-port P`: torch has no counterpart of jax.profiler's capture
  server, so a small listener on 127.0.0.1:P answers `GET
  /capture?ms=N` by tracing the next N ms of the whole process (every
  thread, where this torch can) into the profile directory (a fresh
  temporary one without --profile-dir) and replying with the file's
  path.

torch runs one profiler session at a time (two overlapping sessions in
threads crash the process), so one lock guards them: a request that
arrives while a trace or a capture runs is served untraced, and the log
says so; a capture waits up to CAPTURE_WAIT_S for a running request
trace to end.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator
from urllib.parse import parse_qs, urlparse

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_profile_dir: str | None = None
_capture_dir: str | None = None
_server: ThreadingHTTPServer | None = None
_session = threading.Lock()
_seq = itertools.count()
CAPTURE_WAIT_S = 30.0
MAX_CAPTURE_MS = 60_000


def configure(profile_dir: str | None = None,
              profile_port: int | None = None) -> None:
    """Set up profiling from CLI flags (environment variables as the
    fallback)."""
    global _profile_dir, _capture_dir
    profile_dir = profile_dir or os.environ.get("AHA_PROFILE_DIR") or None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        _profile_dir = profile_dir
    port = profile_port or int(os.environ.get("AHA_PROFILE_PORT", 0) or 0)
    if port and _server is None:
        _capture_dir = _profile_dir or tempfile.mkdtemp(prefix="aha_profile_")
        _start_capture_server(port)
        print(f"[profile] GET http://127.0.0.1:{port}/capture?ms=N traces "
              f"the next N ms into {_capture_dir}", flush=True)
    if _profile_dir or port:
        _warm_up()


def _warm_up() -> None:
    """One empty session: the first in a process pays the profiler's
    initialization (7-12 s with an H100 80GB HBM3; run in a thread beside
    the model's load, it did not overlap the load), which would otherwise
    fall on the first traced request, or eat a capture's window."""
    t0 = time.perf_counter()
    with _session:
        with profile(activities=_activities()):
            pass
    print(f"[profile] profiler ready in {time.perf_counter() - t0:.1f} s",
          flush=True)


def profile_dir() -> str | None:
    return _profile_dir


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_path(directory: str, name: str) -> str:
    stem = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
    return os.path.join(directory, f"{stem}.{os.getpid()}."
                        f"{int(time.time() * 1000)}.{next(_seq)}"
                        ".pt.trace.json")


def _export(prof, directory: str, name: str) -> str:
    """The trace written into `directory`; OSError when no file came out
    (torch's export does not raise when it cannot write)."""
    path = _trace_path(directory, name)
    prof.export_chrome_trace(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"the profiler wrote no trace to {path}")
    return path


@contextlib.contextmanager
def request_trace(name: str) -> Iterator[None]:
    """Trace one request into the profile directory (nothing
    unconfigured); untraced, and logged, while another trace runs."""
    if _profile_dir is None:
        yield
        return
    if not _session.acquire(blocking=False):
        print(f"[profile] {name}: a trace is running; this request is "
              f"served untraced", flush=True)
        yield
        return
    try:
        with profile(activities=_activities()) as prof:
            with record_function(name):
                yield
        try:
            path = _export(prof, _profile_dir, name)
            print(f"[profile] {name}: trace {path} "
                  f"({os.path.getsize(path)} bytes)", flush=True)
        except OSError as e:          # the request itself was served
            print(f"[profile] {name}: no trace written: {e}", flush=True)
    finally:
        _session.release()


def annotate(name: str):
    """A range labelling a region inside an active trace (cheap without
    one)."""
    return record_function(name)


def step_annotation(name: str, step: int):
    """A range labelling the decode work that starts at `step` (one
    captured graph's replay is one such range)."""
    return record_function(f"{name}#{step}")


def _all_threads():
    """An experimental config that traces every thread's operators, where
    this torch has the option; else None (the calling thread only)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def capture(ms: int) -> str:
    """Trace the next `ms` milliseconds of the process into the capture
    directory; the file's path.  Raises TimeoutError when a request trace
    holds the profiler past CAPTURE_WAIT_S."""
    if not _session.acquire(timeout=CAPTURE_WAIT_S):
        raise TimeoutError("a request trace held the profiler for "
                           f"{CAPTURE_WAIT_S:.0f} s")
    try:
        cfg = _all_threads()
        kw = {} if cfg is None else {"experimental_config": cfg}
        with profile(activities=_activities(), **kw) as prof:
            time.sleep(ms / 1000)
        return _export(prof, _capture_dir, "capture")
    finally:
        _session.release()


class _CaptureHandler(BaseHTTPRequestHandler):
    def do_GET(self):
        url = urlparse(self.path)
        if url.path != "/capture":
            return self._reply(404, {"error": f"no route {url.path}"})
        try:
            ms = int(parse_qs(url.query).get("ms", ["1000"])[0])
        except ValueError:
            return self._reply(400, {"error": "ms must be an integer"})
        if not 0 < ms <= MAX_CAPTURE_MS:
            return self._reply(400, {"error": f"ms must lie in 1..{MAX_CAPTURE_MS}"})
        try:
            path = capture(ms)
            size = os.path.getsize(path)
        except TimeoutError as e:
            return self._reply(409, {"error": str(e)})
        except OSError as e:          # the directory went away, disk full
            return self._reply(500, {"error": str(e)})
        print(f"[profile] capture of {ms} ms: {path}", flush=True)
        self._reply(200, {"path": path, "ms": ms, "bytes": size})

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args) -> None:
        pass


def _start_capture_server(port: int) -> None:
    global _server
    _server = ThreadingHTTPServer(("127.0.0.1", port), _CaptureHandler)
    _server.daemon_threads = True
    threading.Thread(target=_server.serve_forever, daemon=True,
                     name="aha-profile-capture").start()
