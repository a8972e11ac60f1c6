"""The management API (the port's copy of aha_tpu/server/manage.py): the
desktop console's backend commands as HTTP routes, mounted on every
server of the port and on the model-less `serv --manage-only`, so the web
console takes a fresh host from "no weights" to "chatting" without the
CLI:

    GET  /manage/models                  — registry + download status/bytes
    POST /manage/download {"model"}      — background download w/ progress
    GET  /manage/download?model=…        — progress {status, bytes, files}
    POST /manage/delete {"model"}        — rm the downloaded weights
    GET  /manage/services                — `ps` over HTTP
    POST /manage/serve {"model", "port"} — spawn a `serv` child process
    POST /manage/stop {"port"}           — SIGTERM a managed/PID-known serv
    GET  /manage/logs?offset=N           — ring-buffered server+child logs
    POST /manage/logs/clear              — clear the ring
    GET  /manage/settings                — console settings + defaults
    POST /manage/settings                — persist settings (save dir,
                                           serve-form defaults) to
                                           <default save dir>/console.json

The JSON shapes are the JAX package's.  The child is `python -m
aha_tpu_torch serv <id> --port P`; a save-dir setting reaches it as
`--weight-path <save_dir>/<id>`, an option `serv` takes (the JAX console
appends `--save-dir`, which its `serv` refuses, so that child exits
before it binds its port).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from collections import deque

from aiohttp import web

from aha_tpu_torch import registry
from aha_tpu_torch.utils.device import default_save_dir


class LogRing:
    """Bounded line log shared by the server and spawned children."""

    def __init__(self, maxlen: int = 4000):
        self._lines: deque = deque(maxlen=maxlen)
        self._dropped = 0
        self._lock = threading.Lock()

    def append(self, line: str, source: str = "server") -> None:
        with self._lock:
            if len(self._lines) == self._lines.maxlen:
                self._dropped += 1
            self._lines.append({"ts": time.time(), "source": source,
                                "line": line.rstrip("\n")})

    def since(self, offset: int) -> tuple[list[dict], int]:
        """Lines with absolute index ≥ offset, plus the next offset."""
        with self._lock:
            start = self._dropped
            end = start + len(self._lines)
            lo = max(offset, start)
            items = list(self._lines)[lo - start:]
            return items, end

    def clear(self) -> None:
        with self._lock:
            self._dropped += len(self._lines)
            self._lines.clear()


class _Tee:
    """File-like that forwards writes to the original stream AND the ring."""

    def __init__(self, orig, ring: LogRing, source: str):
        self._orig = orig
        self._ring = ring
        self._source = source
        self._buf = ""

    def write(self, s):
        self._orig.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.strip():
                self._ring.append(line, self._source)
        return len(s)

    def flush(self):
        self._orig.flush()

    def __getattr__(self, name):
        return getattr(self._orig, name)


#: serve-form defaults the console persists (settings tab); keys mirror the
#: /manage/serve body and `serv`'s flags
SERVE_DEFAULT_KEYS = ("port", "tp", "dp", "batch_slots", "prefix_cache",
                      "spec_tokens", "max_seq_len")


def _settings_path() -> str:
    # always under the DEFAULT root: the settings file must stay findable
    # even when the save_dir setting itself moves the weight root
    return os.path.join(default_save_dir(), "console.json")


class ManageState:
    def __init__(self):
        self.log = LogRing()
        self.downloads: dict[str, dict] = {}
        self.children: dict[int, subprocess.Popen] = {}   # port → proc
        self._lock = threading.Lock()
        self.settings: dict = {}
        try:
            with open(_settings_path()) as f:
                self.settings = json.load(f)
        except (OSError, ValueError):
            pass

    def save_dir(self) -> str:
        return self.settings.get("save_dir") or default_save_dir()

    def persist_settings(self) -> None:
        path = _settings_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.settings, f, indent=1)
        os.replace(tmp, path)

    def install_log_tee(self) -> None:
        if not isinstance(sys.stdout, _Tee):
            sys.stdout = _Tee(sys.stdout, self.log, "server")
            sys.stderr = _Tee(sys.stderr, self.log, "server")


def _mng(request: web.Request) -> ManageState:
    return request.app["manage"]


#: (path → (expires_at, bytes)) — the console polls /manage/models every
#: 1.5 s during downloads; without a TTL every poll re-walks and stats every
#: file of every downloaded model just to show directory sizes
_DIR_BYTES_CACHE: dict[str, tuple[float, int]] = {}
_DIR_BYTES_TTL = 5.0


def _dir_bytes(path: str) -> int:
    now = time.monotonic()
    hit = _DIR_BYTES_CACHE.get(path)
    if hit is not None and hit[0] > now:
        return hit[1]
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    _DIR_BYTES_CACHE[path] = (now + _DIR_BYTES_TTL, total)
    return total


async def list_models(request: web.Request) -> web.Response:
    mng = _mng(request)
    save = mng.save_dir()
    out = []
    for m in registry.model_list():
        d = os.path.join(save, m.model_id)
        downloaded = os.path.isdir(d) and bool(os.listdir(d))
        item = {"model_id": m.model_id, "owner": m.owner,
                "model_type": m.model_type, "downloaded": downloaded,
                "bytes": _dir_bytes(d) if downloaded else 0}
        dl = mng.downloads.get(m.model_id)
        if dl is not None:
            item["download"] = {k: dl[k] for k in
                                ("status", "bytes_done", "bytes_total",
                                 "files_done", "files_total", "error")}
        out.append(item)
    return web.json_response({"models": out, "save_dir": save})


async def start_download(request: web.Request) -> web.Response:
    body = await request.json()
    model_id = body.get("model", "")
    try:
        registry.lookup(model_id)
    except Exception as e:  # noqa: BLE001
        return web.json_response({"error": str(e)}, status=404)
    mng = _mng(request)
    with mng._lock:
        dl = mng.downloads.get(model_id)
        if dl is not None and dl["status"] == "downloading":
            return web.json_response(dl)
        dl = {"status": "downloading", "bytes_done": 0, "bytes_total": 0,
              "files_done": 0, "files_total": 0, "error": None}
        mng.downloads[model_id] = dl

    def progress(ev: dict) -> None:
        if "bytes_total" in ev:
            # emitted once per download ATTEMPT: a retry restarts the file
            # walk, so the done counters reset too (accumulating across
            # attempts showed >100% progress in the console)
            dl["bytes_total"] = ev["bytes_total"]
            dl["files_total"] = ev["files_total"]
            dl["bytes_done"] = 0
            dl["files_done"] = 0
        if "file" in ev:
            dl["files_done"] += 1
        if "bytes" in ev:
            dl["bytes_done"] += ev["bytes"]

    def run() -> None:
        from aha_tpu_torch.utils.download import download_model

        try:
            download_model(model_id, mng.save_dir(), progress=progress)
            dl["status"] = "done"
        except Exception as e:  # noqa: BLE001
            dl["status"] = "error"
            dl["error"] = str(e)
        mng.log.append(f"download {model_id}: {dl['status']}", "manage")

    threading.Thread(target=run, daemon=True,
                     name=f"aha-download-{model_id}").start()
    return web.json_response(dl)


async def download_progress(request: web.Request) -> web.Response:
    model_id = request.query.get("model", "")
    dl = _mng(request).downloads.get(model_id)
    if dl is None:
        return web.json_response({"status": "idle"})
    return web.json_response(dl)


async def delete_model(request: web.Request) -> web.Response:
    body = await request.json()
    model_id = body.get("model", "")
    try:
        registry.lookup(model_id)
    except Exception as e:  # noqa: BLE001
        return web.json_response({"error": str(e)}, status=404)
    target = os.path.join(_mng(request).save_dir(), model_id)
    if not os.path.isdir(target):
        return web.json_response(
            {"error": f"model {model_id} is not downloaded"}, status=404)
    shutil.rmtree(target)
    _mng(request).downloads.pop(model_id, None)
    _mng(request).log.append(f"deleted {target}", "manage")
    return web.json_response({"deleted": target})


async def services(request: web.Request) -> web.Response:
    from aha_tpu_torch.server.process import find_aha_services

    out = [{"service_id": s.service_id, "pid": s.pid, "model": s.model,
            "port": s.port, "address": s.address, "status": s.status}
           for s in find_aha_services()]
    return web.json_response({"services": out})


async def serve_model(request: web.Request) -> web.Response:
    """Spawn `python -m aha_tpu_torch serv` as a child process and stream
    its output into the log ring."""
    body = await request.json()
    model_id = body.get("model", "")
    port = int(body.get("port", 8001))
    try:
        registry.lookup(model_id)
    except Exception as e:  # noqa: BLE001
        return web.json_response({"error": str(e)}, status=404)
    mng = _mng(request)
    if port in mng.children and mng.children[port].poll() is None:
        return web.json_response(
            {"error": f"a managed server already runs on port {port}"},
            status=409)
    # the registry id is serv's positional argument (cli.resolve): its
    # weights are --weight-path, else <save dir>/<id>
    cmd = [sys.executable, "-m", "aha_tpu_torch", "serv", model_id,
           "--port", str(port)]
    defaults = mng.settings.get("serve_defaults", {})
    for k in ("tp", "dp", "batch_slots", "prefix_cache", "spec_tokens",
              "max_seq_len"):
        v = body.get(k) if body.get(k) is not None else defaults.get(k)
        if v not in (None, ""):
            cmd += [f"--{k.replace('_', '-')}", str(v)]
    weight_path = body.get("weight_path") or (
        os.path.join(mng.settings["save_dir"], model_id)
        if mng.settings.get("save_dir") else None)
    if weight_path:
        cmd += ["--weight-path", weight_path]
    # unbuffered, so the child's lines reach the log ring as it prints them
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    state = request.app["state"]
    if getattr(state, "api_key", None):
        # a keyed console spawns keyed children: the same Bearer key guards
        # every managed server (passed via env, never argv — `ps` and
        # /proc would leak a flag)
        env["AHA_API_KEY"] = state.api_key
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    mng.children[port] = proc

    def pump() -> None:
        for line in proc.stdout:
            mng.log.append(line, f"serv:{port}")
        # its output closed: wait for the exit code (poll() can still be
        # None here) and reap the process
        mng.log.append(f"server on port {port} exited rc={proc.wait()}",
                       "manage")

    threading.Thread(target=pump, daemon=True,
                     name=f"aha-serv-logs-{port}").start()
    mng.log.append(f"spawned `{' '.join(cmd)}` pid={proc.pid}", "manage")
    return web.json_response({"pid": proc.pid, "port": port})


async def stop_server(request: web.Request) -> web.Response:
    """SIGTERM a serv by port: managed children directly, otherwise via the
    PID file (never by process-name pattern)."""
    body = await request.json()
    port = int(body.get("port", 0))
    mng = _mng(request)
    proc = mng.children.get(port)
    if proc is not None and proc.poll() is None:
        proc.terminate()
        return web.json_response({"stopped": proc.pid, "port": port})
    from aha_tpu_torch.server.process import find_aha_services

    for s in find_aha_services():
        if s.port == port and s.status == "running":
            os.kill(s.pid, signal.SIGTERM)
            return web.json_response({"stopped": s.pid, "port": port})
    return web.json_response({"error": f"no server on port {port}"},
                             status=404)


async def logs(request: web.Request) -> web.Response:
    offset = int(request.query.get("offset", 0))
    items, next_off = _mng(request).log.since(offset)
    return web.json_response({"lines": items, "next": next_off})


async def clear_logs(request: web.Request) -> web.Response:
    _mng(request).log.clear()
    return web.json_response({"cleared": True})


async def get_settings(request: web.Request) -> web.Response:
    mng = _mng(request)
    return web.json_response({
        "save_dir": mng.settings.get("save_dir", ""),
        "default_save_dir": default_save_dir(),
        "effective_save_dir": mng.save_dir(),
        "serve_defaults": mng.settings.get("serve_defaults", {}),
    })


async def set_settings(request: web.Request) -> web.Response:
    """Persist console settings: save_dir empty/absent resets to the
    default root; serve_defaults keys are whitelisted and pruned."""
    body = await request.json()
    mng = _mng(request)
    if "save_dir" in body:
        sd = (body.get("save_dir") or "").strip()
        if sd:
            mng.settings["save_dir"] = os.path.expanduser(sd)
        else:
            mng.settings.pop("save_dir", None)
    if "serve_defaults" in body:
        d = body.get("serve_defaults") or {}
        if not isinstance(d, dict):
            return web.json_response(
                {"error": "serve_defaults must be an object"}, status=400)
        kept = {k: d[k] for k in SERVE_DEFAULT_KEYS
                if d.get(k) not in (None, "")}
        if kept:
            mng.settings["serve_defaults"] = kept
        else:
            mng.settings.pop("serve_defaults", None)
    try:
        mng.persist_settings()
    except OSError as e:
        return web.json_response({"error": str(e)}, status=500)
    mng.log.append("settings updated", "manage")
    return await get_settings(request)


def add_manage_routes(app: web.Application,
                      state: ManageState | None = None) -> ManageState:
    mng = state or ManageState()
    app["manage"] = mng
    app.add_routes([
        web.get("/manage/models", list_models),
        web.post("/manage/download", start_download),
        web.get("/manage/download", download_progress),
        web.post("/manage/delete", delete_model),
        web.get("/manage/services", services),
        web.post("/manage/serve", serve_model),
        web.post("/manage/stop", stop_server),
        web.get("/manage/logs", logs),
        web.post("/manage/logs/clear", clear_logs),
        web.get("/manage/settings", get_settings),
        web.post("/manage/settings", set_settings),
    ])
    return mng
