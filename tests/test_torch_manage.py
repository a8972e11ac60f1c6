"""The management API (/manage/*) and the web console (GET /) on the port's
app (aha_tpu_torch/server/manage.py, webui.py), against the JAX package's
(aha_tpu/server/manage.py, webui.py): tests/test_manage.py's cases on the
port; all 11 routes answering both apps' JSON shapes alike; the save-dir
setting reaching the child as --weight-path, which the port's `serv`
parses where the JAX child's --save-dir exits 2; the console's routes;
`/` open under --api-key; and `serv --manage-only` in a child process with
no card, then spawning, listing and stopping a CPU model server through
/manage.  Child processes run against 127.0.0.1 with deadlines."""

import asyncio
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

import aha_tpu.server.app as japp
import aha_tpu.server.manage as jmanage
import aha_tpu.utils.download as jdl
from aha_tpu.cli.main import build_parser as jbuild_parser
from aha_tpu_torch import cli
from aha_tpu_torch.server import manage, webui
from aha_tpu_torch.server.app import ServerState, create_app
from aha_tpu_torch.server.manage import LogRing
from aha_tpu_torch.utils import download as dl
from tests.fixtures import build_tiny_qwen3_repo

ROOT = Path(__file__).resolve().parents[1]
MODEL = "Qwen/Qwen3-0.6B"


def with_client(scenario, api_key=None, app_module=None):
    async def runner():
        mod_create, mod_state = ((create_app, ServerState) if app_module is None
                                 else (app_module.create_app,
                                       app_module.ServerState))
        app = mod_create(mod_state(model=None, api_key=api_key))
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await scenario(client, app)
        finally:
            await client.close()

    return asyncio.run(runner())


class FakeProc:
    pid = 4242
    stdout = iter(())

    def poll(self):
        return None

    def wait(self):
        return 0

    def terminate(self):
        pass


# -- tests/test_manage.py's cases, on the port's app -------------------------

def test_manage_models_lists_registry(tmp_path, monkeypatch):
    monkeypatch.setattr(manage, "default_save_dir", lambda: str(tmp_path))
    d = tmp_path / "Qwen" / "Qwen3-0.6B"
    d.mkdir(parents=True)
    (d / "config.json").write_text("{}")

    async def scenario(client, app):
        r = await client.get("/manage/models")
        assert r.status == 200
        body = await r.json()
        assert body["save_dir"] == str(tmp_path)
        by_id = {m["model_id"]: m for m in body["models"]}
        assert len(by_id) >= 40
        assert by_id[MODEL]["downloaded"] is True
        assert by_id[MODEL]["bytes"] == 2
        assert by_id["Qwen/Qwen3-1.7B"]["downloaded"] is False

    with_client(scenario)


def _fake_download(model_id, save_dir, max_retries=3, progress=None):
    progress({"files_total": 2, "bytes_total": 10})
    target = os.path.join(save_dir, model_id)
    os.makedirs(target, exist_ok=True)
    for name in ("a.bin", "b.bin"):
        progress({"file": name})
        with open(os.path.join(target, name), "wb") as f:
            f.write(b"12345")
        progress({"bytes": 5})


async def _download_done(client, model_id):
    for _ in range(200):
        r = await client.get("/manage/download", params={"model": model_id})
        st = await r.json()
        if st["status"] in ("done", "error"):
            return st
        await asyncio.sleep(0.05)
    return st


def test_manage_download_and_delete(tmp_path, monkeypatch):
    monkeypatch.setattr(manage, "default_save_dir", lambda: str(tmp_path))
    monkeypatch.setattr(dl, "download_model", _fake_download)

    async def scenario(client, app):
        r = await client.post("/manage/download", json={"model": MODEL})
        assert r.status == 200
        st = await _download_done(client, MODEL)
        assert st["status"] == "done", st
        assert st["bytes_done"] == 10 and st["files_done"] == 2
        r = await client.get("/manage/models")
        by_id = {m["model_id"]: m for m in (await r.json())["models"]}
        assert by_id[MODEL]["downloaded"] is True
        assert by_id[MODEL]["download"]["status"] == "done"
        r = await client.post("/manage/delete", json={"model": MODEL})
        assert r.status == 200
        assert not (tmp_path / "Qwen" / "Qwen3-0.6B").exists()
        r = await client.post("/manage/delete", json={"model": MODEL})
        assert r.status == 404
        r = await client.post("/manage/download", json={"model": "nope"})
        assert r.status == 404

    with_client(scenario)


def test_manage_logs_ring():
    async def scenario(client, app):
        ring = app["manage"].log
        ring.append("hello one", "server")
        ring.append("hello two", "serv:8001")
        r = await client.get("/manage/logs", params={"offset": 0})
        body = await r.json()
        assert [ln["line"] for ln in body["lines"]] == ["hello one",
                                                        "hello two"]
        assert body["lines"][1]["source"] == "serv:8001"
        nxt = body["next"]
        r = await client.get("/manage/logs", params={"offset": nxt})
        assert (await r.json())["lines"] == []
        ring.append("three", "server")
        r = await client.get("/manage/logs", params={"offset": nxt})
        assert [ln["line"] for ln in (await r.json())["lines"]] == ["three"]
        r = await client.post("/manage/logs/clear")
        assert (await r.json())["cleared"]
        r = await client.get("/manage/logs", params={"offset": 0})
        assert (await r.json())["lines"] == []

    with_client(scenario)


def test_log_ring_bounded_offsets():
    ring = LogRing(maxlen=3)
    for i in range(5):
        ring.append(f"l{i}")
    items, nxt = ring.since(0)
    assert [x["line"] for x in items] == ["l2", "l3", "l4"]
    assert nxt == 5
    items, _ = ring.since(4)
    assert [x["line"] for x in items] == ["l4"]


def test_manage_services_and_stop_unknown(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))

    async def scenario(client, app):
        r = await client.get("/manage/services")
        assert r.status == 200
        assert "services" in await r.json()
        r = await client.post("/manage/stop", json={"port": 59999})
        assert r.status == 404

    with_client(scenario)


def test_manage_serve_spawns_child(monkeypatch):
    """/manage/serve launches `python -m aha_tpu_torch serv <id>` (a stub
    process in its place) and pumps its output into the log ring;
    /manage/stop terminates it."""
    real_popen = subprocess.Popen
    port = _free_port()

    def fake_popen(cmd, **kw):
        assert cmd[:5] == [sys.executable, "-m", "aha_tpu_torch", "serv",
                           MODEL]
        assert "aha_tpu" not in cmd and "--model" not in cmd
        cli.build_parser().parse_args(cmd[3:])
        return real_popen([sys.executable, "-u", "-c",
                           "import time,sys; print('serv up'); "
                           "sys.stdout.flush(); time.sleep(60)"], **kw)

    monkeypatch.setattr(manage.subprocess, "Popen", fake_popen)

    async def scenario(client, app):
        r = await client.post("/manage/serve",
                              json={"model": MODEL, "port": port})
        assert r.status == 200
        pid = (await r.json())["pid"]
        for _ in range(200):
            r = await client.get("/manage/logs", params={"offset": 0})
            lines = (await r.json())["lines"]
            if any("serv up" in ln["line"] for ln in lines):
                break
            await asyncio.sleep(0.05)
        assert any("serv up" in ln["line"] and ln["source"] == f"serv:{port}"
                   for ln in lines), lines
        r = await client.post("/manage/serve",
                              json={"model": MODEL, "port": port})
        assert r.status == 409
        r = await client.post("/manage/stop", json={"port": port})
        assert r.status == 200
        assert (await r.json())["stopped"] == pid
        proc = app["manage"].children[port]
        for _ in range(200):
            if proc.poll() is not None:
                break
            await asyncio.sleep(0.05)
        assert proc.poll() is not None

    with_client(scenario)


def test_manage_settings_roundtrip(tmp_path, monkeypatch):
    """Settings persist (save dir and serve defaults), survive a fresh
    ManageState, reset cleanly; /manage/models reads the set save dir."""
    monkeypatch.setattr(manage, "default_save_dir", lambda: str(tmp_path))
    alt = tmp_path / "alt-weights"
    (alt / "Qwen" / "Qwen3-0.6B").mkdir(parents=True)
    (alt / "Qwen" / "Qwen3-0.6B" / "w.bin").write_bytes(b"xyz")

    async def scenario(client, app):
        s = await (await client.get("/manage/settings")).json()
        assert s["save_dir"] == ""
        assert s["effective_save_dir"] == str(tmp_path)
        r = await client.post("/manage/settings", json={
            "save_dir": str(alt),
            "serve_defaults": {"port": 8005, "tp": 2, "bogus": 1,
                               "spec_tokens": ""}})
        s = await r.json()
        assert s["save_dir"] == str(alt)
        assert s["serve_defaults"] == {"port": 8005, "tp": 2}
        body = await (await client.get("/manage/models")).json()
        assert body["save_dir"] == str(alt)
        by_id = {m["model_id"]: m for m in body["models"]}
        assert by_id[MODEL]["downloaded"] is True
        assert json.loads(
            (tmp_path / "console.json").read_text())["save_dir"] == str(alt)
        assert manage.ManageState().save_dir() == str(alt)
        r = await client.post("/manage/settings",
                              json={"save_dir": "", "serve_defaults": {}})
        s = await r.json()
        assert s["save_dir"] == "" and s["serve_defaults"] == {}
        assert s["effective_save_dir"] == str(tmp_path)
        r = await client.post("/manage/settings",
                              json={"serve_defaults": [1]})
        assert r.status == 400

    with_client(scenario)


def _spawned_cmd(app_module, manage_module, tmp_path, monkeypatch, body):
    """The argv one package's /manage/serve spawns after a save-dir setting
    and serve defaults are set (Popen recorded, nothing started)."""
    monkeypatch.setattr(manage_module, "default_save_dir",
                        lambda: str(tmp_path / "root"))
    seen = {}

    def fake_popen(cmd, **kw):
        seen["cmd"], seen["env"] = cmd, kw.get("env")
        return FakeProc()

    monkeypatch.setattr(manage_module.subprocess, "Popen", fake_popen)

    async def scenario(client, app):
        await client.post("/manage/settings", json={
            "save_dir": str(tmp_path / "alt"),
            "serve_defaults": {"batch_slots": 4, "max_seq_len": 2048}})
        r = await client.post("/manage/serve", json=body)
        assert r.status == 200, await r.text()
        return seen["cmd"]

    return with_client(scenario, app_module=app_module)


def test_manage_serve_applies_setting_defaults(tmp_path, monkeypatch):
    """A spawned `serv` child takes the persisted serve defaults for the
    fields the request leaves blank, and the save-dir setting as
    --weight-path <save dir>/<id>."""
    cmd = _spawned_cmd(None, manage, tmp_path, monkeypatch,
                       {"model": MODEL, "port": 8009, "tp": 2})
    assert cmd[cmd.index("--weight-path") + 1] == \
        os.path.join(str(tmp_path / "alt"), MODEL)
    assert "--save-dir" not in cmd
    assert cmd[cmd.index("--tp") + 1] == "2"
    assert cmd[cmd.index("--batch-slots") + 1] == "4"
    assert cmd[cmd.index("--max-seq-len") + 1] == "2048"
    cmd = _spawned_cmd(None, manage, tmp_path / "b", monkeypatch,
                       {"model": MODEL, "port": 8009,
                        "weight_path": "/given"})
    assert cmd.count("--weight-path") == 1
    assert cmd[cmd.index("--weight-path") + 1] == "/given"


def test_save_dir_setting_child_parses_where_the_jax_child_exits_2(
        tmp_path, monkeypatch, capsys):
    """Reference fault: with a save-dir setting the JAX console appends
    --save-dir, which its `serv` parser refuses (exit 2, so the child dies
    before it binds its port); the port's child gets --weight-path
    <save dir>/<id>, which the port's `serv` parses and resolves to that
    directory."""
    body = {"model": MODEL, "port": 8011}
    jcmd = _spawned_cmd(japp, jmanage, tmp_path / "jax", monkeypatch, body)
    assert jcmd[:4] == [sys.executable, "-m", "aha_tpu", "serv"]
    with pytest.raises(SystemExit) as got:
        jbuild_parser().parse_args(jcmd[3:])
    assert got.value.code == 2
    assert "unrecognized arguments: --save-dir" in capsys.readouterr().err
    cmd = _spawned_cmd(None, manage, tmp_path / "torch", monkeypatch, body)
    args = cli.build_parser().parse_args(cmd[3:])
    target = tmp_path / "torch" / "alt" / MODEL
    target.mkdir(parents=True)
    assert cli.resolve(args) == (MODEL, str(target), None, None)
    assert (args.port, args.batch_slots, args.max_seq_len) == (8011, 4, 2048)


def test_manage_serve_child_inherits_api_key(monkeypatch):
    """A console started with --api-key spawns children that enforce the
    same key: it travels in AHA_API_KEY, never argv."""
    seen = {}

    def fake_popen(cmd, **kw):
        seen["env"], seen["cmd"] = kw.get("env"), cmd
        return FakeProc()

    monkeypatch.setattr(manage.subprocess, "Popen", fake_popen)

    async def scenario(client, app):
        hdr = {"Authorization": "Bearer sk-parent"}
        r = await client.post("/manage/serve", json={"model": MODEL,
                                                     "port": 59997},
                              headers=hdr)
        assert r.status == 200
        assert seen["env"]["AHA_API_KEY"] == "sk-parent"
        assert "--api-key" not in seen["cmd"]
        r = await client.post("/manage/serve", json={"model": MODEL,
                                                     "port": 59996})
        assert r.status == 401

    with_client(scenario, api_key="sk-parent")


# -- the console page ---------------------------------------------------------

def test_index_serves_the_jax_console_page():
    assert webui.INDEX_HTML == __import__(
        "aha_tpu.server.webui", fromlist=["INDEX_HTML"]).INDEX_HTML

    async def scenario(client, app):
        r = await client.get("/")
        assert r.status == 200
        assert r.content_type == "text/html"
        assert await r.text() == webui.INDEX_HTML

    with_client(scenario)


def test_every_console_fetch_is_a_route_of_the_app():
    """Each fetch("...") path in the page (query strings dropped) is a
    route of the port's app, with the method the page uses."""
    paths = set(re.findall(r'fetch\("([^"?]+)', webui.INDEX_HTML))
    assert len(paths) >= 14 and "/manage/serve" in paths
    app = create_app(ServerState())
    routes = {(r.method, r.resource.canonical) for r in app.router.routes()}
    for path in paths:
        assert any(p == path for _, p in routes), path
    posts = set(re.findall(r'fetch\("([^"?]+)",\s*\{\s*method:\s*"POST"',
                           webui.INDEX_HTML))
    for path in posts:
        assert ("POST", path) in routes, path


def test_console_page_stays_open_under_an_api_key():
    async def scenario(client, app):
        assert (await client.get("/")).status == 200
        assert (await client.get("/health")).status == 503
        assert (await client.get("/manage/models")).status == 401
        r = await client.get("/manage/models",
                             headers={"Authorization": "Bearer sk-x"})
        assert r.status == 200

    with_client(scenario, api_key="sk-x")


# -- both apps, all 11 routes --------------------------------------------------

def _shape(x):
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x[:1]]
    return type(x).__name__


def _routes_of(app_module, manage_module, dl_module, root, monkeypatch):
    """(status, body) of each of the 11 /manage routes in turn."""
    monkeypatch.setattr(manage_module, "default_save_dir",
                        lambda: str(root))
    monkeypatch.setattr(dl_module, "download_model", _fake_download)
    monkeypatch.setattr(manage_module.subprocess, "Popen",
                        lambda cmd, **kw: FakeProc())

    async def scenario(client, app):
        out = {}

        async def call(key, method, path, **kw):
            r = await getattr(client, method)(path, **kw)
            out[key] = (r.status, await r.json())

        await call("models", "get", "/manage/models")
        await call("download", "post", "/manage/download",
                   json={"model": MODEL})
        await _download_done(client, MODEL)
        await call("progress", "get", "/manage/download",
                   params={"model": MODEL})
        await call("models_after", "get", "/manage/models")
        await call("delete", "post", "/manage/delete", json={"model": MODEL})
        await call("services", "get", "/manage/services")
        await call("serve", "post", "/manage/serve",
                   json={"model": MODEL, "port": 8123})
        await call("stop", "post", "/manage/stop", json={"port": 8123})
        await call("logs", "get", "/manage/logs", params={"offset": 0})
        await call("clear", "post", "/manage/logs/clear")
        await call("settings", "get", "/manage/settings")
        await call("set_settings", "post", "/manage/settings",
                   json={"serve_defaults": {"port": 8005}})
        return out

    return with_client(scenario, app_module=app_module)


def test_all_manage_routes_answer_the_jax_shapes(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path / "run"))
    got = _routes_of(None, manage, dl, tmp_path / "t", monkeypatch)
    want = _routes_of(japp, jmanage, jdl, tmp_path / "j", monkeypatch)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key][0] == want[key][0], key
        if key == "services":
            assert got[key][1].keys() == want[key][1].keys()
            continue
        assert _shape(got[key][1]) == _shape(want[key][1]), key
    for key in ("progress", "serve", "stop", "clear"):
        assert got[key] == want[key], key
    assert got["models_after"][1]["models"] == [
        dict(m) for m in want["models_after"][1]["models"]]
    assert [ln["source"] for ln in got["logs"][1]["lines"]] == \
        [ln["source"] for ln in want["logs"][1]["lines"]]


# -- serv --manage-only in a child process --------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(url, body=None, timeout=10):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _until(what, fn, deadline_s, proc=None):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited")
        try:
            got = fn()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.2)
    raise AssertionError(f"{what}: not within {deadline_s} s")


@pytest.fixture
def console(tmp_path):
    """Start `serv --manage-only` with AHA_HOME and XDG_RUNTIME_DIR under
    tmp_path; the fixture's value is a function of the extra environment
    giving (base, child, port)."""
    children = []

    def start(**env):
        port = _free_port()
        full = {**{k: v for k, v in os.environ.items()
                   if k not in ("AHA_DEVICE", "AHA_API_KEY")},
                "AHA_HOME": str(tmp_path / "home"),
                "XDG_RUNTIME_DIR": str(tmp_path / "run"),
                "PYTHONPATH": str(ROOT), **env}
        log = open(tmp_path / f"console_{port}.log", "w")
        child = subprocess.Popen(
            [sys.executable, "-m", "aha_tpu_torch", "serv", "--manage-only",
             "--port", str(port)], env=full, cwd=str(ROOT), stdout=log,
            stderr=subprocess.STDOUT)
        children.append((child, log))
        base = f"http://127.0.0.1:{port}"
        _until("console up", lambda: _call(base + "/")[0] == 200, 60, child)
        return base, child, port

    yield start
    for child, log in children:
        child.terminate()
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=10)
        log.close()


def _logs(base, source):
    status, text = _call(base + "/manage/logs?offset=0")
    assert status == 200
    return [ln["line"] for ln in json.loads(text)["lines"]
            if ln["source"] == source]


def test_manage_only_needs_no_card_and_its_child_refuses_one(console,
                                                             tmp_path):
    """With no card and AHA_DEVICE unset: the console serves / and
    /manage, /health says no model, its PID file exists; a model server it
    spawns refuses the missing card (AHA_DEVICE=cpu named in its log) and
    exits."""
    base, child, port = console(CUDA_VISIBLE_DEVICES="")
    assert _call(base + "/health")[0] == 503
    status, text = _call(base + "/manage/models")
    assert status == 200 and len(json.loads(text)["models"]) >= 40
    assert (tmp_path / "run" / "aha" / f"{port}.pid").read_text().strip() \
        == str(child.pid)
    (tmp_path / "home" / "Qwen" / "Qwen3-0.6B").mkdir(parents=True)
    build_tiny_qwen3_repo(str(tmp_path / "home" / "Qwen" / "Qwen3-0.6B"))
    sport = _free_port()
    status, _ = _call(base + "/manage/serve", {"model": MODEL,
                                               "port": sport})
    assert status == 200
    exited = _until("child exit", lambda: [
        ln for ln in _logs(base, "manage")
        if ln.startswith(f"server on port {sport} exited")], 120, child)
    assert exited == [f"server on port {sport} exited rc=1"]
    assert any("AHA_DEVICE=cpu" in ln for ln in _logs(base, f"serv:{sport}"))


def test_manage_only_serves_lists_and_stops_a_model(console, tmp_path,
                                                    monkeypatch):
    """The lifecycle on the CPU: a downloaded model under AHA_HOME is
    listed with its bytes, /manage/serve starts `serv <id>`, which answers
    a chat as the model loaded in process does; /manage/services lists
    it, /manage/logs carries its lines, /manage/stop ends it and its PID
    file goes."""
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    home = tmp_path / "home" / "Qwen" / "Qwen3-0.6B"
    home.mkdir(parents=True)
    build_tiny_qwen3_repo(str(home))
    base, child, _ = console(AHA_DEVICE="cpu")
    status, text = _call(base + "/manage/models")
    item = {m["model_id"]: m for m in json.loads(text)["models"]}[MODEL]
    size = sum(p.stat().st_size for p in home.rglob("*") if p.is_file())
    assert item["downloaded"] and item["bytes"] == size
    sport = _free_port()
    status, text = _call(base + "/manage/serve",
                         {"model": MODEL, "port": sport,
                          "max_seq_len": 256})
    assert status == 200, text
    pid = json.loads(text)["pid"]
    served = f"http://127.0.0.1:{sport}"
    _until("model server up",
           lambda: _call(served + "/health")[0] == 200, 120, child)
    body = {"model": MODEL, "max_tokens": 8, "temperature": 0.0,
            "stream": False, "messages": [{"role": "user",
                                           "content": "hello world"}]}
    status, text = _call(served + "/v1/chat/completions", body, timeout=60)
    assert status == 200, text
    want = load_model(MODEL, str(home), max_seq_len=256).generate(
        ChatCompletionParameters.model_validate(body))
    assert json.loads(text)["choices"][0]["message"] == \
        json.loads(json.dumps(want.to_json_dict()))["choices"][0]["message"]
    status, text = _call(base + "/manage/services")
    assert any(s["pid"] == pid and s["port"] == sport
               for s in json.loads(text)["services"]), text
    assert any("model loaded" in ln for ln in _logs(base, f"serv:{sport}"))
    status, text = _call(base + "/manage/stop", {"port": sport})
    assert status == 200 and json.loads(text)["stopped"] == pid
    _until("model server exit", lambda: any(
        ln.startswith(f"server on port {sport} exited")
        for ln in _logs(base, "manage")), 60, child)
    assert not (tmp_path / "run" / "aha" / f"{sport}.pid").exists()
    shutil.rmtree(home)
