"""Request traces on torch.profiler (aha_tpu_torch/utils/profiling.py),
against the JAX package's jax.profiler hooks (aha_tpu/utils/profiling.py):
nothing happens unconfigured; a configured request writes one
*.pt.trace.json holding its range and the engine's prefill / decode
ranges; a small Qwen3 TextEngine gives the same greedy tokens traced and
untraced; two overlapping request traces both complete in the port (the
second untraced, and logged so), where the JAX package's second raises;
the served app's hooks write a trace per request; and the capture
listener of --profile-port traces every thread for N ms."""

import glob
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import aha_tpu_torch.utils.profiling as prof


@pytest.fixture(autouse=True)
def unconfigured(monkeypatch):
    """Each test starts (and leaves) the module unconfigured."""
    monkeypatch.setattr(prof, "_profile_dir", None)
    monkeypatch.setattr(prof, "_capture_dir", None)
    monkeypatch.setattr(prof, "_server", None)
    monkeypatch.delenv("AHA_PROFILE_DIR", raising=False)
    monkeypatch.delenv("AHA_PROFILE_PORT", raising=False)
    yield
    if prof._server is not None:
        prof._server.shutdown()
        prof._server.server_close()


def _traces(d) -> list[str]:
    return sorted(glob.glob(os.path.join(str(d), "*.pt.trace.json")))


def _names(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_noop_without_configure(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert prof.profile_dir() is None
    with prof.request_trace("x"):
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_configure_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("AHA_PROFILE_DIR", str(tmp_path / "env"))
    prof.configure()
    assert prof.profile_dir() == str(tmp_path / "env")
    assert os.path.isdir(tmp_path / "env")
    prof.configure(profile_dir=str(tmp_path / "flag"))
    assert prof.profile_dir() == str(tmp_path / "flag")


def test_request_trace_writes_its_ranges(tmp_path, capsys):
    prof.configure(profile_dir=str(tmp_path))
    with prof.request_trace("unit"):
        with prof.annotate("prefill"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with prof.step_annotation("decode", 3):
            torch.ones(8) * 2
    files = _traces(tmp_path)
    assert len(files) == 1 and os.path.basename(files[0]).startswith("unit.")
    names = _names(files[0])
    assert {"unit", "prefill", "decode#3", "aten::mm"} <= names
    assert f"trace {files[0]}" in capsys.readouterr().out


def _tiny_engine():
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    cfg = Qwen3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, head_dim=16)
    model = Qwen3Model(cfg)
    params = model.init_random(torch.Generator().manual_seed(0))
    return TextEngine(model, params, eos_token_ids=[], max_seq_len=128,
                      cache_dtype=torch.float32)


def test_engine_generate_under_trace_gives_the_untraced_tokens(tmp_path):
    """A 40-token greedy generate (two decode blocks and a tail) traced and
    untraced: the same tokens; the trace holds one prefill range and a
    decode range a block, each named by its first step."""
    from aha_tpu_torch.core.sampling import SamplingConfig

    eng = _tiny_engine()
    ids = np.random.default_rng(0).integers(1, 64, 20).tolist()
    greedy = SamplingConfig(temperature=None)
    want = eng.generate_tokens(ids, greedy, max_tokens=40)
    prof.configure(profile_dir=str(tmp_path))
    with prof.request_trace("generate"):
        got = eng.generate_tokens(ids, greedy, max_tokens=40)
    assert got == want and len(got) == 40
    names = _names(_traces(tmp_path)[0])
    assert "prefill" in names
    assert {"decode#1", "decode#17", "decode#33"} <= names


def test_a_trace_that_cannot_be_written_leaves_the_request_served(
        tmp_path, capsys):
    """The profile directory removed under a running server: the request
    completes and the log says no trace was written."""
    prof.configure(profile_dir=str(tmp_path / "gone"))
    os.rmdir(tmp_path / "gone")
    with prof.request_trace("lost"):
        out = torch.ones(4).sum()
    assert float(out) == 4.0
    assert "lost: no trace written" in capsys.readouterr().out


def test_overlapping_traces_both_complete(tmp_path, capsys):
    """Reference fault: a request that starts while another's trace runs.
    The port serves it untraced (one trace file, a log line); the JAX
    package's jax.profiler raises on the second trace."""
    prof.configure(profile_dir=str(tmp_path))
    inside, done = threading.Event(), threading.Event()
    errors = []

    def first():
        try:
            with prof.request_trace("first"):
                inside.set()
                done.wait(30)
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=first)
    t.start()
    assert inside.wait(30)
    with prof.request_trace("second"):
        out = torch.ones(4).sum()
    done.set()
    t.join(30)
    assert not errors and float(out) == 4.0
    assert [os.path.basename(p).split(".")[0] for p in _traces(tmp_path)] \
        == ["first"]
    assert "second: a trace is running; this request is served untraced" \
        in capsys.readouterr().out


def test_overlapping_traces_raise_in_the_jax_package(tmp_path, monkeypatch):
    import aha_tpu.utils.profiling as jprof

    monkeypatch.setattr(jprof, "_profile_dir", str(tmp_path))
    inside, done = threading.Event(), threading.Event()

    def first():
        with jprof.request_trace("first"):
            inside.set()
            done.wait(30)

    t = threading.Thread(target=first)
    t.start()
    try:
        assert inside.wait(30)
        with pytest.raises(RuntimeError, match="already been started"):
            with jprof.request_trace("second"):
                pass
    finally:
        done.set()
        t.join(30)


def test_served_requests_write_a_trace_each(tmp_path, monkeypatch):
    """The app's hooks: a non-stream chat traces `generate`, a streamed
    one `generate_stream`, each file holding the engine's prefill."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.server.app import ServerState, create_app
    from tests.fixtures import build_tiny_qwen3_repo

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    build_tiny_qwen3_repo(str(tmp_path / "repo"))
    served = load_model("Qwen/Qwen3-0.6B", str(tmp_path / "repo"),
                        max_seq_len=256)
    prof.configure(profile_dir=str(tmp_path / "traces"))
    body = {"model": "Qwen/Qwen3-0.6B", "max_tokens": 4, "temperature": 0.0,
            "messages": [{"role": "user", "content": "hello world"}]}

    async def ask():
        client = TestClient(TestServer(create_app(ServerState(model=served))))
        await client.start_server()
        try:
            r = await client.post("/v1/chat/completions",
                                  json={**body, "stream": False})
            assert r.status == 200
            r = await client.post("/v1/chat/completions",
                                  json={**body, "stream": True})
            assert r.status == 200 and "[DONE]" in await r.text()
        finally:
            await client.close()

    asyncio.run(ask())
    files = _traces(tmp_path / "traces")
    stems = sorted(os.path.basename(p).split(".")[0] for p in files)
    assert stems == ["generate", "generate_stream"]
    for p in files:
        assert "prefill" in _names(p)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_capture_listener_traces_the_next_ms(tmp_path, capsys):
    """--profile-port: GET /capture?ms=N writes a trace of the process's
    next N ms (another thread's ranges too, where torch offers it) and
    answers its path; a request traced meanwhile runs untraced; bad
    queries are refused."""
    port = _free_port()
    prof.configure(profile_port=port)
    assert prof.profile_dir() is None
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()

    def work():
        while not stop.is_set():
            with prof.annotate("in_worker"):
                torch.ones(32, 32) @ torch.ones(32, 32)

    t = threading.Thread(target=work)
    t.start()
    try:
        status, body = _get(base + "/capture?ms=200")
    finally:
        stop.set()
        t.join(30)
    assert status == 200 and body["ms"] == 200
    assert os.path.dirname(body["path"]) == prof._capture_dir
    assert body["bytes"] == os.path.getsize(body["path"])
    names = _names(body["path"])
    if prof._all_threads() is not None:
        assert "in_worker" in names
    assert _get(base + "/capture?ms=0")[0] == 400
    assert _get(base + "/capture?ms=x")[0] == 400
    assert _get(base + "/nothing")[0] == 404
    os.remove(body["path"])
    assert f"capture of 200 ms: {body['path']}" in capsys.readouterr().out
    os.rmdir(prof._capture_dir)           # a failed export answers 500
    assert _get(base + "/capture?ms=10")[0] == 500


def test_capture_waits_for_a_request_trace(tmp_path):
    """A capture that arrives during a request trace starts when it ends
    (one profiler at a time), writing into the profile directory."""
    port = _free_port()
    prof.configure(profile_dir=str(tmp_path), profile_port=port)
    got = {}
    with prof.request_trace("request"):
        t = threading.Thread(target=lambda: got.update(
            r=_get(f"http://127.0.0.1:{port}/capture?ms=20")))
        t.start()
        t.join(0.3)
        assert t.is_alive()
    t.join(30)
    status, body = got["r"]
    assert status == 200
    assert sorted(os.path.basename(p).split(".")[0]
                  for p in _traces(tmp_path)) == ["capture", "request"]


def test_device_timing_stops_paying_for_empty_traces(monkeypatch, capsys):
    """profile_decode.device_ms_per_kernel, which chip_smoke.py times every
    kernel with: while the profiler's traces come back empty, a call takes
    TRACE_ATTEMPTS traces, the next ones one each, and after
    STREAK_GIVE_UP such calls only every PROBE_EVERY-th call takes one;
    the others are timed with CUDA events.  The first trace that holds the
    kernels ends the spell.  (The profiler and the card are stand-ins.)"""
    from aha_tpu_torch.utils import profile_decode as pd

    state = {"empty": True, "traces": 0}

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 2.0

    class Trace:
        def __init__(self, activities):
            pass

        def __enter__(self):
            state["traces"] += 1
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            if state["empty"]:
                return []
            return [type("E", (), {
                "key": "kernel", "count": 10, "self_device_time_total": 500.0,
                "device_type": torch.autograd.DeviceType.CUDA})()]

    monkeypatch.setattr(torch.profiler, "profile", Trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(pd, "_fallback_streak", 0)
    monkeypatch.setattr(pd, "TRACE_STATS", dict.fromkeys(pd.TRACE_STATS, 0))
    calls = []

    def call():
        before = state["traces"]
        ms = pd.device_ms_per_kernel(lambda: None, iters=10, warmup=0)
        calls.append(state["traces"] - before)
        return ms

    assert pd.STREAK_GIVE_UP == 4 and pd.PROBE_EVERY == 8
    for _ in range(9):
        assert call() == {"(CUDA events)": 0.2}
    assert calls == [pd.TRACE_ATTEMPTS, 1, 1, 1, 0, 0, 0, 0, 1]
    state["empty"] = False
    for _ in range(7):
        assert call() == {"(CUDA events)": 0.2}
    assert call() == {"kernel": 0.05}
    assert call() == {"kernel": 0.05}
    assert calls[9:] == [0] * 7 + [1, 1]
    assert pd.TRACE_STATS["calls"] == 18
    assert pd.TRACE_STATS["traces"] == sum(calls) == 9
    assert pd.TRACE_STATS["empty_traces"] == 7
    assert pd.TRACE_STATS["event_timed"] == 16
    err = capsys.readouterr().err
    assert err.count("stayed empty") == 1
    assert "4 calls in a row timed with CUDA events" in err
    assert "traces are back after 16 call(s)" in err
