"""The port's host-side I/O against the reference's behaviour: an http
image URL is fetched (utils/image.load_image, as aha_tpu/utils/image.py
does with `requests`), and the server writes `<port>.pid` when it starts
and removes it when it stops (server/app.start_http_server, as
aha_tpu/server/app.py does).  Both run against 127.0.0.1 only."""

import http.server
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from aha_tpu_torch.utils.image import load_image

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def png_dir(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)).save(
        tmp_path / "img.png")
    return tmp_path


def test_http_image_equals_the_file(png_dir):
    """A PNG served by http.server on 127.0.0.1 loads equal to the same
    file read from disk; a missing one raises (raise_for_status)."""
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(
        *a, directory=str(png_dir), **kw)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        got = np.asarray(load_image(f"{base}/img.png"))
        want = np.asarray(load_image(str(png_dir / "img.png")))
        assert got.shape == (20, 30, 3)
        np.testing.assert_array_equal(got, want)
        import requests

        with pytest.raises(requests.HTTPError):
            load_image(f"{base}/missing.png")
    finally:
        server.shutdown()
        server.server_close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_writes_and_removes_its_pid_file(tmp_path):
    """start_http_server in a child process under a temporary
    XDG_RUNTIME_DIR: `<port>.pid` holds the child's PID while it serves
    and is gone after SIGTERM stops it."""
    port = _free_port()
    pid_file = tmp_path / "aha" / f"{port}.pid"
    code = ("from aha_tpu_torch.server.app import ServerState, "
            "start_http_server; "
            f"start_http_server(ServerState(), '127.0.0.1', {port})")
    env = {**os.environ, "XDG_RUNTIME_DIR": str(tmp_path),
           "PYTHONPATH": str(ROOT), "AHA_DEVICE": "cpu"}
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        up = False
        while time.monotonic() < deadline and child.poll() is None:
            try:        # 503 (no model) once the app answers
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                       timeout=2)
            except urllib.error.HTTPError as e:
                up = e.code == 503
            except OSError:
                pass
            if up:
                break
            time.sleep(0.2)
        assert up, child.stderr.read().decode()[-2000:] \
            if child.poll() is not None else "server did not answer"
        assert pid_file.read_text().strip() == str(child.pid)
        child.send_signal(signal.SIGTERM)
        child.wait(timeout=30)
        assert not pid_file.exists()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
