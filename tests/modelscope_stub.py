"""A local stand-in for ModelScope's file API, serving directories of this
machine as model repositories on 127.0.0.1 (no network):

    GET /api/v1/models/<id>/repo/files?Recursive=true&Revision=master
        {"Code": 200, "Data": {"Files": [{"Path", "Size", "Type"}, ...]}}
        (a "tree" entry for each subdirectory, a "blob" for each file)
    GET /api/v1/models/<id>/repo?Revision=master&FilePath=<path>
        the file's bytes

Point a downloader's MODELSCOPE_API at `stub.api`.  `fail` makes every
listing fail ("json": a body with Code 500; "http": status 500);
`flaky` names files whose first fetch answers 500.  `requests` records
each request's path and query, in order.  The chip smoke loads this file
by its path, as it loads tests/fixtures.py.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

PREFIX = "/api/v1/models/"
CHUNK = 1 << 20


def repo_files(root: str) -> list[dict]:
    """The listing of `root`: sorted, trees before their files."""
    out = []
    for d, dirs, files in os.walk(root):
        dirs.sort()
        rel = os.path.relpath(d, root)
        if rel != ".":
            out.append({"Path": rel.replace(os.sep, "/"), "Type": "tree",
                        "Size": 0})
        for f in sorted(files):
            p = os.path.join(d, f)
            out.append({"Path": os.path.relpath(p, root).replace(os.sep, "/"),
                        "Type": "blob", "Size": os.path.getsize(p)})
    return out


class ModelScopeStub:
    def __init__(self, repos: dict[str, str], fail: str | None = None,
                 flaky: tuple[str, ...] = ()):
        self.repos = repos
        self.fail = fail
        self.flaky = set(flaky)
        self.requests: list[tuple[str, dict]] = []
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                stub._serve(self)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.api = (f"http://127.0.0.1:{self._server.server_address[1]}"
                    f"{PREFIX.rstrip('/')}")

    def __enter__(self) -> "ModelScopeStub":
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()

    def _serve(self, h: BaseHTTPRequestHandler) -> None:
        url = urlparse(h.path)
        query = {k: v[0] for k, v in parse_qs(url.query).items()}
        path = unquote(url.path)
        with self._lock:
            self.requests.append((path, query))
        if not path.startswith(PREFIX):
            return self._json(h, 404, {"Code": 404, "Message": "no route"})
        rest = path[len(PREFIX):]
        if rest.endswith("/repo/files"):
            return self._list(h, rest[:-len("/repo/files")])
        if rest.endswith("/repo"):
            return self._file(h, rest[:-len("/repo")], query.get("FilePath"))
        return self._json(h, 404, {"Code": 404, "Message": "no route"})

    def _list(self, h, model_id: str) -> None:
        if self.fail == "http":
            return self._json(h, 500, {"Code": 500, "Message": "stub failure"})
        if self.fail == "json":
            return self._json(h, 200, {"Code": 500, "Message": "stub failure"})
        root = self.repos.get(model_id)
        if root is None:
            return self._json(h, 200, {"Code": 404,
                                       "Message": f"no model {model_id}"})
        self._json(h, 200, {"Code": 200,
                            "Data": {"Files": repo_files(root)}})

    def _file(self, h, model_id: str, rel: str | None) -> None:
        root = self.repos.get(model_id)
        path = None if root is None or rel is None else \
            os.path.join(root, *rel.split("/"))
        if path is None or not os.path.isfile(path):
            return self._json(h, 404, {"Code": 404, "Message": "no file"})
        with self._lock:
            flaky = rel in self.flaky
            self.flaky.discard(rel)
        if flaky:
            return self._json(h, 500, {"Code": 500, "Message": "flaky"})
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(os.path.getsize(path)))
        h.end_headers()
        with open(path, "rb") as f:
            while chunk := f.read(CHUNK):
                h.wfile.write(chunk)

    @staticmethod
    def _json(h, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
