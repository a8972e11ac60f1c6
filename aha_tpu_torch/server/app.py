"""OpenAI-compatible HTTP server for the port (aiohttp).

The port's copy of the chat-serving part of aha_tpu/server/app.py: the
same server state, auth middleware and chat / health / models / shutdown
handlers, so both packages answer the same wire format.  The /manage
routes and the embedding / rerank / audio / image endpoints are not ported
yet.

One model in memory; generation runs in a worker thread guarded by an
asyncio lock (the reference's write-lock serialization, api.rs:31/:131) —
except chat on a continuous-batching model (concurrent_streams > 1), where
requests run concurrently and the engine schedules slots itself.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Optional

from aiohttp import web

from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.params import ChatCompletionParameters

__all__ = ["ServerState", "create_app", "start_http_server"]

FILE_LIMIT = 100 * 1024 * 1024      # 100 MiB (server/mod.rs:52-54)


class ServerState:
    def __init__(self, model: Optional[LoadedModel] = None,
                 allow_remote_shutdown: bool = False, port: int = 8000,
                 api_key: Optional[str] = None):
        self.model = model
        self.allow_remote_shutdown = allow_remote_shutdown
        self.port = port
        self.api_key = api_key
        self.lock = asyncio.Lock()

    def chat_gate(self):
        """Serialize chat generations — unless the model sits on the
        continuous-batching engine, which admits concurrent requests
        (concurrent_streams > 1) and does its own slot scheduling."""
        if self.model is not None and \
                getattr(self.model, "concurrent_streams", 1) > 1:
            return _NULL_GATE
        return self.lock


class _NullGate:
    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False


_NULL_GATE = _NullGate()


def _state(request: web.Request) -> ServerState:
    return request.app["state"]


async def _run_blocking(fn, *args):
    return await asyncio.get_event_loop().run_in_executor(None, fn, *args)


async def chat(request: web.Request) -> web.StreamResponse:
    state = _state(request)
    try:
        body = await request.json()
        mes = ChatCompletionParameters.model_validate(body)
    except Exception as e:
        return web.Response(status=400, text=f"invalid request: {e}")

    if state.model is None:
        return web.Response(status=503, text="model not init")

    if mes.stream is False:
        async with state.chat_gate():
            try:
                resp = await _run_blocking(state.model.generate, mes)
            except Exception as e:
                return web.Response(status=500, text=str(e))
        return web.Response(text=json.dumps(resp.to_json_dict()),
                            content_type="text/plain")

    # SSE stream (api.rs:129-158): data: {json}\n\n …, then data: [DONE]\n\n
    response = web.StreamResponse(
        status=200, headers={"Content-Type": "text/event-stream",
                             "Cache-Control": "no-cache"})
    await response.prepare(request)
    async with state.chat_gate():
        queue: asyncio.Queue = asyncio.Queue(maxsize=64)
        loop = asyncio.get_event_loop()
        DONE = object()
        cancel = threading.Event()

        def _put(item) -> bool:
            """Enqueue from the producer thread; returns False on cancel."""
            fut = asyncio.run_coroutine_threadsafe(queue.put(item), loop)
            while True:
                try:
                    fut.result(timeout=0.5)
                    return True
                except FuturesTimeout:
                    if cancel.is_set():
                        fut.cancel()
                        return False

        def producer():
            # closing the generator (finally:) returns the engine's pooled KV
            # cache even when the client disconnects mid-stream
            gen = state.model.generate_stream(mes)
            try:
                for chunk in gen:
                    if cancel.is_set() or not _put(("chunk", chunk)):
                        return
                _put(("done", DONE))
            except Exception as e:
                if not cancel.is_set():
                    _put(("error", str(e)))
            finally:
                gen.close()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = await queue.get()
                if kind == "chunk":
                    payload = json.dumps(item.to_json_dict())
                    await response.write(f"data: {payload}\n\n".encode())
                elif kind == "error":
                    await response.write(
                        ("data: " + json.dumps({"error": item})
                         + "\n\n").encode())
                    break
                else:
                    await response.write(b"data: [DONE]\n\n")
                    break
        except (ConnectionResetError, ConnectionError, asyncio.CancelledError):
            pass  # client went away; producer is signalled below
        finally:
            cancel.set()
            t.join(timeout=60)
    try:
        await response.write_eof()
    except (ConnectionResetError, ConnectionError):
        pass
    return response


async def health(request: web.Request) -> web.Response:
    if _state(request).model is not None:
        return web.json_response({"status": "ok"})
    return web.json_response(
        {"status": "unhealthy", "error": "model not initialized"}, status=503)


async def models(request: web.Request) -> web.Response:
    state = _state(request)
    if state.model is None:
        return web.json_response({"error": "model not initialized"}, status=503)
    entry = state.model.entry
    return web.json_response({
        "object": "list",
        "data": [{"id": entry.model_id, "object": "model", "created": None,
                  "owned_by": entry.owner}],
    })


async def shutdown(request: web.Request) -> web.Response:
    state = _state(request)
    peer = request.remote or ""
    is_local = peer in ("127.0.0.1", "::1", "localhost", "")
    if not state.allow_remote_shutdown and not is_local:
        return web.json_response(
            {"error": "remote shutdown not allowed"}, status=403)
    from aha_tpu_torch.server.process import cleanup_pid_file

    cleanup_pid_file(state.port)

    def delayed_exit():
        import time

        time.sleep(1)
        os._exit(0)

    threading.Thread(target=delayed_exit, daemon=True).start()
    return web.json_response({"message": "Shutting down..."})


# routes usable without a key when --api-key is set: the health probe
# (process supervisors)
_AUTH_EXEMPT = {"/health"}


@web.middleware
async def _auth_middleware(request: web.Request, handler):
    key = request.app["state"].api_key
    if key and request.path not in _AUTH_EXEMPT:
        got = request.headers.get("Authorization", "")
        if not hmac.compare_digest(got.encode(), f"Bearer {key}".encode()):
            return web.json_response(
                {"error": {"message": "invalid or missing API key",
                           "type": "authentication_error"}},
                status=401)
    return await handler(request)


def create_app(state: ServerState | None = None) -> web.Application:
    app = web.Application(client_max_size=FILE_LIMIT,
                          middlewares=[_auth_middleware])
    app["state"] = state or ServerState()
    app.add_routes([
        web.post("/v1/chat/completions", chat),
        web.post("/chat/completions", chat),
        web.get("/health", health),
        web.get("/models", models),
        web.get("/v1/models", models),
        web.post("/shutdown", shutdown),
    ])
    return app


def start_http_server(state: ServerState, address: str = "127.0.0.1",
                      port: int = 8000) -> None:
    """Blocking server start: `<port>.pid` is written before the app runs
    and removed when it stops (server/process.py)."""
    from aha_tpu_torch.server.process import (cleanup_pid_file,
                                              create_pid_file)

    state.port = port
    create_pid_file(os.getpid(), port)
    try:
        web.run_app(create_app(state), host=address, port=port, print=None)
    finally:
        cleanup_pid_file(port)
