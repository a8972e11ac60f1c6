"""OpenAI-compatible HTTP server for the port (aiohttp).

The port's copy of aha_tpu/server/app.py's serving routes: the same
server state, auth middleware and chat / audio transcriptions (multipart)
/ speech synthesis / background removal / embeddings / rerank / health /
models / shutdown handlers, with the same status codes and error strings,
so both packages answer the same wire format.  The /manage routes and the
web console are not ported.

One model in memory; generation runs in a worker thread guarded by an
asyncio lock (the reference's write-lock serialization, api.rs:31/:131) —
except chat on a continuous-batching model (concurrent_streams > 1), where
requests run concurrently and the engine schedules slots itself.
Embedding and rerank calls always run behind the lock.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import tempfile
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Optional

from aiohttp import web

from aha_tpu_torch.models.base import LoadedModel, UnsupportedOperation
from aha_tpu_torch.params import (ChatCompletionParameters, EmbeddingData,
                                  EmbeddingResponse, RerankRequest,
                                  RerankResponse, RerankResult)
from aha_tpu_torch.params.asr import TranscriptionResponse, error_response

__all__ = ["ServerState", "create_app", "start_http_server"]

FILE_LIMIT = 100 * 1024 * 1024      # 100 MiB (server/mod.rs:52-54)

# 29-language code → name map used by the ASR endpoint (src/server/asr.rs /
# utils/mod.rs:593-633)
LANGUAGE_NAMES = {
    "zh": "Chinese", "en": "English", "yue": "Cantonese", "ja": "Japanese",
    "ko": "Korean", "de": "German", "fr": "French", "es": "Spanish",
    "it": "Italian", "pt": "Portuguese", "ru": "Russian", "ar": "Arabic",
    "hi": "Hindi", "th": "Thai", "vi": "Vietnamese", "id": "Indonesian",
    "ms": "Malay", "tr": "Turkish", "nl": "Dutch", "pl": "Polish",
    "sv": "Swedish", "da": "Danish", "no": "Norwegian", "fi": "Finnish",
    "cs": "Czech", "uk": "Ukrainian", "el": "Greek", "he": "Hebrew",
    "hu": "Hungarian",
}


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


def clean_asr_response(text: str) -> str:
    """Strip the <asr_text> prefix markers (utils/mod.rs:634)."""
    for tag in ("<asr_text>", "</asr_text>"):
        text = text.replace(tag, "")
    return text.strip()


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
            # cache even when the client disconnects mid-stream; a model
            # that refuses to stream (an embedding model) raises on the
            # call itself, which streams as the error event
            gen = None
            try:
                gen = state.model.generate_stream(mes)
                for chunk in gen:
                    if cancel.is_set() or not _put(("chunk", chunk)):
                        return
                _put(("done", DONE))
            except Exception as e:
                if not cancel.is_set():
                    _put(("error", str(e)))
            finally:
                if gen is not None:
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


async def remove_background(request: web.Request) -> web.Response:
    return await _generate_json(request)


async def speech(request: web.Request) -> web.Response:
    return await _generate_json(request)


async def _generate_json(request: web.Request) -> web.Response:
    """A non-stream generate answered with the whole response JSON as
    text/plain: 503 with no model, 400 on a body that is not a chat
    request, 500 with the model's error text."""
    state = _state(request)
    if state.model is None:
        return web.Response(status=503, text="model not init")
    try:
        mes = ChatCompletionParameters.model_validate(await request.json())
    except Exception as e:
        return web.Response(status=400, text=f"invalid request: {e}")
    async with state.lock:
        try:
            resp = await _run_blocking(state.model.generate, mes)
        except Exception as e:
            return web.Response(status=500, text=str(e))
    return web.Response(text=json.dumps(resp.to_json_dict()),
                        content_type="text/plain")


async def transcriptions(request: web.Request) -> web.Response:
    """Multipart ASR endpoint (src/server/asr.rs): the uploaded file goes
    to a temporary file, wrapped into a chat request with an audio_url
    part (language as metadata, temperature), the reply's text cleaned of
    its <asr_text> markers; the file is removed afterwards."""
    state = _state(request)
    if state.model is None:
        return web.json_response(
            error_response("Model not initialized", "server_error"), status=503)
    try:
        reader = await request.multipart()
    except Exception:
        return web.json_response(
            error_response("expected multipart form data"), status=400)

    file_bytes = None
    filename = "audio"
    language = None
    temperature = None
    async for part in reader:
        if part.name == "file":
            filename = part.filename or "audio"
            file_bytes = await part.read(decode=False)
            if len(file_bytes) > FILE_LIMIT:
                return web.json_response(
                    error_response("file too large"), status=413)
        elif part.name == "language":
            language = (await part.text()).strip() or None
        elif part.name == "temperature":
            try:
                temperature = float(await part.text())
            except ValueError:
                pass
        else:
            await part.read(decode=False)

    if not file_bytes:
        return web.json_response(
            error_response("No audio file provided"), status=400)

    suffix = os.path.splitext(filename)[1] or ".wav"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(file_bytes)
        tmp_path = f.name
    try:
        metadata = {}
        if language:
            metadata["language"] = LANGUAGE_NAMES.get(language, language)
        mes = ChatCompletionParameters.model_validate({
            "messages": [{
                "role": "user",
                "content": [{"type": "audio_url",
                             "audio_url": {"url": f"file://{tmp_path}"}}],
            }],
            "model": state.model.entry.model_id,
            "metadata": metadata or None,
            "temperature": temperature,
        })
        async with state.lock:
            try:
                resp = await _run_blocking(state.model.generate, mes)
            except Exception as e:
                return web.json_response(
                    error_response(str(e), "server_error"), status=500)
        text = ""
        if resp.choices and resp.choices[0].message.content:
            text = resp.choices[0].message.text()
        return web.json_response(
            TranscriptionResponse(text=clean_asr_response(text)).to_json_dict())
    finally:
        os.unlink(tmp_path)


async def embeddings(request: web.Request) -> web.Response:
    state = _state(request)
    try:
        body = await request.json()
    except Exception:
        return web.json_response({"error": "invalid JSON body"}, status=400)
    raw = body.get("input")
    if isinstance(raw, str):
        texts = [raw]
    elif isinstance(raw, list):
        if not raw:
            return web.json_response(
                {"error": "embedding input cannot be empty"}, status=400)
        if not all(isinstance(x, str) for x in raw):
            return web.json_response(
                {"error": "embedding input array must contain only strings"},
                status=400)
        texts = raw
    else:
        return web.json_response(
            {"error": "embedding input must be a string or an array of strings"},
            status=400)
    if state.model is None:
        return web.json_response({"error": "model not init"}, status=503)
    async with state.lock:
        try:
            vecs = await _run_blocking(state.model.embedding, texts)
        except (UnsupportedOperation, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
    resp = EmbeddingResponse(
        object="list",
        model=state.model.entry.model_id,
        data=[EmbeddingData(object="embedding", index=i, embedding=v)
              for i, v in enumerate(vecs)],
    )
    return web.json_response(resp.to_json_dict())


async def rerank(request: web.Request) -> web.Response:
    state = _state(request)
    try:
        req = RerankRequest.model_validate(await request.json())
    except Exception as e:
        return web.json_response({"error": f"invalid request: {e}"}, status=400)
    if not req.query.strip():
        return web.json_response({"error": "rerank query cannot be empty"},
                                 status=400)
    if not req.documents:
        return web.json_response({"error": "rerank documents cannot be empty"},
                                 status=400)
    if state.model is None:
        return web.json_response({"error": "model not init"}, status=503)
    async with state.lock:
        try:
            scores = await _run_blocking(state.model.rerank, req.query,
                                         req.documents)
        except (UnsupportedOperation, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
    results = [RerankResult(index=i, relevance_score=s, document=d)
               for i, (s, d) in enumerate(zip(scores, req.documents))]
    results.sort(key=lambda r: r.relevance_score, reverse=True)
    if req.top_n is not None:
        results = results[: req.top_n]
    resp = RerankResponse(object="list", model=state.model.entry.model_id,
                          results=results)
    return web.json_response(resp.to_json_dict())


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
        web.post("/images/remove_background", remove_background),
        web.post("/audio/speech", speech),
        web.post("/audio/transcriptions", transcriptions),
        web.post("/v1/audio/transcriptions", transcriptions),
        web.post("/embeddings", embeddings),
        web.post("/v1/embeddings", embeddings),
        web.post("/rerank", rerank),
        web.post("/v1/rerank", rerank),
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
