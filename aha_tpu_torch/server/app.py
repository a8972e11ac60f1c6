"""OpenAI-compatible HTTP server for the port (aiohttp).

Reuses aha_tpu's server state, auth middleware and the chat / health /
models / shutdown handlers, so both packages answer the same wire format.
It builds its own application: aha_tpu's `create_app` also mounts the
/manage routes, whose module imports jax.  Those routes, and the
embedding / rerank / audio / image endpoints, are not ported yet.
"""

from __future__ import annotations

from aiohttp import web

from aha_tpu.server.app import (FILE_LIMIT, ServerState, _auth_middleware,
                                chat, health, models, shutdown)

__all__ = ["ServerState", "create_app", "start_http_server"]


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
    state.port = port
    web.run_app(create_app(state), host=address, port=port, print=None)
