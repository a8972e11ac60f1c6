"""aha_tpu_torch's /embeddings, /v1/embeddings, /rerank and /v1/rerank
routes against aha_tpu's, in process: the same request sent to both
packages' apps, each serving its own toy model of the same kind (chat,
embedding, reranker), must get the same status and the same body — the
vectors, the scores sorted and cut to top_n, and every refusal's message
(empty input, a non-string array, empty query or documents, embeddings
of a chat model, chat on an embedding model).  Then a tiny Qwen3
embedding checkpoint served by the port answers with the vectors its
model computes in process."""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from aha_tpu.models.base import LoadedModel as JLoadedModel
from aha_tpu.registry import lookup as jlookup
from aha_tpu.server.app import ServerState as JState
from aha_tpu.server.app import create_app as jcreate_app
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.registry import lookup
from aha_tpu_torch.server.app import ServerState, create_app
from tests.fixtures import build_tiny_qwen3_repo

IDS = {"chat": "Qwen/Qwen3-0.6B",
       "embedding": "sentence-transformers/all-MiniLM-L6-v2",
       "reranker": "Qwen/Qwen3-Reranker-0.6B"}


def _toys(base, find):
    """The three toy models over one package's LoadedModel."""
    class Embed(base):
        def embedding(self, texts):
            if any(not t.strip() for t in texts):
                raise ValueError("embedding tokenized input cannot be empty")
            return [[float(len(t)), 0.5, -1.0] for t in texts]

    class Rerank(base):
        def rerank(self, query, documents):
            return [float(len(d)) / (1 + len(query)) for d in documents]

    return {"chat": base(find(IDS["chat"])),
            "embedding": Embed(find(IDS["embedding"])),
            "reranker": Rerank(find(IDS["reranker"]))}


PORT = _toys(LoadedModel, lookup)
REF = _toys(JLoadedModel, jlookup)


async def _ask(app, method, path, body):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        kw = {"data": body} if isinstance(body, str) else {"json": body}
        r = await client.request(method, path, **kw)
        text = await r.text()
        return r.status, text
    finally:
        await client.close()


def _both(kind, path, body):
    """(port's (status, body), reference's) for one request; a model kind
    of None serves no model."""
    port = create_app(ServerState(model=PORT[kind] if kind else None))
    ref = jcreate_app(JState(model=REF[kind] if kind else None))
    return (asyncio.run(_ask(port, "POST", path, body)),
            asyncio.run(_ask(ref, "POST", path, body)))


EMBED_CASES = [
    ("embedding", {"input": "abc"}, 200),
    ("embedding", {"input": ["a", "bb", "ccc"]}, 200),
    ("embedding", {"input": []}, 400),
    ("embedding", {"input": ["a", 3]}, 400),
    ("embedding", {"input": 7}, 400),
    ("embedding", {}, 400),
    ("embedding", "{not json", 400),
    ("embedding", {"input": ["a", "  "]}, 400),
    ("chat", {"input": "abc"}, 400),
    ("reranker", {"input": "abc"}, 400),
    (None, {"input": "abc"}, 503),
]


@pytest.mark.parametrize("path", ["/embeddings", "/v1/embeddings"])
@pytest.mark.parametrize("kind,body,status", EMBED_CASES)
def test_embeddings_route_answers_as_the_reference(kind, body, status, path):
    got, want = _both(kind, path, body)
    assert got == want
    assert got[0] == status


RERANK_CASES = [
    ("reranker", {"query": "q", "documents": ["aaa", "b", "cc"]}, 200),
    ("reranker", {"query": "q", "documents": ["aaa", "b", "cc", "dddd"],
                  "top_n": 2}, 200),
    ("reranker", {"query": "  ", "documents": ["a"]}, 400),
    ("reranker", {"query": "q", "documents": []}, 400),
    ("reranker", {"documents": ["a"]}, 400),
    ("reranker", {"query": "q", "documents": "a"}, 400),
    ("embedding", {"query": "q", "documents": ["a"]}, 400),
    ("chat", {"query": "q", "documents": ["a"]}, 400),
    (None, {"query": "q", "documents": ["a"]}, 503),
]


@pytest.mark.parametrize("path", ["/rerank", "/v1/rerank"])
@pytest.mark.parametrize("kind,body,status", RERANK_CASES)
def test_rerank_route_answers_as_the_reference(kind, body, status, path):
    got, want = _both(kind, path, body)
    assert got == want
    assert got[0] == status


def test_rerank_sorts_and_cuts_to_top_n():
    (status, text), _ = _both("reranker", "/v1/rerank", {
        "query": "q", "documents": ["aaa", "b", "cc", "dddd"], "top_n": 3})
    import json

    body = json.loads(text)
    assert status == 200 and body["object"] == "list"
    assert [r["index"] for r in body["results"]] == [3, 0, 2]
    assert [r["document"] for r in body["results"]] == ["dddd", "aaa", "cc"]


@pytest.mark.parametrize("kind", ["embedding", "reranker"])
def test_chat_on_an_embedding_model_answers_as_the_reference(kind):
    body = {"model": IDS[kind], "stream": False,
            "messages": [{"role": "user", "content": "hi"}]}
    got, want = _both(kind, "/v1/chat/completions", body)
    assert got == want
    assert got == (500, f"{kind} model does not support chat completions")


@pytest.mark.parametrize("kind", ["embedding", "reranker"])
def test_streamed_chat_on_an_embedding_model_ends_with_its_error(kind):
    """The refusal arrives as the stream's error event.  (The reference's
    handler calls generate_stream outside its producer's try, so its
    stream never ends here; it is not asked.)"""
    import json

    port = create_app(ServerState(model=PORT[kind]))
    status, text = asyncio.run(_ask(port, "POST", "/v1/chat/completions", {
        "model": IDS[kind], "stream": True,
        "messages": [{"role": "user", "content": "hi"}]}))
    events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert status == 200 and len(events) == 1
    assert json.loads(events[0]) == {
        "error": f"{kind} model does not support streaming chat completions"}


def test_served_qwen3_embedding_checkpoint(tmp_path, monkeypatch):
    """A tiny Qwen3 checkpoint served as Qwen/Qwen3-Embedding-0.6B: the
    route's vectors equal the model's own, a string as one text."""
    import json

    from aha_tpu_torch.models.loader import load_model

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.setenv("AHA_DTYPE", "float32")
    build_tiny_qwen3_repo(str(tmp_path))
    served = load_model("Qwen/Qwen3-Embedding-0.6B", str(tmp_path))
    texts = ["hello world", "the quick brown fox jumps over the lazy dog"]
    for inp, want in ((texts, served.embedding(texts)),
                      (texts[0], served.embedding(texts[:1]))):
        app = create_app(ServerState(model=served))
        status, text = asyncio.run(_ask(app, "POST", "/v1/embeddings",
                                        {"input": inp}))
        body = json.loads(text)
        assert status == 200 and body["model"] == "Qwen/Qwen3-Embedding-0.6B"
        got = [d["embedding"] for d in body["data"]]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert [d["index"] for d in body["data"]] == list(range(len(want)))
