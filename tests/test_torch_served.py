"""The port's served Qwen3 chat model, HTTP app and CLI on the tiny on-disk
repo of tests/fixtures: greedy text equals aha_tpu's on the same checkpoint,
streaming agrees with non-streaming, and the aiohttp app answers the
OpenAI routes."""

import asyncio
import json

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from aha_tpu.models.qwen3_served import Qwen3Chat as JQwen3Chat
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu.registry import lookup as jlookup
from aha_tpu_torch.cli import build_parser
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.qwen3_served import Qwen3Chat
from aha_tpu_torch.parallel.replicas import ReplicaEngine
from aha_tpu_torch.params import ChatCompletionParameters
from aha_tpu_torch.registry import lookup
from aha_tpu_torch.server.app import ServerState, create_app
from tests.fixtures import build_tiny_qwen3_repo

torch.set_num_threads(1)
ENTRY = lookup("Qwen/Qwen3-0.6B")
JENTRY = jlookup("Qwen/Qwen3-0.6B")


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_qwen3"))
    build_tiny_qwen3_repo(path)
    return path


@pytest.fixture(scope="module")
def served(repo):
    return Qwen3Chat.load(ENTRY, repo, max_seq_len=512)


def _body(**kw):
    body = {"model": "Qwen/Qwen3-0.6B", "max_tokens": 20, "temperature": 0.0,
            "messages": [{"role": "user",
                          "content": "hello world how are you today " * 3}]}
    return {**body, **kw}


def _req(**kw):
    """The request as the port's wire type."""
    return ChatCompletionParameters.model_validate(_body(**kw))


def _jreq(**kw):
    """The same request as aha_tpu's wire type, for the JAX oracle."""
    return JParameters.model_validate(_body(**kw))


def test_greedy_text_matches_jax(repo, served):
    jax_served = JQwen3Chat.load(JENTRY, repo, max_seq_len=512)
    want = jax_served.generate(_jreq()).choices[0].message.content
    got = served.generate(_req())
    assert got.choices[0].message.content == want
    assert got.usage.prompt_tokens >= 32 and got.usage.completion_tokens >= 1


def test_stream_chunks_match_jax(repo, served):
    """Same text and reasoning deltas (the channel routing of
    <think>/<tool_call> markers) as aha_tpu's stream, then a usage chunk."""
    def deltas(model, req):
        chunks = list(model.generate_stream(req(stream=True)))
        assert chunks[-1].usage is not None
        assert chunks[-1].usage.completion_tokens >= 1
        return [(c.choices[0].delta.content,
                 c.choices[0].delta.reasoning_content) for c in chunks[:-1]]

    jax_served = JQwen3Chat.load(JENTRY, repo, max_seq_len=512)
    assert deltas(served, _req) == deltas(jax_served, _jreq)


def test_loader_and_unported_options(repo):
    batched = load_model("Qwen/Qwen3-0.6B", repo, max_seq_len=256,
                         batch_slots=2)
    try:
        assert isinstance(batched.engine, BatchEngine)
        assert batched.concurrent_streams == 2
        assert batched.engine.slots == 2
        want = batched.generate(_req(max_tokens=6)).choices[0].message
    finally:
        batched.engine.shutdown()
    # refused before any weights load, with the JAX loader's message
    with pytest.raises(ValueError, match="--spec-tokens rides"):
        load_model("Qwen/Qwen3-0.6B", "/nonexistent", batch_slots=2,
                   spec_tokens=4)
    # --dp D: D BatchEngine replicas of batch_slots / D slots (the CPU
    # stands for each card here), answering as the one engine does
    replicas = load_model("Qwen/Qwen3-0.6B", repo, max_seq_len=256,
                          batch_slots=2, dp=2)
    try:
        assert isinstance(replicas.engine, ReplicaEngine)
        assert [e.slots for e in replicas.engine.engines] == [1, 1]
        assert replicas.concurrent_streams == 2
        got = replicas.generate(_req(max_tokens=6)).choices[0].message
        assert got.content == want.content
    finally:
        replicas.shutdown()
    args = build_parser().parse_args(["serv", repo, "--port", "9001"])
    assert (args.path, args.port, args.model) == (repo, 9001,
                                                  "Qwen/Qwen3-0.6B")
    args = build_parser().parse_args(["serv", repo, "--batch-slots", "3"])
    assert args.batch_slots == 3


def test_kv_int8_env_reaches_both_engines(repo, monkeypatch):
    """AHA_KV_INT8=1: the single-stream and the batched engine both store
    int8 rows with their scales."""
    monkeypatch.setenv("AHA_KV_INT8", "1")
    single = load_model("Qwen/Qwen3-0.6B", repo, max_seq_len=256)
    assert single.engine.model.supports_kv_int8
    assert single.engine.cache_dtype == torch.int8
    assert single.generate(_req(max_tokens=4)).usage.completion_tokens >= 1
    batched = load_model("Qwen/Qwen3-0.6B", repo, max_seq_len=256,
                         batch_slots=2)
    try:
        cache = batched.engine._cache
        assert cache["k"].dtype == torch.int8 and "k_scale" in cache
        assert cache["pos"].shape == (2,)
    finally:
        batched.engine.shutdown()


def test_batch_slots_serve_concurrent_chats(repo):
    """Three chat requests at once to a --batch-slots 3 model over HTTP: all
    complete, and their greedy text equals the single-stream model's."""
    served = load_model("Qwen/Qwen3-0.6B", repo, max_seq_len=512,
                        batch_slots=3)
    single = Qwen3Chat.load(ENTRY, repo, max_seq_len=512)
    texts = [f"question number {i}: how are you today? " * 3
             for i in range(3)]

    def body(text, stream):
        return {**json.loads(_req().model_dump_json()), "stream": stream,
                "messages": [{"role": "user", "content": text}]}

    async def scenario():
        client = TestClient(TestServer(create_app(ServerState(model=served))))
        await client.start_server()
        try:
            async def ask(text, stream):
                r = await client.post("/v1/chat/completions",
                                      json=body(text, stream))
                return r.status, await r.text()

            return await asyncio.wait_for(asyncio.gather(
                *(ask(t, i == 1) for i, t in enumerate(texts))), timeout=120)
        finally:
            await client.close()

    try:
        replies = asyncio.run(scenario())
    finally:
        served.engine.shutdown()
    assert [status for status, _ in replies] == [200, 200, 200]
    for i in (0, 2):
        resp = json.loads(replies[i][1])
        want = single.generate(ChatCompletionParameters.model_validate(
            body(texts[i], False)))
        assert resp["choices"][0]["message"]["content"] == \
            want.choices[0].message.content
        assert resp["usage"]["completion_tokens"] >= 1
    events = [ln[6:] for ln in replies[1][1].splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"


def test_http_routes(served):
    async def scenario():
        client = TestClient(TestServer(create_app(ServerState(model=served))))
        await client.start_server()
        try:
            r = await client.get("/health")
            assert r.status == 200
            r = await client.get("/v1/models")
            assert (await r.json())["data"][0]["id"] == "Qwen/Qwen3-0.6B"
            body = json.loads(_req().model_dump_json())
            r = await client.post("/v1/chat/completions",
                                  json={**body, "stream": False})
            assert r.status == 200
            resp = json.loads(await r.text())
            assert resp["usage"]["completion_tokens"] >= 1
            r = await client.post("/v1/chat/completions",
                                  json={**body, "stream": True})
            assert r.status == 200
            events = [ln[6:] for ln in (await r.text()).splitlines()
                      if ln.startswith("data: ")]
            assert events[-1] == "[DONE]"
            assert json.loads(events[-2])["usage"]["completion_tokens"] >= 1
        finally:
            await client.close()

    asyncio.run(scenario())
