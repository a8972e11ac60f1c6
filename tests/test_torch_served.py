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
from aha_tpu.params import ChatCompletionParameters
from aha_tpu.registry import lookup
from aha_tpu_torch.cli import build_parser
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.qwen3_served import Qwen3Chat
from aha_tpu_torch.server.app import ServerState, create_app
from tests.fixtures import build_tiny_qwen3_repo

torch.set_num_threads(1)
ENTRY = lookup("Qwen/Qwen3-0.6B")


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_qwen3"))
    build_tiny_qwen3_repo(path)
    return path


@pytest.fixture(scope="module")
def served(repo):
    return Qwen3Chat.load(ENTRY, repo, max_seq_len=512)


def _req(**kw):
    body = {"model": "Qwen/Qwen3-0.6B", "max_tokens": 20, "temperature": 0.0,
            "messages": [{"role": "user",
                          "content": "hello world how are you today " * 3}]}
    return ChatCompletionParameters.model_validate({**body, **kw})


def test_greedy_text_matches_jax(repo, served):
    jax_served = JQwen3Chat.load(ENTRY, repo, max_seq_len=512)
    want = jax_served.generate(_req()).choices[0].message.content
    got = served.generate(_req())
    assert got.choices[0].message.content == want
    assert got.usage.prompt_tokens >= 32 and got.usage.completion_tokens >= 1


def test_stream_chunks_match_jax(repo, served):
    """Same text and reasoning deltas (the channel routing of
    <think>/<tool_call> markers) as aha_tpu's stream, then a usage chunk."""
    def deltas(model):
        chunks = list(model.generate_stream(_req(stream=True)))
        assert chunks[-1].usage is not None
        assert chunks[-1].usage.completion_tokens >= 1
        return [(c.choices[0].delta.content,
                 c.choices[0].delta.reasoning_content) for c in chunks[:-1]]

    jax_served = JQwen3Chat.load(ENTRY, repo, max_seq_len=512)
    assert deltas(served) == deltas(jax_served)


def test_loader_and_unported_options(repo):
    with pytest.raises(NotImplementedError):
        load_model("Qwen/Qwen3-Embedding-0.6B", repo)
    with pytest.raises(ValueError):
        load_model("Qwen/Qwen3-0.6B", repo, batch_slots=2)
    args = build_parser().parse_args(["serv", repo, "--port", "9001"])
    assert (args.path, args.port, args.model) == (repo, 9001,
                                                  "Qwen/Qwen3-0.6B")


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
