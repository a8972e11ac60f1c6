"""Chat-level generation: request → prompt → engine → OpenAI responses
(counterpart of aha_tpu/core/generate.py, text only).

The response types, tokenizer and chat-template classes are the port's
copies of aha_tpu's host modules; the stream channel routing (UTF-8
partial tokens, <think> reasoning channel, <tool_call> capture, final
usage chunk) is the same as the JAX package's, so both serve identical
chunk streams.
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass
from typing import Iterator

from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import DEFAULT_SEED, SamplingConfig
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.params import (
    ChatCompletionChunkChoice,
    ChatCompletionChunkResponse,
    ChatCompletionChoice,
    ChatCompletionParameters,
    ChatCompletionResponse,
    ChatMessage,
    DeltaChatMessage,
    DeltaFunction,
    DeltaToolCall,
    Usage,
)
from aha_tpu_torch.params.chat import now_created

DEFAULT_MAX_TOKENS = 1024


@dataclass
class PrepareData:
    """A model family's request preprocessing output."""

    input_ids: list[int]
    in_reasoning: bool = False


@dataclass
class GenerateModel:
    """Base of a served text model: subclasses set engine/tokenizer/
    model_name and implement `get_data`."""

    engine: TextEngine
    tokenizer: TokenizerModel
    model_name: str

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        raise NotImplementedError

    def get_temperature(self, t: float | None) -> float | None:
        return t

    def get_top_p(self, p: float | None) -> float | None:
        return p

    def get_top_k(self, k: int | None) -> int | None:
        return k

    def is_in_reasoning(self, rendered_prompt: str) -> bool:
        return rendered_prompt.endswith("<think>\n")

    def _sampling_cfg(self, mes: ChatCompletionParameters) -> SamplingConfig:
        return SamplingConfig(
            temperature=self.get_temperature(mes.temperature),
            top_p=self.get_top_p(mes.top_p),
            top_k=self.get_top_k(mes.top_k),
            repeat_penalty=mes.repeat_penalty if mes.repeat_penalty is not None else 1.0,
            repeat_last_n=mes.repeat_last_n if mes.repeat_last_n is not None else 64,
            seed=mes.seed if mes.seed is not None else DEFAULT_SEED,
        )

    def generate(self, mes: ChatCompletionParameters) -> ChatCompletionResponse:
        cfg = self._sampling_cfg(mes)
        max_tokens = mes.max_tokens or DEFAULT_MAX_TOKENS
        data = self.get_data(mes)
        ids = self.engine.generate_tokens(data.input_ids, cfg, max_tokens)
        t = self.engine.last_timing
        return ChatCompletionResponse(
            id=str(uuid.uuid4()),
            choices=[ChatCompletionChoice(
                index=0,
                message=ChatMessage(role="assistant",
                                    content=self.tokenizer.decode(ids)),
                finish_reason="stop",
            )],
            created=now_created(),
            model=self.model_name,
            usage=Usage.from_timing(t.prompt_tokens, t.prompt_secs,
                                    t.completion_tokens, t.completion_secs),
        )

    def generate_stream(self, mes: ChatCompletionParameters
                        ) -> Iterator[ChatCompletionChunkResponse]:
        cfg = self._sampling_cfg(mes)
        max_tokens = mes.max_tokens or DEFAULT_MAX_TOKENS
        data = self.get_data(mes)
        in_reasoning = data.in_reasoning
        tool_call_id: str | None = None
        tool_call_content = ""
        error_tokens: list[int] = []

        for token in self.engine.stream_tokens(data.input_ids, cfg, max_tokens):
            decoded = self.tokenizer.decode(error_tokens + [token])
            if "�" in decoded:          # partial UTF-8 sequence
                error_tokens.append(token)
                if len(error_tokens) > 3:
                    error_tokens.clear()
                continue
            error_tokens.clear()
            if decoded == "<think>":
                in_reasoning = True
                continue
            if decoded == "</think>":
                in_reasoning = False
                continue
            if decoded == "<tool_call>":
                tool_call_id = str(uuid.uuid4())
                continue
            if decoded == "</tool_call>":
                yield _tool_call_chunk(self.model_name, tool_call_id,
                                       tool_call_content)
                tool_call_id = None
                tool_call_content = ""
            elif tool_call_id is not None:
                tool_call_content += decoded
                continue
            elif decoded:
                yield _text_chunk(self.model_name, decoded, in_reasoning)
            if token in self.engine.eos_token_ids:
                break
        yield _usage_chunk(self.model_name, self.engine.last_timing)


def _base_chunk(model_name: str) -> ChatCompletionChunkResponse:
    return ChatCompletionChunkResponse(id=str(uuid.uuid4()), choices=[],
                                       created=now_created(), model=model_name)


def _text_chunk(model_name: str, text: str,
                reasoning: bool) -> ChatCompletionChunkResponse:
    chunk = _base_chunk(model_name)
    delta = (DeltaChatMessage(role="assistant", reasoning_content=text)
             if reasoning else DeltaChatMessage(role="assistant", content=text))
    chunk.choices.append(ChatCompletionChunkChoice(index=0, delta=delta))
    return chunk


def _tool_call_chunk(model_name: str, call_id: str,
                     content: str) -> ChatCompletionChunkResponse:
    """A captured <tool_call> body parsed as {"name", "arguments"};
    unparseable bodies pass through as raw arguments."""
    try:
        value = json.loads(content)
        fn = DeltaFunction(
            name=value.get("name") if isinstance(value, dict) else None,
            arguments=json.dumps(value.get("arguments"), ensure_ascii=False)
            if isinstance(value, dict) and "arguments" in value else None,
        )
    except json.JSONDecodeError:
        fn = DeltaFunction(arguments=content)
    chunk = _base_chunk(model_name)
    chunk.choices.append(ChatCompletionChunkChoice(
        index=0,
        delta=DeltaChatMessage(role="assistant", tool_calls=[DeltaToolCall(
            index=0, id=call_id, type="function", function=fn)]),
    ))
    return chunk


def _usage_chunk(model_name: str, t) -> ChatCompletionChunkResponse:
    chunk = _base_chunk(model_name)
    chunk.usage = Usage.from_timing(t.prompt_tokens, t.prompt_secs,
                                    t.completion_tokens, t.completion_secs)
    chunk.choices.append(ChatCompletionChunkChoice(
        index=0, delta=DeltaChatMessage(role="assistant")))
    return chunk
