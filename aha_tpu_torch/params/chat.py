"""OpenAI chat-completions wire schema (the port's copy of
aha_tpu/params/chat.py).

Equivalent of src/params/chat.rs (ChatCompletionParameters at :59,
role-tagged ChatMessage at :256, multimodal content parts at :602-664,
tool-call deltas at :420-460).  Messages are modeled as one pydantic class
with a `role` discriminator — identical JSON to the reference's tagged enum.
"""

from __future__ import annotations

import time
from typing import Any, Union

from aha_tpu_torch.params.shared import ApiModel, Usage


# ---------------------------------------------------------------------------
# Content parts (untagged union on the wire; discriminated by "type")
# ---------------------------------------------------------------------------


class ImageUrl(ApiModel):
    url: str
    detail: str | None = None


class AudioUrl(ApiModel):
    url: str


class VideoUrl(ApiModel):
    url: str


class ContentPart(ApiModel):
    """One multimodal content part: text / image_url / audio_url / video_url."""

    type: str
    text: str | None = None
    image_url: ImageUrl | None = None
    audio_url: AudioUrl | None = None
    video_url: VideoUrl | None = None


Content = Union[str, list[ContentPart], None]


def content_to_text(content: Content) -> str:
    """Flatten message content to its text (joins text parts)."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    return "".join(p.text for p in content if p.type == "text" and p.text)


def extract_parts(content: Content, part_type: str) -> list[ContentPart]:
    """All parts of a given type ("image_url", "audio_url", "video_url")."""
    if content is None or isinstance(content, str):
        return []
    return [p for p in content if p.type == part_type]


# ---------------------------------------------------------------------------
# Tool calls
# ---------------------------------------------------------------------------


class FunctionCall(ApiModel):
    name: str
    arguments: str


class ToolCall(ApiModel):
    id: str
    type: str = "function"
    function: FunctionCall


class DeltaFunction(ApiModel):
    name: str | None = None
    arguments: str | None = None


class DeltaToolCall(ApiModel):
    index: int | None = None
    id: str | None = None
    type: str | None = None
    function: DeltaFunction


class ToolFunctionDef(ApiModel):
    name: str
    description: str | None = None
    parameters: Any = None


class ToolDef(ApiModel):
    type: str = "function"
    function: ToolFunctionDef


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


class ChatMessage(ApiModel):
    """A chat message; `role` in {developer, system, user, assistant, tool}."""

    role: str
    content: Content = None
    name: str | None = None
    # assistant-only extras
    reasoning_content: str | None = None
    refusal: str | None = None
    audio: dict | None = None
    tool_calls: list[ToolCall] | None = None
    # tool-only
    tool_call_id: str | None = None

    def text(self) -> str:
        return content_to_text(self.content)


class DeltaChatMessage(ApiModel):
    role: str | None = None
    content: str | None = None
    reasoning_content: str | None = None
    refusal: str | None = None
    tool_calls: list[DeltaToolCall] | None = None


# ---------------------------------------------------------------------------
# Request
# ---------------------------------------------------------------------------


class StreamOptions(ApiModel):
    include_usage: bool | None = None
    continuous_usage_stats: bool | None = None


class ResponseFormat(ApiModel):
    type: str | None = None
    json_schema: Any = None


class ChatCompletionParameters(ApiModel):
    """Request body of POST /v1/chat/completions (chat.rs:59-185)."""

    messages: list[ChatMessage]
    model: str = ""
    store: bool | None = None
    reasoning_effort: str | None = None
    # free-form string map: model-specific knobs (crop modes, TTS params, ...)
    metadata: dict[str, str] | None = None
    enable_thinking: bool | None = None
    frequency_penalty: float | None = None
    logit_bias: dict[str, int] | None = None
    logprobs: bool | None = None
    top_logprobs: int | None = None
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    n: int | None = None
    modalities: list[str] | None = None
    prediction: Any = None
    audio: dict | None = None
    presence_penalty: float | None = None
    response_format: ResponseFormat | None = None
    seed: int | None = None
    stop: str | list[str] | None = None
    stream: bool | None = None
    stream_options: StreamOptions | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    repeat_penalty: float | None = None
    repeat_last_n: int | None = None
    tools: list[ToolDef] | None = None
    tool_choice: Any = None
    parallel_tool_calls: bool | None = None
    safety_identifier: str | None = None
    prompt_cache_key: str | None = None
    web_search_options: Any = None
    extra_body: Any = None
    query_params: dict[str, str] | None = None

    def metadata_value(self, key: str) -> str | None:
        if self.metadata is None:
            return None
        return self.metadata.get(key)


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------


class ChatCompletionChoice(ApiModel):
    index: int = 0
    message: ChatMessage
    finish_reason: str | None = None
    logprobs: Any = None


class ChatCompletionResponse(ApiModel):
    id: str | None = None
    choices: list[ChatCompletionChoice]
    created: int = 0
    model: str = ""
    service_tier: str | None = None
    system_fingerprint: str | None = None
    object: str = "chat.completion"
    usage: Usage | None = None


class ChatCompletionChunkChoice(ApiModel):
    index: int | None = 0
    delta: DeltaChatMessage
    finish_reason: str | None = None
    logprobs: Any = None


class ChatCompletionChunkResponse(ApiModel):
    id: str | None = None
    choices: list[ChatCompletionChunkChoice]
    created: int = 0
    model: str = ""
    system_fingerprint: str | None = None
    object: str = "chat.completion.chunk"
    usage: Usage | None = None


def now_created() -> int:
    return int(time.time())
