"""Shared wire types: token usage with aha's extended timing fields (the
port's copy of aha_tpu/params/shared.py).

Mirrors src/params/shared.rs:4-28 — `Usage` carries prompt/completion second
counts and tokens/sec so every response doubles as a benchmark sample.
"""

from __future__ import annotations

from pydantic import BaseModel, ConfigDict


class ApiModel(BaseModel):
    """Base for all wire types: tolerate unknown fields, drop None on dump."""

    model_config = ConfigDict(extra="allow", protected_namespaces=())

    def to_json_dict(self) -> dict:
        return self.model_dump(exclude_none=True)


class PromptTokensDetails(ApiModel):
    audio_tokens: int | None = None
    cached_tokens: int = 0


class CompletionTokensDetails(ApiModel):
    reasoning_tokens: int = 0
    audio_tokens: int | None = None
    accepted_prediction_tokens: int | None = None
    rejected_prediction_tokens: int | None = None


class Usage(ApiModel):
    prompt_tokens: int | None = None
    prompt_secs: float | None = None
    completion_tokens: int | None = None
    completion_secs: float | None = None
    completion_per_token_secs: float | None = None
    completion_tps: float | None = None
    total_tokens: int = 0
    prompt_tokens_details: PromptTokensDetails | None = None
    completion_tokens_details: CompletionTokensDetails | None = None

    @classmethod
    def from_timing(
        cls,
        prompt_tokens: int,
        prompt_secs: float,
        completion_tokens: int,
        completion_secs: float,
    ) -> "Usage":
        per_token = completion_secs / completion_tokens if completion_tokens else None
        tps = completion_tokens / completion_secs if completion_secs > 0 else None
        return cls(
            prompt_tokens=prompt_tokens,
            prompt_secs=prompt_secs,
            completion_tokens=completion_tokens,
            completion_secs=completion_secs,
            completion_per_token_secs=per_token,
            completion_tps=tps,
            total_tokens=prompt_tokens + completion_tokens,
        )
