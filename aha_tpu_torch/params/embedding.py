"""Embedding endpoint wire types (the port's copy of
aha_tpu/params/embedding.py; src/params/embedding.rs)."""

from __future__ import annotations

from typing import Union

from aha_tpu_torch.params.shared import ApiModel


class EmbeddingRequest(ApiModel):
    model: str | None = None
    # string or array of strings (the reference accepts serde_json::Value,
    # validated in the handler, src/server/embedding.rs:219-239)
    input: Union[str, list[str]]


class EmbeddingData(ApiModel):
    object: str = "embedding"
    index: int
    embedding: list[float]


class EmbeddingResponse(ApiModel):
    object: str = "list"
    model: str
    data: list[EmbeddingData]
