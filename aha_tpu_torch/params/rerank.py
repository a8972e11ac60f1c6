"""Rerank endpoint wire types (the port's copy of aha_tpu/params/rerank.py;
src/params/rerank.rs)."""

from __future__ import annotations

from aha_tpu_torch.params.shared import ApiModel


class RerankRequest(ApiModel):
    model: str | None = None
    query: str
    documents: list[str]
    top_n: int | None = None


class RerankResult(ApiModel):
    index: int
    relevance_score: float
    document: str


class RerankResponse(ApiModel):
    object: str = "rerank.result"
    model: str
    results: list[RerankResult]
