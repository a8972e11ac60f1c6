"""LoadedModel: the served-model interface (the port's copy of
aha_tpu/models/base.py).

Python equivalent of the reference's GenerateModel trait + ModelInstance
dispatch (src/models/mod.rs:62-191); default implementations raise the same
error strings the reference returns for unsupported operations.
"""

from __future__ import annotations

from typing import Iterator

from aha_tpu_torch.params import (
    ChatCompletionChunkResponse,
    ChatCompletionParameters,
    ChatCompletionResponse,
)
from aha_tpu_torch.registry import ModelEntry


class UnsupportedOperation(Exception):
    pass


class LoadedModel:
    """One loaded, servable model. Subclasses override what they support."""

    #: how many chat generations may run at once.  1 = the server serializes
    #: requests behind its lock (the reference's RwLock, api.rs:31); >1 means
    #: the model sits on a continuous-batching engine and the server lets
    #: requests run concurrently.
    concurrent_streams: int = 1

    def __init__(self, entry: ModelEntry):
        self.entry = entry

    # -- chat ----------------------------------------------------------------

    def generate(self, mes: ChatCompletionParameters) -> ChatCompletionResponse:
        raise UnsupportedOperation(self._chat_error())

    def generate_stream(self, mes: ChatCompletionParameters
                        ) -> Iterator[ChatCompletionChunkResponse]:
        raise UnsupportedOperation(self._chat_error(stream=True))

    def _chat_error(self, stream: bool = False) -> str:
        kind = self.entry.model_type
        if kind in ("embedding", "reranker"):
            op = ("streaming chat completions" if stream else "chat completions")
            return f"{kind} model does not support {op}"
        return "model does not support chat completions"

    # -- embedding / rerank --------------------------------------------------

    def embedding(self, texts: list[str]) -> list[list[float]]:
        raise UnsupportedOperation("current model does not support embeddings")

    def rerank(self, query: str, documents: list[str]) -> list[float]:
        raise UnsupportedOperation("current model does not support rerank")
