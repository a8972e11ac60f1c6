"""OpenAI-compatible wire types (pydantic): the port's copy of
aha_tpu/params (chat, embedding, rerank and the shared Usage), field for
field, so both packages answer the same JSON.  The transcription types
come with the endpoint that uses them.
"""

from aha_tpu_torch.params.shared import (
    Usage,
    PromptTokensDetails,
    CompletionTokensDetails,
)
from aha_tpu_torch.params.chat import (
    ChatCompletionParameters,
    ChatCompletionResponse,
    ChatCompletionChunkResponse,
    ChatCompletionChoice,
    ChatCompletionChunkChoice,
    ChatMessage,
    DeltaChatMessage,
    ToolCall,
    DeltaToolCall,
    FunctionCall,
    DeltaFunction,
    content_to_text,
    extract_parts,
)
from aha_tpu_torch.params.embedding import (
    EmbeddingRequest,
    EmbeddingData,
    EmbeddingResponse,
)
from aha_tpu_torch.params.rerank import (
    RerankRequest,
    RerankResult,
    RerankResponse,
)

__all__ = [
    "Usage",
    "PromptTokensDetails",
    "CompletionTokensDetails",
    "ChatCompletionParameters",
    "ChatCompletionResponse",
    "ChatCompletionChunkResponse",
    "ChatCompletionChoice",
    "ChatCompletionChunkChoice",
    "ChatMessage",
    "DeltaChatMessage",
    "ToolCall",
    "DeltaToolCall",
    "FunctionCall",
    "DeltaFunction",
    "content_to_text",
    "extract_parts",
    "EmbeddingRequest",
    "EmbeddingData",
    "EmbeddingResponse",
    "RerankRequest",
    "RerankResult",
    "RerankResponse",
]
