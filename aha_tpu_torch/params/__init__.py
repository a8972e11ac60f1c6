"""OpenAI-compatible wire types (pydantic): the port's copy of
aha_tpu/params (chat and the shared Usage), field for field, so both
packages answer the same JSON.  The embedding, rerank and transcription
types come with the endpoints that use them.
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
]
