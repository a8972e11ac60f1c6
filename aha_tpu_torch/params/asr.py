"""Transcription endpoint wire types (the port's copy of
aha_tpu/params/asr.py; src/params/asr.rs).

The request arrives as multipart form-data (file, model, language, prompt,
response_format, temperature) and is parsed by the server handler directly;
only the response/error bodies are JSON types.
"""

from __future__ import annotations

from aha_tpu_torch.params.shared import ApiModel


class TranscriptionResponse(ApiModel):
    text: str


class ErrorDetail(ApiModel):
    message: str
    type: str
    code: str | None = None


class ErrorResponse(ApiModel):
    error: ErrorDetail


def error_response(message: str, error_type: str = "invalid_request_error",
                   code: str | None = None) -> dict:
    return ErrorResponse(
        error=ErrorDetail(message=message, type=error_type, code=code)
    ).to_json_dict()
