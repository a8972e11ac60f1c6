"""Model registry: every model id the engine knows how to serve (the
port's copy of aha_tpu/registry.py, entry for entry).

Equivalent of the reference's `WhichModel` enum
(src/models/common/model_mapping.rs:3-189).  Each entry records the
ModelScope/HF id, the serving category, and which implementation family
loads it (models/loader.py serves every family).
"""

from __future__ import annotations

from dataclasses import dataclass

MODEL_TYPES = (
    "llm",
    "vlm",
    "ocr",
    "asr",
    "tts",
    "image",
    "embedding",
    "reranker",
)


@dataclass(frozen=True)
class ModelEntry:
    model_id: str
    model_type: str  # one of MODEL_TYPES
    family: str  # the model family implementing it

    @property
    def owner(self) -> str:
        parts = self.model_id.split("/")
        return parts[0] if len(parts) >= 2 else "none"

    @property
    def name(self) -> str:
        return self.model_id.split("/")[-1]

    @property
    def is_gguf(self) -> bool:
        return "gguf" in self.model_id.lower()

    @property
    def is_onnx(self) -> bool:
        return "onnx" in self.model_id.lower()


def _e(model_id: str, model_type: str, family: str) -> ModelEntry:
    assert model_type in MODEL_TYPES
    return ModelEntry(model_id, model_type, family)


# Ordered as the reference lists them (model_mapping.rs:3-91) so `aha list`
# output matches.
MODELS: tuple[ModelEntry, ...] = (
    _e("sentence-transformers/all-MiniLM-L6-v2", "embedding", "minilm"),
    _e("LiquidAI/LFM2-1.2B", "llm", "lfm2"),
    _e("LiquidAI/LFM2.5-1.2B-Instruct", "llm", "lfm2"),
    _e("LiquidAI/LFM2.5-VL-1.6B", "vlm", "lfm2vl"),
    _e("LiquidAI/LFM2.5-VL-450M", "vlm", "lfm2vl"),
    _e("LiquidAI/LFM2-VL-1.6B", "vlm", "lfm2vl"),
    _e("OpenBMB/MiniCPM4-0.5B", "llm", "minicpm4"),
    _e("OpenBMB/MiniCPM5-1B", "llm", "minicpm5"),
    _e("Qwen/Qwen2.5-VL-3B-Instruct", "vlm", "qwen2_5vl"),
    _e("Qwen/Qwen2.5-VL-7B-Instruct", "vlm", "qwen2_5vl"),
    _e("Qwen/Qwen3-0.6B", "llm", "qwen3"),
    _e("Qwen/Qwen3-1.7B", "llm", "qwen3"),
    _e("Qwen/Qwen3-4B", "llm", "qwen3"),
    _e("Qwen/Qwen3.5-0.8B", "vlm", "qwen3_5"),
    _e("Qwen/Qwen3.5-2B", "vlm", "qwen3_5"),
    _e("Qwen/Qwen3.5-4B", "vlm", "qwen3_5"),
    _e("Qwen/Qwen3.5-9B", "vlm", "qwen3_5"),
    _e("qwen3.5-gguf", "vlm", "qwen3_5"),
    _e("Qwen/Qwen3-ASR-0.6B", "asr", "qwen3_asr"),
    _e("Qwen/Qwen3-ASR-1.7B", "asr", "qwen3_asr"),
    _e("Qwen/Qwen3-Embedding-0.6B", "embedding", "qwen3_embedding"),
    _e("Qwen/Qwen3-Embedding-4B", "embedding", "qwen3_embedding"),
    _e("Qwen/Qwen3-Embedding-8B", "embedding", "qwen3_embedding"),
    _e("Qwen/Qwen3-Reranker-0.6B", "reranker", "qwen3_reranker"),
    _e("Qwen/Qwen3-Reranker-4B", "reranker", "qwen3_reranker"),
    _e("Qwen/Qwen3-Reranker-8B", "reranker", "qwen3_reranker"),
    _e("Qwen/Qwen3-VL-2B-Instruct", "vlm", "qwen3vl"),
    _e("Qwen/Qwen3-VL-4B-Instruct", "vlm", "qwen3vl"),
    _e("Qwen/Qwen3-VL-8B-Instruct", "vlm", "qwen3vl"),
    _e("Qwen/Qwen3-VL-32B-Instruct", "vlm", "qwen3vl"),
    _e("deepseek-ai/DeepSeek-OCR", "ocr", "deepseek_ocr"),
    _e("deepseek-ai/DeepSeek-OCR-2", "ocr", "deepseek_ocr"),
    _e("Tencent-Hunyuan/HunyuanOCR", "ocr", "hunyuan_ocr"),
    _e("PaddlePaddle/PaddleOCR-VL", "ocr", "paddleocr_vl"),
    _e("PaddlePaddle/PaddleOCR-VL-1.5", "ocr", "paddleocr_vl"),
    _e("PaddlePaddle/PaddleOCR-VL-1.6", "ocr", "paddleocr_vl"),
    _e("AI-ModelScope/RMBG-2.0", "image", "rmbg2_0"),
    _e("OpenBMB/VoxCPM-0.5B", "tts", "voxcpm"),
    _e("OpenBMB/VoxCPM1.5", "tts", "voxcpm"),
    _e("OpenBMB/VoxCPM2", "tts", "voxcpm"),
    _e("ZhipuAI/GLM-ASR-Nano-2512", "asr", "glm_asr_nano"),
    _e("FunAudioLLM/Fun-ASR-Nano-2512", "asr", "fun_asr_nano"),
    _e("ZhipuAI/GLM-OCR", "ocr", "glm_ocr"),
)

_BY_ID = {m.model_id: m for m in MODELS}
_BY_ID_LOWER = {m.model_id.lower(): m for m in MODELS}


def model_list() -> tuple[ModelEntry, ...]:
    return MODELS


def lookup(model_id: str) -> ModelEntry:
    m = _BY_ID.get(model_id) or _BY_ID_LOWER.get(model_id.lower())
    if m is None:
        known = ", ".join(e.model_id for e in MODELS)
        raise KeyError(f"unknown model '{model_id}'. Supported models: {known}")
    return m


def supported(model_id: str) -> bool:
    return model_id in _BY_ID or model_id.lower() in _BY_ID_LOWER
