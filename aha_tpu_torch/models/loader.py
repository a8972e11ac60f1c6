"""Model factory: registry id → served model (counterpart of
aha_tpu/models/loader.py).  Ported families: qwen3 (the Qwen3 chat
models), the llama text families minicpm4 / minicpm5, the hybrid text
families lfm2 (LFM2 / LFM2.5) and qwen3_5 (Qwen3.5: text, and image and
video chat on a checkpoint with a vision tower), qwen2_5vl (Qwen2.5-VL
image and video chat), qwen3vl (Qwen3-VL image and video chat),
paddleocr_vl (PaddleOCR-VL document OCR), deepseek_ocr (DeepSeek-OCR and
DeepSeek-OCR-2), lfm2vl (LFM2-VL image chat), the ASR families qwen3_asr
(Qwen3-ASR), fun_asr_nano (Fun-ASR-Nano) and glm_asr_nano (GLM-ASR-Nano),
voxcpm (VoxCPM text-to-speech), rmbg2_0 (RMBG-2.0 background removal),
qwen3_embedding / qwen3_reranker and minilm (all-MiniLM-L6-v2); every
other family (hunyuan_ocr, glm_ocr) raises NotImplementedError.
The reference's option checks run first, before any weights load, with
its strings."""

from __future__ import annotations

from typing import Callable

from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.registry import ModelEntry, lookup


def _qwen3(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_served import Qwen3Chat

    return Qwen3Chat.load(entry, path, **kw)


def _qwen3_embedding(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_served import Qwen3EmbeddingServed

    return Qwen3EmbeddingServed.load(entry, path)


def _qwen3_reranker(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_served import Qwen3RerankerServed

    return Qwen3RerankerServed.load(entry, path)


def _minilm(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.minilm_served import MiniLMServed

    return MiniLMServed.load(entry, path)


def _llama_family(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    """minicpm4 / minicpm5: the generic LlamaForCausalLM wrapper —
    LlamaConfig picks up whatever mup / LongRoPE fields the config.json
    has."""
    from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aha_tpu_torch.models.text_served import TextChatModel

    return TextChatModel.load_decoder(entry, path, LlamaModel, LlamaConfig,
                                      **kw)


def _lfm2(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    """LFM2 / LFM2.5 text chat on the hybrid conv / attention decoder."""
    from aha_tpu_torch.models.lfm2 import Lfm2Config, Lfm2Model
    from aha_tpu_torch.models.text_served import TextChatModel

    return TextChatModel.load_decoder(entry, path, Lfm2Model, Lfm2Config,
                                      **kw)


def _qwen3_5(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    """Qwen3.5 on the GatedDeltaNet decoder: text chat, or (a checkpoint
    with a vision_config, single-stream) image and video chat."""
    from aha_tpu_torch.models.qwen3_5_served import load_qwen3_5

    return load_qwen3_5(entry, path, **kw)


def _qwen2_5vl(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen2_5vl_served import Qwen2_5VLChat

    return Qwen2_5VLChat.load(entry, path, **kw)


def _qwen3vl(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3vl_served import Qwen3VLChat

    return Qwen3VLChat.load(entry, path, **kw)


def _paddleocr_vl(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.paddleocr_vl_served import PaddleOCRVLChat

    return PaddleOCRVLChat.load(entry, path, **kw)


def _deepseek_ocr(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.deepseek_ocr_served import DeepseekOCRChat

    return DeepseekOCRChat.load(entry, path, **kw)


def _lfm2vl(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.lfm2vl_served import Lfm2VLChat

    return Lfm2VLChat.load(entry, path, **kw)


def _qwen3_asr(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_asr_served import Qwen3ASRChat

    return Qwen3ASRChat.load(entry, path, **kw)


def _fun_asr_nano(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.fun_asr_nano_served import FunAsrNanoChat

    return FunAsrNanoChat.load(entry, path, **kw)


def _glm_asr_nano(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.glm_asr_nano_served import GlmAsrNanoChat

    return GlmAsrNanoChat.load(entry, path, **kw)


def _voxcpm(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.voxcpm_served import VoxCPMServed

    return VoxCPMServed.load(entry, path, **kw)


def _rmbg2_0(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.rmbg2_0_served import RMBG2Served

    return RMBG2Served.load(entry, path, **kw)


FAMILY_LOADERS: dict[str, Callable[..., LoadedModel]] = {
    "voxcpm": _voxcpm,
    "rmbg2_0": _rmbg2_0,
    "minilm": _minilm,
    "qwen3_asr": _qwen3_asr,
    "fun_asr_nano": _fun_asr_nano,
    "glm_asr_nano": _glm_asr_nano,
    "paddleocr_vl": _paddleocr_vl,
    "deepseek_ocr": _deepseek_ocr,
    "lfm2vl": _lfm2vl,
    "qwen2_5vl": _qwen2_5vl,
    "qwen3vl": _qwen3vl,
    "qwen3": _qwen3,
    "qwen3_embedding": _qwen3_embedding,
    "qwen3_reranker": _qwen3_reranker,
    "minicpm4": _llama_family,
    "minicpm5": _llama_family,
    "lfm2": _lfm2,
    "qwen3_5": _qwen3_5,
}

# families whose serving path can sit on the continuous-batching engine:
# the reference's set, so its refusal reads the same
BATCHABLE_FAMILIES = {"qwen3", "minicpm4", "minicpm5", "lfm2", "qwen3_5"}


def load_model(model_id: str, path: str, **kw) -> LoadedModel:
    """`batch_slots > 1` serves a batchable family through the
    continuous-batching engine; combined with `spec_tokens > 0` it is
    refused before any weights load, as the JAX loader does.  `dp > 1`
    (sharded slots) is not ported."""
    from aha_tpu_torch.models.text_served import SPEC_WITH_SLOTS

    entry = lookup(model_id)
    if kw.get("batch_slots", 1) > 1 and entry.family not in BATCHABLE_FAMILIES:
        raise ValueError(
            f"--batch-slots applies to text chat families "
            f"({', '.join(sorted(BATCHABLE_FAMILIES))}); "
            f"'{entry.family}' is served single-stream")
    if kw.get("batch_slots", 1) > 1 and kw.get("spec_tokens", 0) > 0:
        raise ValueError(SPEC_WITH_SLOTS)
    if kw.pop("dp", 1) > 1:
        raise ValueError("--dp (continuous-batching slots sharded over "
                         "devices) is not ported to aha_tpu_torch yet; "
                         "serve with --dp 1")
    if kw.get("batch_slots", 1) == 1:
        kw.pop("batch_slots", None)   # keep kwargs clean for family loaders
    if entry.family not in BATCHABLE_FAMILIES:
        # prompt-prefix KV caching + speculative decoding ride the
        # text-chat engine only
        kw.pop("prefix_cache", None)
        kw.pop("spec_tokens", None)
    if kw.get("spec_tokens", 0) == 0:
        kw.pop("spec_tokens", None)
    loader = FAMILY_LOADERS.get(entry.family)
    if loader is None:
        raise NotImplementedError(
            f"model family '{entry.family}' is not ported to aha_tpu_torch "
            "yet (the Qwen3 chat, MiniCPM4/5, LFM2, Qwen3.5, Qwen2.5-VL, "
            "Qwen3-VL, PaddleOCR-VL, DeepSeek-OCR, LFM2-VL, Qwen3-ASR, "
            "Fun-ASR-Nano, GLM-ASR-Nano, VoxCPM, RMBG-2.0, Qwen3 embedding "
            "and reranker, and all-MiniLM-L6-v2 models are)")
    return loader(entry, path, **kw)
