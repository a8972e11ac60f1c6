"""Model factory: registry id → served model (counterpart of
aha_tpu/models/loader.py).  Ported families: qwen3 (the Qwen3 chat
models), the llama text families minicpm4 / minicpm5, the hybrid text
families lfm2 (LFM2 / LFM2.5) and qwen3_5 (Qwen3.5: text, and image and
video chat on a checkpoint with a vision tower), qwen2_5vl (Qwen2.5-VL
image and video chat), qwen3vl (Qwen3-VL image and video chat),
the OCR families paddleocr_vl (PaddleOCR-VL), deepseek_ocr (DeepSeek-OCR
and DeepSeek-OCR-2), hunyuan_ocr (HunyuanOCR) and glm_ocr (GLM-OCR),
lfm2vl (LFM2-VL image chat), the ASR families qwen3_asr (Qwen3-ASR),
fun_asr_nano (Fun-ASR-Nano) and glm_asr_nano (GLM-ASR-Nano), voxcpm
(VoxCPM text-to-speech), rmbg2_0 (RMBG-2.0 background removal),
qwen3_embedding / qwen3_reranker and minilm (all-MiniLM-L6-v2): every
family of the registry, and the GGUF entry qwen3.5-gguf through qwen3_5.
The reference's option checks run first, before any weights load, with
its strings."""

from __future__ import annotations

from typing import Callable

from aha_tpu_torch.core.engine import SPEC_WITH_TP
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.registry import ModelEntry, lookup


def _qwen3(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_served import Qwen3Chat

    return Qwen3Chat.load(entry, path, **kw)


def _qwen3_embedding(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_served import Qwen3EmbeddingServed

    return Qwen3EmbeddingServed.load(entry, path, tp=kw.get("tp", 1))


def _qwen3_reranker(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.qwen3_served import Qwen3RerankerServed

    return Qwen3RerankerServed.load(entry, path, tp=kw.get("tp", 1))


def _minilm(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.minilm_served import MiniLMServed

    return MiniLMServed.load(entry, path)


def _llama_family(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    """minicpm4 / minicpm5: the generic LlamaForCausalLM wrapper —
    LlamaConfig picks up whatever mup / LongRoPE fields the config.json
    has; `tp > 1` shards it over tp ranks."""
    from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel, check_tp
    from aha_tpu_torch.models.text_served import TextChatModel

    return TextChatModel.load_decoder(entry, path, LlamaModel, LlamaConfig,
                                      check_tp=check_tp, **kw)


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


def _hunyuan_ocr(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.hunyuan_ocr_served import HunyuanOCRChat

    return HunyuanOCRChat.load(entry, path, **kw)


def _glm_ocr(entry: ModelEntry, path: str, **kw) -> LoadedModel:
    from aha_tpu_torch.models.glm_ocr_served import GlmOcrChat

    return GlmOcrChat.load(entry, path, **kw)


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
    "hunyuan_ocr": _hunyuan_ocr,
    "glm_ocr": _glm_ocr,
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


# families whose serving wrappers have no mesh path (the reference's set
# and words): --tp is refused before loading any weights
_NO_TP_FAMILIES = {"minilm", "voxcpm", "rmbg2_0"}
#: families the port shards over --tp ranks
TP_FAMILIES = {"qwen3", "minicpm4", "minicpm5", "qwen3vl", "qwen2_5vl",
               "qwen3_embedding", "qwen3_reranker", "qwen3_asr",
               "fun_asr_nano", "glm_asr_nano", "paddleocr_vl", "hunyuan_ocr",
               "glm_ocr", "deepseek_ocr"}

#: the reference's refusals of the file kinds, word for word
ONNX_REFUSED = "onnx comming soon but now not support"
GGUF_PATH_NEEDED = "gguf model need gguf model path"


def load_model(model_id: str, path: str, gguf: str | None = None,
               mmproj: str | None = None, **kw) -> LoadedModel:
    """`batch_slots > 1` serves a batchable family through the
    continuous-batching engine; combined with `spec_tokens > 0` it is
    refused before any weights load, as the JAX loader does.  A GGUF
    entry (`qwen3.5-gguf`) loads the file `gguf` (and the tower from
    `mmproj`) and refuses to run without one, an ONNX entry is refused,
    each with the reference's words (aha_tpu/models/loader.py:204-213).
    `tp > 1` shards a family of TP_FAMILIES over tp ranks, one a card
    (Qwen3 chat, MiniCPM4 / MiniCPM5, Qwen3-VL, Qwen2.5-VL, the Qwen3
    embedder and reranker, the ASR families Qwen3-ASR, Fun-ASR-Nano and
    GLM-ASR-Nano, and the OCR families PaddleOCR-VL, HunyuanOCR, GLM-OCR
    and DeepSeek-OCR, its routed experts split across the ranks); the
    families with no mesh path refuse it with the reference's words, a
    GGUF entry with its loader's, every other family (LFM2, LFM2-VL,
    Qwen3.5) and tp with dp with the port's, naming what is not ported.
    `dp > 1` (dp BatchEngine replicas, one a card) goes through the
    reference's checks of its combination with the slots; a GGUF entry
    refuses it.  A host with
    fewer cards than tp·dp is refused before anything loads."""
    from aha_tpu_torch.models.text_served import (SPEC_WITH_SLOTS,
                                                  TP_WITH_DP, check_dp)
    from aha_tpu_torch.utils.device import mesh_devices

    entry = lookup(model_id)
    tp = kw.pop("tp", 1)
    dp = kw.pop("dp", 1)
    if tp > 1 and entry.family in _NO_TP_FAMILIES:
        raise ValueError(
            f"--tp does not apply to '{entry.family}' (no sharded serving "
            "path); serve it with --tp 1")
    if kw.get("batch_slots", 1) > 1 and entry.family not in BATCHABLE_FAMILIES:
        raise ValueError(
            f"--batch-slots applies to text chat families "
            f"({', '.join(sorted(BATCHABLE_FAMILIES))}); "
            f"'{entry.family}' is served single-stream")
    if kw.get("batch_slots", 1) > 1 and kw.get("spec_tokens", 0) > 0:
        raise ValueError(SPEC_WITH_SLOTS)
    if dp > 1:
        if entry.family not in BATCHABLE_FAMILIES:
            raise ValueError(
                "--dp shards continuous-batching slots and applies to the "
                f"batchable text families; '{entry.family}' is served "
                "single-stream")
        check_dp(dp, kw.get("batch_slots", 1))
    if entry.is_gguf:
        kw.update({"tp": tp} if tp > 1 else {})
        kw.update({"dp": dp} if dp > 1 else {})   # its loader refuses both
    elif tp > 1 or dp > 1:
        if tp > 1 and dp > 1:
            raise ValueError(TP_WITH_DP)
        if tp > 1 and entry.family not in TP_FAMILIES:
            raise ValueError(
                f"--tp: the sharding of '{entry.family}' is not ported to "
                "aha_tpu_torch yet (its tp ranks cover "
                f"{', '.join(sorted(TP_FAMILIES))}); serve it with --tp 1")
        if tp > 1 and kw.get("spec_tokens", 0) > 0:
            raise ValueError(SPEC_WITH_TP)
        mesh_devices(tp, dp)          # enough cards, before any weights
        kw.update(tp=tp, dp=dp)
    if kw.get("batch_slots", 1) == 1:
        kw.pop("batch_slots", None)   # keep kwargs clean for family loaders
    if entry.family not in BATCHABLE_FAMILIES:
        # prompt-prefix KV caching + speculative decoding ride the
        # text-chat engine only
        kw.pop("prefix_cache", None)
        kw.pop("spec_tokens", None)
    if kw.get("spec_tokens", 0) == 0:
        kw.pop("spec_tokens", None)
    if entry.is_onnx:
        raise NotImplementedError(ONNX_REFUSED)
    if entry.is_gguf:
        if gguf is None:
            raise ValueError(GGUF_PATH_NEEDED)
        return FAMILY_LOADERS[entry.family](entry, path, gguf=gguf,
                                            mmproj=mmproj, **kw)
    return FAMILY_LOADERS[entry.family](entry, path, **kw)
