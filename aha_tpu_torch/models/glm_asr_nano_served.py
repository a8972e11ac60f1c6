"""GLM-ASR-Nano served model (counterpart of
aha_tpu/models/glm_asr_nano_served.py's GlmAsrNanoChat).

Processor of src/models/glm_asr_nano/processor.rs: each audio split into
30 s windows (at most max_audio_len seconds of them), each padded to the
full window and turned into a whisper mel on the engine's device; the
audio token expands to the audio's summed valid token count; the audio
token and max_audio_len come from processor_config.json /
preprocessor_config.json.  One stream on a TextEngine without a prefix
store.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.models.glm_asr_nano import (GlmAsrNanoConfig,
                                               GlmAsrNanoModel,
                                               audio_token_length, check_tp)
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              rank_builder)
from aha_tpu_torch.ops.audio_feats import whisper_log_mel
from aha_tpu_torch.params import ChatCompletionParameters, extract_parts
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.audio import prepare_audio

SAMPLE_RATE = 16000
CHUNK_SECONDS = 30
WINDOW_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS
WINDOW_FRAMES = WINDOW_SAMPLES // 160  # 3000 mel frames per window


class GlmAsrNanoChat(TextChatModel):
    asr_model: GlmAsrNanoModel
    processor_cfg: dict

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "GlmAsrNanoChat":
        """One stream on a TextEngine without a prefix store; `batch_slots
        > 1` is refused by the loader before this runs.  `tp > 1` shards
        the model over tp ranks (text_served.rank_builder), after check_tp
        refuses a tp that does not divide it."""
        tp = kw.get("tp", 1)
        build = functools.partial(decoder_rank, GlmAsrNanoModel,
                                  GlmAsrNanoConfig)
        served = super().load(
            entry, path, build, max_seq_len=max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(GlmAsrNanoModel, GlmAsrNanoConfig,
                                    path, max_seq_len, tp, check_tp))
        served.asr_model = served.engine.model
        pcfg = {}
        for name in ("processor_config.json", "preprocessor_config.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p) as f:
                    pcfg.update(json.load(f))
        served.processor_cfg = pcfg
        return served

    @property
    def audio_token(self) -> str:
        return self.processor_cfg.get("audio_token", "<|pad_audio|>")

    @property
    def max_audio_len(self) -> int:
        return self.processor_cfg.get("max_audio_len", 600)

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True)
        sources = [p.audio_url.url for m in mes.messages
                   for p in extract_parts(m.content, "audio_url")]
        if not sources:
            return PrepareData(input_ids=self.tokenizer.encode(rendered))

        windows, token_lens_per_audio = [], []
        max_windows = self.max_audio_len // CHUNK_SECONDS
        for src in sources:
            audio = prepare_audio(src, SAMPLE_RATE)
            n_win = max(1, min((len(audio) + WINDOW_SAMPLES - 1)
                               // WINDOW_SAMPLES, max_windows))
            total_tokens = 0
            for i in range(n_win):
                seg = audio[i * WINDOW_SAMPLES:(i + 1) * WINDOW_SAMPLES]
                frames = max(len(seg) // 160, 8)
                total_tokens += audio_token_length(frames)
                padded = np.zeros(WINDOW_SAMPLES, np.float32)
                padded[:len(seg)] = seg
                windows.append((padded, frames))
            token_lens_per_audio.append(total_tokens)

        dev = self.engine.device
        mel = whisper_log_mel(
            torch.from_numpy(np.stack([w for w, _ in windows])).to(dev),
            num_mel_bins=self.asr_model.config.audio.num_mel_bins)
        tokens_per_window = mel.shape[2] // 8
        gather = []
        for w, (_, frames) in enumerate(windows):
            gather.extend(range(w * tokens_per_window,
                                w * tokens_per_window
                                + audio_token_length(frames)))
        # expand the audio token per audio
        text = rendered
        for n_tok in token_lens_per_audio:
            text = text.replace(self.audio_token, "<|placeholder|>" * n_tok, 1)
        text = text.replace("<|placeholder|>", self.audio_token)
        mm = {"mel": mel.float(),
              "gather": torch.tensor(gather, dtype=torch.int32, device=dev)}
        return PrepareData(input_ids=self.tokenizer.encode(text), mm=mm)
