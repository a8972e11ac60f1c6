"""Qwen3-ASR served model: chat with audio_url parts and
/v1/audio/transcriptions (counterpart of
aha_tpu/models/qwen3_asr_served.py's Qwen3ASRChat).

Behaviour of src/models/qwen3_asr/{processor,generate}.rs:
- repeated <|audio_start|><|audio_pad|><|audio_end|> runs collapse to one
  (processor.rs:132-143);
- metadata "language" appends "language {Lang}'<asr_text>'" when the
  language is supported (processor.rs:143-151);
- long audio splits into chunks of at most MAX_ASR_SECONDS, each
  transcribed on its own and the texts concatenated with summed usage;
- <|audio_pad|> expands to the post-conv token count
  (get_feat_extract_output_lengths).

The waveform is padded to a frame bucket (FRAME_BUCKETS) before the mel
runs on the engine's device, and the frames past the real length are
zeroed (the reference zero-pads the final window).  One stream on a
TextEngine without a prefix store (the reference passes no mm_key), its
decode in graphed blocks of 16 steps on the card.
"""

from __future__ import annotations

import functools
import uuid

import numpy as np
import torch

from aha_tpu_torch.core.generate import DEFAULT_MAX_TOKENS, PrepareData
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.models.qwen3_asr import (Qwen3ASRConfig, Qwen3ASRModel,
                                            check_tp,
                                            get_feat_extract_output_lengths)
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              rank_builder)
from aha_tpu_torch.ops.audio_feats import whisper_log_mel
from aha_tpu_torch.params import (ChatCompletionChoice,
                                  ChatCompletionParameters,
                                  ChatCompletionResponse, ChatMessage, Usage,
                                  extract_parts)
from aha_tpu_torch.params.chat import now_created
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.audio import prepare_audio, split_audio_into_chunks

AUDIO_MARKER = "<|audio_start|><|audio_pad|><|audio_end|>"
AUDIO_PAD = "<|audio_pad|>"
MAX_ASR_SECONDS = 1200.0
SAMPLE_RATE = 16000
FRAME_BUCKETS = (100, 200, 400, 800, 1600, 3200, 6400, 12800, 25600, 51200,
                 102400, 120000)

SUPPORTED_LANGUAGES = {
    "Chinese", "English", "Cantonese", "Arabic", "German", "French",
    "Spanish", "Portuguese", "Indonesian", "Italian", "Korean", "Russian",
    "Thai", "Vietnamese", "Japanese", "Turkish", "Hindi", "Malay", "Dutch",
    "Swedish", "Danish", "Finnish", "Polish", "Czech", "Filipino", "Persian",
    "Greek", "Romanian", "Hungarian", "Macedonian",
}


def _frame_bucket(n: int) -> int:
    for b in FRAME_BUCKETS:
        if n <= b:
            return b
    return FRAME_BUCKETS[-1]


def mel_for(audio: np.ndarray, n_mel: int,
            dev: torch.device) -> tuple[torch.Tensor, int, int]:
    """A 16 kHz waveform (T,) → (mel (1, n_mel, F_bucket) float32 on
    `dev` with the frames past the real length zeroed, the real frames,
    the audio tokens)."""
    n_frames = len(audio) // 160
    bucket = _frame_bucket(max(n_frames, 100))
    padded = np.zeros(bucket * 160, np.float32)
    padded[:len(audio)] = audio
    mel = whisper_log_mel(torch.from_numpy(padded)[None].to(dev),
                          num_mel_bins=n_mel)
    valid = torch.arange(mel.shape[2], device=dev) < n_frames
    mel = torch.where(valid[None, None, :], mel, 0.0)
    return mel.float(), n_frames, get_feat_extract_output_lengths(n_frames)


class Qwen3ASRChat(TextChatModel):
    asr_model: Qwen3ASRModel

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "Qwen3ASRChat":
        """One stream on a TextEngine without a prefix store; `batch_slots
        > 1` is refused by the loader before this runs.  `tp > 1` shards
        the model over tp ranks (text_served.rank_builder), after check_tp
        refuses a tp that does not divide it."""
        tp = kw.get("tp", 1)
        build = functools.partial(decoder_rank, Qwen3ASRModel,
                                  Qwen3ASRConfig)
        served = super().load(
            entry, path, build, max_seq_len=max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(Qwen3ASRModel, Qwen3ASRConfig,
                                    path, max_seq_len, tp, check_tp))
        served.asr_model = served.engine.model
        return served

    # -- preprocessing -------------------------------------------------------

    def _render(self, mes: ChatCompletionParameters) -> str:
        rendered = self.chat_template.apply(
            [m.to_json_dict() for m in mes.messages],
            add_generation_prompt=True)
        count = rendered.count(AUDIO_MARKER)
        if count > 1:
            rendered = rendered.replace(AUDIO_MARKER * count, AUDIO_MARKER)
        lang = mes.metadata_value("language")
        if lang:
            lang = lang[:1].upper() + lang[1:]
            if lang in SUPPORTED_LANGUAGES:
                rendered = f"{rendered}language {lang}'<asr_text>'"
        return rendered

    @staticmethod
    def _audio_sources(mes: ChatCompletionParameters) -> list[str]:
        return [p.audio_url.url for m in mes.messages
                for p in extract_parts(m.content, "audio_url")]

    def _mel_for(self, audio: np.ndarray):
        return mel_for(audio, self.asr_model.config.audio.num_mel_bins,
                       self.engine.device)

    def prepare_chunks(self, mes: ChatCompletionParameters
                       ) -> list[PrepareData]:
        rendered = self._render(mes)
        sources = self._audio_sources(mes)
        if not sources:
            # a text-only request still works through the thinker
            return [PrepareData(input_ids=self.tokenizer.encode(rendered))]
        chunks: list[np.ndarray] = []
        for src in sources:
            audio = prepare_audio(src, SAMPLE_RATE)
            chunks.extend(split_audio_into_chunks(audio, SAMPLE_RATE,
                                                  MAX_ASR_SECONDS))
        out = []
        for audio in chunks:
            mel, _, n_out = self._mel_for(audio)
            text = rendered.replace(AUDIO_PAD, AUDIO_PAD * n_out, 1)
            out.append(PrepareData(input_ids=self.tokenizer.encode(text),
                                   mm={"mel": mel, "n_out": n_out}))
        return out

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        return self.prepare_chunks(mes)[0]

    # -- VAD-fed streaming ASR (generate.rs:89-120) ----------------------------

    DEFAULT_TEMPLATE = ("<|im_start|>system\n<|im_end|>\n<|im_start|>user\n"
                        "<|audio_start|><|audio_pad|><|audio_end|><|im_end|>\n"
                        "<|im_start|>assistant\n")

    def asr_waveform(self, audio: np.ndarray, max_tokens: int = 512) -> str:
        """Transcribe one 16 kHz waveform through the fixed ASR template."""
        mel, _, n_out = self._mel_for(np.asarray(audio, np.float32))
        text = self.DEFAULT_TEMPLATE.replace(AUDIO_PAD, AUDIO_PAD * n_out, 1)
        ids = self.engine.generate_tokens(
            self.tokenizer.encode(text), SamplingConfig(), max_tokens,
            mm={"mel": mel, "n_out": n_out})
        return self.tokenizer.decode(ids)

    def asr_vad_res(self, vad_res) -> str:
        """Transcribe a FireRedVAD VadFrameResult's flushed speech buffer;
        empty when the frame carries no speech (generate.rs:89-98)."""
        if not vad_res.is_speech or vad_res.orig_audio is None:
            return ""
        return self.asr_waveform(vad_res.orig_audio)

    # -- generation over chunks ---------------------------------------------

    def generate(self, mes: ChatCompletionParameters
                 ) -> ChatCompletionResponse:
        """Each chunk transcribed in turn, the texts concatenated and the
        usage summed; one chunk gives the plain chat response (the JAX
        model prepares it twice, this once)."""
        cfg = self._sampling_cfg(mes)
        max_tokens = mes.max_tokens or DEFAULT_MAX_TOKENS
        texts = []
        pt = ps = ct = cs = 0.0
        for data in self.prepare_chunks(mes):
            ids = self.engine.generate_tokens(data.input_ids, cfg, max_tokens,
                                              **data.engine_kw())
            texts.append(self.tokenizer.decode(ids))
            t = self.engine.last_timing
            pt += t.prompt_tokens
            ps += t.prompt_secs
            ct += t.completion_tokens
            cs += t.completion_secs
        return ChatCompletionResponse(
            id=str(uuid.uuid4()),
            choices=[ChatCompletionChoice(
                index=0,
                message=ChatMessage(role="assistant", content="".join(texts)),
                finish_reason="stop")],
            created=now_created(),
            model=self.model_name,
            usage=Usage.from_timing(int(pt), ps, int(ct), cs),
        )
