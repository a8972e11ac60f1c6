"""Fun-ASR-Nano served model (counterpart of
aha_tpu/models/fun_asr_nano_served.py's FunAsrNanoChat).

The prompt is fixed (processor.rs:47-54): a qwen-style system/user wrapper
around the user's text, then the audio region as zero token ids that
fbank_mask marks, then the assistant turn.  Frontend: kaldi fbank
(×32768) + LFR 7/6 on the host; the LFR rows are padded to LFR_BUCKETS
(pad rows seg −1) and fbank_mask to the engine's prompt bucket
(`bucket_for`).  Only the first audio part of a request is read, as in
the reference.  One stream on a TextEngine without a prefix store.
"""

from __future__ import annotations

import functools
import numpy as np

from aha_tpu_torch.core.chat_template import ChatTemplate
from aha_tpu_torch.core.engine import bucket_for
from aha_tpu_torch.core.generate import PrepareData
from aha_tpu_torch.models.fun_asr_nano import (FunAsrNanoConfig,
                                               FunAsrNanoModel, check_tp,
                                               fun_asr_token_length)
from aha_tpu_torch.models.text_served import (TextChatModel, decoder_rank,
                                              rank_builder)
from aha_tpu_torch.ops.audio_feats import apply_lfr, kaldi_fbank
from aha_tpu_torch.params import ChatCompletionParameters, extract_parts
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.audio import prepare_audio

PROMPT_PREFIX = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>"
                 "\n<|im_start|>user\n")
PROMPT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"
LFR_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _lfr_bucket(n: int) -> int:
    for b in LFR_BUCKETS:
        if n <= b:
            return b
    return LFR_BUCKETS[-1]


def build_mm(feats: np.ndarray, n_prompt: int, head_len: int,
             n_tok: int) -> dict:
    """The host inputs of one prefill (numpy): the LFR rows padded to their
    bucket, seg (0 real, −1 pad), the spliced adaptor rows' gather and
    fbank_mask over the prompt's bucket (`n_prompt` ids, the audio region
    `n_tok` rows from `head_len`)."""
    t_lfr = feats.shape[0]
    bucket = _lfr_bucket(t_lfr)
    speech = np.zeros((1, bucket, feats.shape[1]), np.float32)
    speech[0, :t_lfr] = feats
    seg = np.full(bucket, -1, np.int32)
    seg[:t_lfr] = 0
    fmask = np.zeros(bucket_for(n_prompt), bool)
    fmask[head_len:head_len + n_tok] = True
    return {"speech": speech, "seg": seg,
            "gather": np.arange(n_tok, dtype=np.int32), "fbank_mask": fmask}


class FunAsrNanoChat(TextChatModel):
    asr_model: FunAsrNanoModel

    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "FunAsrNanoChat":
        """One stream on a TextEngine without a prefix store; `batch_slots
        > 1` is refused by the loader before this runs.  `tp > 1` shards
        the model over tp ranks (text_served.rank_builder), after check_tp
        refuses a tp that does not divide it."""
        tp = kw.get("tp", 1)
        build = functools.partial(decoder_rank, FunAsrNanoModel,
                                  FunAsrNanoConfig)
        served = super().load(
            entry, path, build, max_seq_len=max_seq_len, prefix_cache=0,
            cuda_graphs=kw.get("cuda_graphs", True), tp=tp,
            build_rank=rank_builder(FunAsrNanoModel, FunAsrNanoConfig,
                                    path, max_seq_len, tp, check_tp),
            chat_template=ChatTemplate.str_init("{{ messages }}"))
        served.asr_model = served.engine.model
        return served

    def get_data(self, mes: ChatCompletionParameters) -> PrepareData:
        e = self.asr_model.config.encoder
        user_text = ""
        sources = []
        for m in mes.messages:
            if m.role == "user":
                user_text += m.text()
            for p in extract_parts(m.content, "audio_url"):
                sources.append(p.audio_url.url)
        if not sources:
            raise ValueError("FunASRNano need audio input")
        audio = prepare_audio(sources[0], 16000)
        feats = apply_lfr(kaldi_fbank(audio, num_mel_bins=e.n_mels),
                          e.lfr_m, e.lfr_n)
        n_tok = fun_asr_token_length(feats.shape[0])
        head = self.tokenizer.encode(PROMPT_PREFIX + user_text)
        tail = self.tokenizer.encode(PROMPT_SUFFIX)
        input_ids = head + [0] * n_tok + tail
        mm = build_mm(feats, len(input_ids), len(head), n_tok)
        return PrepareData(input_ids=input_ids,
                           mm=mm)
