"""Tokenizer wrapper over HF `tokenizers` (the port's copy of
aha_tpu/core/tokenizer.py).

Equivalent of src/tokenizer/mod.rs:10-121: loads tokenizer.json, falling
back to vocab.json + merges.txt byte-level BPE with added special tokens
from tokenizer_config.json's added_tokens_decoder.
"""

from __future__ import annotations

import json
import os

from tokenizers import Tokenizer


class TokenizerModel:
    def __init__(self, tok: Tokenizer):
        self.tok = tok

    @classmethod
    def init(cls, model_dir: str) -> "TokenizerModel":
        tj = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(tj):
            return cls(Tokenizer.from_file(tj))
        vocab = os.path.join(model_dir, "vocab.json")
        merges = os.path.join(model_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return cls(cls._from_bpe(model_dir, vocab, merges))
        raise FileNotFoundError(
            f"no tokenizer.json or vocab.json+merges.txt in {model_dir}")

    @staticmethod
    def _from_bpe(model_dir: str, vocab: str, merges: str) -> Tokenizer:
        from tokenizers import decoders, models, pre_tokenizers
        from tokenizers.models import BPE

        tok = Tokenizer(BPE.from_file(vocab, merges))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            added = cfg.get("added_tokens_decoder", {})
            if added:
                from tokenizers import AddedToken

                tok.add_special_tokens([
                    AddedToken(v["content"], special=True)
                    for v in added.values()
                ])
        return tok

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self.tok.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: list[int], skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> int | None:
        return self.tok.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self.tok.get_vocab_size()


class IncrementalDecoder:
    """Streaming token→text with partial-UTF8 handling.

    Mirrors the reference's "�" accumulation (common/generate.rs:201-218,
    :287-306): hold back output while the tail decodes to a replacement
    char, flush once the multibyte sequence completes.
    """

    def __init__(self, tokenizer: TokenizerModel):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.emitted = 0  # chars of decode(ids) already yielded

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tokenizer.decode(self.ids)
        if text.endswith("�"):
            return ""
        new = text[self.emitted:]
        self.emitted = len(text)
        return new

    def flush(self) -> str:
        text = self.tokenizer.decode(self.ids)
        new = text[self.emitted:]
        self.emitted = len(text)
        return new
