"""all-MiniLM-L6-v2 as a served embedding model (counterpart of
aha_tpu/models/minilm_served.py).

Token id 0 ([PAD]) is dropped from each encoding and the rest truncated to
max_position_embeddings; texts are grouped by length bucket (16 to 512)
and each group's rows padded to a power of two (pad rows repeat row 0 and
are discarded), then embedded in one masked forward: masked mean pool, L2
normalize, float32.  The JAX package jits one program per (rows, bucket);
here each group runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.minilm import BertConfig, BertModel
from aha_tpu_torch.registry import ModelEntry

_LEN_BUCKETS = (16, 32, 64, 128, 256, 512)


def _bucket(n: int) -> int:
    for b in _LEN_BUCKETS:
        if n <= b:
            return b
    return _LEN_BUCKETS[-1]


class MiniLMServed(LoadedModel):
    def __init__(self, entry: ModelEntry, model: BertModel, params: dict,
                 tokenizer: TokenizerModel):
        super().__init__(entry)
        self.model = model
        self.params = params
        self.tokenizer = tokenizer

    @classmethod
    def load(cls, entry: ModelEntry, path: str) -> "MiniLMServed":
        from aha_tpu_torch.io.weights import open_weights
        from aha_tpu_torch.utils.device import device

        model = BertModel(BertConfig.from_file(path), device=device())
        params = model.load_params(open_weights(path), dtype=torch.float32)
        return cls(entry, model, params, TokenizerModel.init(path))

    def embedding(self, texts: list[str]) -> list[list[float]]:
        if not texts:
            raise ValueError("embedding input cannot be empty")
        max_pos = self.model.config.max_position_embeddings
        encs = []
        for t in texts:
            ids = [i for i in self.tokenizer.encode(t) if i != 0][:max_pos]
            if not ids:
                raise ValueError("embedding tokenized input cannot be empty")
            encs.append(ids)
        out: list[list[float]] = [None] * len(texts)  # type: ignore
        by_bucket: dict[int, list[int]] = {}
        for i, ids in enumerate(encs):
            by_bucket.setdefault(_bucket(len(ids)), []).append(i)
        dev = self.model.device
        for blen, idxs in by_bucket.items():
            rows = 1 << (len(idxs) - 1).bit_length()
            ids_arr = np.zeros((rows, blen), np.int64)
            mask = np.zeros((rows, blen), np.int64)
            for row, i in enumerate(idxs):
                ids_arr[row, :len(encs[i])] = encs[i]
                mask[row, :len(encs[i])] = 1
            ids_arr[len(idxs):] = ids_arr[0]
            mask[len(idxs):] = mask[0]
            with torch.no_grad():
                emb = self.model.embed(self.params,
                                       torch.from_numpy(ids_arr).to(dev),
                                       torch.from_numpy(mask).to(dev))
            emb = emb.float().cpu().numpy()
            for row, i in enumerate(idxs):
                out[i] = emb[row].tolist()
        return out
