"""Qwen3 served models (counterpart of aha_tpu/models/qwen3_served.py):
the chat LLM, and the embedding and reranker models over the same
backbone.

- embedding: each text's last-token final hidden, float32, L2-normalized
  (1e-12 floor).  Texts are grouped by prefill length bucket and each
  group runs as ONE batched cache-free forward (`forward_hidden`), its
  rows padded to a power of two with copies of row 0 (discarded); on the
  card a group at a bucket of 128 or more prefills through the flash
  prefill kernel at B = rows, a shorter one through masked sdpa, as the
  reference routes them.  The JAX package jits one program per (rows,
  bucket); here each group runs eagerly, as prefill does.
- reranker: the dot of the normalized query and document vectors (their
  cosine) from one batched call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aha_tpu_torch.core.engine import bucket_for
from aha_tpu_torch.core.tokenizer import TokenizerModel
from aha_tpu_torch.io.weights import open_weights
from aha_tpu_torch.models.base import LoadedModel
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model, check_tp
from aha_tpu_torch.models.text_served import TextChatModel
from aha_tpu_torch.ops.norms import l2_normalize
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype


def qwen3_rank(path: str, max_seq_len: int, mesh) -> tuple:
    """A tensor-parallel rank's Qwen3 model on its card and its slice of
    the checkpoint (read alone, io/weights.read_shard)."""
    model = Qwen3Model(Qwen3Config.from_file(path), max_rope_len=max_seq_len,
                       device=mesh.device, mesh=mesh)
    return model, model.load_params(open_weights(path),
                                    dtype=get_dtype(mesh.device))


class Qwen3Chat(TextChatModel):
    @classmethod
    def load(cls, entry: ModelEntry, path: str, max_seq_len: int = 8192,
             **kw) -> "Qwen3Chat":
        """`tp > 1` shards the model over tp ranks (qwen3_rank), after
        check_tp refuses a tp that does not divide its heads or MLP;
        `dp > 1` serves dp BatchEngine replicas."""
        tp = kw.get("tp", 1)
        if tp > 1:
            check_tp(Qwen3Config.from_file(path), tp)

        def build(path, max_seq_len):
            dev = device()
            model = Qwen3Model(Qwen3Config.from_file(path),
                               max_rope_len=max_seq_len, device=dev)
            return model, model.load_params(open_weights(path),
                                            dtype=get_dtype(dev))

        return super().load(entry, path, build, max_seq_len=max_seq_len,
                            batch_slots=kw.get("batch_slots", 1),
                            prefix_cache=kw.get("prefix_cache", 4),
                            spec_tokens=kw.get("spec_tokens", 0),
                            cuda_graphs=kw.get("cuda_graphs", True),
                            tp=tp, dp=kw.get("dp", 1),
                            build_rank=functools.partial(qwen3_rank, path,
                                                         max_seq_len))


class Qwen3EmbeddingServed(LoadedModel):
    def __init__(self, entry: ModelEntry, model: Qwen3Model, params: dict,
                 tokenizer: TokenizerModel):
        super().__init__(entry)
        self.model = model
        self.params = params
        self.tokenizer = tokenizer

    @classmethod
    def load(cls, entry: ModelEntry, path: str) -> "Qwen3EmbeddingServed":
        dev = device()
        model = Qwen3Model(Qwen3Config.from_file(path), max_rope_len=8192,
                           device=dev)
        params = model.load_params(open_weights(path), dtype=get_dtype(dev))
        return cls(entry, model, params, TokenizerModel.init(path))

    def embed_group(self, ids: torch.Tensor,
                    valid_len: torch.Tensor) -> torch.Tensor:
        """(rows, bucket) ids on the device, (rows,) lengths → (rows, H)
        float32 unit vectors: each row's hidden at valid_len − 1."""
        with torch.no_grad():
            hidden = self.model.forward_hidden(self.params, ids)
            rows = torch.arange(ids.shape[0], device=ids.device)
            last = hidden[rows, valid_len.long() - 1].float()
            return l2_normalize(last)

    def embed_one_array(self, text: str) -> np.ndarray:
        return self.embed_arrays([text])[0]

    def embed_arrays(self, texts: list[str]) -> np.ndarray:
        """(N, H) float32, L2-normalized, one batched forward per length
        bucket."""
        encs = []
        for t in texts:
            ids = self.tokenizer.encode(t)
            if not ids:
                raise ValueError("embedding tokenized input cannot be empty")
            encs.append(ids)
        out = np.empty((len(texts), self.model.config.hidden_size),
                       np.float32)
        by_bucket: dict[int, list[int]] = {}
        for i, ids in enumerate(encs):
            by_bucket.setdefault(bucket_for(len(ids)), []).append(i)
        dev = self.model.device
        for blen, idxs in by_bucket.items():
            rows = 1 << (len(idxs) - 1).bit_length()
            arr = np.zeros((rows, blen), np.int64)
            lens = np.ones(rows, np.int64)
            for row, i in enumerate(idxs):
                arr[row, :len(encs[i])] = encs[i]
                lens[row] = len(encs[i])
            arr[len(idxs):] = arr[0]
            lens[len(idxs):] = lens[0]
            vecs = self.embed_group(torch.from_numpy(arr).to(dev),
                                    torch.from_numpy(lens).to(dev))
            out[idxs] = vecs.cpu().numpy()[:len(idxs)]
        return out

    def embedding(self, texts: list[str]) -> list[list[float]]:
        if not texts:
            raise ValueError("embedding input cannot be empty")
        return self.embed_arrays(texts).tolist()


class Qwen3RerankerServed(LoadedModel):
    """Cosine-similarity reranker over Qwen3 embeddings."""

    def __init__(self, entry: ModelEntry, embedding: Qwen3EmbeddingServed):
        super().__init__(entry)
        self._embedding = embedding

    @classmethod
    def load(cls, entry: ModelEntry, path: str) -> "Qwen3RerankerServed":
        return cls(entry, Qwen3EmbeddingServed.load(entry, path))

    def rerank(self, query: str, documents: list[str]) -> list[float]:
        # one batched forward for query + documents together
        vecs = self._embedding.embed_arrays([query] + documents)
        q, docs = vecs[0], vecs[1:]
        # embeddings are L2-normalized → cosine == dot
        return (docs @ q).astype(np.float32).tolist()
