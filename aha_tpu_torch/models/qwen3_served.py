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
- `tp > 1` (the JAX package's Qwen3EmbeddingServed.load(..., tp=)): the
  forward runs over tp ranks (parallel/ranks.py), each holding its slice
  of the checkpoint in a sharded Qwen3Model (qwen3_rank); every length
  group goes to the ranks through `Ranks.call` as host arrays, so every
  rank makes the same forward and collectives, and the vectors are read
  on rank 0.  The reranker rides the embedder.
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
from aha_tpu_torch.models.text_served import TextChatModel, decoder_rank
from aha_tpu_torch.ops.norms import l2_normalize
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device, get_dtype


#: qwen3_rank(path, max_seq_len, mesh): a tensor-parallel rank's Qwen3
#: model on its card and its slice of the checkpoint (read alone,
#: io/weights.read_shard)
qwen3_rank = functools.partial(decoder_rank, Qwen3Model, Qwen3Config)


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


class EmbedRank:
    """One rank's embedding model and parameters (what a tp rank builds;
    parallel/ranks.start sets `ranks` and `tp_name` on rank 0's)."""

    def __init__(self, model: Qwen3Model, params: dict):
        self.model, self.params = model, params
        self.ranks = self.tp_name = None


def embed_rank(path: str, mesh) -> EmbedRank:
    """A tp rank's sharded embedding model (every rank runs this)."""
    return EmbedRank(*qwen3_rank(path, 8192, mesh))


def embed_rows(rank, ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """(rows, bucket) ids and (rows,) lengths, host arrays, → (rows, H)
    float32 unit vectors on the host: each row's final hidden at
    len − 1, L2-normalized, through `rank`'s model and parameters (an
    EmbedRank, or the served embedder on one device).  Every rank of a tp
    group runs it (Ranks.call) on its shard; rank 0's vectors are the
    answer."""
    dev = rank.model.device
    ids_t = torch.from_numpy(ids).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    with torch.no_grad():
        hidden = rank.model.forward_hidden(rank.params, ids_t)
        rows = torch.arange(ids_t.shape[0], device=dev)
        last = hidden[rows, lens_t.long() - 1].float()
        return l2_normalize(last).cpu().numpy()


class Qwen3EmbeddingServed(LoadedModel):
    def __init__(self, entry: ModelEntry, model: Qwen3Model, params: dict,
                 tokenizer: TokenizerModel, ranks=None):
        super().__init__(entry)
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        #: rank 0's handle on the tp workers (None on one device)
        self.ranks = ranks

    @classmethod
    def load(cls, entry: ModelEntry, path: str,
             tp: int = 1) -> "Qwen3EmbeddingServed":
        """On the default device, or `tp > 1` ranks one a card after
        check_tp refuses a tp that does not divide the model."""
        if tp > 1:
            from aha_tpu_torch.parallel.mesh import MeshConfig
            from aha_tpu_torch.parallel.ranks import start
            from aha_tpu_torch.utils.device import mesh_devices

            check_tp(Qwen3Config.from_file(path), tp)
            rank, ranks = start(MeshConfig(tp=tp),
                                functools.partial(embed_rank, path),
                                devices=mesh_devices(tp=tp))
            return cls(entry, rank.model, rank.params,
                       TokenizerModel.init(path), ranks)
        dev = device()
        model = Qwen3Model(Qwen3Config.from_file(path), max_rope_len=8192,
                           device=dev)
        params = model.load_params(open_weights(path), dtype=get_dtype(dev))
        return cls(entry, model, params, TokenizerModel.init(path))

    def shutdown(self) -> None:
        """Stop the tp workers (none on one device)."""
        if self.ranks is not None:
            self.ranks.shutdown()

    def embed_group(self, ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """One length group's vectors (embed_rows), on every rank of a tp
        group."""
        if self.ranks is not None:
            return self.ranks.call(embed_rows, ids, lens)
        return embed_rows(self, ids, lens)

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
        for blen, idxs in by_bucket.items():
            rows = 1 << (len(idxs) - 1).bit_length()
            arr = np.zeros((rows, blen), np.int64)
            lens = np.ones(rows, np.int64)
            for row, i in enumerate(idxs):
                arr[row, :len(encs[i])] = encs[i]
                lens[row] = len(encs[i])
            arr[len(idxs):] = arr[0]
            lens[len(idxs):] = lens[0]
            out[idxs] = self.embed_group(arr, lens)[:len(idxs)]
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
    def load(cls, entry: ModelEntry, path: str,
             tp: int = 1) -> "Qwen3RerankerServed":
        return cls(entry, Qwen3EmbeddingServed.load(entry, path, tp))

    def shutdown(self) -> None:
        self._embedding.shutdown()

    def rerank(self, query: str, documents: list[str]) -> list[float]:
        # one batched forward for query + documents together
        vecs = self._embedding.embed_arrays([query] + documents)
        q, docs = vecs[0], vecs[1:]
        # embeddings are L2-normalized → cosine == dot
        return (docs @ q).astype(np.float32).tolist()
