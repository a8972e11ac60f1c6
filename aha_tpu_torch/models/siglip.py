"""The SigLIP encoder block's parameter layout, shared by the PaddleOCR-VL
and LFM2-VL towers: its HF names under `<prefix><i>.` and the port's
per-block dict.  Each tower keeps its own forward pass."""

from __future__ import annotations

#: (port key, HF name within one encoder block)
BLOCK_NORMS = (("ln1", "layer_norm1"), ("ln2", "layer_norm2"))
BLOCK_LINEARS = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                 ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                 ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))


def block_params(lin, norm, prefix: str, n: int) -> list[dict]:
    """The n blocks under `prefix` (".../encoder.layers."), each tensor
    read through the caller's `lin(name)` / `norm(name)`."""
    return [{**{k: norm(f"{prefix}{i}.{name}") for k, name in BLOCK_NORMS},
             **{k: lin(f"{prefix}{i}.{name}") for k, name in BLOCK_LINEARS}}
            for i in range(n)]


def init_blocks(lin, norm, d: int, ff: int, n: int) -> list[dict]:
    """n blocks of seeded parameters from the caller's `lin(in, out)` /
    `norm(d)`, drawn in the order q, k, v, o, fc1, fc2."""
    return [{"ln1": norm(d), "ln2": norm(d),
             "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
             "fc1": lin(d, ff), "fc2": lin(ff, d)} for _ in range(n)]
