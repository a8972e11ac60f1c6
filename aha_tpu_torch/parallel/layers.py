"""The sharded layers of a tensor-parallel rank (what GSPMD derives from
the partition rules in the JAX package, written out here).

- Column-sharded linears (q / k / v, gate / up) need nothing: a rank's
  weight holds its output columns, `nn.linear` gives its slice of the
  output.
- Row-sharded linears (o, down): the rank's input columns times its rows
  of the weight is one term of the full product; `row_linear` sums the
  terms with one `all_reduce`, in float32.  One device rounds the f32
  accumulation of the whole K-sum to bf16 once; rounding each rank's
  partial sum to bf16 before the reduce would add tp − 1 roundings, so
  the terms are reduced in f32 and rounded once.  The reduce moves
  rows × hidden × 4 bytes (4 KB a decode step at hidden 1024).
- The vocab-sharded embedding: rank r holds rows [r·V/tp, (r + 1)·V/tp);
  a masked lookup gives the rank's rows and zeros elsewhere, and the sum
  over ranks (exact: one term is nonzero) is the full lookup.
- The vocab-sharded head (tied: the same table): `gathered_logits` puts
  each rank's logits in their columns of a zero (…, V) tensor and sums
  them (exact), for prefill, sampling and the batched step;
  `greedy_token` runs the value-out head kernel over the shard and
  combines the ranks' (value, index) pairs: the first global index of the
  maximum wins (so the lower rank wins a tie across shards), and a NaN on
  any shard gives V − 1, as fast_argmax on the full logits does.  The
  pairs travel as a packed (tp, 2) f32 tensor summed over the ranks: gloo
  takes only all_reduce and broadcast on CUDA tensors.
"""

from __future__ import annotations

import torch

from aha_tpu_torch.core import nn
from aha_tpu_torch.core.sampling import fast_argmax
from aha_tpu_torch.ops.lm_head import head_argmax_value
from aha_tpu_torch.parallel.mesh import Mesh


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 sums never rounded to x's dtype."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(
                            *x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def row_linear(p: dict, x: torch.Tensor, mesh: Mesh | None,
               promoted: bool = False) -> torch.Tensor:
    """A row-sharded linear: the sum over ranks of x_r @ w_r, reduced in
    f32, returned in x's dtype (the bias, replicated, added once in x's
    dtype); with no mesh, the one device's `nn.linear` (`promoted`:
    `nn.linear_promoted`, the weight cast to x's dtype — the float32
    towers'; under a mesh the f32 product already is)."""
    if mesh is None:
        return (nn.linear_promoted if promoted else nn.linear)(p, x)
    y = mesh.all_reduce(matmul_f32(x, p["w"])).to(x.dtype)
    return y + p["b"].to(x.dtype) if "b" in p else y


def swiglu_mlp(p: dict, x: torch.Tensor,
               mesh: Mesh | None) -> torch.Tensor:
    """The SwiGLU MLP over this rank's I/tp hidden columns: gate and up
    column-sharded, down row-sharded; with no mesh, the one device's
    `nn.swiglu_mlp`."""
    if mesh is None:
        return nn.swiglu_mlp(p, x)
    act = torch.nn.functional.silu(nn.linear(p["gate"], x)) \
        * nn.linear(p["up"], x)
    return row_linear(p["down"], act, mesh)


def vocab_range(vocab: int, mesh: Mesh) -> tuple[int, int]:
    """(first row, rows) of this rank's vocab shard."""
    n = vocab // mesh.tp
    return mesh.tp_rank * n, n


def embedding(p: dict, ids: torch.Tensor, vocab: int,
              mesh: Mesh | None) -> torch.Tensor:
    """Lookup in a vocab-sharded table: this rank's rows where the id is
    its own, zeros elsewhere, summed over the ranks; with no mesh, the one
    device's lookup."""
    if mesh is None:
        return nn.embedding(p, ids)
    start, n = vocab_range(vocab, mesh)
    local = ids.long() - start
    mine = (local >= 0) & (local < n)
    x = p["w"][local.clamp(0, n - 1)] * mine.unsqueeze(-1).to(p["w"].dtype)
    return mesh.all_reduce(x)


def gathered_logits(local: torch.Tensor, vocab: int,
                    mesh: Mesh) -> torch.Tensor:
    """The full (…, V) logits from every rank's (…, V/tp) columns."""
    start, n = vocab_range(vocab, mesh)
    full = local.new_zeros((*local.shape[:-1], vocab))
    full[..., start:start + n] = local
    return mesh.all_reduce(full)


def head_logits(w: torch.Tensor, hidden: torch.Tensor, vocab: int,
                mesh: Mesh | None) -> torch.Tensor:
    """hidden @ w.t() over a vocab-major head (V/tp, K): under a mesh each
    rank's columns, gathered."""
    local = hidden @ w.t()
    return local if mesh is None else gathered_logits(local, vocab, mesh)


def head_greedy(w: torch.Tensor, hidden: torch.Tensor, vocab: int,
                mesh: Mesh | None) -> torch.Tensor:
    """Greedy next token for ONE hidden row (0-dim int32): under a mesh
    `greedy_token`; on one device logits + fast_argmax, the engines' path
    for a model without a head kernel."""
    if mesh is not None:
        return greedy_token(w, hidden, vocab, mesh)
    return fast_argmax(head_logits(w, hidden, vocab, None).float()
                       .reshape(-1))


def pick_token(packed: torch.Tensor, vocab: int) -> torch.Tensor:
    """The global greedy token from the ranks' (value, global index) rows
    of `packed` (tp, 2) f32, rank order: the first rank with the largest
    value (its index the first of its shard), V − 1 if any value is NaN.
    0-dim int32."""
    vals, idxs = packed[:, 0], packed[:, 1]
    best = idxs.gather(0, torch.argmax(
        torch.nan_to_num(vals, nan=0.0)).reshape(1))[0]
    return torch.where(torch.isnan(vals).any(),
                       torch.full_like(best, vocab - 1), best).to(torch.int32)


def greedy_token(w: torch.Tensor, hidden: torch.Tensor, vocab: int,
                 mesh: Mesh) -> torch.Tensor:
    """Greedy next token for ONE hidden row over a vocab-sharded bf16 head
    (V/tp, K): the value-out head kernel on this rank's shard (its plain
    version on the CPU), then the ranks' pairs combined.  The same 0-dim
    int32 token on every rank."""
    idx, val = head_argmax_value(w, hidden)
    start, _ = vocab_range(vocab, mesh)
    packed = torch.zeros((mesh.tp, 2), dtype=torch.float32,
                         device=hidden.device)
    packed[mesh.tp_rank] = torch.stack([val, (idx + start).float()])
    return pick_token(mesh.all_reduce(packed), vocab)
