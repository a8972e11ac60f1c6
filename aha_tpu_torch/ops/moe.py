"""Mixture-of-experts FFN (counterpart of aha_tpu/ops/moe.py): DeepSeek-V2's
gate (float32 scores, softmax or sigmoid, greedy top-k, norm_topk_prob,
routed_scaling_factor), its routed experts with the JAX package's
capacity rule, and its shared experts.

The capacity rule is part of the result, kept exactly: a (token, k)
pair's slot is its rank among the pairs routed to its expert in
token-major order, a pair whose slot is ≥ C contributes zero, and C comes
from the caller (the decoder passes `default_capacity` of its padded
token count).  The layout is the port's own:

- N tokens with N ≤ C cannot overflow (a token routes to an expert at
  most once, so no expert gets more than N pairs): the N·K routed
  experts' weights are gathered (advanced indexing: PyTorch's
  `index_select` takes a slower kernel for a few indices) and each pair
  runs as one row of a batched product.  A decode step (N = 1, C =
  K) reads the K experts' weights, not all E, with static shapes and no
  host sync, so it is captured in the engine's decode graph.
- Otherwise the reference's dispatch: tokens scattered into an
  (E, C + 1, D) buffer (the extra row takes every overflowing pair and
  is dropped), one batched product per projection over all E experts,
  results gathered back by slot.

Expert parallelism (a tp `mesh`, DeepSeek-OCR's rules): rank r holds
experts [r·E/tp, (r + 1)·E/tp) and its I/tp columns of the shared
experts.  The router runs whole on every rank over the same tokens, so
every rank makes the same choices, and the capacity comes from the global
E and N, so a pair past it is dropped exactly as on one device.  A rank
computes only the pairs routed to its own experts (zero for the others)
on either path — the gather gives a foreign pair its clamped local
expert's weights and masks the row; the dispatch sends it to the spill
row —, adds its shared-expert term in float32, and one f32 `all_reduce`
sums both over the ranks.

Plain PyTorch: the reference computes its MoE outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aha_tpu_torch.parallel.layers import matmul_f32


def moe_gate(gate_w: torch.Tensor, x: torch.Tensor, top_k: int, *,
             scoring: str = "softmax", norm_topk_prob: bool = False,
             routed_scaling_factor: float = 1.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights (S, K) float32, expert indices (S, K) int64): float32
    logits, greedy top-k (ties to the lower index), the optional
    normalisation, the scaling factor."""
    logits = x.float() @ gate_w.float()
    if scoring == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(f"unsupported MoE scoring function {scoring}")
    # a stable sort: ties go to the lower expert index, as lax.top_k's do
    # (saturated sigmoid scores tie)
    topw, topi = torch.sort(scores, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :top_k], topi[..., :top_k]
    if top_k > 1 and norm_topk_prob:
        topw = topw / (topw.sum(-1, keepdim=True) + 1e-20)
    return topw * routed_scaling_factor, topi


def default_capacity(n_tokens: int, top_k: int, n_experts: int,
                     factor: float = 4.0) -> int:
    """Per-expert slot count: `factor`× the average load, capped at the
    token count, at least top_k."""
    avg = n_tokens * top_k / n_experts
    return max(top_k, min(n_tokens, math.ceil(factor * avg)))


def _expert_rows(xk: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> torch.Tensor:
    """down(SiLU(x·gate) · (x·up)) for (n, m, D) rows against (n, D, F) /
    (n, F, D) expert weights."""
    return torch.bmm(F.silu(torch.bmm(xk, wg)) * torch.bmm(xk, wu), wd)


def moe_ffn(p: dict, x: torch.Tensor, top_k: int, *,
            scoring: str = "softmax", norm_topk_prob: bool = False,
            routed_scaling_factor: float = 1.0,
            capacity: int | None = None, mesh=None) -> torch.Tensor:
    """Routed experts + shared experts over (N, D) tokens.

    p = {"gate": {"w": (D, E) float32},
         "experts": {"gate"/"up": {"w": (E, D, F)}, "down": {"w": (E, F, D)}},
         "shared": {"gate"/"up"/"down": {"w": ...}}}  (shared optional)

    Under a tp `mesh` the experts are the rank's E/tp and the shared
    experts its columns / rows; the result is the sum over the ranks."""
    N, D = x.shape
    E = p["gate"]["w"].shape[1]
    C = capacity if capacity is not None else default_capacity(N, top_k, E)
    topw, topi = moe_gate(p["gate"]["w"], x, top_k, scoring=scoring,
                          norm_topk_prob=norm_topk_prob,
                          routed_scaling_factor=routed_scaling_factor)
    ew = p["experts"]
    wg, wu, wd = ew["gate"]["w"], ew["up"]["w"], ew["down"]["w"]
    E_loc = wg.shape[0]                       # E, or a rank's E/tp
    flat_e = topi.reshape(-1)                                  # (N·K,)
    local_e = flat_e - (mesh.tp_rank * E_loc if mesh is not None else 0)
    mine = (local_e >= 0) & (local_e < E_loc)
    local_e = local_e.clamp(0, E_loc - 1)
    x_rep = x[:, None].expand(N, top_k, D).reshape(N * top_k, D)
    if N <= C:
        # no pair can overflow: each pair against its expert's weights
        out_sk = _expert_rows(x_rep[:, None], wg[local_e], wu[local_e],
                              wd[local_e])[:, 0]
        if mesh is not None:
            out_sk = torch.where(mine[:, None], out_sk, 0.0)
    else:
        onehot = F.one_hot(flat_e, E)                          # (N·K, E)
        slot = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
        drop = (slot >= C) | ~mine
        xe = x.new_zeros((E_loc, C + 1, D))                    # C = spill row
        xe.index_put_((local_e, torch.where(drop, C, slot)), x_rep,
                      accumulate=True)
        h = _expert_rows(xe[:, :C], wg, wu, wd).reshape(E_loc * C, D)
        gidx = (local_e * C + slot).clamp(0, E_loc * C - 1)
        out_sk = torch.where(drop[:, None], 0.0, h[gidx]).to(x.dtype)
    out = (out_sk.reshape(N, top_k, D)
           * topw[..., None].to(x.dtype)).sum(dim=1)
    if mesh is not None:
        if "shared" in p:
            sh = p["shared"]
            act = F.silu(x @ sh["gate"]["w"]) * (x @ sh["up"]["w"])
            out = out.float() + matmul_f32(act, sh["down"]["w"])
        return mesh.all_reduce(out.float()).to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        out = out + (F.silu(x @ sh["gate"]["w"]) * (x @ sh["up"]["w"])
                     ) @ sh["down"]["w"]
    return out
