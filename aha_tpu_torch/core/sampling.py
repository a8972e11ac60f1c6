"""Token sampling on the device (counterpart of aha_tpu/core/sampling.py).

Same semantics and filter order as the JAX package (candle's): repeat
penalty → temperature → top-k → top-p, then a categorical draw by the
Gumbel trick (argmax of logits + Gumbel noise).  The noise comes from a
`torch.Generator`, or is passed in — the tests hand both packages the same
numpy noise, since jax.random and torch draw different numbers from one
seed.  Defaults follow the reference generate loop: seed 299792458, repeat
window 64.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_SEED = 299792458
DEFAULT_REPEAT_LAST_N = 64


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    repeat_penalty: float = 1.0
    repeat_last_n: int | None = DEFAULT_REPEAT_LAST_N
    seed: int = DEFAULT_SEED

    @property
    def greedy(self) -> bool:
        return self.temperature is None or self.temperature < 1e-7


def fast_argmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """First index of the maximum, as int32.  A row holding a NaN has no
    element equal to its (NaN) maximum; the sentinel is clamped to the last
    index so a diverged model still yields a valid id (the JAX
    fast_argmax's rule)."""
    m = logits.amax(dim=dim, keepdim=True)
    n = logits.shape[dim]
    shape = [1] * logits.ndim
    shape[dim] = n
    iota = torch.arange(n, device=logits.device).reshape(shape)
    idx = torch.where(logits == m, iota, n).amin(dim=dim)
    return torch.clamp(idx, max=n - 1).to(torch.int32)


def apply_repeat_penalty(logits: torch.Tensor, recent_tokens: torch.Tensor,
                         n_valid: int, penalty: float) -> torch.Tensor:
    """Penalize tokens among the first `n_valid` entries of the recent-token
    ring: positive logits are divided by the penalty, negative multiplied."""
    present = torch.zeros(logits.shape[-1], dtype=torch.bool,
                          device=logits.device)
    present[recent_tokens[:n_valid].long()] = True
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(present, penalized, logits)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter; always keeps the most probable token."""
    sorted_logits, sort_idx = torch.sort(-logits, dim=-1, stable=True)
    sorted_logits = -sorted_logits
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cut = cum > p
    cut[..., 0] = False
    sorted_logits = torch.where(cut, float("-inf"), sorted_logits)
    return torch.empty_like(logits).scatter_(-1, sort_idx, sorted_logits)


def filter_logits(logits: torch.Tensor, cfg: SamplingConfig,
                  recent_tokens: torch.Tensor | None = None,
                  n_valid: int = 0) -> torch.Tensor:
    """The logits a sampled draw is taken from: float32, penalized,
    temperature-scaled, top-k then top-p masked with -inf."""
    logits = logits.float()
    if cfg.repeat_penalty != 1.0 and recent_tokens is not None:
        logits = apply_repeat_penalty(logits, recent_tokens, n_valid,
                                      cfg.repeat_penalty)
    if cfg.greedy:
        return logits
    logits = logits / cfg.temperature
    if cfg.top_k is not None:
        logits = _mask_top_k(logits, cfg.top_k)
    if cfg.top_p is not None and 0.0 < cfg.top_p < 1.0:
        logits = _mask_top_p(logits, cfg.top_p)
    return logits


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device | str) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp_min(tiny))          # Exponential(1)
    return -torch.log(e.clamp_min(tiny))


def sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                 generator: torch.Generator | None = None,
                 recent_tokens: torch.Tensor | None = None, n_valid: int = 0,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """logits: (vocab,) → 0-dim int32 token on the logits' device.  A
    sampled draw adds `noise` (Gumbel) if given, else draws it from
    `generator`."""
    logits = filter_logits(logits, cfg, recent_tokens, n_valid)
    if cfg.greedy:
        return fast_argmax(logits)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return fast_argmax(logits + noise)


# -- batched sampling (continuous batching) -----------------------------------
#
# One step samples every slot with its own (temperature, top_k, top_p,
# repeat_penalty, repeat_last_n), carried as (B,) tensors: slot configs
# change without any per-config code path (aha_tpu/core/sampling.py
# pack_sampling_params / sample_tokens_batch).  Per row the filters and
# their order are sample_token's.


def pack_sampling_params(cfgs: "list[SamplingConfig]",
                         device: torch.device | str = "cpu") -> dict:
    """Per-slot configs → dict of (B,) tensors on `device` (temperature 0
    marks a greedy row, top_k 0 and top_p 1 disable their filters)."""
    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    return {
        "temperature": t([0.0 if c.greedy else float(c.temperature)
                          for c in cfgs], torch.float32),
        "top_k": t([int(c.top_k) if c.top_k else 0 for c in cfgs],
                   torch.int32),
        "top_p": t([float(c.top_p) if (c.top_p and 0.0 < c.top_p < 1.0)
                    else 1.0 for c in cfgs], torch.float32),
        "repeat_penalty": t([float(c.repeat_penalty) for c in cfgs],
                            torch.float32),
        "repeat_last_n": t([int(c.repeat_last_n if c.repeat_last_n
                                is not None else DEFAULT_REPEAT_LAST_N)
                            for c in cfgs], torch.int32),
    }


def _penalized(logits: torch.Tensor, rings: torch.Tensor,
               n_valid: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """(B, V) logits; rings (B, W) recent tokens, the first n_valid[b] of
    row b valid; penalty (B,) — 1.0 leaves a row as it is."""
    W = rings.shape[1]
    valid = torch.arange(W, device=rings.device)[None, :] < n_valid[:, None]
    idx = torch.where(valid, rings, 0).long()
    present = torch.zeros(logits.shape, dtype=torch.int32,
                          device=logits.device)
    present = present.scatter_add_(1, idx, valid.int()) > 0
    pen = penalty[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(present, penalized, logits)


def _mask_top_k_dyn(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """top-k per row with k (B,); k <= 0 disables."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = (k.long() - 1).clamp(0, V - 1)[:, None]
    kth = sorted_desc.gather(-1, idx)
    keep = (k <= 0)[:, None] | (logits >= kth)
    return torch.where(keep, logits, float("-inf"))


def _mask_top_p_dyn(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus per row with p (B,); p >= 1 disables; the most probable
    token always stays."""
    sorted_neg, sort_idx = torch.sort(-logits, dim=-1, stable=True)
    sorted_logits = -sorted_neg
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cut = (cum > p[:, None]) & (p < 1.0)[:, None]
    cut[:, 0] = False
    sorted_logits = torch.where(cut, float("-inf"), sorted_logits)
    return torch.empty_like(logits).scatter_(-1, sort_idx, sorted_logits)


def sample_tokens_batch(logits: torch.Tensor, sp: dict, rings: torch.Tensor,
                        n_gen: torch.Tensor,
                        generators: "list[torch.Generator] | None" = None,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """logits (B, V); sp from pack_sampling_params; rings (B, W) recent-token
    rings; n_gen (B,) tokens generated so far.  Returns (B,) int32.  Row b
    draws its Gumbel noise from generators[b] alone (or takes noise[b]), so
    a slot's stream depends only on its own seed and config."""
    logits = logits.float()
    B, V = logits.shape
    W = rings.shape[1]
    n_valid = torch.minimum(torch.minimum(n_gen, sp["repeat_last_n"]),
                            torch.tensor(W, device=n_gen.device))
    lg = _penalized(logits, rings, n_valid, sp["repeat_penalty"])
    greedy_tok = fast_argmax(lg)
    temp = sp["temperature"]
    sl = lg / temp.clamp_min(1e-7)[:, None]
    sl = _mask_top_k_dyn(sl, sp["top_k"])
    sl = _mask_top_p_dyn(sl, sp["top_p"])
    if noise is None:
        noise = torch.stack([gumbel_noise((V,), g, logits.device)
                             for g in generators])
    samp_tok = fast_argmax(sl + noise)
    return torch.where(temp < 1e-7, greedy_tok, samp_tok)
