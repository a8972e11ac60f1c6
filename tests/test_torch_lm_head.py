"""aha_tpu_torch's head_argmax (plain versions on the CPU) against the
Pallas head_argmax in interpret mode: the bf16 head, and the int8 and
4-bit heads (the port's column-major grids from `quant_from_jax` of the
JAX packs) — ragged vocab tiles, a tie planted across tiles, a NaN row,
the layouts no body takes, and the explicit one-row shape check.  The port
stores the dense head vocab-major (V, K); the JAX kernel takes (K, V)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops.lm_head import head_argmax as jhead_argmax
from aha_tpu.ops.quant_matmul import pack_q4_rows, pack_q8_rows
from aha_tpu_torch.io.convert import quant_from_jax
from aha_tpu_torch.core.sampling import fast_argmax
from aha_tpu_torch.ops.lm_head import head_argmax

torch.set_num_threads(1)


@pytest.mark.parametrize("K,V", [(64, 1000), (1024, 5000)])
def test_matches_pallas_ragged_vocab(K, V):
    """(1024, 5000) spans three 1920-column Pallas tiles, the last ragged;
    (64, 1000) is one ragged tile."""
    rng = np.random.default_rng(K)
    w_kv = (rng.standard_normal((K, V)) * 0.1).astype(np.float32)
    h = rng.standard_normal((1, 1, K)).astype(np.float32)
    got = head_argmax({"w": torch.from_numpy(w_kv.T.copy())},
                      torch.from_numpy(h))
    ref = jhead_argmax({"w": jnp.asarray(w_kv)}, jnp.asarray(h),
                       interpret=True)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(ref) == int(np.argmax(h.reshape(K) @ w_kv))


def test_tie_across_tiles_takes_first_index():
    K, V = 1024, 5000
    w_kv = np.zeros((K, V), np.float32)
    w_kv[0, 37] = w_kv[0, 4100] = 1.0      # same logit, tiles 0 and 2
    h = np.zeros((1, K), np.float32)
    h[0, 0] = 1.0
    got = head_argmax({"w": torch.from_numpy(w_kv.T.copy())},
                      torch.from_numpy(h))
    ref = jhead_argmax({"w": jnp.asarray(w_kv)}, jnp.asarray(h),
                       interpret=True)
    assert int(got) == int(ref) == 37


def test_nan_row_gives_fast_argmax_answer():
    K, V = 64, 300
    w = torch.randn(V, K)
    h = torch.full((1, K), float("nan"))
    logits = (h @ w.t()).reshape(-1)
    assert int(head_argmax({"w": w}, h)) == int(fast_argmax(logits)) == V - 1


def test_one_row_only():
    w = torch.randn(10, 8)
    with pytest.raises(ValueError):
        head_argmax({"w": w}, torch.randn(2, 8))
    with pytest.raises(ValueError):
        head_argmax({"w": torch.randn(8, 10)}, torch.randn(1, 8))  # (K, V)
    with pytest.raises(ValueError):                      # no body takes it
        head_argmax({"u": w}, torch.randn(1, 8))
    with pytest.raises(ValueError):                      # biased heads
        head_argmax({"w": w, "b": torch.zeros(10)}, torch.randn(1, 8))


def _quant_head(grid, w_vk):
    """The JAX pack of a (V, K) head and the port's layout of it."""
    jp = (pack_q8_rows if grid == "q8" else pack_q4_rows)(w_vk)
    return ({k: jnp.asarray(v) for k, v in jp.items()}, quant_from_jax(jp))


@pytest.mark.parametrize("grid", ["q8", "q4"])
@pytest.mark.parametrize("K,V", [(64, 1000), (1024, 5000)])
def test_quant_heads_match_pallas(grid, K, V):
    """The int8 and 4-bit bodies, plain version vs the Pallas kernel in
    interpret mode: the same index on random rows whose top-2 logit gap is
    above 1e-2 of max |logit| (both quantize the hidden state the same way;
    the 4-bit grids differ by the JAX fold's activation rounding, ~1e-2 of
    max |out| at most, so closer rows may part)."""
    rng = np.random.default_rng(K + V)
    w = (rng.standard_normal((V, K)) * 0.1).astype(np.float32)
    jp, tp = _quant_head(grid, w)
    rows = [h for h in rng.standard_normal((40, 1, K)).astype(np.float32)
            if np.diff(np.sort(h[0] @ w.T)[-2:])[0]
            > 1e-2 * np.abs(h[0] @ w.T).max()][:3]
    assert len(rows) == 3
    for h in rows:
        ref = int(jhead_argmax(jp, jnp.asarray(h), interpret=True))
        got = head_argmax(tp, torch.from_numpy(h))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == ref


@pytest.mark.parametrize("grid", ["q8", "q4"])
def test_quant_head_tie_and_nan(grid):
    """A tie planted across Pallas vocab tiles goes to the first index in
    both; a NaN hidden state gives V − 1, fast_argmax's answer (the Pallas
    kernel returns 0 for an all-NaN row)."""
    K, V = 1024, 5000
    w = np.zeros((V, K), np.float32)
    w[37, :4] = w[4100, :4] = 1.0
    w[2000, :4] = 0.5
    jp, tp = _quant_head(grid, w)
    h = np.zeros((1, K), np.float32)
    h[0, :4] = 1.0
    got = head_argmax(tp, torch.from_numpy(h))
    assert int(got) == int(jhead_argmax(jp, jnp.asarray(h), interpret=True)) \
        == 37
    nan = torch.full((1, K), float("nan"))
    assert int(head_argmax(tp, nan)) == V - 1
