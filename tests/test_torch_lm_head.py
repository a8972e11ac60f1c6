"""aha_tpu_torch's head_argmax (plain version on the CPU) against the
Pallas head_argmax in interpret mode: ragged vocab tiles, a tie planted
across tiles, a NaN row, and the explicit one-row shape check.  The port
stores the head vocab-major (V, K); the JAX kernel takes (K, V)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops.lm_head import head_argmax as jhead_argmax
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
    got = head_argmax(torch.from_numpy(w_kv.T.copy()), torch.from_numpy(h))
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
    got = head_argmax(torch.from_numpy(w_kv.T.copy()), torch.from_numpy(h))
    ref = jhead_argmax({"w": jnp.asarray(w_kv)}, jnp.asarray(h),
                       interpret=True)
    assert int(got) == int(ref) == 37


def test_nan_row_gives_fast_argmax_answer():
    K, V = 64, 300
    w = torch.randn(V, K)
    h = torch.full((1, K), float("nan"))
    logits = (h @ w.t()).reshape(-1)
    assert int(head_argmax(w, h)) == int(fast_argmax(logits)) == V - 1


def test_one_row_only():
    w = torch.randn(10, 8)
    with pytest.raises(ValueError):
        head_argmax(w, torch.randn(2, 8))
    with pytest.raises(ValueError):
        head_argmax(torch.randn(8, 10), torch.randn(1, 8))   # (K, V) layout
