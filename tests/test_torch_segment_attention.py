"""aha_tpu_torch's segment-masked attention against aha_tpu's: the port's
flash_attention_segmented (its plain version on the CPU) against the
Pallas kernel in interpret mode, and segment_attention against JAX's
(masked sdpa off the TPU), on sorted windows of ≤ 64 rows that straddle
the kernels' tiles, one full segment, a pad tail of seg −1 and a ragged S;
D 80 and 64, G 1 and 2.  Only rows with seg ≥ 0 are compared with JAX: the
port's pad row matches nothing and gives 0 (checked), where JAX's attends
the other pad rows; no caller reads either.  float32 on the CPU: tolerance
rtol 1e-4, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops.attention import segment_attention as jsegment_attention
from aha_tpu.ops.flash_attention import \
    flash_attention_segmented as jsegmented
from aha_tpu_torch.ops import attention
from aha_tpu_torch.ops.flash_attention import (
    flash_attention_segmented, flash_attention_segmented_plain)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _windows(rng, S: int, pad: int = 0) -> np.ndarray:
    """Sorted segments of 1-64 rows over S − pad rows, then `pad` rows of
    seg −1."""
    sizes = rng.integers(1, 65, S)
    seg = np.repeat(np.arange(S), sizes)[:S - pad]
    return np.concatenate([seg, -np.ones(pad, np.int64)]).astype(np.int32)


SEGS = {
    "windows": lambda rng, S: _windows(rng, S),
    "windows+pad": lambda rng, S: _windows(rng, S, pad=S // 5),
    "full": lambda rng, S: np.zeros(S, np.int32),
    "full+pad": lambda rng, S: np.concatenate(
        [np.zeros(S - 37, np.int32), -np.ones(37, np.int32)]),
}


def _case(S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return rng, tuple(rng.standard_normal(s).astype(np.float32)
                      for s in ((1, S, H, D), (1, S, Hkv, D), (1, S, Hkv, D)))


@pytest.mark.parametrize("kind", list(SEGS))
@pytest.mark.parametrize("S,H,Hkv,D,block", [
    (256, 2, 2, 80, 128),       # D 80 (the Qwen2.5-VL tower), G 1
    (256, 4, 2, 64, 128),       # D 64, G 2
    (300, 2, 1, 80, 128),       # ragged S, G 2
])
def test_segmented_plain_matches_pallas(kind, S, H, Hkv, D, block):
    rng, (q, k, v) = _case(S, H, Hkv, D)
    seg = SEGS[kind](rng, S)
    got = flash_attention_segmented(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(seg)).numpy()
    want = np.asarray(jsegmented(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(seg),
                                 block_q=block, block_k=block,
                                 interpret=True))
    real = seg >= 0
    np.testing.assert_allclose(got[:, real], want[:, real], **TOL)
    assert not got[:, ~real].any()


@pytest.mark.parametrize("S", [64, 256, 300])
def test_segment_attention_matches_jax(S):
    """The wrapper's route at every S equals JAX's segment_attention
    (masked sdpa off the TPU) on the real rows; pad rows give 0."""
    rng, (q, k, v) = _case(S, 2, 2, 80, seed=S)
    seg = _windows(rng, S, pad=S // 8)
    got = attention.segment_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      torch.from_numpy(seg)).numpy()
    want = np.asarray(jsegment_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(seg)))
    real = seg >= 0
    np.testing.assert_allclose(got[:, real], want[:, real], **TOL)
    assert not got[:, ~real].any()


def test_segment_route_counts_nothing_on_the_cpu():
    """On the CPU the wrapper runs its plain version: no launch counted."""
    _, (q, k, v) = _case(256, 2, 2, 64, seed=3)
    n0 = flash_attention_segmented.launches
    seg = torch.zeros(256, dtype=torch.int32)
    out = attention.segment_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), seg)
    assert flash_attention_segmented.launches == n0
    np.testing.assert_array_equal(
        out.numpy(), flash_attention_segmented_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            seg).numpy())


def test_strided_qkv_view_matches_contiguous():
    """The tower hands the wrapper thirds of one fused qkv product."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((1, 256, 3, 2, 80)).astype(
        np.float32))
    seg = torch.from_numpy(_windows(rng, 256))
    views = [qkv[:, :, i] for i in range(3)]
    assert not views[2].is_contiguous()
    np.testing.assert_array_equal(
        flash_attention_segmented(*views, seg).numpy(),
        flash_attention_segmented(*[t.contiguous() for t in views],
                                  seg).numpy())


def test_segmented_rejects_bad_shapes():
    q = torch.zeros((1, 64, 2, 80))
    with pytest.raises(ValueError, match="seg must be"):
        flash_attention_segmented(q, q, q, torch.zeros(63, dtype=torch.int32))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_segmented(q, torch.zeros((1, 64, 3, 80)),
                                  torch.zeros((1, 64, 3, 80)),
                                  torch.zeros(64, dtype=torch.int32))
