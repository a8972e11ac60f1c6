"""aha_tpu_torch's sampler against aha_tpu.core.sampling on the same numpy
logits: the filtered distribution (repeat penalty → temperature → top-k →
top-p), the Gumbel draw given the same numpy noise, greedy argmax rules,
and the shared defaults."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import sampling as js
from aha_tpu_torch.core import sampling as ts

torch.set_num_threads(1)

CONFIGS = [
    dict(temperature=0.7, top_k=20, top_p=0.9),
    dict(temperature=1.3, top_p=0.5),
    dict(temperature=0.5, top_k=5, repeat_penalty=1.3),
    dict(temperature=1.0, top_k=50, top_p=0.95, repeat_penalty=0.8),
]


def _jax_filtered(logits, cfg, ring, n_valid):
    """aha_tpu.core.sampling.sample_token's filter chain, before the draw."""
    x = jnp.asarray(logits, jnp.float32)
    if cfg.repeat_penalty != 1.0:
        x = js.apply_repeat_penalty(x, jnp.asarray(ring), jnp.int32(n_valid),
                                    cfg.repeat_penalty)
    x = x / cfg.temperature
    if cfg.top_k is not None:
        x = js._mask_top_k(x, cfg.top_k)
    if cfg.top_p is not None and 0.0 < cfg.top_p < 1.0:
        x = js._mask_top_p(x, cfg.top_p)
    return np.asarray(x)


def _case(seed, V=300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(V) * 3).astype(np.float32)
    ring = rng.integers(0, V, 64).astype(np.int32)
    return rng, logits, ring


@pytest.mark.parametrize("kw", CONFIGS)
def test_filtered_distribution_matches(kw):
    _, logits, ring = _case(0)
    n_valid = 17
    ref = _jax_filtered(logits, js.SamplingConfig(**kw), ring, n_valid)
    got = ts.filter_logits(torch.from_numpy(logits), ts.SamplingConfig(**kw),
                           torch.from_numpy(ring), n_valid).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    live = np.isfinite(ref)

    def logp(x):
        x = x[live].astype(np.float64)
        return x - np.log(np.exp(x - x.max()).sum()) - x.max()

    np.testing.assert_allclose(logp(got), logp(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", CONFIGS)
def test_same_gumbel_noise_same_token(kw):
    for seed in range(5):
        rng, logits, ring = _case(seed)
        noise = rng.gumbel(size=logits.shape).astype(np.float32)
        ref = js.fast_argmax(jnp.asarray(
            _jax_filtered(logits, js.SamplingConfig(**kw), ring, 9) + noise))
        got = ts.sample_token(torch.from_numpy(logits),
                              ts.SamplingConfig(**kw),
                              recent_tokens=torch.from_numpy(ring), n_valid=9,
                              noise=torch.from_numpy(noise))
        assert int(got) == int(ref)


def test_generator_draw_is_seeded_and_in_range():
    _, logits, _ = _case(1)
    cfg = ts.SamplingConfig(temperature=0.8, top_k=10)

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return [int(ts.sample_token(torch.from_numpy(logits), cfg, g))
                for _ in range(20)]

    a = draws(3)
    assert a == draws(3) and len(set(a)) > 1
    allowed = set(np.argsort(-logits)[:10].tolist())
    assert set(a) <= allowed


def test_greedy_first_index_and_nan_rule():
    x = np.array([1.0, 5.0, 2.0, 5.0], np.float32)
    assert int(ts.fast_argmax(torch.from_numpy(x))) == \
        int(js.fast_argmax(jnp.asarray(x))) == 1
    x[2] = np.nan
    assert int(ts.fast_argmax(torch.from_numpy(x))) == \
        int(js.fast_argmax(jnp.asarray(x))) == 3
    g = ts.sample_token(torch.tensor([0.0, 2.0, 2.0]), ts.SamplingConfig())
    assert g.dtype == torch.int32 and int(g) == 1


def test_defaults_match():
    assert ts.DEFAULT_SEED == js.DEFAULT_SEED == 299792458
    assert ts.DEFAULT_REPEAT_LAST_N == js.DEFAULT_REPEAT_LAST_N == 64
    assert ts.SamplingConfig().greedy and js.SamplingConfig().greedy
