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


# -- batched sampling (continuous batching) -----------------------------------

# one config per row: greedy, greedy with a repeat penalty, and sampled rows
# with top-k, top-p, both, a penalty and a short repeat window
BATCH_CONFIGS = [
    dict(),
    dict(repeat_penalty=1.3),
    dict(temperature=0.7, top_k=20),
    dict(temperature=1.3, top_p=0.5),
    dict(temperature=0.5, top_k=5, top_p=0.9, repeat_penalty=0.8,
         repeat_last_n=16),
    dict(temperature=1.0, top_k=50, top_p=0.95, repeat_penalty=1.2),
    dict(temperature=0.9, repeat_penalty=1.5, repeat_last_n=None),
    dict(temperature=2.0, top_k=1),
]
# tokens generated so far per row: none yet, a partial window, and rings
# that have wrapped past their width W = 64
N_GEN = [0, 5, 17, 64, 100, 130, 3, 200]


def _batch_case(seed, V=300, W=64):
    rng = np.random.default_rng(seed)
    B = len(BATCH_CONFIGS)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    # rings drawn from the top logits, so the penalty hits tokens in play
    top = np.argsort(-logits, axis=1)[:, :W]
    rings = np.stack([rng.permutation(t) for t in top]).astype(np.int32)
    return logits, rings, np.asarray(N_GEN, np.int32)


def _jax_batch_filters(logits, rings, n_gen, jsp):
    """aha_tpu's sample_tokens_batch per row, up to the draw: the penalized
    logits, then temperature → top-k → top-p."""
    import jax

    W = rings.shape[1]
    n_valid = jnp.minimum(jnp.minimum(jnp.asarray(n_gen),
                                      jsp["repeat_last_n"]), W)
    lg = jax.vmap(js._penalized)(jnp.asarray(logits), jnp.asarray(rings),
                                 n_valid, jsp["repeat_penalty"])
    sl = lg / jnp.maximum(jsp["temperature"], 1e-7)[:, None]
    topk = jax.vmap(js._mask_top_k_dyn)(sl, jsp["top_k"])
    topp = jax.vmap(js._mask_top_p_dyn)(topk, jsp["top_p"])
    return n_valid, lg, topk, topp


def _port_sp():
    return ts.pack_sampling_params(
        [ts.SamplingConfig(**kw) for kw in BATCH_CONFIGS])


def test_pack_sampling_params_matches():
    jsp = js.pack_sampling_params(
        [js.SamplingConfig(**kw) for kw in BATCH_CONFIGS])
    sp = _port_sp()
    assert set(sp) == set(jsp)
    for name in sp:
        np.testing.assert_array_equal(sp[name].numpy(), np.asarray(jsp[name]))
        assert sp[name].numpy().dtype == np.asarray(jsp[name]).dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_filters_match(seed):
    """_penalized, _mask_top_k_dyn and _mask_top_p_dyn over ragged per-row
    configs equal aha_tpu's vmapped ones: the penalty bit for bit, the
    masks in which entries survive and, where they do, the values."""
    logits, rings, n_gen = _batch_case(seed)
    jsp = js.pack_sampling_params(
        [js.SamplingConfig(**kw) for kw in BATCH_CONFIGS])
    n_valid, j_pen, j_topk, j_topp = _jax_batch_filters(logits, rings, n_gen,
                                                        jsp)
    sp = _port_sp()
    pen = ts._penalized(torch.from_numpy(logits), torch.from_numpy(rings),
                        torch.from_numpy(np.array(n_valid)),
                        sp["repeat_penalty"])
    np.testing.assert_array_equal(pen.numpy(), np.asarray(j_pen))
    # the penalty changed the rows that have one and a non-empty window
    changed = (pen.numpy() != logits).any(axis=1)
    want = [kw.get("repeat_penalty", 1.0) != 1.0 and n > 0
            for kw, n in zip(BATCH_CONFIGS, N_GEN)]
    assert changed.tolist() == want
    sl = pen / sp["temperature"].clamp_min(1e-7)[:, None]
    topk = ts._mask_top_k_dyn(sl, sp["top_k"])
    topp = ts._mask_top_p_dyn(topk, sp["top_p"])
    for got, ref in ((topk, j_topk), (topp, j_topp)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        live = np.isfinite(ref)
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-6, atol=0)
    # the filters cut: top_k=5 keeps 5, top_k=1 keeps 1, top_p keeps fewer
    kept = np.isfinite(topp.numpy()).sum(axis=1)
    assert kept[4] <= 5 and kept[7] == 1 and kept[3] < logits.shape[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_sample_matches_given_the_same_noise(seed):
    """sample_tokens_batch against aha_tpu's on the same logits, rings,
    n_gen and configs.  aha_tpu draws jax.random.categorical with row b's
    key, which is argmax(logits + gumbel(key_b)); the port takes that
    same Gumbel noise, so greedy and sampled rows must give the same
    tokens."""
    import jax

    logits, rings, n_gen = _batch_case(seed)
    B, V = logits.shape
    jsp = js.pack_sampling_params(
        [js.SamplingConfig(**kw) for kw in BATCH_CONFIGS])
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    want = np.asarray(js.sample_tokens_batch(
        jnp.asarray(logits), keys, jsp, jnp.asarray(rings),
        jnp.asarray(n_gen)))
    noise = np.stack([np.asarray(jax.random.gumbel(keys[b], (V,),
                                                   jnp.float32))
                      for b in range(B)])
    got = ts.sample_tokens_batch(torch.from_numpy(logits), _port_sp(),
                                 torch.from_numpy(rings),
                                 torch.from_numpy(n_gen),
                                 noise=torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the greedy rows took the penalized argmax, the sampled rows a draw
    # that is not always the argmax
    _, j_pen, _, _ = _jax_batch_filters(logits, rings, n_gen, jsp)
    argmax = np.asarray(j_pen).argmax(axis=1)
    assert got[0] == argmax[0] and got[1] == argmax[1]
    assert (got.numpy()[2:] != argmax[2:]).any()


def test_batched_sampled_rows_draw_from_their_own_generators():
    """Row b's draw uses generators[b] alone: the same seed in another row,
    beside other rows, gives the same token sequence."""
    logits, rings, n_gen = _batch_case(4)
    sp = _port_sp()
    row = 5

    def draws(order, seeds):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        out = []
        for _ in range(6):
            toks = ts.sample_tokens_batch(
                torch.from_numpy(logits[order]),
                {k: v[order] for k, v in sp.items()},
                torch.from_numpy(rings[order]), torch.from_numpy(n_gen[order]),
                gens)
            out.append(int(toks[order.index(row)]))
        return out

    ident = list(range(len(BATCH_CONFIGS)))
    rolled = ident[3:] + ident[:3]
    a = draws(ident, [11 + i for i in ident])
    # the row keeps its seed; every other row gets another one
    b = draws(rolled, [11 + i if i == row else 111 + i for i in rolled])
    assert a == b and len(set(a)) > 1
