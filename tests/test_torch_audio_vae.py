"""aha_tpu_torch's AudioVAE (models/audio_vae.py) and causal convs
(ops/conv.py) against aha_tpu's on the CPU, float32: the causal conv with
dilation and groups, the causal transpose conv, the weight-norm fold, and
the VAE's encode and decode (with and without the decoder's sample-rate
embeddings) on tests/test_voxcpm.py's tiny geometry and at the default
rates at narrow widths, parameters carried with io/convert.params_from_jax;
then the causality test of tests/test_voxcpm.py repeated on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models import audio_vae as jvae
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import audio_vae as tvae
from aha_tpu_torch.ops.conv import causal_conv1d, causal_conv_transpose1d

torch.set_num_threads(1)
#: one conv's agreement, max abs error relative to max |ref|
TOL_CONV = 1e-5
#: a whole encode or decode (tens of convs), relative to max |ref|
TOL_VAE = 1e-4


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("stride,dilation,groups,padding", [
    (1, 1, 1, 3), (1, 3, 6, 9), (1, 9, 6, 27), (2, 1, 1, 1), (5, 1, 1, 3),
    (1, 1, 3, 0)])
def test_causal_conv1d_matches(stride, dilation, groups, padding):
    rng = np.random.default_rng(stride * 100 + dilation)
    x = rng.standard_normal((2, 6, 40)).astype(np.float32)
    w = rng.standard_normal((12, 6 // groups, 7)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    ref = jvae.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=stride, dilation=dilation, groups=groups,
                             padding=padding)
    got = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), stride=stride,
                        dilation=dilation, groups=groups, padding=padding)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL_CONV


@pytest.mark.parametrize("stride", [2, 5, 8])
def test_causal_conv_transpose1d_matches(stride):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((1, 6, 10)).astype(np.float32)
    w = rng.standard_normal((6, 3, 2 * stride)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    kw = dict(stride=stride, padding=-(-stride // 2),
              output_padding=stride % 2)
    ref = jvae.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), **kw)
    got = causal_conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), **kw)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL_CONV


def test_weight_norm_fold_matches():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((4, 3, 7)).astype(np.float32)
    g = rng.standard_normal((4, 1, 1)).astype(np.float32)
    ref = jvae.fold_weight_norm(v, g)
    got = tvae.fold_weight_norm(torch.from_numpy(v), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


GEOMETRIES = {
    # tests/test_voxcpm.py's TINY_CFG audio_vae_config
    "tiny": dict(encoder_dim=4, encoder_rates=(2, 2), latent_dim=8,
                 decoder_dim=16, decoder_rates=(2, 2)),
    # the published rates (hop 640) at narrow widths
    "rates": dict(encoder_dim=4, encoder_rates=(2, 5, 8, 8), latent_dim=8,
                  decoder_dim=32, decoder_rates=(8, 8, 5, 2)),
}


def _sr_embeddings(params, vae, key):
    """Add VoxCPM1.5's per-stage sample-rate scale / bias tables (4 bins)
    to a JAX decoder tree."""
    ks = iter(jax.random.split(key, 16))
    cin = vae.decoder_dim
    for bp in params["decoder"]["blocks"]:
        bp["sr_scale"] = 1.0 + 0.1 * jax.random.normal(next(ks), (4, cin))
        bp["sr_bias"] = 0.1 * jax.random.normal(next(ks), (4, cin))
        cin //= 2
    return params


@pytest.fixture(scope="module", params=[
    ("tiny", False), ("rates", False), ("rates", True)],
    ids=["tiny", "rates", "rates-sr"])
def vaes(request):
    name, sr = request.param
    geo = dict(GEOMETRIES[name])
    if sr:
        geo.update(sr_bin_boundaries=[12000, 20000, 36000],
                   out_sample_rate=24000)
    jm, tm = jvae.AudioVAE(**geo), tvae.AudioVAE(**geo)
    jp = jm.init_random(jax.random.PRNGKey(3))
    if sr:
        jp = _sr_embeddings(jp, jm, jax.random.PRNGKey(4))
    # nonzero biases, so a dropped bias shows
    jp = jax.tree.map(lambda x: x + 0.01 if x.ndim == 1 else x, jp)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def test_vae_encode_matches(vaes):
    jm, jp, tm, tp = vaes
    n = 3 * jm.hop_length + 7            # padded up to a whole hop
    wav = (np.random.default_rng(5).standard_normal((1, 1, n)) * 0.3).astype(
        np.float32)
    ref = jm.encode(jp, jnp.asarray(wav))
    got = tm.encode(tp, torch.from_numpy(wav))
    frames = -(-n // jm.hop_length)
    assert got.shape == ref.shape == (1, jm.latent_dim, frames)
    assert _rel(got, ref) <= TOL_VAE


@pytest.mark.parametrize("sr_cond", [None, 16000, 44100])
def test_vae_decode_matches(vaes, sr_cond):
    jm, jp, tm, tp = vaes
    z = np.random.default_rng(6).standard_normal(
        (1, jm.latent_dim, 5)).astype(np.float32)
    ref = jm.decode(jp, jnp.asarray(z), sr_cond=sr_cond)
    got = tm.decode(tp, torch.from_numpy(z), sr_cond=sr_cond)
    assert got.shape == ref.shape == (1, 1, 5 * jm.hop_length)
    assert _rel(got, ref) <= TOL_VAE
    assert tm.sr_index(sr_cond) == (
        None if jm.sr_bin_boundaries is None else int(np.searchsorted(
            jm.sr_bin_boundaries, sr_cond or jm.out_sample_rate)))


def test_sample_rate_bins_change_the_decode():
    geo = dict(GEOMETRIES["tiny"], sr_bin_boundaries=[12000, 20000, 36000])
    jm, tm = jvae.AudioVAE(**geo), tvae.AudioVAE(**geo)
    jp = _sr_embeddings(jm.init_random(jax.random.PRNGKey(1)), jm,
                        jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    z = torch.randn(1, tm.latent_dim, 3,
                    generator=torch.Generator().manual_seed(7))
    assert not torch.allclose(tm.decode(tp, z, 8000), tm.decode(tp, z, 44100))


def test_vae_encoder_is_causal_on_the_port(vaes):
    """tests/test_voxcpm.py's causality check on the port: changing the
    samples from 10 hops on must not change the 10 latent frames before."""
    _, _, tm, tp = vaes
    hop = tm.hop_length
    n = 16 * hop
    rng = np.random.default_rng(5)
    wav = rng.standard_normal((1, 1, n)).astype(np.float32)
    wav2 = wav.copy()
    cut = 10 * hop
    wav2[..., cut:] += 1.0
    mu1 = tm.encode(tp, torch.from_numpy(wav)).numpy()
    mu2 = tm.encode(tp, torch.from_numpy(wav2)).numpy()
    n_safe = cut // hop
    np.testing.assert_allclose(mu1[..., :n_safe], mu2[..., :n_safe],
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(mu1[..., n_safe:], mu2[..., n_safe:])


def test_vae_init_random_has_the_jax_trees_shapes():
    for geo in GEOMETRIES.values():
        jm, tm = jvae.AudioVAE(**geo), tvae.AudioVAE(**geo)
        jshapes = [tuple(x.shape) for x in
                   jax.tree.leaves(jm.init_random(jax.random.PRNGKey(0)))]
        tp = tm.init_random(torch.Generator().manual_seed(0))
        assert [tuple(t.shape) for t in jax.tree.leaves(tp)] == jshapes
