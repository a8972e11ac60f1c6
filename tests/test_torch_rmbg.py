"""aha_tpu_torch's RMBG-2.0 (models/rmbg2_0.py) against aha_tpu's on the
CPU, float32: the deformable conv at tests/test_rmbg.py's (ks, pad, stride)
cases (against the JAX function and the scalar transcription of the
reference kernel there), batched and in several tap chunks; the Swin
backbone; the bilinear resize with align_corners=True; the whole matte on
tests.fixtures.build_tiny_rmbg_repo's checkpoint; the port's seeded
checkpoint against the fixture's names and shapes; its saver against its
loader."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aha_tpu.io.weights import open_weights as jopen_weights
from aha_tpu.models import rmbg2_0 as jr
from aha_tpu.utils import interpolate as jinterp
from aha_tpu_torch.io.weights import open_weights, save_hf_rmbg2_0
from aha_tpu_torch.models import rmbg2_0 as tr
from aha_tpu_torch.models.rmbg2_0_served import swin_config
from aha_tpu_torch.utils import interpolate as tinterp
from tests.fixtures import build_tiny_rmbg_repo, rmbg_state_dict
from tests.test_rmbg import _deform_ref

torch.set_num_threads(1)
#: one op's agreement, max abs error relative to max |ref|
TOL_OP = 1e-5
#: a stage stack or the whole matte, relative to max |ref|
TOL_NET = 1e-4


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(got.detach().numpy() - ref).max()
                 / np.abs(ref).max())


def _deform_inputs(seed, B, C, O, H, W, ks, pad, stride):
    rng = np.random.default_rng(seed)
    Ho = (H + 2 * pad - ks) // stride + 1
    Wo = (W + 2 * pad - ks) // stride + 1
    return (rng.standard_normal((B, C, H, W)).astype(np.float32),
            rng.standard_normal((O, C, ks, ks)).astype(np.float32) * 0.2,
            rng.standard_normal(O).astype(np.float32),
            rng.standard_normal((B, 2 * ks * ks, Ho, Wo)).astype(
                np.float32) * 2.0,
            rng.random((B, ks * ks, Ho, Wo)).astype(np.float32))


@pytest.mark.parametrize("ks,pad,stride", [(3, 1, 1), (1, 0, 1), (3, 1, 2),
                                           (7, 3, 1)])
def test_deform_conv_matches(ks, pad, stride):
    x, w, b, off, m = _deform_inputs(0, 1, 4, 5, 7, 8, ks, pad, stride)
    ref = jr.deform_conv2d(*map(jnp.asarray, (x, w, b, off, m)), stride, pad)
    got = tr.deform_conv2d(*map(torch.from_numpy, (x, w, b, off, m)),
                           stride, pad)
    assert _rel(got, ref) <= TOL_OP
    if ks < 7:      # the scalar transcription is slow at 49 taps
        want = _deform_ref(x, w, b, off, m, stride, pad)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_deform_conv_batched_and_chunked(monkeypatch):
    """A batch of 2 equals each sample alone, and a tap budget that splits
    the 9 taps into chunks of 2 gives the same output."""
    x, w, _, off, m = _deform_inputs(1, 2, 3, 4, 6, 6, 3, 1, 1)
    t = [torch.from_numpy(a) for a in (x, w, off, m)]
    full = tr.deform_conv2d(t[0], t[1], None, t[2], t[3], 1, 1)
    ref = jr.deform_conv2d(*map(jnp.asarray, (x, w)), None,
                           *map(jnp.asarray, (off, m)), 1, 1)
    assert _rel(full, ref) <= TOL_OP
    for b in range(2):
        one = tr.deform_conv2d(t[0][b:b + 1], t[1], None, t[2][b:b + 1],
                               t[3][b:b + 1], 1, 1)
        torch.testing.assert_close(full[b:b + 1], one, atol=1e-5, rtol=0)
    monkeypatch.setattr(tr, "DEFORM_CHUNK_ELEMS", 2 * 2 * 36 * 3)
    chunked = tr.deform_conv2d(t[0], t[1], None, t[2], t[3], 1, 1)
    torch.testing.assert_close(chunked, full, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,size", [((1, 3, 5, 9), (7, 11)),
                                        ((2, 4, 8, 8), (3, 3)),
                                        ((1, 1, 1, 1), (4, 6)),
                                        ((1, 2, 6, 4), (1, 1))])
def test_interpolate_align_corners(shape, size):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = tinterp.interpolate(torch.from_numpy(x), size, "bilinear",
                              align_corners=True)
    ref = jinterp.interpolate(jnp.asarray(x), size, "bilinear",
                              align_corners=True)
    lib = F.interpolate(torch.from_numpy(x), size=size, mode="bilinear",
                        align_corners=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-5)
    np.testing.assert_array_equal(
        tinterp.resize_weights_1d(shape[-1], size[1], "linear",
                                  align_corners=True),
        jinterp.resize_weights_1d(shape[-1], size[1], "linear", True))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rmbg_tiny"))
    build_tiny_rmbg_repo(path)
    jm = jr.BiRefNet(jr.SwinConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in swin_config(path).__dict__.items()}))
    jp = jm.load_params(jopen_weights(path))
    tm = tr.BiRefNet(swin_config(path))
    tp = tm.load_params(open_weights(path))
    return path, jm, jp, tm, tp


def _pixels(seed: int, side: int, B: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, 3, side, side)).astype(np.float32)


@pytest.mark.parametrize("side,B", [(64, 1), (48, 2)])
def test_swin_backbone_matches(tiny, side, B):
    _, jm, jp, tm, tp = tiny
    x = _pixels(3, side, B)
    ref = jax.jit(functools.partial(jr.swin_forward, cfg=jm.swin))(
        jp["bb"], jnp.asarray(x))
    got = tr.swin_forward(tp["bb"], torch.from_numpy(x), tm.swin)
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) <= TOL_NET


def test_swin_attention_and_shift_mask_match(tiny):
    _, jm, jp, tm, tp = tiny
    x = np.random.default_rng(4).standard_normal((8, 16, 8)).astype(
        np.float32)
    mask = jr._shift_mask(8, 8, 4, 2)
    np.testing.assert_array_equal(tr._shift_mask(8, 8, 4, 2), mask)
    for m in (None, mask):
        ref = jr._swin_attention(jp["bb"]["layers"][0]["blocks"][0]["attn"],
                                 jnp.asarray(x), 1, m)
        got = tr._swin_attention(tp["bb"]["layers"][0]["blocks"][0]["attn"],
                                 torch.from_numpy(x), 1, m)
        assert _rel(got, ref) <= TOL_OP


@pytest.mark.parametrize("side", [64, 96])
def test_whole_matte_matches(tiny, side):
    _, jm, jp, tm, tp = tiny
    x = _pixels(5, side)
    ref = jax.jit(jm.forward)(jp, jnp.asarray(x))
    got = tm.forward(tp, torch.from_numpy(x))
    assert got.shape == (1, 1, side, side)
    assert _rel(got, ref) <= TOL_NET


def test_random_state_dict_has_the_fixtures_names_and_shapes():
    cfg = {"patch_size": 4, "embed_dim": 8, "depths": [1, 1, 2, 1],
           "num_heads": [1, 2, 4, 8], "window_size": 4}
    want = rmbg_state_dict(cfg)
    got = tr.random_state_dict(
        tr.SwinConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg.items()}),
        torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)


def test_saver_round_trips_through_the_loader(tiny, tmp_path):
    _, _, _, tm, tp = tiny
    params = tm.init_random(torch.Generator().manual_seed(1))
    save_hf_rmbg2_0(params, tm.swin, str(tmp_path))
    assert swin_config(str(tmp_path)) == tm.swin
    back = tm.load_params(open_weights(str(tmp_path)))
    flat = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(flat(params), flat(back)))
    assert len(flat(params)) == len(flat(back)) == len(flat(tp))
