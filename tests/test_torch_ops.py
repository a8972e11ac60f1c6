"""aha_tpu_torch's plain ops against aha_tpu's on the same numpy inputs:
rms_norm, rope, linear, embedding, swiglu MLP, and the in-place cache.
float32 on the CPU; tolerance rtol 1e-4, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import nn as jnn
from aha_tpu.ops import norms as jnorms
from aha_tpu.ops import rope as jrope
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core import nn
from aha_tpu_torch.ops import norms, rope

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 4, 16)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape), _rand(rng, shape[-1])
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (64, 1e4)])
def test_rope_table_apply_gather(head_dim, theta):
    rng = np.random.default_rng(1)
    cos, sin = rope.rope_table(head_dim, 64, theta)
    jcos, jsin = jrope.rope_table(head_dim, 64, theta)
    _close(cos, jcos)
    _close(sin, jsin)
    pos = np.array([3, 4, 5, 40, 63])
    c, s = rope.gather_rope(cos, sin, torch.from_numpy(pos))
    jc, js = jrope.gather_rope(jcos, jsin, jnp.asarray(pos))
    _close(c, jc)
    q, k = _rand(rng, 1, 5, 4, head_dim), _rand(rng, 1, 5, 2, head_dim)
    tq, tk = rope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), c, s)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    rng = np.random.default_rng(2)
    x, w = _rand(rng, 2, 3, 64), _rand(rng, 64, 48, scale=0.1)
    p = {"w": w}
    if bias:
        p["b"] = _rand(rng, 48)
    _close(nn.linear({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x)),
           jnn.linear({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x)))


def test_embedding():
    rng = np.random.default_rng(3)
    table = _rand(rng, 100, 32)
    ids = np.array([[0, 5, 99, 5]])
    _close(nn.embedding({"w": torch.from_numpy(table)}, torch.from_numpy(ids)),
           jnn.embedding({"w": jnp.asarray(table)}, jnp.asarray(ids)))


@pytest.mark.parametrize("fused", [False, True])
def test_swiglu_mlp(fused):
    rng = np.random.default_rng(4)
    x = _rand(rng, 1, 4, 64)
    g, u, d = (_rand(rng, 64, 128, scale=0.1), _rand(rng, 64, 128, scale=0.1),
               _rand(rng, 128, 64, scale=0.1))
    p = ({"gateup": {"w": np.concatenate([g, u], -1)}, "down": {"w": d}}
         if fused else {"gate": {"w": g}, "up": {"w": u}, "down": {"w": d}})

    def conv(tree, f):
        return {k: conv(v, f) if isinstance(v, dict) else f(v)
                for k, v in tree.items()}

    _close(nn.swiglu_mlp(conv(p, torch.from_numpy), torch.from_numpy(x)),
           jnn.swiglu_mlp(conv(p, jnp.asarray), jnp.asarray(x)))


def test_cache_advance_reset_keeps_rows():
    """pos is a device int32 scalar; reset rewinds it without zeroing the
    pooled rows (they are never read past pos)."""
    c = kv.init_kv_cache(2, 1, 16, 2, 4, torch.float32)
    assert c["k"].shape == (2, 1, 16, 8) and c["pos"].dtype == torch.int32
    c["k"][0, 0, 3] = 7.0
    kv.advance(c, 5)
    kv.advance(c, torch.tensor(2, dtype=torch.int32))
    assert int(c["pos"]) == 7 and kv.cache_max_len(c) == 16
    kv.reset(c)
    assert int(c["pos"]) == 0 and float(c["k"][0, 0, 3, 0]) == 7.0


def test_device_and_dtype_selection(monkeypatch):
    """Unset AHA_DEVICE means the card: with no card visible device()
    raises instead of running on the CPU; AHA_DEVICE=cpu asks for the
    CPU."""
    from aha_tpu_torch.utils import device as d

    monkeypatch.delenv("AHA_DEVICE", raising=False)
    monkeypatch.delenv("AHA_DTYPE", raising=False)
    assert d.get_dtype(torch.device("cpu")) == torch.float32
    assert d.get_dtype(torch.device("cuda")) == torch.bfloat16
    monkeypatch.setenv("AHA_DTYPE", "bf16")
    assert d.get_dtype(torch.device("cpu")) == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="AHA_DEVICE=cpu"):
        d.device()
    monkeypatch.delenv("AHA_DTYPE")
    with pytest.raises(RuntimeError):
        d.get_dtype()
    monkeypatch.setenv("AHA_DEVICE", "cuda")
    with pytest.raises(RuntimeError):
        d.device()
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    assert d.device() == torch.device("cpu")
    monkeypatch.delenv("AHA_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert d.device() == torch.device("cuda")
    monkeypatch.setenv("AHA_HOME", "/models")
    assert d.default_save_dir() == "/models"
