"""The port's attention routers send the kernel wrappers every shape the
reference's gates send its TPU kernels (prefill: D % 64 == 0 and the
bucket conditions; decode: every shape), and the kernels take D 64, 128,
192 and 256 with any whole group G = Hq / Hkv (`flash_attention.
prefill_takes` / `decode_takes`, read by the wrappers' checks on the
card).  At the wide heads and groups (D 192 / 256, G 16) the routers'
results equal aha_tpu.ops.attention's on the CPU, where the wrappers run
their plain versions: float32, with the tolerance of
tests/test_torch_attention.py (rtol 1e-4, atol 1e-5).  The card tests
hold the kernels themselves at those shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops import attention as jattn
from aha_tpu_torch.ops import attention
from aha_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
DS = [64, 128, 192, 256]
GS = [1, 8, 16]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _spy(monkeypatch, name):
    """Replace fa.<name> with a stub that records its calls and returns
    None, so a test sees which of the kernel wrappers a router picked."""
    calls = []

    def stub(*args, **kwargs):
        calls.append(name)

    monkeypatch.setattr(fa, name, stub)
    return calls


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("D", DS + [80, 320])
def test_predicates_hold_the_kernels_limits(D, G):
    """The prefill and decode kernels take D 64, 128, 192 and 256 and any
    whole group; a wider head (D 320) is past them, where the wrappers
    raise on the card."""
    assert fa.prefill_takes(D) == (D in DS)
    assert fa.decode_takes(D, 2 * G, 2) == (D in DS)
    assert not fa.decode_takes(D, 3, 2) and not fa.decode_takes(D, 1, 2)


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("D", DS + [320])
def test_decode_routers_send_every_shape_to_the_kernel_wrapper(
        monkeypatch, D, G):
    """attention_decode_at (flat, flat batched, stacked), attention_decode
    and attention_decode_at_q8 call their kernel's wrapper at every head
    width and group, choosing it by the cache's rank and B alone: the
    wrapper runs the kernel on the card (or raises past its limits) and
    its plain version on the CPU."""
    Hkv, L, S = 1, 2, 8
    q1 = torch.ones(1, 1, Hkv * G, D)
    q2 = torch.ones(2, 1, Hkv * G, D)
    layer = torch.tensor(1, dtype=torch.int32)
    names = ["flash_decode_at_layer_flat", "flash_decode_at_layer_flat_batched",
             "flash_decode_at_layer", "flash_decode",
             "flash_decode_at_layer_q8", "flash_decode_at_layer_q8_batched"]
    calls = {n: _spy(monkeypatch, n) for n in names}
    outs = [
        attention.attention_decode_at(q1, torch.ones(L, 1, S, Hkv * D),
                                      torch.ones(L, 1, S, Hkv * D), layer,
                                      torch.tensor([3], dtype=torch.int32)),
        attention.attention_decode_at(q2, torch.ones(L, 2, S, Hkv * D),
                                      torch.ones(L, 2, S, Hkv * D), layer,
                                      torch.tensor([3, 5], dtype=torch.int32)),
        attention.attention_decode_at(q1, torch.ones(L, 1, S, Hkv, D),
                                      torch.ones(L, 1, S, Hkv, D), layer,
                                      torch.tensor([3], dtype=torch.int32)),
        attention.attention_decode(q1, torch.ones(1, S, Hkv, D),
                                   torch.ones(1, S, Hkv, D),
                                   torch.tensor(2, dtype=torch.int32)),
    ]
    i8 = torch.ones(L, 1, S, Hkv * D, dtype=torch.int8)
    sc = torch.ones(L, 1, S, Hkv)
    i8b = torch.ones(L, 2, S, Hkv * D, dtype=torch.int8)
    scb = torch.ones(L, 2, S, Hkv)
    outs += [
        attention.attention_decode_at_q8(q1, i8, i8, sc, sc, layer,
                                         torch.tensor([3], dtype=torch.int32)),
        attention.attention_decode_at_q8(q2, i8b, i8b, scb, scb, layer,
                                         torch.tensor([3, 5],
                                                      dtype=torch.int32)),
    ]
    for n in names:
        assert calls[n] == [n], n
    assert all(out is None for out in outs)


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("D", DS + [80, 320])
def test_prefill_router_follows_the_reference_gate(monkeypatch, D, G):
    """attention_prefill sends a bucketed prompt to the flash kernel's
    wrapper wherever the reference's `_flash_eligible` sends it to its TPU
    kernel (D % 64 == 0), and gives the rest masked sdpa, as the reference
    does."""
    calls = _spy(monkeypatch, "flash_attention")
    Sq = 128
    q = torch.ones(1, Sq, G, D)
    kv = torch.ones(1, Sq, 1, D)
    out = attention.attention_prefill(q, kv, kv, causal=True)
    assert calls == (["flash_attention"] if D % 64 == 0 else [])
    if D % 64:
        torch.testing.assert_close(out, torch.ones_like(q))


@pytest.mark.parametrize("D,G", [(192, 2), (256, 16), (128, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_prefill_at_wide_heads_and_groups_matches_jax(D, G, causal):
    rng = np.random.default_rng(D + G)
    Hkv, S = 1, 128
    q, k, v = (_rand(rng, 1, S, Hkv * G, D), _rand(rng, 1, S, Hkv, D),
               _rand(rng, 1, S, Hkv, D))
    got = attention.attention_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    ref = jattn.attention_prefill(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,valid", [(1, [37]), (2, [1, 64])])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("D,G", [(192, 2), (256, 16), (128, 16)])
def test_decode_at_at_wide_heads_and_groups_matches_jax(D, G, stacked, B, valid):
    rng = np.random.default_rng(100 + D + G)
    L, S, Hkv = 2, 64, 1
    q = _rand(rng, B, 1, Hkv * G, D)
    shape = (L, B, S, Hkv, D) if stacked else (L, B, S, Hkv * D)
    k, v = _rand(rng, *shape), _rand(rng, *shape)
    pos = np.asarray(valid, np.int32) - 1
    got = attention.attention_decode_at(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(1, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.int32))
    ref = jattn.attention_decode_at(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(1),
                                    jnp.asarray(pos if B > 1 else pos[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("D,G", [(256, 16), (192, 2)])
def test_decode_at_wide_heads_and_groups_matches_jax(D, G):
    rng = np.random.default_rng(200 + D)
    S, Hkv = 64, 1
    q = _rand(rng, 1, 1, Hkv * G, D)
    k, v = _rand(rng, 1, S, Hkv, D), _rand(rng, 1, S, Hkv, D)
    got = attention.attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.tensor(40, dtype=torch.int32))
    ref = jattn.attention_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(40))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("D,G", [(256, 16), (192, 2)])
def test_decode_at_q8_at_wide_heads_and_groups_matches_jax(D, G):
    """The int8 cache: the JAX scales are lane-oriented (L, B, Hkv, S), the
    port's (L, B, S, Hkv); the same rows and scales go to both."""
    rng = np.random.default_rng(300 + D)
    L, S, Hkv = 2, 64, 1
    q = _rand(rng, 1, 1, Hkv * G, D)
    k8, v8 = (rng.integers(-127, 128, (L, 1, S, Hkv * D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (L, 1, S, Hkv)).astype(np.float32)
              for _ in range(2))
    got = attention.attention_decode_at_q8(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(ks), torch.from_numpy(vs),
        torch.tensor(0, dtype=torch.int32), torch.tensor([50],
                                                         dtype=torch.int32))
    ref = jattn.attention_decode_at_q8(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(ks.transpose(0, 1, 3, 2)),
        jnp.asarray(vs.transpose(0, 1, 3, 2)), jnp.int32(0), jnp.int32(49))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
