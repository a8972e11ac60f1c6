"""aha_tpu_torch's plain attention against aha_tpu's: the decode plain
version vs the Pallas decode kernel (interpret mode) and the XLA
attention_decode_at, the prefill plain version vs the Pallas flash kernel
(interpret mode), and attention_prefill_at at a cache offset; decode at
the odd group sizes G 3, 5, 7 (Qwen2.5-VL-7B's 28 over 4 heads) that the
decode kernels' checks admit.  float32 on the CPU; tolerance rtol 1e-4,
atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops import attention as jattn
from aha_tpu.ops.flash_attention import (flash_attention as jflash,
                                         flash_decode_at_layer as jdecode5,
                                         flash_decode_at_layer_flat as jdecode)
from aha_tpu_torch.ops import attention
from aha_tpu_torch.ops import flash_attention as fa
from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_decode_at_layer,
                                               flash_decode_at_layer_flat)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def decode_case():
    rng = np.random.default_rng(0)
    L, S, Hq, Hkv, D = 3, 256, 4, 2, 64
    return (_rand(rng, 1, 1, Hq, D), _rand(rng, L, 1, S, Hkv * D),
            _rand(rng, L, 1, S, Hkv * D))


@pytest.mark.parametrize("layer,valid", [(0, 1), (2, 77), (1, 200), (2, 256)])
def test_decode_plain_matches_pallas_and_xla(decode_case, layer, valid):
    q, k, v = decode_case
    got = flash_decode_at_layer_flat(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(layer, dtype=torch.int32),
        torch.tensor([valid], dtype=torch.int32)).numpy()
    pallas = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.int32(layer), jnp.int32(valid), block_k=128,
                     interpret=True)
    xla = jattn.attention_decode_at(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(layer),
                                    jnp.int32(valid - 1))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    # the model-level gate takes the same plain path on the CPU
    via_gate = attention.attention_decode_at(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(layer, dtype=torch.int32),
        torch.tensor([valid], dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(via_gate, got)


@pytest.mark.parametrize("G", [3, 5, 7])
def test_decode_at_odd_groups_matches_pallas(G):
    """G query heads per kv head, G odd: the port's flat and stacked decode
    (plain on the CPU) against the Pallas stacked decode in interpret
    mode, which takes any G."""
    rng = np.random.default_rng(10 + G)
    L, S, Hkv, D, valid = 2, 256, 2, 64, 201
    q = _rand(rng, 1, 1, Hkv * G, D)
    k, v = _rand(rng, L, 1, S, Hkv, D), _rand(rng, L, 1, S, Hkv, D)
    layer, vl = torch.tensor(1, dtype=torch.int32), torch.tensor(
        [valid], dtype=torch.int32)
    want = np.asarray(jdecode5(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(1), jnp.int32(valid), block_k=128,
                               interpret=True))
    got = flash_decode_at_layer(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), layer, vl)
    flat = flash_decode_at_layer_flat(
        torch.from_numpy(q), torch.from_numpy(k.reshape(L, 1, S, Hkv * D)),
        torch.from_numpy(v.reshape(L, 1, S, Hkv * D)), layer, vl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(flat.numpy(), want, **TOL)


@pytest.mark.parametrize("G,ok", [(1, True), (3, True), (5, True),
                                  (6, True), (7, True), (8, True),
                                  (9, False)])
def test_decode_kernel_check_admits_groups_up_to_8(G, ok):
    """The checks the bf16 and int8 decode kernels share take any G from 1
    to 8 (the kernels dispatch each), and refuse a larger one."""
    q = torch.zeros(1, 1, 4 * G, 128, dtype=torch.bfloat16)
    one = torch.tensor([1], dtype=torch.int32)
    for kv_dtype in (torch.bfloat16, torch.int8):
        kv = torch.zeros(2, 1, 64, 4 * 128, dtype=kv_dtype)
        if ok:
            assert fa._check_decode(q, kv, kv, one[0], one, kv_dtype) == (
                1, 4 * G, 4, 128, 2, 64)
        else:
            with pytest.raises(ValueError, match="G="):
                fa._check_decode(q, kv, kv, one[0], one, kv_dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_plain_matches_pallas(causal):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 1, 256, 4, 64), _rand(rng, 1, 256, 2, 64),
               _rand(rng, 1, 256, 2, 64))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal).numpy()
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    gate = attention.attention_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(gate.numpy(), got, **TOL)


def test_prefill_at_offset_matches_jax():
    rng = np.random.default_rng(2)
    L, S, Hkv, D = 2, 64, 2, 16
    q = _rand(rng, 1, 8, 4, D)
    k, v = _rand(rng, L, 1, S, Hkv * D), _rand(rng, L, 1, S, Hkv * D)
    got = attention.attention_prefill_at(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(1, dtype=torch.int32), torch.tensor(20, dtype=torch.int32))
    ref = jattn.attention_prefill_at(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(1),
                                     jnp.int32(20))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_sdpa_causal_mask_match_jax():
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 2, 5, 4, 16), _rand(rng, 2, 7, 2, 16),
               _rand(rng, 2, 7, 2, 16))
    mask = attention.causal_mask(5, 7, q_offset=2)
    jmask = jattn.causal_mask(5, 7, q_offset=2)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got = attention.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), mask)
    ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(2, 1, 32, 32)
    one = torch.tensor(1, dtype=torch.int32)
    with pytest.raises(ValueError):      # decode takes one query row
        flash_decode_at_layer_flat(q, kv, kv, one, one.reshape(1))
    with pytest.raises(ValueError):      # k/v shapes disagree
        flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 8))
