"""aha_tpu_torch's one-layer fused decode block (ops/fused_layer.py
fused_decode_layer) against aha_tpu's fused_decode_layer in interpret mode,
at tests/test_fused_layer.py's geometry (hidden 1024, 2 layers, 16/8 heads,
D 128, intermediate 3072, a 256-row cache, window 64), on the same bf16
inputs made with numpy from a seed.  On the CPU the port's wrapper runs its
plain version; tests/test_torch_cuda.py holds the kernel to that plain
version on the card.

Tolerances, relative to max |ref|: both sides compute in float32 and round
to bf16 at the same points (h1, q and k after RoPE, v, the probabilities,
the attention output, x2, the SwiGLU activation, x_out), and differ only
in summation order, which can flip one of those roundings: x_out within
two bf16 ulps (2·2**-7), k_row within one (it passes through one rounded
matmul and two norms), v_row exact up to one rounding flip of its own
(2**-7).  Measured: x_out ≤ 4.5e-3, k_row ≤ 1.1e-5, v_row bit-equal.  The
JAX test's own bounds against its reference `_layer` are looser (k 0.03,
x 0.06 abs) because `_layer` rounds elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu.models.qwen3 import fuse_decode_params as jfuse
from aha_tpu.ops.fused_layer import fused_decode_layer as jlayer
from aha_tpu.ops.rope import gather_rope
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.ops.fused_layer import (MAX_WINDOW, fused_decode_layer,
                                           fused_decode_stack_plain,
                                           fused_layer_supported)

torch.set_num_threads(2)
GEO = dict(vocab_size=512, hidden_size=1024, intermediate_size=3072,
           num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
           head_dim=128, tie_word_embeddings=True)
H, L, HD, D = 1024, 2, 8 * 128, 128
EPS = 1e-6
BF_ULP = 2 ** -7


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**GEO), max_rope_len=256)
    jp = jfuse(jm.init_random(jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    return jm, jp, tp


def _f32(a):
    return np.asarray(a, np.float32)


def _bf16_pair(rng, *shape, zeros=False):
    a = np.zeros(shape, np.float32) if zeros else \
        rng.standard_normal(shape, dtype=np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _rope(jm, pos):
    cos, sin = gather_rope(jm.cos, jm.sin, pos + jnp.arange(1))
    jc = jnp.concatenate([cos, cos], -1).reshape(1, D)
    js = jnp.concatenate([sin, sin], -1).reshape(1, D)
    return jc, js, torch.tensor(_f32(jc)), torch.tensor(_f32(js))


def _np(a):
    return a.float().numpy() if torch.is_tensor(a) else _f32(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _both(jm, jp, tp, li, pos, S, window, seed, zeros=False):
    rng = np.random.default_rng(seed)
    jk, tk = _bf16_pair(rng, L, 1, S, HD, zeros=zeros)
    jv, tv = _bf16_pair(rng, L, 1, S, HD, zeros=zeros)
    jx, tx = _bf16_pair(rng, 1, 1, H)
    jc, js, tc, ts = _rope(jm, pos)
    want = jlayer(jx, jp["layers"], jnp.int32(li), jnp.int32(pos), jc, js,
                  jk, jv, window=window, eps=EPS, interpret=True)
    tk0, tv0 = tk.clone(), tv.clone()
    got = fused_decode_layer(tx, tp["layers"], _i32(li), _i32(pos), tc, ts,
                             tk, tv, window, EPS)
    assert torch.equal(tk, tk0) and torch.equal(tv, tv0), "cache written"
    return got, want, tk, tv, (tx, tc, ts)


@pytest.mark.parametrize("li,pos", [(0, 37), (1, 1), (1, 63)])
def test_fused_layer_matches_jax_kernel(pair, li, pos):
    jm, jp, tp = pair
    (x, k, v), (jx, jk, jv), _, _, _ = _both(jm, jp, tp, li, pos, 256, 64,
                                          seed=li * 100 + pos)
    assert x.shape == (1, 1, H) and x.dtype == torch.bfloat16
    assert k.shape == v.shape == (8, D) and k.dtype == torch.bfloat16
    assert _rel(v, jv) <= BF_ULP
    assert _rel(k, jk) <= BF_ULP
    assert _rel(x, jx) <= 2 * BF_ULP


@pytest.mark.parametrize("pos", [64, 200])
def test_fused_layer_window_bounds_the_rows_read(pair, pos):
    """Past the window only rows [0, window) are attended, as the JAX
    kernel's fetched window: rows [window, pos) change nothing."""
    jm, jp, tp = pair
    (x, k, v), (jx, _, _), tk, tv, (tx, tc, ts) = _both(
        jm, jp, tp, 1, pos, 256, 64, seed=pos)
    assert _rel(x, jx) <= 2 * BF_ULP
    tk[:, :, 64:] = 9.0
    tv[:, :, 64:] = -9.0
    x2, _, _ = fused_decode_layer(tx, tp["layers"], _i32(1), _i32(pos), tc,
                                  ts, tk, tv, 64, EPS)
    assert torch.equal(x2, x)


def test_fused_layer_cache_rows_roundtrip(pair):
    """The caller writes the returned rows into a zero cache: the row
    matches the JAX rows written the same way, untouched rows stay zero."""
    jm, jp, tp = pair
    pos, li = 9, 1
    (_, k, v), (_, jk, jv), tk, tv, _ = _both(jm, jp, tp, li, pos, 128, 64,
                                              seed=5, zeros=True)
    tk[li, 0, pos] = k.reshape(HD)
    tv[li, 0, pos] = v.reshape(HD)
    jkc = jnp.zeros((L, 1, 128, HD), jnp.bfloat16).at[li, 0, pos].set(
        jk.reshape(HD))
    assert _rel(tk[li, 0, pos], jkc[li, 0, pos]) <= BF_ULP
    assert _rel(tv[li, 0, pos], jv.reshape(HD)) <= BF_ULP
    assert float(tk[0].abs().sum()) == 0.0
    assert float(tk[1, 0, :pos].abs().sum()) == 0.0
    assert float(tk[1, 0, pos + 1:].abs().sum()) == 0.0
    assert float(tv[1, 0, pos + 1:].abs().sum()) == 0.0


@pytest.mark.parametrize("pos", [0, 33])
def test_layer_chain_matches_stack(pair, pos):
    """L per-layer calls, each row written by the caller, against the
    port's whole-stack plain version on the same inputs.  The stack carries
    the hidden state in f32 across layers; the layer rounds x2 and x_out to
    bf16 in every layer: two roundings of ≤ half a bf16 ulp per layer, 2·L
    ulps in all, bound the gap (relative to max |ref|; measured ≤ 4.3e-3,
    the second layer's k row ≤ 5e-3)."""
    _, _, tp = pair
    rng = np.random.default_rng(77 + pos)
    S = 128
    _, tk = _bf16_pair(rng, L, 1, S, HD)
    _, tv = _bf16_pair(rng, L, 1, S, HD)
    _, tx = _bf16_pair(rng, 1, 1, H)
    jm = JModel(JConfig(**GEO), max_rope_len=256)
    _, _, tc, ts = _rope(jm, pos)
    sk, sv = tk.clone(), tv.clone()
    want = fused_decode_stack_plain(tx, tp["layers"], _i32(pos), tc, ts, sk,
                                    sv, EPS)
    x = tx
    for li in range(L):
        x, k, v = fused_decode_layer(x, tp["layers"], _i32(li), _i32(pos),
                                     tc, ts, tk, tv, S, EPS)
        tk[li, 0, pos] = k.reshape(HD)
        tv[li, 0, pos] = v.reshape(HD)
    assert _rel(x, want) <= 2 * L * BF_ULP
    assert torch.equal(tk[0], sk[0]) and torch.equal(tv[0], sv[0])
    assert _rel(tk[1, 0, pos], sk[1, 0, pos]) <= 2 * BF_ULP
    keep = torch.arange(S) != pos
    assert torch.equal(tk[:, :, keep], sk[:, :, keep])


def test_fused_layer_gate(pair):
    """fused_layer_supported takes the fused bf16 layout with a window of
    at most MAX_WINDOW rows; a bias, an unfused q|k|v and a longer (or no)
    window are each refused."""
    _, _, tp = pair
    lyr = tp["layers"]
    geo = (H, 16, 8, D, 3072)
    assert fused_layer_supported(lyr, *geo, 64)
    assert fused_layer_supported(lyr, *geo, MAX_WINDOW)
    assert not fused_layer_supported(lyr, *geo, MAX_WINDOW + 1)
    assert not fused_layer_supported(lyr, *geo, None)
    biased = {**lyr, "o": {**lyr["o"], "b": torch.zeros(L, H)}}
    assert not fused_layer_supported(biased, *geo, 64)
    qkv = lyr["qkv"]["w"]
    unfused = {k: v for k, v in lyr.items() if k != "qkv"}
    unfused.update(q={"w": qkv[..., :2048]}, k={"w": qkv[..., 2048:3072]},
                   v={"w": qkv[..., 3072:]})
    assert not fused_layer_supported(unfused, *geo, 64)
    assert not fused_layer_supported(lyr, H, 16, 8, 80, 3072, 64)
