"""aha_tpu_torch's one-launch decode stack (ops/fused_layer.py) against
aha_tpu's fused_decode_stack in interpret mode, on the same bf16 inputs
(numpy, from a seed): the module alone, and Qwen3Model's fused decode
steps against the JAX model's as it runs them on a TPU.  On the CPU the
port's wrapper runs its plain version; tests/test_torch_cuda.py holds the
kernel to that plain version on the card.

Tolerance: one bf16 ulp at the output's largest magnitude (2**-7 of max
|ref|), two for the model's final-normed hidden state, whose own bf16
rounding adds one.  Both sides compute in float32 and round to bf16 at the
same points; only the summation order differs, which can flip an
intermediate rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu.models.qwen3 import fuse_decode_params as jfuse
from aha_tpu.ops import fused_layer as jfused_mod
from aha_tpu.ops.attention import decode_window
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import qwen3 as tqwen3
from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                        fuse_decode_params)
from aha_tpu_torch.ops.fused_layer import fused_decode_stack

torch.set_num_threads(1)
# the JAX kernel's gate needs D = 128 and widths in its 128-column chunks
GEO = dict(vocab_size=400, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=128)
S = 64


@pytest.fixture(autouse=True)
def _chunk(monkeypatch):
    # the JAX kernel streams weights in AHA_FUSED_CN-column chunks, which
    # must divide the tiny widths
    monkeypatch.setenv("AHA_FUSED_CN", "128")


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig(**GEO), max_rope_len=256)
    jp = jfuse(jm.init_random(jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                              scale=0.3))
    tm = Qwen3Model(Qwen3Config(**GEO), max_rope_len=256)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    return jm, jp, tm, tp


def _f32(a):
    return np.asarray(a, np.float32)


def _close(got, want, what="", ulps=1):
    got, want = np.asarray(got, np.float32), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= ulps * 2 ** -7 * np.abs(want).max(), (what, err)


def _bf16_pair(rng, *shape):
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                    jnp.bfloat16)
    return a, torch.from_numpy(_f32(a)).to(torch.bfloat16)


@pytest.mark.parametrize("pos", [0, 33, S - 1])
def test_fused_stack_matches_jax_kernel(pair, pos):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(pos)
    L, HD = GEO["num_hidden_layers"], 2 * 128
    jx, tx = _bf16_pair(rng, 1, 1, 256)
    jk, tk = _bf16_pair(rng, L, 1, S, HD)
    jv, tv = _bf16_pair(rng, L, 1, S, HD)
    cos, sin = jm.cos[pos][None], jm.sin[pos][None]
    jcos = jnp.concatenate([cos, cos], -1)
    jsin = jnp.concatenate([sin, sin], -1)
    want_x, want_k, want_v = jfused_mod.fused_decode_stack(
        jx, jp["layers"], jnp.int32(pos), jcos, jsin, jk, jv, window=S,
        eps=1e-6, interpret=True)
    tk0, tv0 = tk.clone(), tv.clone()
    got = fused_decode_stack(tx, tp["layers"],
                             torch.tensor(pos, dtype=torch.int32),
                             torch.tensor(_f32(jcos)), torch.tensor(_f32(jsin)),
                             tk, tv, 1e-6)
    _close(got.float(), want_x, "x")
    _close(tk[:, 0, pos].float(), want_k[:, 0, pos], "k row")
    _close(tv[:, 0, pos].float(), want_v[:, 0, pos], "v row")
    keep = torch.arange(S) != pos
    assert torch.equal(tk[:, :, keep], tk0[:, :, keep])
    assert torch.equal(tv[:, :, keep], tv0[:, :, keep])


def test_fused_decode_steps_match_jax_model(pair, monkeypatch):
    """Prefill 20 tokens, then 4 teacher-forced decode steps through each
    model's fused stack: the JAX model as on a TPU (its gate forced open,
    the kernel in interpret mode), the port's through `window`."""
    jm, jp, tm, tp = pair
    monkeypatch.setattr("aha_tpu.utils.device.on_tpu", lambda: True)
    jkernel = jfused_mod.fused_decode_stack
    monkeypatch.setattr(jfused_mod, "fused_decode_stack",
                        lambda *a, **k: jkernel(*a, **k, interpret=True))
    calls = []
    monkeypatch.setattr(tqwen3, "fused_decode_stack",
                        lambda *a: calls.append(1) or fused_decode_stack(*a))
    rng = np.random.default_rng(5)
    ids = [int(t) for t in rng.integers(1, 399, 20)]
    jc = jm.init_cache(1, S, jnp.bfloat16)
    tc = tm.init_cache(1, S, torch.bfloat16)
    _, jc = jm.backbone(jp, jnp.asarray([ids]), jc)
    tm.backbone(tp, torch.tensor([ids]), tc)
    jc = {**jc, "pos": jnp.int32(20)}
    kv.advance(tc, 20)
    for step, tok in enumerate(int(t) for t in rng.integers(1, 399, 4)):
        with decode_window(S):
            jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc, window=S)
        jc = {**jc, "pos": jc["pos"] + 1}
        kv.advance(tc, 1)
        _close(th.float(), jh, f"decode step {step}", ulps=2)
    assert len(calls) == 4
    _close(tc["k"][:, :, 20:24].float(), jc["k"][:, :, 20:24], "k rows")


def test_fused_gate(pair, monkeypatch):
    """The fused stack runs for one bf16 token with window ≤ 2048 and
    fused parameters; not without a window, past 2048 rows, in float32,
    or with AHA_FUSED_LAYER=0 — those run the per-op chain."""
    _, _, tm, tp = pair
    calls = []
    monkeypatch.setattr(tqwen3, "fused_decode_stack",
                        lambda *a: calls.append(1) or fused_decode_stack(*a))
    fused = fuse_decode_params(tp)
    tok = torch.tensor([[7]])

    def step(params, window, dtype=torch.bfloat16):
        c = tm.init_cache(1, S, dtype)
        n = len(calls)
        tm.backbone(params, tok, c, window=window)
        return len(calls) > n

    assert step(fused, 2048)
    assert not step(fused, None)
    assert not step(fused, 2049)
    f32 = jax.tree.map(lambda t: t.float(), fused)
    assert not step(f32, 64, torch.float32)
    monkeypatch.setenv("AHA_FUSED_LAYER", "0")
    assert not step(fused, 64)


def test_fused_step_close_to_per_op_chain(pair):
    """Same cache, same token: the fused stack and the per-op chain agree
    within bf16 rounding of a 2-layer stack, and write the same rows."""
    _, _, tm, tp = pair
    ids = torch.tensor([[int(t) for t in np.random.default_rng(8)
                         .integers(1, 399, 12)]])
    caches = []
    for window in (S, None):
        c = tm.init_cache(1, S, torch.bfloat16)
        tm.backbone(tp, ids, c)
        kv.advance(c, 12)
        caches.append((tm.backbone(tp, torch.tensor([[11]]), c,
                                   window=window), c))
    (hf, cf), (hp, cp) = caches
    scale = hp.float().abs().max().item()
    assert (hf.float() - hp.float()).abs().max().item() <= 3e-2 * scale
    assert (cf["k"][:, :, 12].float() - cp["k"][:, :, 12].float()).abs() \
        .max().item() <= 3e-2 * cp["k"][:, :, 12].float().abs().max().item()
    assert int(tm.greedy_token(tp, hf)) == int(tm.greedy_token(tp, hp))
