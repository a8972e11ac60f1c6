"""aha_tpu_torch's one-launch decode stack over the GGUF grids
(ops/fused_layer.fused_decode_stack_q8) against aha_tpu's
fused_decode_stack_q8 in interpret mode, on the same inputs (numpy and JAX
keys from a seed): the module alone on the int8 grid, the 4-bit grid and
the mix a Q4_K file gives (4-bit attention and gate|up, int8 down), and
Qwen3Model's fused decode steps against the JAX model's as it runs them on
a TPU; then the model's gate.  On the CPU the port's wrapper runs its plain
version; tests/test_torch_cuda.py holds the kernel to that plain version
on the card.  The geometry is the smallest the JAX kernel takes: every K a
whole 1024-row chunk of its packer.

Tolerances, relative to max |ref|:

- int8 grids: 2**-6 — both sides quantize the same f32 activations and
  dot the same integers; the hidden state's own bf16 rounding (2**-8) and
  the f32 summation order, which can move an activation across a .5
  quantization boundary (one step of max|a_g|/127 in one product), make
  the rest (measured ≤ 7.1e-5 for the module);
- with a 4-bit grid: 1e-1 — the Pallas kernel's folded high-half groups
  add 8s·(xsum − sx·Σ xq), the activation rounding of that group's sum,
  which the port's unfolded grid does not (tests/test_torch_quant_matmul.py
  measures it per product).  Over two layers of 0.05-scale weights that
  noise and the port's own activation rounding are each 3–4.5e-2 from the
  exact dequantized path and reach 6.9e-2 between them (module,
  measured).  So each side is also held to the exact path, the JAX
  model's per-op layers with dequantized weights: 6e-2 on every grid
  (measured ≤ 4.3e-2 for the port, 4.5e-2 for the JAX kernel).
"""

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
from aha_tpu.ops.quant_matmul import pack_q4_rows, pack_q8_rows
from aha_tpu.ops.rope import gather_rope
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import qwen3 as tqwen3
from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from aha_tpu_torch.ops.fused_layer import (fused_decode_stack_q8,
                                           fused_stack_q8_supported)

torch.set_num_threads(1)
GEO = dict(vocab_size=400, hidden_size=1024, intermediate_size=1024,
           num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
           head_dim=128)
S = 64
#: the grid of (attention projections, gate|up, down) per case
GRIDS = {"q8": ("q8", "q8", "q8"), "q4": ("q4", "q4", "q4"),
         "gguf": ("q4", "q4", "q8")}
TOL = {"q8": 2 ** -6, "q4": 1e-1, "gguf": 1e-1}
TOL_EXACT = 6e-2


def _jax_params(jm, grids):
    """Seeded bf16 params with every decoder linear packed by the JAX
    packers on its case's grid, then fused as the JAX model fuses them."""
    params = jm.init_random(jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                            scale=0.05)
    pack = {"q8": pack_q8_rows, "q4": pack_q4_rows}
    attn, gu, dn = (pack[g] for g in grids)
    lyr = params["layers"]
    L = GEO["num_hidden_layers"]

    def q(p, fn):
        packs = [fn(np.asarray(p["w"][i], np.float32).T) for i in range(L)]
        return {k: jnp.stack([jnp.asarray(pk[k]) for pk in packs])
                for k in packs[0]}

    layers = {**lyr,
              "q": q(lyr["q"], attn), "k": q(lyr["k"], attn),
              "v": q(lyr["v"], attn), "o": q(lyr["o"], attn),
              "mlp": {"gate": q(lyr["mlp"]["gate"], gu),
                      "up": q(lyr["mlp"]["up"], gu),
                      "down": q(lyr["mlp"]["down"], dn)}}
    return jfuse({**params, "layers": layers})


@pytest.fixture(scope="module")
def models():
    return (JModel(JConfig(**GEO), max_rope_len=256),
            Qwen3Model(Qwen3Config(**GEO), max_rope_len=256))


@pytest.fixture(scope="module", params=list(GRIDS))
def case(request, models):
    jm, tm = models
    jp = _jax_params(jm, GRIDS[request.param])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    return request.param, jp, tp


def _f32(a):
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_pair(rng, *shape):
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                    jnp.bfloat16)
    return a, torch.from_numpy(_f32(a)).to(torch.bfloat16)


@pytest.mark.parametrize("pos", [0, 41])
def test_fused_stack_q8_matches_jax_kernel(models, case, pos):
    jm, _ = models
    grid, jp, tp = case
    H, HD = GEO["hidden_size"], GEO["num_key_value_heads"] * 128
    L = GEO["num_hidden_layers"]
    assert jfused_mod.fused_layer_q8_supported(
        jp["layers"], H, GEO["num_attention_heads"],
        GEO["num_key_value_heads"], 128, GEO["intermediate_size"], S)
    rng = np.random.default_rng(pos)
    jx, tx = _bf16_pair(rng, 1, 1, H)
    jk, tk = _bf16_pair(rng, L, 1, S, HD)
    jv, tv = _bf16_pair(rng, L, 1, S, HD)
    cos, sin = jm.cos[pos][None], jm.sin[pos][None]
    jcos = jnp.concatenate([cos, cos], -1)
    jsin = jnp.concatenate([sin, sin], -1)
    want_x, want_k, want_v = jfused_mod.fused_decode_stack_q8(
        jx, jp["layers"], jnp.int32(pos), jcos, jsin, jk, jv, window=S,
        eps=1e-6, interpret=True)
    tk0, tv0 = tk.clone(), tv.clone()
    got = fused_decode_stack_q8(tx, tp["layers"],
                                torch.tensor(pos, dtype=torch.int32),
                                torch.tensor(_f32(jcos)),
                                torch.tensor(_f32(jsin)), tk, tv, 1e-6)
    assert _rel(got.float(), want_x) <= TOL[grid], "hidden"
    # the exact path: the JAX model's per-op layers, dequantized weights
    exact, kc, vc = jx, jk, jv
    jpos = jnp.int32(pos)
    c, s = gather_rope(jm.cos, jm.sin, jpos + jnp.arange(1))
    for i in range(L):
        lp = jax.tree.map(lambda a: a[i], jp["layers"])
        exact, kc, vc, _, _ = jm._layer(lp, exact, c, s, kc, vc,
                                        jnp.int32(i), jpos, is_prefill=False)
    assert _rel(got.float(), exact) <= TOL_EXACT, "port vs exact"
    assert _rel(_f32(want_x), exact) <= TOL_EXACT, "JAX kernel vs exact"
    assert _rel(tk[:, 0, pos].float(), want_k[:, 0, pos]) <= TOL[grid]
    assert _rel(tv[:, 0, pos].float(), want_v[:, 0, pos]) <= TOL[grid]
    keep = torch.arange(S) != pos
    assert torch.equal(tk[:, :, keep], tk0[:, :, keep])
    assert torch.equal(tv[:, :, keep], tv0[:, :, keep])


def test_fused_q8_decode_steps_match_jax_model(models, case, monkeypatch):
    """Prefill 20 tokens on both models' per-op paths, then 3
    teacher-forced decode steps through each model's quantized fused stack:
    the JAX model as on a TPU (its gate forced open, the kernel in
    interpret mode), the port's through `window`."""
    jm, tm = models
    grid, jp, tp = case
    rng = np.random.default_rng(5)
    ids = [int(t) for t in rng.integers(1, 399, 20)]
    jc = jm.init_cache(1, S, jnp.bfloat16)
    tc = tm.init_cache(1, S, torch.bfloat16)
    _, jc = jm.backbone(jp, jnp.asarray([ids]), jc)
    tm.backbone(tp, torch.tensor([ids]), tc)
    jc = {**jc, "pos": jnp.int32(20)}
    kv.advance(tc, 20)
    # the TPU gate only for the decode steps: off the TPU the JAX prefill
    # takes its XLA paths, as the port's does on the CPU
    monkeypatch.setattr("aha_tpu.utils.device.on_tpu", lambda: True)
    jkernel = jfused_mod.fused_decode_stack_q8
    monkeypatch.setattr(jfused_mod, "fused_decode_stack_q8",
                        lambda *a, **k: jkernel(*a, **k, interpret=True))
    calls = []
    monkeypatch.setattr(tqwen3, "fused_decode_stack_q8",
                        lambda *a: calls.append(1) or fused_decode_stack_q8(*a))
    for step, tok in enumerate(int(t) for t in rng.integers(1, 399, 3)):
        with decode_window(S):
            jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc, window=S)
        jc = {**jc, "pos": jc["pos"] + 1}
        kv.advance(tc, 1)
        assert _rel(th.float(), jh) <= TOL[grid], f"decode step {step}"
    assert len(calls) == 3
    assert _rel(tc["k"][:, :, 20:23].float(), jc["k"][:, :, 20:23]) \
        <= TOL[grid]


def test_fused_q8_gate(models, case, monkeypatch):
    """The quantized stack runs for one bf16 token with window ≤ 2048 and
    fused grid parameters whose K is each grid's Kp; not without a window,
    with AHA_FUSED_LAYER=0, for unfused q/k/v, a biased projection, float32
    norms, or a grid padded past its K."""
    _, tm = models
    grid, _, tp = case
    x = torch.zeros((1, 1, GEO["hidden_size"]), dtype=torch.bfloat16)
    cache = tm.init_cache(1, S, torch.bfloat16)
    assert tm._use_fused_stack(tp, x, cache, 2048) == "q8"
    assert tm._use_fused_stack(tp, x, cache, None) is None
    geo = (GEO["hidden_size"], GEO["num_attention_heads"],
           GEO["num_key_value_heads"], 128, GEO["intermediate_size"])
    lyr = tp["layers"]
    unfused = {k: v for k, v in lyr.items() if k != "qkv"}
    unfused.update(q=lyr["qkv"], k=lyr["qkv"], v=lyr["qkv"])
    biased = {**lyr, "o": {**lyr["o"], "b": torch.zeros(GEO["hidden_size"])}}
    f32 = {**lyr, "ln1": {"w": lyr["ln1"]["w"].float()}}
    padded = {**lyr, "o": {k: torch.nn.functional.pad(v, (0, 128 if k in (
        "qt", "q4") else 1)) for k, v in lyr["o"].items()}}
    assert fused_stack_q8_supported(lyr, *geo)
    for bad in (unfused, biased, f32, padded):
        assert not fused_stack_q8_supported(bad, *geo)
    monkeypatch.setenv("AHA_FUSED_LAYER", "0")
    assert tm._use_fused_stack(tp, x, cache, 64) is None
