"""aha_tpu_torch's GGUF-grid matmuls against aha_tpu's: the packers (the
port's column-major layout against `quant_from_jax` of the JAX packs), the
plain versions of the int8 and 4-bit kernels and of the fused quantized
SwiGLU against the Pallas kernels in interpret mode, the dequantize paths
against quant_matmul_xla / quant_matmul_q4_xla, the fused-SwiGLU gate, and
fused against separate q|k|v and gate|up products.  float32 on the CPU.

Tolerances, each relative to max |ref|:

- int8 grid, plain vs Pallas: 1e-5 — the same integers and scales, only
  the f32 order of the group sums differs (measured ≤ 2e-7);
- 4-bit grid, plain vs Pallas: 3e-2 — the Pallas kernel's high-half
  groups dot 16·(n − 8) with s/16 and add b + 8s, which carries the
  activation rounding of that group's sum, 8s·(xsum − sx·Σ xq); the port
  stores plain n, s, b.  That is of the order of the activation
  quantization error: measured ≤ 1.1e-2 over M ∈ {1, 3, 8, 37, 64} and
  three seeds (unit activations, 0.02-scale weights);
- dequantize paths vs XLA: 1e-5 (f32 rounding; no activation
  quantization);
- fused SwiGLU: 1e-5 on the int8 grids (measured ≤ 2e-7), 8e-2 where a
  4-bit grid takes part (the 4-bit fold difference above, through the SiLU
  and a second quantization; measured ≤ 3.8e-2 over three seeds, 7e-3
  with q4 on the down side only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops import quant_matmul as jq
from aha_tpu_torch.io.convert import quant_from_jax
from aha_tpu_torch.models.qwen3 import fuse_decode_params
from aha_tpu_torch.ops import quant_matmul as tq

torch.set_num_threads(1)
Q4_KEYS, Q8_KEYS = ("q4", "s4", "b4"), ("qt", "st")


def _weights(rng, n, k, shift=0.0):
    """0.02-scale weights with one all-zero 128-group in the first
    columns (a scale-0 group)."""
    w = (rng.standard_normal((n, k)) * 0.02 + shift).astype(np.float32)
    w[:7, 128:256] = 0.0
    return w


def _acts(rng, m, k):
    """Unit activations with one all-zero group (sx = 0) in row 0."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :128] = 0.0
    return x


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _jargs(p, keys):
    return [jnp.asarray(p[k]) for k in keys]


def _targs(p, keys):
    return [p[k] for k in keys]


@pytest.mark.parametrize("shape", [(384, 1280), (2, 256, 224)])
def test_packers_match_jax_packs(shape):
    """The port's packs equal quant_from_jax of the JAX packs (stacked or
    not) over the port's K padding to 128, and the JAX packer's further
    padding to whole 1024-row chunks is zeros: integers equal, int8 scales
    bit-equal, 4-bit scales bit-equal and the dequantized weights within 1
    f32 ulp (the unfolded min b4 − 8·s)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05 + 0.01).astype(np.float32)

    def jpack(fn):
        packs = [fn(wi) for wi in w.reshape(-1, *shape[-2:])]
        return {k: np.stack([p[k] for p in packs]).reshape(
            *shape[:-2], *packs[0][k].shape) for k in packs[0]}

    Kp = -(-shape[-1] // 128) * 128
    G = Kp // 128

    def split(t, n):
        """The port's K range and the JAX chunk padding past it."""
        return t[..., :n], t[..., n:]

    t8, j8 = tq.pack_q8_rows(w), quant_from_jax(jpack(jq.pack_q8_rows))
    assert t8["qt"].shape == (*shape[:-1], Kp) and t8["qt"].dtype == torch.int8
    (jq8, jpad), (js8, jspad) = split(j8["qt"], Kp), split(j8["st"], G)
    assert torch.equal(t8["qt"], jq8) and torch.equal(t8["st"], js8)
    assert not jpad.any() and not jspad.any()
    t4, j4 = tq.pack_q4_rows(w), quant_from_jax(jpack(jq.pack_q4_rows))
    assert t4["q4"].shape == (*shape[:-1], Kp // 2)
    assert torch.equal(t4["q4"], split(j4["q4"], Kp // 2)[0])
    assert torch.equal(t4["s4"], split(j4["s4"], G)[0])
    dt, dj = tq.dequant(t4), tq.dequant(j4)
    ulp = np.spacing(np.abs(dt.numpy()).max())
    assert (dt - dj[..., :Kp]).abs().max().item() <= ulp
    assert not dj[..., Kp:].any()


@pytest.mark.parametrize("M", [1, 3, 8, 37, 64])
def test_q8_plain_matches_pallas(M):
    rng = np.random.default_rng(M)
    w, x = _weights(rng, 384, 1280), _acts(rng, M, 1280)
    jp = jq.pack_q8_rows(w)
    ref = np.asarray(jq.quant_matmul(jnp.asarray(x), *_jargs(jp, Q8_KEYS),
                                     block_n=256, interpret=True))
    got = tq.quant_matmul(torch.from_numpy(x), *_targs(quant_from_jax(jp),
                                                       Q8_KEYS))
    assert got.shape == (M, 384)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("M", [1, 3, 8, 37, 64])
def test_q4_plain_matches_pallas(M):
    rng = np.random.default_rng(10 + M)
    w, x = _weights(rng, 384, 1280, shift=0.01), _acts(rng, M, 1280)
    jp = jq.pack_q4_rows(w)
    ref = np.asarray(jq.quant_matmul_q4(
        jnp.asarray(x), *_jargs(jp, Q4_KEYS), block_n=256, interpret=True))
    got = tq.quant_matmul_q4(torch.from_numpy(x),
                             *_targs(quant_from_jax(jp), Q4_KEYS))
    assert got.shape == (M, 384)
    assert _rel(got, ref) <= 3e-2
    # and the port's own pack gives the same plain result within f32
    own = tq.quant_matmul_q4(torch.from_numpy(x),
                             *_targs(tq.pack_q4_rows(w), Q4_KEYS))
    assert _rel(own, got) <= 1e-5


@pytest.mark.parametrize("grid", ["q8", "q4"])
def test_dequant_paths_match_xla(grid):
    rng = np.random.default_rng(3)
    w, x = _weights(rng, 256, 1280, 0.01), _acts(rng, 70, 1280)
    if grid == "q8":
        jp = jq.pack_q8_rows(w)
        ref = jq.quant_matmul_xla(jnp.asarray(x), *_jargs(jp, Q8_KEYS))
        got = tq.dequant_matmul(torch.from_numpy(x),
                                *_targs(quant_from_jax(jp), Q8_KEYS))
    else:
        jp = jq.pack_q4_rows(w)
        ref = jq.quant_matmul_q4_xla(jnp.asarray(x), *_jargs(jp, Q4_KEYS))
        got = tq.dequant_matmul_q4(torch.from_numpy(x),
                                   *_targs(quant_from_jax(jp), Q4_KEYS))
    assert _rel(got, np.asarray(ref)) <= 1e-5
    # quant_linear on a CPU tensor takes this path at any M, as the JAX
    # package's non-TPU branch does
    p = quant_from_jax(jp)
    for m in (1, 70):
        xm = torch.from_numpy(x[:m]).reshape(1, m, -1)
        lin = tq.quant_linear(p, xm)
        assert lin.shape == (1, m, 256)
        assert torch.equal(lin[0], got[:m]) or _rel(lin[0], got[:m]) <= 1e-6


@pytest.mark.parametrize("gu_fmt,dn_fmt", [("q8", "q8"), ("q4", "q4"),
                                           ("q4", "q8"), ("q8", "q4")])
def test_swiglu_plain_matches_pallas(gu_fmt, dn_fmt):
    """All four grid pairs (Q4_K_M's q4 gate/up beside a Q6_K int8 down)
    at decode M, against the one-launch Pallas kernel."""
    rng = np.random.default_rng(11)
    H, I = 1024, 1024
    wg, wu = _weights(rng, I, H), _weights(rng, I, H, 0.01)
    wd = _weights(rng, H, I)

    def pack(w, fmt):
        return (jq.pack_q8_rows if fmt == "q8" else jq.pack_q4_rows)(w)

    jgu = {k: np.concatenate([pack(wg, gu_fmt)[k], pack(wu, gu_fmt)[k]], -1)
           for k in pack(wg, gu_fmt)}
    jdn = pack(wd, dn_fmt)
    tgu, tdn = quant_from_jax(jgu), quant_from_jax(jdn)
    assert tq.swiglu_fusable(tgu, tdn, 3)
    x = _acts(rng, 3, H).reshape(1, 3, H)
    ref = np.asarray(jq.quant_swiglu(
        {k: jnp.asarray(v) for k, v in jgu.items()},
        {k: jnp.asarray(v) for k, v in jdn.items()}, jnp.asarray(x),
        interpret=True))
    got = tq.quant_swiglu(tgu, tdn, torch.from_numpy(x))
    assert got.shape == (1, 3, H)
    tol = 1e-5 if gu_fmt == dn_fmt == "q8" else 8e-2
    assert _rel(got, ref) <= tol


def test_swiglu_fusable_gate():
    """The JAX gate's cases, less its VMEM budget: quantized pairs at
    decode M pass; prefill M, dense weights, biases, a down K that is not
    the intermediate size, and an unclean gate|up split fail.  Where the
    JAX gate refuses only for its 1024-row chunk padding (I = 640), the
    port's 128-row padding takes the MLP."""
    rng = np.random.default_rng(12)
    H, I = 1024, 1024

    def q8(n, k):
        return tq.pack_q8_rows(rng.standard_normal((n, k)).astype(np.float32))

    gu, dn = q8(2 * I, H), q8(H, I)
    jgu = {k: jnp.asarray(v) for k, v in jq.pack_q8_rows(
        rng.standard_normal((2 * I, H)).astype(np.float32)).items()}
    jdn = {k: jnp.asarray(v) for k, v in jq.pack_q8_rows(
        rng.standard_normal((H, I)).astype(np.float32)).items()}
    assert tq.swiglu_fusable(gu, dn, 8) and jq.swiglu_fusable(jgu, jdn, 8)
    assert not tq.swiglu_fusable(gu, dn, 65)
    assert not jq.swiglu_fusable(jgu, jdn, 65)
    assert not tq.swiglu_fusable({"w": torch.zeros(H, 2 * I)}, dn, 1)
    assert not tq.swiglu_fusable({**gu, "b": torch.zeros(2 * I)}, dn, 1)
    assert not tq.swiglu_fusable(gu, q8(H, I + 128), 1)    # dKp != I
    assert not tq.swiglu_fusable(q8(2 * I + 128, H), dn, 1)  # gN % 256
    assert tq.swiglu_fusable(tq.pack_q4_rows(
        rng.standard_normal((2 * I, H)).astype(np.float32)), dn, 1)
    j640 = {k: jnp.asarray(v) for k, v in jq.pack_q8_rows(
        rng.standard_normal((H, 640)).astype(np.float32)).items()}
    jgu640 = {k: jnp.asarray(v) for k, v in jq.pack_q8_rows(
        rng.standard_normal((1280, H)).astype(np.float32)).items()}
    assert not jq.swiglu_fusable(jgu640, j640, 1)
    assert tq.swiglu_fusable(q8(1280, H), q8(H, 640), 1)
    jmis = {k: jnp.asarray(v) for k, v in jq.pack_q8_rows(
        rng.standard_normal((H, I + 1024)).astype(np.float32)).items()}
    assert not jq.swiglu_fusable(jgu, jmis, 1)
    assert not tq.swiglu_fusable(gu, q8(H, I + 1024), 1)


@pytest.mark.parametrize("grid", ["q8", "q4"])
def test_fused_columns_bit_identical(grid):
    """fuse_decode_params concatenates q|k|v and gate|up on the grids'
    column axis: the kernels' arithmetic (plain versions) and the dequant
    path give the fused product bit for bit equal to the separate ones."""
    rng = np.random.default_rng(13)
    K = 256

    def mk(n, shift=0.0):
        w = (rng.standard_normal((2, n, K)) * 0.1 + shift).astype(np.float32)
        return tq.pack_rows(w, grid == "q4")

    lay = {"q": mk(256), "k": mk(128, 0.02), "v": mk(128),
           "mlp": {"gate": mk(384), "up": mk(384, 0.01), "down": mk(K)}}
    fused = fuse_decode_params({"layers": lay})["layers"]
    assert "qkv" in fused and "gateup" in fused["mlp"]
    x = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32))
    plain = tq.quant_matmul_q4_plain if grid == "q4" else \
        tq.quant_matmul_plain
    keys = Q4_KEYS if grid == "q4" else Q8_KEYS

    def pick(p, li):
        return [p[k][li] for k in keys]

    for li in range(2):
        for parts, whole in (([lay["q"], lay["k"], lay["v"]], fused["qkv"]),
                             ([lay["mlp"]["gate"], lay["mlp"]["up"]],
                              fused["mlp"]["gateup"])):
            sep = torch.cat([plain(x, *pick(p, li)) for p in parts], -1)
            assert torch.equal(plain(x, *pick(whole, li)), sep)
            one = {k: whole[k][li] for k in keys}
            sep = torch.cat([tq.quant_linear({k: p[k][li] for k in keys}, x)
                             for p in parts], -1)
            assert torch.equal(tq.quant_linear(one, x), sep)


def test_mixed_grids_stay_separate():
    """A q8 tensor beside q4 ones does not fuse; a uniform gate|up does."""
    rng = np.random.default_rng(14)

    def mk(q4, n):
        return tq.pack_rows(rng.standard_normal((2, n, 256)).astype(
            np.float32), q4)

    lay = {"q": mk(True, 256), "k": mk(False, 128), "v": mk(True, 128),
           "mlp": {"gate": mk(True, 384), "up": mk(True, 384),
                   "down": mk(False, 256)}}
    fused = fuse_decode_params({"layers": lay})["layers"]
    assert "qkv" not in fused and "q" in fused
    assert "gateup" in fused["mlp"] and "q4" in fused["mlp"]["gateup"]
    assert fused["mlp"]["gateup"]["q4"].shape == (2, 768, 128)


def test_cpu_wrappers_count_no_launch():
    """On a CPU tensor each wrapper runs its plain version and counts no
    kernel launch."""
    rng = np.random.default_rng(15)
    p8 = tq.pack_q8_rows(rng.standard_normal((256, 256)).astype(np.float32))
    p4 = tq.pack_q4_rows(rng.standard_normal((256, 256)).astype(np.float32))
    x = torch.randn(2, 256)
    n = (tq.quant_matmul.launches, tq.quant_matmul_q4.launches,
         tq.quant_swiglu.launches)
    tq.quant_matmul(x, p8["qt"], p8["st"])
    tq.quant_matmul_q4(x, p4["q4"], p4["s4"], p4["b4"])
    tq.quant_swiglu(p4, tq.pack_q8_rows(torch.randn(256, 128)), x)
    assert (tq.quant_matmul.launches, tq.quant_matmul_q4.launches,
            tq.quant_swiglu.launches) == n


def test_pass_rows_fit_shared_memory():
    """Rows per pass of the staged activations: the fewest sizes that take
    all M rows, stepped down where they would pass an H100 block's opt-in
    shared memory (227 KB) — 8 rows of Qwen3-14B's (17408) or Qwen3-32B's
    (25600) intermediate width instead of 16 — and a width whose one row
    does not fit refused."""
    limit = 227 * 1024
    assert tq.staged_bytes(16, 17408) > limit
    for kp in (17408, 25600):
        assert tq.pass_rows(37, kp, limit, tq.SWIGLU_PASS_ROWS) == 8
        assert tq.pass_rows(37, kp, limit) == 8
        assert tq.staged_bytes(8, kp) <= limit
    assert tq.pass_rows(64, 3072, limit, tq.SWIGLU_PASS_ROWS) == 16
    assert tq.pass_rows(1, 25600, limit, tq.SWIGLU_PASS_ROWS) == 1
    assert tq.pass_rows(3, 1024, limit, tq.SWIGLU_PASS_ROWS) == 4
    assert tq.pass_rows(2, 1024, limit) == 2
    assert tq.pass_rows(9, 1024, limit) == 16
    assert tq.pass_rows(37, 60000, limit) == 2
    with pytest.raises(ValueError):
        tq.pass_rows(1, 240000, limit)
