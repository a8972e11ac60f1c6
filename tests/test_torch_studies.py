"""The port's H100 studies (aha_tpu_torch/studies/) against the TPU design
studies under scripts/: each plain version against the script's own Pallas
body, run through the script's own pallas_call specs in interpret mode, on
the same numpy-seeded inputs at K 1024 and N a multiple of the block width.

The scripts are loaded by file path (their top level imports only jax and
numpy; main() does not run).  The kernel bodies and the functions that
call pallas_call are nested in main(): they are taken out with `ast` and
executed with the script module's globals (K, M and the rest), N set to the
test's width and pallas_call given interpret=True.  fused_layer_kernel is
module-level and runs for one layer of an L = 2 stack at the script's full
widths under pltpu.InterpretParams().  Tolerances: int4 bit-equal; the sum
and the GEMV within 1e-5 of max |ref| (f32 summation order), the sum's
total within 1e-5 of the sum of |w| (its terms cancel); the argmax's
index equal and its value within 1e-5 relative; the fused layer within
2^-7 of max |ref| (the bf16 roundings of its folds).

One more test shows a fault of the reference, left as it is: the TPU grids
are N // bn, so the last N % bn columns are never read; with the maximum
planted there, the script's head_kernel returns an index below 2·bn while
the port's gemv_argmax (plain) finds it.
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aha_tpu_torch.studies import exp_fused_layer as efl
from aha_tpu_torch.studies import exp_gemv as eg
from aha_tpu_torch.studies import exp_int4 as e4

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
K = 1024
TOL_SUM = 1e-5


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _InterpretPallas(types.SimpleNamespace):
    """`pl` for the extracted functions: pallas_call in interpret mode,
    every other name the real module's."""

    def __getattr__(self, name):
        return getattr(pl, name)


def _interpret_call(kernel, **kw):
    return pl.pallas_call(kernel, interpret=True, **kw)


def _capturing_call(out: list):
    """pallas_call in interpret mode that also keeps each call's result
    (mk_sum's and mk_gemv's steps fold it into x before returning)."""
    def pallas_call(kernel, **kw):
        f = _interpret_call(kernel, **kw)

        def call(*args):
            r = f(*args)
            out.append(r)
            return r
        return call
    return pallas_call


def _nested(name: str, wanted: set[str], **overrides) -> dict:
    """The functions `wanted` defined inside the script's main(), executed
    with the script module's globals and `overrides`."""
    mod = _load(name)
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    ns = dict(mod.__dict__)
    ns.update(overrides)
    found = set()
    for node in main.body:
        if isinstance(node, ast.FunctionDef) and node.name in wanted:
            exec(compile(ast.Module([node], []), str(path), "exec"), ns)
            found.add(node.name)
    assert found == wanted, wanted - found
    return ns


def _bf16(rng, *shape, scale: float = 1.0
          ) -> tuple[jnp.ndarray, torch.Tensor]:
    """The same bf16 values for JAX and torch, N(0, scale²) from numpy."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


def _gemv_script(N: int):
    captured: list = []
    ns = _nested("exp_gemv", {"sum_kernel", "mk_sum", "gemv_kernel",
                              "mk_gemv", "head_kernel", "mk_head",
                              "head_once"},
                 N=N, pl=_InterpretPallas(pallas_call=_capturing_call(
                     captured)))
    return ns, captured


def _rel(got: torch.Tensor, ref) -> float:
    ref = torch.as_tensor(np.asarray(ref, np.float32))
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("bn", [2048, 4096])
def test_stream_sum_plain_matches_sum_kernel(bn):
    """stream_sum's (1, 128) output against mk_sum's, N = 2·bn; its total
    against the sum of every element."""
    N = 2 * bn
    rng = np.random.default_rng(bn)
    jw, tw = _bf16(rng, K, N)
    jx, tx = _bf16(rng, 1, K)
    ns, captured = _gemv_script(N)
    ns["mk_sum"](bn)(jx, jw)
    out, total = eg.stream_sum(tx, tw, bn)
    assert out.shape == (1, 128) and out.dtype == torch.float32
    assert _rel(out, captured[-1]) <= TOL_SUM
    # the total of ~8M terms cancels: its f32 error is held to Σ|w|
    wf = np.asarray(jw, np.float64)
    assert abs(float(total) - wf.sum()) <= TOL_SUM * np.abs(wf).sum()


@pytest.mark.parametrize("bn", [1024, 2048])
def test_gemv_m8_plain_matches_gemv_kernel(bn):
    N = 2 * bn
    rng = np.random.default_rng(bn + 1)
    jw, tw = _bf16(rng, K, N)
    jx, tx = _bf16(rng, 1, K)
    ns, captured = _gemv_script(N)
    ns["mk_gemv"](bn)(jx, jw)
    got = eg.gemv_m8(tx.expand(8, K).contiguous(), tw)
    assert got.shape == (8, N) and got.dtype == torch.float32
    assert _rel(got, captured[-1]) <= TOL_SUM


@pytest.mark.parametrize("bn", [2048, 4096])
def test_gemv_argmax_plain_matches_head_kernel(bn):
    """mk_head's (max, first index) and head_once's index (bn 2048, the
    script's check call) against the port's gemv_argmax and head_once."""
    N = 2 * bn
    rng = np.random.default_rng(bn + 2)
    jw, tw = _bf16(rng, K, N)
    jx, tx = _bf16(rng, 1, K)
    ns, captured = _gemv_script(N)
    ns["mk_head"](bn)(jx, jw)
    m, idx = captured[-1]
    val, i = eg.gemv_argmax(tx, tw, bn)
    assert int(i) == int(np.asarray(idx)[0, 0])
    assert abs(float(val) - float(np.asarray(m)[0, 0])) <= \
        TOL_SUM * abs(float(np.asarray(m)[0, 0]))
    _, i_once = eg.head_once(tx, tw)
    assert int(i_once) == int(ns["head_once"](jx, jw)) == int(i)


def test_reference_drops_the_last_columns():
    """The TPU head's grid is N // bn: with N = 2·bn + 384 and the maximum
    planted in the last 384 columns, head_kernel returns an index below
    2·bn; the port's gemv_argmax returns the planted one, as np.argmax."""
    bn, N = 2048, 2 * 2048 + 384
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.01
    planted = N - 100
    w[:, planted] = np.sign(x[0]) * 0.5           # x · w[:, planted] ≫ the rest
    jw, jx = jnp.asarray(w, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32))).bfloat16()
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    ns, captured = _gemv_script(N)
    ns["mk_head"](bn)(jx, jw)
    tpu_idx = int(np.asarray(captured[-1][1])[0, 0])
    assert tpu_idx < 2 * bn
    logits = np.asarray(jx, np.float32) @ np.asarray(jw, np.float32)
    assert int(np.argmax(logits[0])) == planted
    assert int(eg.gemv_argmax(tx, tw, bn)[1]) == planted
    assert int(eg.head_once(tx, tw)[1]) == planted


@pytest.fixture(scope="module")
def int4_case():
    """x (8, K), int4 weights (K, N) at N = 2·2048, the script's own
    jnp.int4 and packed layouts, and the port's k8 words and packed bytes."""
    N = 2 * 2048
    rng = np.random.default_rng(11)
    jx, tx = _bf16(rng, 8, K)
    w4np = rng.integers(-8, 8, (K, N), dtype=np.int8)
    packed = ((w4np[0::2, :] & 0x0F) | ((w4np[1::2, :] & 0x0F) << 4)
              ).astype(np.int8)
    ns = _nested("exp_int4", {"k_i4", "f_i4_pl", "k_i4n", "f_i4n_pl",
                              "k_pk", "f_pk"},
                 N=N, bn=2048, pl=_InterpretPallas(
                     pallas_call=_interpret_call))
    return ns, jx, tx, w4np, packed


@pytest.mark.parametrize("script_fn,port_fn", [
    ("f_i4_pl", "i4_upcast"), ("f_i4n_pl", "i4_tensorcore"),
    ("f_pk", "i4_packed_k")])
def test_int4_plain_bit_equal_to_script(int4_case, script_fn, port_fn):
    ns, jx, tx, w4np, packed = int4_case
    if script_fn == "f_pk":
        want = ns[script_fn](jx, jnp.asarray(packed))
        got = getattr(e4, port_fn)(tx, e4.pack_k(w4np))
        assert np.array_equal(e4.pack_k(w4np).numpy(), packed)
    else:
        want = ns[script_fn](jx, jnp.asarray(w4np, jnp.int4))
        got = getattr(e4, port_fn)(tx, e4.pack_k8(w4np))
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.float(), want)


def test_int4_layouts_round_trip():
    rng = np.random.default_rng(12)
    w4 = rng.integers(-8, 8, (64, 40), dtype=np.int8)
    words = e4.pack_k8(w4)
    assert words.dtype == torch.int32 and words.shape == (8, 40)
    assert torch.equal(e4.unpack_k8(words), torch.from_numpy(w4))
    assert torch.equal(e4.unpack_k(e4.pack_k(w4)), torch.from_numpy(w4))
    # word [q, n] holds W[8q + j, n] in bits 4j..4j+3
    j, q, n = 5, 3, 17
    assert (int(words[q, n]) >> (4 * j)) & 0xF == int(w4[8 * q + j, n]) & 0xF
    # a zero row quantizes with sx = 0 and gives zeros
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    assert torch.equal(e4.i4_upcast(x, words), torch.zeros(8, 40,
                                                           dtype=torch.bfloat16))


@pytest.mark.parametrize("cn,nbuf", [(1024, 2), (2048, 2)])
def test_fused_layer_plain_matches_kernel(cn, nbuf):
    """One layer (li = 1) of an L = 2 stack at the script's full widths:
    fused_layer_kernel under pltpu.InterpretParams(), the script's specs,
    against fused_layer_stream (plain)."""
    mod = _load("exp_fused_layer")
    L, H, NQKV, NO, NI, M = 2, mod.H, mod.NQKV, mod.NO, mod.NI, mod.M
    rng = np.random.default_rng(cn + nbuf)
    (jq, tq), (jo, to), (jg, tg), (jd, td) = (
        _bf16(rng, *shape, scale=0.02) for shape in (
            (L, H, NQKV), (L, NO, H), (L, H, 2 * NI), (L, NI, H)))
    jx, tx = _bf16(rng, M, H)
    out = pl.pallas_call(
        functools.partial(mod.fused_layer_kernel, cn=cn, nbuf=nbuf),
        out_shape=jax.ShapeDtypeStruct((M, H), jnp.bfloat16),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((nbuf, H, max(cn, H)), jnp.bfloat16),
                        pltpu.VMEM((M, NQKV), jnp.float32),
                        pltpu.VMEM((M, NO), jnp.float32),
                        pltpu.VMEM((M, 2 * NI), jnp.float32),
                        pltpu.SemaphoreType.DMA((nbuf,))],
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray([1], jnp.int32), jx, jq, jo, jg, jd)
    want = torch.from_numpy(np.asarray(out.astype(jnp.float32)))
    got = efl.fused_layer_stream(tx, tq, to, tg, td,
                                 torch.tensor(1, dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and got.shape == (M, H)
    assert _rel(got, want) <= 2.0 ** -7
    assert mod.BYTES_PER_LAYER == efl.BYTES_PER_LAYER
