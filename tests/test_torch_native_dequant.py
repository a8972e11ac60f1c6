"""aha_tpu_torch's native GGUF dequant (aha_tpu_torch/native, the port's
copy of aha_tpu/native) against its numpy path for every block type of
BLOCK_SPECS, within tests/test_native_dequant.py's tolerance (rtol and atol
1e-6), and against the JAX package's native and numpy paths; the reader
takes it first, and where it cannot build it logs the numpy fallback once.
Skips where g++ is missing."""

import logging
import shutil

import numpy as np
import pytest

import aha_tpu.native as jnative
from aha_tpu.io import gguf as jg
from aha_tpu_torch import native
from aha_tpu_torch.io import gguf as tg

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native dequant")

TYPES = {
    "q8_0": tg.GGML_Q8_0,
    "q4_0": tg.GGML_Q4_0,
    "q4_1": tg.GGML_Q4_1,
    "q5_0": tg.GGML_Q5_0,
    "iq4_nl": tg.GGML_IQ4_NL,
    "q4_k": tg.GGML_Q4_K,
    "q6_k": tg.GGML_Q6_K,
    "q5_k": tg.GGML_Q5_K,
    "q2_k": tg.GGML_Q2_K,
    "q3_k": tg.GGML_Q3_K,
}
TOL = dict(rtol=1e-6, atol=1e-6)


def _blocks(name: str, n_blocks: int, seed: int) -> np.ndarray:
    """Random block bytes with finite f16 scale fields (the JAX test's
    recipe)."""
    rng = np.random.default_rng(seed)
    _, bb, _ = native.BLOCK_SPECS[name]
    raw = rng.integers(0, 256, n_blocks * bb, dtype=np.uint8).reshape(
        n_blocks, bb)

    def f16(lo, hi, at):
        v = np.float16(rng.uniform(lo, hi, n_blocks))
        raw[:, at:at + 2] = v[:, None].view(np.uint8).reshape(n_blocks, 2)

    if name in ("q8_0", "q4_0", "q5_0", "iq4_nl", "q4_k", "q4_1", "q5_k"):
        f16(0.001, 2.0, 0)
    if name in ("q4_1", "q4_k", "q5_k"):
        f16(-1.0, 1.0, 2)
    if name == "q6_k":
        f16(0.001, 2.0, 208)
    if name == "q3_k":
        f16(0.001, 2.0, 108)
    if name == "q2_k":
        f16(0.001, 2.0, 80)
        f16(0.0, 1.0, 82)
    return raw.reshape(-1)


def test_every_block_type_is_listed():
    assert set(native.BLOCK_SPECS) == set(TYPES) == set(jnative.BLOCK_SPECS)
    assert native.BLOCK_SPECS == jnative.BLOCK_SPECS


@pytest.mark.parametrize("name", sorted(TYPES))
def test_native_matches_numpy(name):
    """Random blocks and the port's quantizer's blocks (where it has one):
    native within TOL of the numpy path, which is bit-equal to the JAX
    package's numpy path; the JAX native within TOL too."""
    raw = _blocks(name, 64, seed=len(name))
    got = native.dequant(name, raw)
    assert got is not None and got.dtype == np.float32
    ref = tg._dequant_numpy(raw, TYPES[name])
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(ref, _jax_numpy(raw, TYPES[name]))
    np.testing.assert_allclose(got, jnative.dequant(name, raw), **TOL)
    writer = getattr(tg, f"quantize_{name}", None)
    if writer is not None:
        x = np.random.default_rng(1).standard_normal((8, 512)).astype(
            np.float32)
        packed = writer(x)
        np.testing.assert_allclose(native.dequant(name, packed),
                                   tg._dequant_numpy(packed, TYPES[name]),
                                   **TOL)


def _jax_numpy(raw, ggml_type):
    import unittest.mock as mock

    with mock.patch.object(jnative, "dequant", lambda *a: None):
        return jg._dequant(raw, ggml_type)


def test_reader_takes_the_native_path_first(tmp_path):
    """GGUFFile.dequantize of block tensors counts native calls, not numpy
    ones; float tensors count neither."""
    x = np.random.default_rng(2).standard_normal((4, 256)).astype(np.float32)
    path = str(tmp_path / "t.gguf")
    tg.write_gguf(path, {"general.architecture": "x"},
                  {"a": (x, tg.GGML_Q4_K), "b": (x, tg.GGML_Q8_0),
                   "c": (x, tg.GGML_F32)})
    before = dict(tg.DEQUANT_PATHS)
    f = tg.GGUFFile(path)
    for n in "abc":
        f.dequantize(n)
    assert tg.DEQUANT_PATHS["native"] - before["native"] == 2
    assert tg.DEQUANT_PATHS["numpy"] == before["numpy"]
    np.testing.assert_array_equal(f.dequantize("c"), x)


def test_library_is_built_into_the_build_dir(tmp_path, monkeypatch):
    """A fresh build directory gets one library named by a hash of the
    source and flags; a second load reuses it."""
    monkeypatch.setenv("AHA_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    so = native.library_path()
    assert so.parent == tmp_path and so.name.startswith("libaha_dequant_")
    assert native.get_lib() is not None and so.exists()
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    mtime = so.stat().st_mtime_ns
    assert native.get_lib() is not None and so.stat().st_mtime_ns == mtime


def test_fallback_is_logged_once(monkeypatch, caplog):
    """AHA_NO_NATIVE (or a failed build) leaves loads on numpy, logged
    once, and the reader counts the numpy path."""
    monkeypatch.setenv("AHA_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    raw = _blocks("q8_0", 8, seed=3)
    before = tg.DEQUANT_PATHS["numpy"]
    with caplog.at_level(logging.WARNING, logger="aha_tpu_torch.native"):
        out = [tg._dequant(raw, tg.GGML_Q8_0) for _ in range(3)]
    assert [r.getMessage() for r in caplog.records] == [
        "AHA_NO_NATIVE is set: GGUF blocks are dequantized with numpy"]
    assert tg.DEQUANT_PATHS["numpy"] - before == 3
    for o in out:
        np.testing.assert_array_equal(o, tg._dequant_numpy(raw,
                                                           tg.GGML_Q8_0))


def test_a_failed_build_falls_back(monkeypatch, caplog, tmp_path):
    """No compiler on the PATH: the build fails, the failure is logged
    once and dequant returns None."""
    monkeypatch.setenv("AHA_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("AHA_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with caplog.at_level(logging.WARNING, logger="aha_tpu_torch.native"):
        assert native.dequant("q8_0", _blocks("q8_0", 2, seed=4)) is None
        assert native.dequant("q4_k", _blocks("q4_k", 2, seed=5)) is None
    assert len(caplog.records) == 1
    assert "unavailable" in caplog.records[0].getMessage()
