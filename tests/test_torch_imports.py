"""aha_tpu_torch never imports jax, its device path imports nothing of
aha_tpu, and chip_smoke.py imports neither and refuses to run without a
card.  Each check runs in a fresh interpreter."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_PATH = ["aha_tpu_torch.ops.kernels", "aha_tpu_torch.ops.norms",
               "aha_tpu_torch.ops.rope", "aha_tpu_torch.ops.attention",
               "aha_tpu_torch.ops.flash_attention",
               "aha_tpu_torch.ops.lm_head", "aha_tpu_torch.ops.fused_layer",
               "aha_tpu_torch.core.cache",
               "aha_tpu_torch.core.nn", "aha_tpu_torch.core.sampling",
               "aha_tpu_torch.core.engine", "aha_tpu_torch.core.batch_engine",
               "aha_tpu_torch.models.qwen3", "aha_tpu_torch.utils.device",
               "aha_tpu_torch.io.convert"]


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True,
                          env={**os.environ, **env}, timeout=120)


def test_no_module_imports_jax():
    code = (
        "import importlib, pkgutil, sys, aha_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(aha_tpu_torch.__path__,"
        " 'aha_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) > 20, mods\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print(len(mods))\n")
    r = _run(code, AHA_NO_COMPILE_CACHE="1")
    assert r.returncode == 0, r.stderr


def test_device_path_imports_nothing_of_aha_tpu():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in DEVICE_PATH)
            + "bad = [m for m in sys.modules if m == 'aha_tpu' or "
              "m.startswith('aha_tpu.') or m == 'jax']\n"
              "assert not bad, bad\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_and_needs_a_card():
    r = _run("import sys, chip_smoke\n"
             "assert not [m for m in sys.modules if m == 'jax' or "
             "m.startswith('aha_tpu')], 'chip_smoke imported jax/aha_tpu'\n")
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""
