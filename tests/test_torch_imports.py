"""aha_tpu_torch imports nothing of jax or aha_tpu — every module of the
package, and a chat request served through its aiohttp app — and
chip_smoke.py imports neither and refuses to run without a card.  Each
check runs in a fresh interpreter, with no AHA_NO_COMPILE_CACHE set."""

import os
import subprocess
import sys

from tests.fixtures import build_tiny_qwen3_repo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every module of the package (the device path and the host modules)
ALL_MODULES = (
    "import importlib, pkgutil, sys, aha_tpu_torch\n"
    "mods = [m.name for m in pkgutil.walk_packages(aha_tpu_torch.__path__,"
    " 'aha_tpu_torch.') if not m.name.endswith('__main__')]\n"
    "[importlib.import_module(m) for m in mods]\n"
    "assert len(mods) > 30, mods\n")
#: the check that closes each child's code
NOTHING_OF_AHA_TPU = (
    "bad = [m for m in sys.modules if m in ('aha_tpu', 'jax') or "
    "m.startswith(('aha_tpu.', 'jax.'))]\n"
    "assert not bad, bad\n")


def _run(code: str, **env) -> subprocess.CompletedProcess:
    clean = {k: v for k, v in os.environ.items()
             if k != "AHA_NO_COMPILE_CACHE"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True,
                          env={**clean, **env}, timeout=120)


#: the modules of the Qwen2.5-VL slice, each named so the walk above must
#: find it
VL_MODULES = ("aha_tpu_torch.models.llama", "aha_tpu_torch.models.qwen2_5vl",
              "aha_tpu_torch.models.qwen2_5vl_served",
              "aha_tpu_torch.utils.image", "aha_tpu_torch.utils.video")


#: the modules of the ASR slice
ASR_MODULES = ("aha_tpu_torch.params.asr", "aha_tpu_torch.utils.audio",
               "aha_tpu_torch.ops.audio_feats",
               "aha_tpu_torch.models.qwen3_asr",
               "aha_tpu_torch.models.qwen3_asr_served",
               "aha_tpu_torch.models.fun_asr_nano",
               "aha_tpu_torch.models.fun_asr_nano_served",
               "aha_tpu_torch.models.glm_asr_nano",
               "aha_tpu_torch.models.glm_asr_nano_served",
               "aha_tpu_torch.models.fire_red_vad")


#: the modules of the text-to-speech and background-removal slice
TTS_IMAGE_MODULES = ("aha_tpu_torch.ops.conv",
                     "aha_tpu_torch.models.audio_vae",
                     "aha_tpu_torch.models.voxcpm",
                     "aha_tpu_torch.models.voxcpm_served",
                     "aha_tpu_torch.models.rmbg2_0",
                     "aha_tpu_torch.models.rmbg2_0_served",
                     "aha_tpu_torch.utils.interpolate")


def test_tts_and_image_modules_walked_and_free_of_aha_tpu():
    r = _run(ALL_MODULES + f"missing = set({TTS_IMAGE_MODULES!r}) - "
             "set(mods)\nassert not missing, missing\n" + NOTHING_OF_AHA_TPU)
    assert r.returncode == 0, r.stderr


def test_asr_modules_walked_and_free_of_aha_tpu():
    r = _run(ALL_MODULES + f"missing = set({ASR_MODULES!r}) - set(mods)\n"
             "assert not missing, missing\n" + NOTHING_OF_AHA_TPU)
    assert r.returncode == 0, r.stderr


def test_vl_modules_walked_and_free_of_aha_tpu():
    r = _run(ALL_MODULES + f"missing = set({VL_MODULES!r}) - set(mods)\n"
             "assert not missing, missing\n" + NOTHING_OF_AHA_TPU)
    assert r.returncode == 0, r.stderr


def test_no_module_imports_jax():
    r = _run(ALL_MODULES + "assert 'jax' not in sys.modules, 'jax imported'\n")
    assert r.returncode == 0, r.stderr


def test_device_path_imports_nothing_of_aha_tpu():
    """Every module of the package, the host modules included (the served
    model, the HTTP app, the CLI, the GGUF reader)."""
    r = _run(ALL_MODULES + NOTHING_OF_AHA_TPU)
    assert r.returncode == 0, r.stderr


def test_served_chat_imports_nothing_of_aha_tpu(tmp_path):
    """One non-stream chat request through the port's aiohttp app on the
    tiny on-disk Qwen3 repo, in a fresh interpreter: 200, and still no
    aha_tpu or jax module loaded."""
    build_tiny_qwen3_repo(str(tmp_path))
    code = (
        "import asyncio, json, sys\n"
        "from aiohttp.test_utils import TestClient, TestServer\n"
        "from aha_tpu_torch.models.loader import load_model\n"
        "from aha_tpu_torch.server.app import ServerState, create_app\n"
        f"served = load_model('Qwen/Qwen3-0.6B', {str(tmp_path)!r},"
        " max_seq_len=256)\n"
        "async def ask():\n"
        "    client = TestClient(TestServer(create_app(ServerState("
        "model=served))))\n"
        "    await client.start_server()\n"
        "    try:\n"
        "        r = await client.post('/v1/chat/completions', json={"
        "'model': 'Qwen/Qwen3-0.6B', 'max_tokens': 4, 'temperature': 0.0,"
        " 'stream': False, 'messages': [{'role': 'user', 'content': 'hi'}]})\n"
        "        return r.status, json.loads(await r.text())\n"
        "    finally:\n"
        "        await client.close()\n"
        "status, resp = asyncio.run(ask())\n"
        "assert status == 200 and resp['usage']['completion_tokens'] >= 1,"
        " resp\n"
        + NOTHING_OF_AHA_TPU)
    r = _run(code, AHA_DEVICE="cpu")
    assert r.returncode == 0, r.stderr


def test_serv_refuses_a_missing_card(tmp_path):
    """`python -m aha_tpu_torch serv` with AHA_DEVICE unset where torch
    sees no card raises before loading, naming the way to ask for the CPU;
    nothing is served on the CPU."""
    build_tiny_qwen3_repo(str(tmp_path))
    clean = {k: v for k, v in os.environ.items()
             if k not in ("AHA_DEVICE", "AHA_NO_COMPILE_CACHE")}
    r = subprocess.run([sys.executable, "-m", "aha_tpu_torch", "serv",
                        str(tmp_path), "--port", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**clean, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "AHA_DEVICE=cpu" in r.stderr, r.stderr[-2000:]
    assert "model loaded" not in r.stdout


def test_chip_smoke_imports_and_needs_a_card():
    r = _run("import sys, chip_smoke\n" + NOTHING_OF_AHA_TPU)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""
