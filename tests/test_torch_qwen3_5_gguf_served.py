"""The qwen3.5-gguf entry served by aha_tpu_torch against aha_tpu, on the
CPU in float32, over the tiny files of tests/test_torch_qwen3_5_gguf.py:
`load_model("qwen3.5-gguf", gguf=…)` on a TextEngine and a 2-slot
BatchEngine, and with an mmproj an image chat, each giving the JAX
package's greedy reply; the refusals with the reference's words; `serv`
and `run` in both argument forms; `run` printing the reply, and a `serv`
child answering over HTTP as the in-process JAX model does.

The JAX package's GGUF chat loads in bfloat16 with a bfloat16 cache
(aha_tpu/models/qwen3_5_served.py:122-140); the port's CPU path computes
in float32, so the `jax_f32` fixture holds the JAX loader and engines to
float32 for the comparison."""

import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu_torch import cli
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.models.loader import load_model
from tests.test_torch_qwen3_5_gguf import write_decoder, write_mmproj
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MODEL = "qwen3.5-gguf"
TEXT = "<t5><t9><t17><t3><t40>"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf35_served")
    return {"model": write_decoder(str(d / "tiny-qwen35.gguf")),
            "untied": write_decoder(str(d / "tiny-qwen35-q4head.gguf"),
                                    "untied-q4", seed=8),
            "mmproj": write_mmproj(str(d / "mmproj.gguf"))}


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.delenv("AHA_DTYPE", raising=False)


def _f32_cache(cls):
    class F32Cache(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "cache_dtype": jnp.float32})
    return F32Cache


def _f32_load(fn, *a, **kw):
    return fn(*a, **{**kw, "dtype": jnp.float32})


@pytest.fixture
def jax_f32(monkeypatch):
    import aha_tpu.core.batch_engine as jbe
    import aha_tpu.io.gguf_models as jgm
    import aha_tpu.models.qwen3_5_served as jserved

    for name in ("load_qwen3_5_gguf", "load_qwen3_5_gguf_vl"):
        monkeypatch.setattr(jgm, name,
                            functools.partial(_f32_load, getattr(jgm, name)))
    monkeypatch.setattr(jserved, "TextEngine", _f32_cache(jserved.TextEngine))
    monkeypatch.setattr(jbe, "BatchEngine", _f32_cache(jbe.BatchEngine))


def _chat(content, max_tokens=8):
    from aha_tpu.params import ChatCompletionParameters as JParams
    from aha_tpu_torch.params import ChatCompletionParameters

    body = {"messages": [{"role": "user", "content": content}],
            "model": MODEL, "max_tokens": max_tokens, "temperature": 0.0}
    return (ChatCompletionParameters.model_validate(body),
            JParams.model_validate(body))


def _reply(resp) -> tuple[str, int, int]:
    return (resp.choices[0].message.text(), resp.usage.prompt_tokens,
            resp.usage.completion_tokens)


def _shutdown(served):
    if hasattr(served.engine, "shutdown"):
        served.engine.shutdown()


@pytest.mark.parametrize("which", ["model", "untied"])
def test_text_chat_matches_jax(cpu, jax_f32, files, which):
    """One stream on a TextEngine, named by the file's basename, with the
    file's template, tokenizer and eos: aha_tpu's greedy reply."""
    from aha_tpu_torch.models.qwen3_5_served import Qwen3_5Chat

    path = files[which]
    served = load_model(MODEL, "GGUF", gguf=path, max_seq_len=256)
    assert isinstance(served, Qwen3_5Chat)
    assert isinstance(served.engine, TextEngine)
    assert served.model_name == os.path.basename(path)
    assert served.engine.eos_token_ids == {1}
    assert served.engine.prefix_cache_entries == 0
    jserved = jload_model(MODEL, path, gguf=path, max_seq_len=256)
    for text in (TEXT, "<t100><t7>"):
        mes, jmes = _chat(text)
        got, want = _reply(served.generate(mes)), _reply(
            jserved.generate(jmes))
        assert got == want and got[0], text


def test_batch_slots_serve_concurrent_chats_as_jax(cpu, jax_f32, files):
    """--batch-slots 2: a BatchEngine answering two chats at once with
    aha_tpu's 2-slot replies."""
    path = files["model"]
    served = load_model(MODEL, "GGUF", gguf=path, max_seq_len=256,
                        batch_slots=2)
    jserved = jload_model(MODEL, path, gguf=path, max_seq_len=256,
                          batch_slots=2)
    try:
        assert isinstance(served.engine, BatchEngine)
        assert served.concurrent_streams == 2 == jserved.concurrent_streams
        texts = (TEXT, "<t8><t3><t7>")
        got, want = [None, None], [None, None]

        def run(i):
            got[i] = _reply(served.generate(_chat(texts[i])[0]))

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "a batched chat did not finish"
        for i in range(2):
            want[i] = _reply(jserved.generate(_chat(texts[i])[1]))
        assert got == want and all(g[0] for g in got)
    finally:
        _shutdown(served)
        _shutdown(jserved)


def test_image_chat_matches_jax(cpu, jax_f32, files):
    """With an mmproj: Qwen3_5VLChat on one stream, the vision token ids
    from the file's token list, and an image chat's prompt (a 64 x 96
    image: 24 patches, 6 image tokens) and greedy reply equal to
    aha_tpu's."""
    from aha_tpu_torch.models.qwen3_5_served import Qwen3_5VLChat

    path, mmproj = files["model"], files["mmproj"]
    served = load_model(MODEL, "GGUF", gguf=path, mmproj=mmproj,
                        max_seq_len=512)
    assert isinstance(served, Qwen3_5VLChat)
    assert served.vl_config.image_token_id == 157
    jserved = jload_model(MODEL, path, gguf=path, mmproj=mmproj,
                          max_seq_len=512)
    for seed in (0, 1):
        mes, jmes = _chat([{"type": "text", "text": "<t5><t9>"},
                           {"type": "image_url",
                            "image_url": {"url": png_data_url(64, 96,
                                                              seed)}}])
        got, want = _reply(served.generate(mes)), _reply(
            jserved.generate(jmes))
        # 2 text tokens, the image's 6 between its two markers
        assert got == want and got[1] == 10 and got[0]


def test_refusals_use_the_reference_words(cpu, files, monkeypatch):
    """No gguf file; slots with an mmproj; --tp; --dp (after the
    reference's checks of its slots); an ONNX entry; a file without a chat
    template — each refused with aha_tpu's exception and words."""
    from aha_tpu import registry as jregistry
    from aha_tpu_torch import registry
    from aha_tpu_torch.io import gguf as tg
    from aha_tpu_torch.io.gguf import GGUFFile

    path, mmproj = files["model"], files["mmproj"]
    cases = [((MODEL, "GGUF"), {}),
             ((MODEL, "GGUF"), dict(gguf=path, mmproj=mmproj,
                                    batch_slots=2)),
             ((MODEL, "GGUF"), dict(gguf=path, tp=2)),
             ((MODEL, "GGUF"), dict(gguf=path, dp=2, batch_slots=2)),
             ((MODEL, "GGUF"), dict(gguf=path, dp=2)),
             ((MODEL, "GGUF"), dict(gguf=path, dp=2, batch_slots=3))]
    onnx = "x/tiny-onnx"
    for reg in (registry, jregistry):
        e = reg.ModelEntry(onnx, "llm", "qwen3")
        monkeypatch.setitem(reg._BY_ID, onnx, e)
        monkeypatch.setitem(reg._BY_ID_LOWER, onnx, e)
    cases.append(((onnx, "/nonexistent"), {}))
    g = GGUFFile(path)
    meta = {k: v for k, v in g.metadata.items()
            if k != "tokenizer.chat_template"}
    bare = str(Path(path).with_name("no-template.gguf"))
    tg.write_gguf(bare, meta, {n: (g.dequantize(n), i.ggml_type)
                               for n, i in g.tensors.items()})
    cases.append(((MODEL, "GGUF"), dict(gguf=bare, max_seq_len=128)))
    for args, kw in cases:
        with pytest.raises(Exception) as got:
            load_model(*args, **kw)
        with pytest.raises(Exception) as want:
            jload_model(*args, **kw)
        assert type(got.value) is type(want.value), (args, kw)
        assert str(got.value) == str(want.value), (args, kw)


# -- the CLI --------------------------------------------------------------------


def test_serv_and_run_parse_both_forms(files):
    """The reference's `serv ID --gguf-path F [--mmproj-path M]` (and its
    --weight-path, --onnx-path, --config-path) beside the port's `serv
    PATH --model ID`: `resolve` gives (id, path, gguf, mmproj)."""
    ap = cli.build_parser()
    path, mmproj = files["model"], files["mmproj"]
    for cmd in ("serv", "run"):
        extra = ["--input", "hi"] if cmd == "run" else []
        a = ap.parse_args([cmd, MODEL, "--gguf-path", path, "--mmproj-path",
                           mmproj, "--config-path", "c.json",
                           "--onnx-path", "o.onnx", *extra])
        assert cli.resolve(a) == (MODEL, "GGUF", path, mmproj)
        a = ap.parse_args([cmd, path, "--model", MODEL, *extra])
        assert cli.resolve(a) == (MODEL, path, path, None)
        a = ap.parse_args([cmd, "/some/dir", *extra])
        assert cli.resolve(a) == ("Qwen/Qwen3-0.6B", "/some/dir", None,
                                  None)
        a = ap.parse_args([cmd, "Qwen/Qwen3-0.6B", "--weight-path", "/w",
                           *extra])
        assert cli.resolve(a) == ("Qwen/Qwen3-0.6B", "/w", None, None)
    j = ap.parse_args(["serv", MODEL, "--gguf-path", path])
    assert (j.weight_path, j.onnx_path, j.config_path) == (None, None, None)


def test_cli_refusals_use_the_reference_words(files, tmp_path, monkeypatch):
    """A GGUF id without --gguf-path, an ONNX id, and `serv` of an id with
    neither --weight-path nor a downloaded directory exit with the JAX
    CLI's words (aha_tpu/cli/main.py:204-226); `run` downloads where the
    JAX CLI downloads (both packages' download_model replaced by a
    recorder: no network); an id's directory under AHA_HOME is served."""
    import aha_tpu.utils.download as jdownload
    from aha_tpu import registry as jregistry
    from aha_tpu.cli.main import _resolve_model_path
    from aha_tpu.cli.main import build_parser as jbuild_parser
    from aha_tpu_torch import registry
    from aha_tpu_torch.utils import download

    monkeypatch.setenv("AHA_HOME", str(tmp_path / "home"))
    onnx = "x/tiny-onnx"
    for reg in (registry, jregistry):
        e = reg.ModelEntry(onnx, "llm", "qwen3")
        monkeypatch.setitem(reg._BY_ID, onnx, e)
        monkeypatch.setitem(reg._BY_ID_LOWER, onnx, e)
    ap, jap = cli.build_parser(), jbuild_parser()
    for argv in (["serv", MODEL], ["serv", onnx],
                 ["serv", "Qwen/Qwen3-0.6B"]):
        with pytest.raises(SystemExit) as got:
            cli.resolve(ap.parse_args(argv))
        with pytest.raises(SystemExit) as want:
            _resolve_model_path(jap.parse_args(argv), allow_download=False)
        assert str(got.value) == str(want.value), argv
    fetched = {}
    for mod in (download, jdownload):
        monkeypatch.setattr(mod, "download_model",
                            lambda *a, _m=mod: fetched.setdefault(_m, a))
    argv = ["run", "Qwen/Qwen3-0.6B", "--input", "hi"]
    got = cli.resolve(ap.parse_args(argv))
    want = _resolve_model_path(jap.parse_args(argv), allow_download=True)
    assert got == ("Qwen/Qwen3-0.6B", *want)
    assert fetched[download] == fetched[jdownload] == (
        "Qwen/Qwen3-0.6B", str(tmp_path / "home"), 3)
    with pytest.raises(SystemExit, match="given twice"):
        cli.resolve(ap.parse_args(["serv", MODEL, "--model",
                                   "Qwen/Qwen3-8B", "--gguf-path", "f"]))
    home = tmp_path / "home" / "Qwen" / "Qwen3-0.6B"
    home.mkdir(parents=True)
    a = ap.parse_args(["serv", "Qwen/Qwen3-0.6B"])
    assert cli.resolve(a) == ("Qwen/Qwen3-0.6B", str(home), None, None)
    assert _resolve_model_path(jap.parse_args(["serv", "Qwen/Qwen3-0.6B"]),
                               False) == (str(home), None, None)


def test_run_prints_the_reply(cpu, jax_f32, files, capsys, tmp_path):
    """`run qwen3.5-gguf --gguf-path F --mmproj-path M --input prompt
    --input image` prints the load time, aha_tpu's reply to that image
    chat and the generate time; `run F --model qwen3.5-gguf` (the port's
    form) the same; one input on this vlm entry is refused as the JAX
    CLI refuses it."""
    import base64

    path, mmproj = files["model"], files["mmproj"]
    url = png_data_url(64, 96, 2)
    png = tmp_path / "x.png"
    png.write_bytes(base64.b64decode(url.split(",", 1)[1]))
    jserved = jload_model(MODEL, path, gguf=path, mmproj=mmproj,
                          max_seq_len=512)
    want = _reply(jserved.generate(_chat([
        {"type": "image_url", "image_url": {"url": f"file://{png}"}},
        {"type": "text", "text": "<t5><t9>"}], max_tokens=6)[1]))[0]
    assert want
    for argv in (["run", MODEL, "--gguf-path", path, "--mmproj-path",
                  mmproj],
                 ["run", path, "--model", MODEL, "--mmproj-path", mmproj]):
        assert cli.main(argv + ["--input", "<t5><t9>", "--input", str(png),
                                "--max-tokens", "6", "--max-seq-len",
                                "512"]) == 0
        out = capsys.readouterr().out.split("\n")
        assert out[0].startswith("load model use time: ")
        assert out[-2].startswith("generate use time: ")
        assert "\n".join(out[1:-2]) == want
    assert cli.main(["run", MODEL, "--gguf-path", path, "--input",
                     "<t5>"]) == 1
    assert capsys.readouterr().out.strip() == (
        f"{MODEL} needs --input <prompt> --input <image>")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serv_child_answers_as_jax(cpu, jax_f32, files):
    """`python -m aha_tpu_torch serv qwen3.5-gguf --gguf-path F` in a child
    process on the CPU answers a chat with aha_tpu's greedy reply."""
    path = files["model"]
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "AHA_DEVICE": "cpu"}
    child = subprocess.Popen(
        [sys.executable, "-m", "aha_tpu_torch", "serv", MODEL, "--gguf-path",
         path, "--port", str(port), "--max-seq-len", "256"], env=env,
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline, body = time.monotonic() + 120, None
        while time.monotonic() < deadline and child.poll() is None:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/chat/completions",
                    data=json.dumps({
                        "model": MODEL, "max_tokens": 8, "temperature": 0.0,
                        "stream": False,
                        "messages": [{"role": "user", "content": TEXT}]
                    }).encode(), headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    body = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.2)
        assert body is not None, (child.stdout.read().decode()[-2000:]
                                  if child.poll() is not None
                                  else "server did not answer")
    finally:
        child.terminate()
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=10)
    jserved = jload_model(MODEL, path, gguf=path, max_seq_len=256)
    want = _reply(jserved.generate(_chat(TEXT)[1]))
    msg = body["choices"][0]["message"]["content"]
    assert msg == want[0] and body["model"] == os.path.basename(path)
