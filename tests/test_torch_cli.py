"""The port's CLI (`python -m aha_tpu_torch`): its subcommands against the
JAX CLI's behaviour (aha_tpu/cli/main.py) — `list` with the downloaded
mark under AHA_HOME, `delete`, `ps` finding a live server by its PID file
and removing a stale one, and `run` on the tiny Qwen3 repo of
tests/fixtures answering as the served model does (and on its tiny
DeepSeek-OCR repo, with the family's prompt), on the CPU; `download` /
`cli` / `serv`'s options parsed with the JAX parser's defaults, `serv`
without a model, `--tp` / `--dp` refused before loading, and the model
types a directory is served as (`model_id_for`).  Child processes run
against 127.0.0.1 with a deadline."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from aha_tpu.cli.main import build_parser as jbuild_parser
from aha_tpu_torch import cli
from aha_tpu_torch.registry import model_list
from aha_tpu_torch.server import process
from tests.fixtures import build_tiny_qwen3_repo

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_qwen3"))
    build_tiny_qwen3_repo(path)
    return path


@pytest.fixture
def aha_home(tmp_path, monkeypatch):
    monkeypatch.setenv("AHA_HOME", str(tmp_path / "home"))
    return tmp_path / "home"


def test_parser_subcommands(repo):
    ap = cli.build_parser()
    assert ap.parse_args(["list", "--json"]).json
    a = ap.parse_args(["delete", "Qwen/Qwen3-0.6B", "-y", "--save-dir", "/x"])
    assert (a.model, a.yes, a.save_dir) == ("Qwen/Qwen3-0.6B", True, "/x")
    assert ap.parse_args(["ps", "--compact"]).compact
    a = ap.parse_args(["serv", repo, "--spec-tokens", "8", "--port", "9002"])
    assert (a.path, a.spec_tokens, a.port, a.batch_slots) == (repo, 8, 9002,
                                                              1)
    a = ap.parse_args(["run", repo, "--input", "hi", "--input", "x.png",
                       "--max-tokens", "5", "--spec-tokens", "4"])
    assert (a.input, a.max_tokens, a.spec_tokens, a.model) == (
        ["hi", "x.png"], 5, 4, "Qwen/Qwen3-0.6B")
    # the JAX CLI's options of the same names take the same defaults
    j = jbuild_parser().parse_args(["run", "Qwen/Qwen3-0.6B", "--input", "h"])
    t = ap.parse_args(["run", repo, "--input", "h"])
    assert (t.max_tokens, t.max_seq_len, t.spec_tokens) == \
        (j.max_tokens, j.max_seq_len, j.spec_tokens)
    for cmd in ("download", "cli"):     # ported: both take an id
        a = ap.parse_args([cmd, "Qwen/Qwen3-0.6B", "--save-dir", "/s",
                           "--download-retries", "5"])
        assert (a.save_dir, a.download_retries) == ("/s", 5)
    a = ap.parse_args(["serv", "--manage-only"])
    assert a.manage_only and a.path is None


def test_list_json_and_table_mark_downloaded_models(aha_home, capsys):
    (aha_home / "Qwen" / "Qwen3-0.6B").mkdir(parents=True)
    (aha_home / "Qwen" / "Qwen3-0.6B" / "config.json").write_text("{}")
    (aha_home / "Qwen" / "Qwen3-1.7B").mkdir(parents=True)   # empty: not
    assert cli.main(["list", "--json"]) == 0
    infos = json.loads(capsys.readouterr().out)
    assert [i["model_id"] for i in infos] == [m.model_id
                                              for m in model_list()]
    marked = {i["model_id"] for i in infos if i["downloaded"]}
    assert marked == {"Qwen/Qwen3-0.6B"}
    assert infos[0].keys() == {"model_id", "owner", "model_type",
                               "downloaded"}
    assert cli.main(["list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = {ln.split()[0]: ln for ln in lines[4:]}
    assert len(rows) == len(model_list())
    assert rows["Qwen/Qwen3-0.6B"].rstrip().endswith("✔")
    assert "✔" not in rows["Qwen/Qwen3-1.7B"]


def test_delete_missing_and_present(aha_home, capsys, monkeypatch):
    assert cli.main(["delete", "Qwen/Qwen3-0.6B"]) == 1
    assert "is not downloaded" in capsys.readouterr().out
    target = aha_home / "Qwen" / "Qwen3-0.6B"
    target.mkdir(parents=True)
    (target / "model.safetensors").write_bytes(b"x")
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    assert cli.main(["delete", "Qwen/Qwen3-0.6B"]) == 1
    assert target.exists() and "aborted" in capsys.readouterr().out
    assert cli.main(["delete", "Qwen/Qwen3-0.6B", "--yes"]) == 0
    assert not target.exists()
    assert f"deleted {target}" in capsys.readouterr().out
    with pytest.raises(KeyError):
        cli.main(["delete", "no/such-model", "-y"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ps_finds_a_live_server_and_drops_a_stale_pid_file(
        repo, tmp_path, monkeypatch, capsys):
    """`python -m aha_tpu_torch serv` in a child under a temporary
    XDG_RUNTIME_DIR: ps lists it as <pid>@<port> from its PID file; a PID
    file whose process is gone is removed."""
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    port = _free_port()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait(timeout=30)
    stale = process.get_pid_dir() / "1.pid"
    stale.write_text(f"{dead.pid}\n")
    env = {**os.environ, "XDG_RUNTIME_DIR": str(tmp_path),
           "PYTHONPATH": str(ROOT), "AHA_DEVICE": "cpu"}
    child = subprocess.Popen(
        [sys.executable, "-m", "aha_tpu_torch", "serv", repo, "--port",
         str(port), "--max-seq-len", "256"], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        up = False
        while time.monotonic() < deadline and child.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    up = r.status == 200
            except OSError:
                pass
            if up:
                break
            time.sleep(0.2)
        assert up, child.stdout.read().decode()[-2000:] \
            if child.poll() is not None else "server did not answer"
        ids = {s.service_id for s in process.find_aha_services()}
        assert f"{child.pid}@{port}" in ids
        assert not stale.exists()
        assert cli.main(["ps", "--compact"]) == 0
        assert f"{child.pid}@{port}" in capsys.readouterr().out.split()
        assert cli.main(["ps"]) == 0
        table = capsys.readouterr().out
        assert "Service ID" in table and str(port) in table
    finally:
        child.terminate()
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=10)
    assert f"{child.pid}@{port}" not in {
        s.service_id for s in process.find_aha_services()}


def _served_answer(repo, temperature=None, **kw) -> str:
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    body = {"messages": [{"role": "user", "content": "write me a poem"}],
            "model": "Qwen/Qwen3-0.6B", "max_tokens": 24}
    if temperature is not None:
        body["temperature"] = temperature
    served = load_model("Qwen/Qwen3-0.6B", repo, max_seq_len=512, **kw)
    resp = served.generate(ChatCompletionParameters.model_validate(body))
    return resp.choices[0].message.text()


@pytest.mark.parametrize("spec", [0, 4])
def test_run_answers_as_the_served_model(repo, monkeypatch, capsys, spec):
    """`run` prints the load time, the answer the served model gives the
    same chat, and the generate time; with --spec-tokens it notes the
    forced greedy sampling and answers as a greedy request."""
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    assert cli.main(["run", repo, "--input", "write me a poem",
                     "--max-tokens", "24", "--max-seq-len", "512",
                     "--spec-tokens", str(spec)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("load model use time: ")
    assert out[-1].startswith("generate use time: ")
    noted = out[1].startswith("note: --spec-tokens forces greedy")
    assert noted == (spec > 0)
    answer = "\n".join(out[1 + noted:-1])
    want = _served_answer(repo, 0.0 if spec else None, spec_tokens=spec)
    assert answer == want and answer


@pytest.mark.parametrize("family", sorted({m.family for m in model_list()}))
def test_every_registry_family_has_a_loader(family):
    """Every family of the registry is served: it has a loader, each of
    its ids' model types a `run` branch, and an OCR family its default
    prompt, the JAX CLI's."""
    from aha_tpu.cli.main import _OCR_PROMPTS as JAX_OCR_PROMPTS
    from aha_tpu_torch.models.loader import FAMILY_LOADERS

    assert family in FAMILY_LOADERS
    for m in model_list():
        if m.family != family:
            continue
        assert m.model_type in cli.RUN_TYPES
        if m.model_type == "ocr":
            assert cli._OCR_PROMPTS[family] == JAX_OCR_PROMPTS[family]


def test_run_transcribes_an_asr_models_input(tmp_path, monkeypatch, capsys):
    """`run` of an ASR id (the tiny Qwen3-ASR repo of tests/test_asr.py)
    sends the first --input as an audio_url and prints the reply the
    served model gives that request, as the JAX CLI's `run` does."""
    import numpy as np

    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters
    from aha_tpu_torch.utils.audio import save_wav
    from tests.test_asr import build_tiny_asr_repo

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    model_id = "Qwen/Qwen3-ASR-0.6B"
    asr = str(tmp_path / "asr")
    build_tiny_asr_repo(asr)
    wav = str(tmp_path / "a.wav")
    t = np.arange(16000) / 16000
    save_wav(wav, (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32),
             16000)
    assert cli.main(["run", asr, "--model", model_id, "--input", wav,
                     "--max-tokens", "6", "--max-seq-len", "512"]) == 0
    out = capsys.readouterr().out.rstrip("\n").split("\n")
    assert out[0].startswith("load model use time: ")
    assert out[-1].startswith("generate use time: ")
    want = load_model(model_id, asr, max_seq_len=512).generate(
        ChatCompletionParameters.model_validate({
            "messages": [{"role": "user", "content": [
                {"type": "audio_url", "audio_url": {"url": f"file://{wav}"}}]}],
            "model": model_id, "max_tokens": 6}))
    assert "\n".join(out[1:-1]) == want.choices[0].message.text()


def test_run_prints_an_embedding_models_vectors(repo, monkeypatch, capsys):
    """`run` of an embedding model prints each input's dimension and
    leading values (file:// inputs read as text), as the served model
    computes them."""
    from aha_tpu_torch.models.loader import load_model

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    text_file = Path(repo) / "doc.txt"
    text_file.write_text("the quick brown fox")
    inputs = ["hello world", f"file://{text_file}"]
    assert cli.main(["run", repo, "--model", "Qwen/Qwen3-Embedding-0.6B",
                     "--input", inputs[0], "--input", inputs[1]]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("load model use time: ")
    assert out[-1].startswith("generate use time: ")
    want = load_model("Qwen/Qwen3-Embedding-0.6B", repo).embedding(
        ["hello world", "the quick brown fox"])
    assert out[1:-1] == [f"embedding dim 64: {v[:8]}..." for v in want]


def test_run_ranks_a_rerankers_documents(repo, monkeypatch, capsys):
    """`run` of a reranker: the query, then the documents, printed best
    first with their scores; fewer than two inputs are refused."""
    from aha_tpu_torch.models.loader import load_model

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    mid = "Qwen/Qwen3-Reranker-0.6B"
    query, docs = "hello world", ["the lazy dog", "hello", "quick brown fox"]
    args = ["run", repo, "--model", mid, "--input", query]
    assert cli.main(args) == 1
    assert "reranker needs --input query" in capsys.readouterr().out
    for d in docs:
        args += ["--input", d]
    assert cli.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    scores = load_model(mid, repo).rerank(query, docs)
    order = sorted(range(3), key=lambda i: -scores[i])
    assert out[1:-1] == [f"#{r + 1} score={scores[i]:.4f}  {docs[i]}"
                         for r, i in enumerate(order)]


def test_run_reads_a_deepseek_ocr_page_with_the_family_prompt(
        tmp_path, monkeypatch, capsys):
    """`run` of a DeepSeek-OCR id (the tiny repo of tests/fixtures.py)
    answers an image with the family's default prompt, the JAX CLI's
    "<image>\\nConvert the document to markdown. ", as the served model
    answers that request."""
    import base64

    from aha_tpu.cli.main import _OCR_PROMPTS as JAX_OCR_PROMPTS
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters
    from tests.fixtures import build_tiny_deepseek_ocr_repo
    from tests.vision_chat import png_data_url

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    model_id = "deepseek-ai/DeepSeek-OCR"
    prompt = cli._OCR_PROMPTS["deepseek_ocr"]
    assert prompt == JAX_OCR_PROMPTS["deepseek_ocr"]
    repo = str(tmp_path / "dsocr")
    build_tiny_deepseek_ocr_repo(repo)
    path = tmp_path / "page.png"
    path.write_bytes(base64.b64decode(png_data_url(96, 64, seed=9)
                                      .split(",")[1]))
    assert cli.main(["run", repo, "--model", model_id, "--input", str(path),
                     "--max-tokens", "6", "--max-seq-len", "4096"]) == 0
    # a seeded reply may hold any character: split at newlines only
    out = capsys.readouterr().out.rstrip("\n").split("\n")
    assert out[0].startswith("load model use time: ")
    assert out[-1].startswith("generate use time: ")
    want = load_model(model_id, repo, max_seq_len=4096).generate(
        ChatCompletionParameters.model_validate({
            "messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": f"file://{path}"}},
                {"type": "text", "text": prompt}]}],
            "model": model_id, "max_tokens": 6}))
    assert "\n".join(out[1:-1]) == want.choices[0].message.text()


#: options whose defaults differ on purpose: the port's positional is a
#: path or an id (`path`, with `--model`)
_NOT_COMPARED = {"command", "model", "path"}


@pytest.mark.parametrize("argv", [
    ["download", "Qwen/Qwen3-0.6B"],
    ["cli", "Qwen/Qwen3-0.6B"],
    ["serv", "Qwen/Qwen3-0.6B"],
    ["serv", "--manage-only"],
    ["run", "Qwen/Qwen3-0.6B", "--input", "hi"],
])
def test_options_take_the_jax_parsers_defaults(argv):
    """Every option the port's subcommand shares with the JAX CLI's parses
    to the same default, and the JAX CLI's options of `download`, `cli`
    and `serv` all exist in the port (`serv`'s --eager is the port's
    own)."""
    t = vars(cli.build_parser().parse_args(argv))
    j = vars(jbuild_parser().parse_args(argv))
    shared = (t.keys() & j.keys()) - _NOT_COMPARED
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    if argv[0] != "run":
        assert j.keys() - _NOT_COMPARED <= t.keys(), \
            j.keys() - _NOT_COMPARED - t.keys()


def test_serv_needs_a_model_or_manage_only():
    """`serv` with neither a path nor --manage-only is refused with the
    JAX CLI's words, before anything loads."""
    from aha_tpu.cli.main import main as jmain

    with pytest.raises(SystemExit) as got:
        cli.main(["serv"])
    with pytest.raises(SystemExit) as want:
        jmain(["serv"])
    assert str(got.value) == str(want.value) == cli.SERV_NEEDS_MODEL


@pytest.mark.parametrize("argv,refusal,cards", [
    (["serv", "{repo}", "--tp", "2", "--dp", "2", "--batch-slots", "4"],
     "TP_WITH_DP", None),
    (["cli", "{repo}", "--tp", "4"], "needs 4 cards", 1),
    (["run", "{repo}", "--input", "hi", "--tp", "2", "--model",
      "LiquidAI/LFM2-1.2B"], "sharding of 'lfm2' is not ported", None),
    (["serv", "{repo}", "--dp", "2"], "--dp shards continuous-batching",
     None),
    (["serv", "{repo}", "--dp", "2", "--batch-slots", "3"],
     "must be a multiple of --dp 2", None),
    (["serv", "{repo}", "--dp", "2", "--batch-slots", "4"],
     "needs 2 cards", 1),
])
def test_tp_and_dp_are_refused_before_loading(repo, monkeypatch, argv,
                                              refusal, cards):
    """What the port does not take is refused before any family loader
    runs: --tp with --dp, --tp on a family whose sharding is not ported,
    --dp against the slots (the reference's words), and a host with fewer
    cards than --tp or --dp asks for (`cards` patches the count; None runs
    on the CPU)."""
    from aha_tpu_torch.models import loader, text_served

    if cards is None:
        monkeypatch.setenv("AHA_DEVICE", "cpu")
    else:
        monkeypatch.delenv("AHA_DEVICE", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(loader, "FAMILY_LOADERS", {})
    with pytest.raises(ValueError) as got:
        cli.main([a.format(repo=repo) for a in argv])
    refusal = getattr(text_served, refusal, refusal)
    want = getattr(loader, refusal, refusal)
    assert want in str(got.value)


@pytest.mark.parametrize("model_type,want", [
    (None, "Qwen/Qwen3-0.6B"),
    ("qwen3", "Qwen/Qwen3-0.6B"),
    ("qwen2_5_vl", "Qwen/Qwen2.5-VL-3B-Instruct"),
    ("lfm2-vl", "LiquidAI/LFM2-VL-1.6B"),
    ("bert", "sentence-transformers/all-MiniLM-L6-v2"),
    ("minicpm", SystemExit),
    ("qwen3_5_text", SystemExit),
    ("deepseek_vl_v2", SystemExit),
    ("glm_ocr", SystemExit),
])
def test_model_id_for_maps_or_refuses_a_model_type(tmp_path, model_type,
                                                   want):
    """A directory served without --model: no model_type or qwen3 keeps
    the default id, a type of MODEL_TYPES maps to its one id, any other
    type is refused, naming it and asking for --model; a named --model
    always wins."""
    cfg = {} if model_type is None else {"model_type": model_type}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    if want is SystemExit:
        with pytest.raises(SystemExit) as got:
            cli.model_id_for(str(tmp_path), cli.DEFAULT_MODEL)
        assert repr(model_type) in str(got.value)
        assert "--model" in str(got.value)
    else:
        assert cli.model_id_for(str(tmp_path), cli.DEFAULT_MODEL) == want
    assert cli.model_id_for(str(tmp_path), "OpenBMB/MiniCPM4-0.5B") == \
        "OpenBMB/MiniCPM4-0.5B"


def test_every_model_type_maps_to_one_registry_id():
    """Each MODEL_TYPES entry names an id of the registry."""
    from aha_tpu_torch.registry import lookup

    for model_type, model_id in cli.MODEL_TYPES.items():
        assert lookup(model_id).model_id == model_id, model_type


def test_serv_of_an_unknown_model_type_loads_nothing(tmp_path, monkeypatch):
    """`serv <dir>` of a MiniCPM checkpoint without --model: refused before
    any loader runs (it was loaded as Qwen3-0.6B)."""
    from aha_tpu_torch.models import loader

    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "minicpm"}))
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.setattr(loader, "FAMILY_LOADERS", {})
    with pytest.raises(SystemExit, match="'minicpm'"):
        cli.main(["serv", str(tmp_path)])
