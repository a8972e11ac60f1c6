"""The port's ModelScope downloader (aha_tpu_torch/utils/download.py, on
urllib) against the JAX package's (aha_tpu/utils/download.py, on
requests): both fetch from one local stub (tests/modelscope_stub.py) with
their MODELSCOPE_API pointed at it, and must make the same requests, write
the same tree, report the same progress events, skip the same files and
retry as often, with the same final error.  Then the CLI's `download`
and `cli` on the stub.  Nothing here leaves 127.0.0.1."""

import os
import time

import pytest

import aha_tpu.utils.download as jdl
from aha_tpu_torch import cli
from aha_tpu_torch.utils import download as dl
from tests.fixtures import build_tiny_qwen3_repo
from tests.modelscope_stub import ModelScopeStub

MODEL = "Qwen/Qwen3-0.6B"
PACKAGES = {"torch": dl, "jax": jdl}


@pytest.fixture(autouse=True)
def no_proxy(monkeypatch):
    """The stub is local: no proxy setting may route a request elsewhere."""
    for k in ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY",
              "HTTPS_PROXY", "ALL_PROXY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """The tiny Qwen3 repo with a nested file (a recursive listing)."""
    path = tmp_path_factory.mktemp("ms_repo")
    build_tiny_qwen3_repo(str(path))
    (path / "sub").mkdir()
    (path / "sub" / "notes.txt").write_bytes(b"nested file\n" * 100)
    return str(path)


@pytest.fixture
def sleeps(monkeypatch):
    """time.sleep recorded, not slept (the downloaders wait 2 s a retry)."""
    calls = []
    monkeypatch.setattr(time, "sleep", calls.append)
    return calls


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _fetch(name, stub, save, monkeypatch, capsys, **kw):
    """One package's download_model against `stub`: (events, printed
    lines, the stub's requests, the exception or None)."""
    mod = PACKAGES[name]
    monkeypatch.setattr(mod, "MODELSCOPE_API", stub.api)
    stub.requests.clear()
    events, err = [], None
    try:
        mod.download_model(MODEL, str(save), progress=events.append, **kw)
    except RuntimeError as e:
        err = e
    return events, capsys.readouterr().out.splitlines(), \
        list(stub.requests), err


def test_same_requests_tree_and_progress(repo, tmp_path, monkeypatch,
                                         capsys):
    with ModelScopeStub({MODEL: repo}) as stub:
        got = {n: _fetch(n, stub, tmp_path / n, monkeypatch, capsys)
               for n in PACKAGES}
    for name in PACKAGES:
        assert got[name][3] is None
        assert _tree(tmp_path / name / MODEL) == _tree(repo), name
    t, j = got["torch"], got["jax"]
    assert t[0] == j[0]                       # progress events, in order
    assert t[1] == j[1]                       # printed lines
    assert t[2] == j[2]                       # the same ModelScope calls
    assert t[2][0] == (f"/api/v1/models/{MODEL}/repo/files",
                       {"Recursive": "true", "Revision": "master"})
    files = [q["FilePath"] for p, q in t[2][1:]]
    assert sorted(files) == sorted(_tree(repo))
    assert "sub/notes.txt" in files
    total = sum(len(b) for b in _tree(repo).values())
    assert t[0][0] == {"files_total": len(files), "bytes_total": total}
    assert sum(e.get("bytes", 0) for e in t[0]) == total
    assert not list((tmp_path / "torch").rglob("*.part"))


def test_skips_files_already_present(repo, tmp_path, monkeypatch, capsys):
    """A file whose size matches the listing is not fetched (one event
    with its size); one of another size is fetched again."""
    keep, stale = "config.json", "sub/notes.txt"
    for name in PACKAGES:
        target = tmp_path / name / MODEL
        (target / "sub").mkdir(parents=True)
        (target / keep).write_bytes(open(os.path.join(repo, keep),
                                         "rb").read())
        (target / stale).write_bytes(b"short")
    with ModelScopeStub({MODEL: repo}) as stub:
        got = {n: _fetch(n, stub, tmp_path / n, monkeypatch, capsys)
               for n in PACKAGES}
    t, j = got["torch"], got["jax"]
    assert t[0] == j[0] and t[2] == j[2] and t[1] == j[1]
    fetched = [q["FilePath"] for _, q in t[2][1:]]
    assert keep not in fetched and stale in fetched
    size = os.path.getsize(os.path.join(repo, keep))
    assert {"file": keep, "bytes": size} in t[0]
    assert _tree(tmp_path / "torch" / MODEL) == _tree(repo)


@pytest.mark.parametrize("fail", ["json", "http"])
def test_retries_then_the_same_final_error(repo, tmp_path, monkeypatch,
                                           capsys, sleeps, fail):
    """A stub whose listing fails every time: 3 attempts, 2 s apart, then
    RuntimeError; a ModelScope error body gives the same message word for
    word, an HTTP 500 the same message up to the transport's own words."""
    with ModelScopeStub({MODEL: repo}, fail=fail) as stub:
        got = {}
        for n in PACKAGES:
            sleeps.clear()
            got[n] = (*_fetch(n, stub, tmp_path / n, monkeypatch, capsys),
                      list(sleeps))
    t, j = got["torch"], got["jax"]
    for name, g in got.items():
        assert len(g[2]) == 3, name               # one listing an attempt
        assert g[4] == [2, 2], name
        assert isinstance(g[3], RuntimeError), name
        assert str(g[3]).startswith("Failed to download model after 3 "
                                    "attempts. Last error: "), name
        assert [ln for ln in g[1] if ln.startswith("Attempting")] == [
            f"Attempting to download model (attempt {i}/3)"
            for i in (1, 2, 3)]
    assert t[2] == j[2]
    if fail == "json":
        assert str(t[3]) == str(j[3]) == (
            "Failed to download model after 3 attempts. Last error: "
            "modelscope list files failed: stub failure")
        assert t[1] == j[1]
    else:
        assert "500" in str(t[3]) and "500" in str(j[3])
    assert not (tmp_path / "torch" / MODEL).exists()


def test_a_failed_file_is_retried(repo, tmp_path, monkeypatch, capsys,
                                  sleeps):
    """A file whose first fetch fails: the attempt fails, the second one
    skips what is already there and completes the tree, in both."""
    got = {}
    for n in PACKAGES:
        with ModelScopeStub({MODEL: repo}, flaky=("tokenizer.json",)) as stub:
            got[n] = _fetch(n, stub, tmp_path / n, monkeypatch, capsys)
    t, j = got["torch"], got["jax"]
    assert t[3] is None and j[3] is None
    assert t[0] == j[0] and t[2] == j[2]
    assert sum(1 for p, _ in t[2] if p.endswith("/repo/files")) == 2
    assert sum(1 for e in t[0] if "files_total" in e) == 2
    assert _tree(tmp_path / "torch" / MODEL) == _tree(repo)
    assert sleeps == [2, 2]


def test_is_model_downloaded_matches(tmp_path):
    (tmp_path / "Qwen" / "Qwen3-1.7B").mkdir(parents=True)
    d = tmp_path / "Qwen" / "Qwen3-0.6B"
    d.mkdir(parents=True)
    (d / "config.json").write_text("{}")
    for mid in (MODEL, "Qwen/Qwen3-1.7B", "Qwen/Qwen3-4B"):
        assert dl.is_model_downloaded(mid, str(tmp_path)) == \
            jdl.is_model_downloaded(mid, str(tmp_path))
    assert dl.is_model_downloaded(MODEL, str(tmp_path))


def test_cli_download_fetches_into_the_save_dir(repo, tmp_path, monkeypatch,
                                                capsys):
    """`download <id> --save-dir D` writes the id's tree under D; an id
    outside the registry is refused before any request."""
    with ModelScopeStub({MODEL: repo}) as stub:
        monkeypatch.setattr(dl, "MODELSCOPE_API", stub.api)
        assert cli.main(["download", MODEL, "--save-dir",
                         str(tmp_path)]) == 0
        assert _tree(tmp_path / MODEL) == _tree(repo)
        assert "Model downloaded successfully" in capsys.readouterr().out
        n = len(stub.requests)
        with pytest.raises(KeyError):
            cli.main(["download", "no/such-model"])
        assert len(stub.requests) == n


def test_cli_downloads_then_serves(repo, tmp_path, monkeypatch):
    """`cli <id>`: the id is not under the save directory, so it is
    fetched into --save-dir, loaded from there and served (the blocking
    server start replaced by a recorder); a second `cli` finds it and
    makes no request."""
    from aha_tpu_torch.server import app

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.setenv("AHA_HOME", str(tmp_path / "home"))
    served = []
    monkeypatch.setattr(app, "start_http_server",
                        lambda state, address, port: served.append(
                            (state, address, port)))
    with ModelScopeStub({MODEL: repo}) as stub:
        monkeypatch.setattr(dl, "MODELSCOPE_API", stub.api)
        assert cli.main(["cli", MODEL, "--save-dir", str(tmp_path / "home"),
                         "--port", "8123", "--max-seq-len", "256"]) == 0
        assert _tree(tmp_path / "home" / MODEL) == _tree(repo)
        n = len(stub.requests)
        assert cli.main(["cli", MODEL, "--max-seq-len", "256"]) == 0
        assert len(stub.requests) == n
    state, address, port = served[0]
    assert (address, port) == ("127.0.0.1", 8123)
    assert state.model.entry.model_id == MODEL
