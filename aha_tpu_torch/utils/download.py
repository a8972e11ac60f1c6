"""ModelScope model downloader (the port's copy of
aha_tpu/utils/download.py, on the standard library's urllib).

The same calls: the file list at `MODELSCOPE_API/{id}/repo/files`
(Recursive, Revision), then one streamed `GET .../repo?Revision=&FilePath=`
per file, written to `<dest>.part` and moved into place; a file whose size
already matches is skipped; 3 attempts with a 2 s wait; the weights land
in <save_dir>/<model_id>/ (default ~/.aha).
"""

from __future__ import annotations

import json
import os
import time
import urllib.parse
import urllib.request

MODELSCOPE_API = "https://modelscope.cn/api/v1/models"
CHUNK = 1 << 20


def _get(url: str, params: dict, timeout: float):
    """An open response to GET `url?params`; an HTTP error status raises
    (urllib.error.HTTPError)."""
    return urllib.request.urlopen(
        f"{url}?{urllib.parse.urlencode(params)}", timeout=timeout)


def list_repo_files(model_id: str, revision: str = "master") -> list[dict]:
    with _get(f"{MODELSCOPE_API}/{model_id}/repo/files",
              {"Recursive": "true", "Revision": revision}, 30) as r:
        body = json.loads(r.read())
    if body.get("Code") != 200:
        raise RuntimeError(f"modelscope list files failed: {body.get('Message')}")
    return [f for f in body["Data"]["Files"] if f.get("Type") != "tree"]


def download_file(model_id: str, file_path: str, dest: str,
                  revision: str = "master", progress=None) -> None:
    """`progress(n_bytes)` is called per received chunk."""
    with _get(f"{MODELSCOPE_API}/{model_id}/repo",
              {"Revision": revision, "FilePath": file_path}, 60) as r:
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = dest + ".part"
        with open(tmp, "wb") as f:
            while chunk := r.read(CHUNK):
                f.write(chunk)
                if progress is not None:
                    progress(len(chunk))
        os.replace(tmp, dest)


def download_model_once(model_id: str, save_dir: str, progress=None) -> None:
    """`progress(event: dict)` receives {"files_total", "bytes_total"} once,
    then {"file": rel} per file start and {"bytes": n} per chunk; a file
    already present at its listed size gives {"file": rel, "bytes": size}
    and is not fetched."""
    target = os.path.join(save_dir, model_id)
    files = list_repo_files(model_id)
    if progress is not None:
        progress({"files_total": len(files),
                  "bytes_total": sum(int(f.get("Size") or 0) for f in files)})
    for info in files:
        rel = info["Path"]
        dest = os.path.join(target, rel)
        if os.path.exists(dest) and info.get("Size") == os.path.getsize(dest):
            if progress is not None:
                progress({"file": rel, "bytes": int(info.get("Size") or 0)})
            continue
        print(f"downloading {model_id}/{rel}")
        if progress is not None:
            progress({"file": rel})
        download_file(model_id, rel, dest,
                      progress=(None if progress is None
                                else lambda n: progress({"bytes": n})))


def download_model(model_id: str, save_dir: str, max_retries: int = 3,
                   progress=None) -> None:
    attempts = 0
    while True:
        attempts += 1
        print(f"Attempting to download model (attempt {attempts}/{max_retries})")
        try:
            download_model_once(model_id, save_dir, progress=progress)
            print("Model downloaded successfully")
            return
        except Exception as e:  # noqa: BLE001 — retry any transport error
            if attempts >= max_retries:
                raise RuntimeError(
                    f"Failed to download model after {max_retries} attempts. "
                    f"Last error: {e}") from e
            print(f"Download failed (attempt {attempts}): {e}. "
                  f"Retrying in 2 seconds...")
            time.sleep(2)


def is_model_downloaded(model_id: str, save_dir: str) -> bool:
    d = os.path.join(save_dir, model_id)
    return os.path.isdir(d) and bool(os.listdir(d))
