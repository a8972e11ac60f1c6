"""`python -m aha_tpu_torch <command>`: the port's CLI (counterpart of
`aha`, aha_tpu/cli/main.py), for the model families the port serves.

- `serv <path>`: serve a local checkpoint as the registry id --model
  names: Qwen3 or MiniCPM4/5 chat, Qwen2.5-VL image chat, or a Qwen3
  embedding / reranker or all-MiniLM-L6-v2 model behind /v1/embeddings
  and /v1/rerank.  A directory whose config.json has a model_type of
  MODEL_TYPES (qwen2_5_vl, qwen3_vl, paddleocr_vl, lfm2_vl) is served as
  that type's id unless --model names another.
  `--batch-slots N` serves N chats at once through the continuous-batching
  engine; `--spec-tokens N` drafts N tokens a speculative round on the
  single-stream engine (greedy requests); `AHA_KV_INT8=1` stores the KV
  cache in int8.
- `run <path> --input ...`: one chat from the command line (text, or for
  a vlm a prompt and an image, or for an OCR model an image and an
  optional prompt, the family's task prompt by default, or for an ASR
  model an audio file, whose transcript is printed), the vectors of
  an embedding model's inputs, or a reranker's ranking of `--input query
  --input doc ...`, with the load and generate times; a tts model's speech
  of the first input as a WAV (`--output`, default voxcpm_<time>.wav), an
  image model's background removal of each input as a PNG (`--output`,
  default output.png; <base>_<i>.png for several).
- `list [--json]`, `delete <model>`, `ps [--compact]`: the registry with
  the downloaded mark, a downloaded model's removal, the running servers.

The paths are given, never fetched: `download` and `cli` stay with the JAX
package's CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

from aha_tpu_torch import registry
from aha_tpu_torch.utils.device import default_save_dir

DEFAULT_MODEL = "Qwen/Qwen3-0.6B"
#: config.json model_type → the id a directory is served as by default
MODEL_TYPES = {"qwen2_5_vl": "Qwen/Qwen2.5-VL-3B-Instruct",
               "qwen3_vl": "Qwen/Qwen3-VL-8B-Instruct",
               "paddleocr_vl": "PaddlePaddle/PaddleOCR-VL",
               # transformers registers lfm2_vl; its config class writes
               # lfm2-vl into a saved config.json
               "lfm2_vl": "LiquidAI/LFM2-VL-1.6B",
               "lfm2-vl": "LiquidAI/LFM2-VL-1.6B"}
#: family → default OCR instruction (the JAX CLI's); each OCR family
#: adds its own as it is ported
_OCR_PROMPTS = {"paddleocr_vl": "OCR:",
                "deepseek_ocr": "<image>\nConvert the document to markdown. "}


def model_id_for(path: str, model: str) -> str:
    """`model`, or for the default id the one the directory's config.json
    model_type names."""
    cfg = os.path.join(path, "config.json")
    if model != DEFAULT_MODEL or not os.path.exists(cfg):
        return model
    with open(cfg) as f:
        return MODEL_TYPES.get(json.load(f).get("model_type"), model)


def _add_model_path(p: argparse.ArgumentParser) -> None:
    p.add_argument("path", help="model directory (config.json, tokenizer, "
                                "*.safetensors)")
    p.add_argument("--model", default=DEFAULT_MODEL,
                   help="registry id the checkpoint is served as")
    p.add_argument("--max-seq-len", type=int, default=8192)
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="speculative decoding: draft up to N tokens a round "
                        "by prompt lookup and verify them in one forward; "
                        "greedy requests stream output identical to plain "
                        "decoding.  Models with a pure K/V cache only; 0 "
                        "disables")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m aha_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("list", help="list supported models")
    p.add_argument("--json", action="store_true", help="JSON output")

    p = sub.add_parser("delete", help="delete a downloaded model")
    p.add_argument("model", help="model id")
    p.add_argument("--save-dir", help="model root (default ~/.aha)")
    p.add_argument("-y", "--yes", action="store_true",
                   help="skip confirmation")

    p = sub.add_parser("ps", help="list running servers")
    p.add_argument("--compact", action="store_true")

    s = sub.add_parser("serv", help="serve a local checkpoint")
    _add_model_path(s)
    s.add_argument("--address", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--batch-slots", type=int, default=1,
                   help="continuous batching: decode up to N chat requests "
                        "together in one batched step (text models)")
    s.add_argument("--prefix-cache", type=int, default=4,
                   help="prompt-prefix KV cache entries (0 disables)")
    s.add_argument("--eager", action="store_true",
                   help="run decode blocks eagerly instead of replaying "
                        "captured CUDA graphs")
    s.add_argument("--allow-remote-shutdown", action="store_true")
    s.add_argument("--api-key", help="require 'Authorization: Bearer <key>' "
                                     "(env AHA_API_KEY also works)")

    r = sub.add_parser("run", help="one chat from the command line")
    _add_model_path(r)
    r.add_argument("--input", required=True, action="append",
                   help="repeatable: the prompt (text, or file:// text), "
                        "then for a vlm the image (path or URL); for an "
                        "OCR model the image, then an optional prompt; for "
                        "an ASR model the audio (path or URL); an "
                        "embedding model's texts; a reranker's query, "
                        "then its documents")
    r.add_argument("--max-tokens", type=int, default=1024)
    r.add_argument("--output", help="output file (audio/image models)")
    return ap


def is_model_downloaded(model_id: str, save_dir: str) -> bool:
    d = os.path.join(save_dir, model_id)
    return os.path.isdir(d) and bool(os.listdir(d))


def run_list(args) -> int:
    save = default_save_dir()
    models = registry.model_list()
    if args.json:
        print(json.dumps([{
            "model_id": m.model_id,
            "owner": m.owner,
            "model_type": m.model_type,
            "downloaded": is_model_downloaded(m.model_id, save),
        } for m in models], indent=2))
        return 0
    print("Available models:")
    print()
    print(f"{'Model ID':<40} {'Owner':<20} {'type':<10} {'Download':<10}")
    print("-" * 80)
    for m in models:
        mark = "  ✔" if is_model_downloaded(m.model_id, save) else ""
        print(f"{m.model_id:<40} {m.owner:<20} {m.model_type:<10} {mark:<10}")
    return 0


def run_delete(args) -> int:
    registry.lookup(args.model)
    target = os.path.join(args.save_dir or default_save_dir(), args.model)
    if not os.path.isdir(target):
        print(f"model {args.model} is not downloaded ({target})")
        return 1
    if not args.yes:
        answer = input(f"Delete {target}? [y/N] ").strip().lower()
        if answer not in ("y", "yes"):
            print("aborted")
            return 1
    shutil.rmtree(target)
    print(f"deleted {target}")
    return 0


def run_ps(args) -> int:
    from aha_tpu_torch.server.process import find_aha_services

    services = find_aha_services()
    if not services:
        print("No aha services found running.")
        return 0
    if args.compact:
        for svc in services:
            print(svc.service_id)
        return 0
    print(f"{'Service ID':<20} {'PID':<10} {'Model':<20} {'Port':<10} "
          f"{'Address':<15} {'Status':<10}")
    print("-" * 85)
    for svc in services:
        print(f"{svc.service_id:<20} {svc.pid:<10} {svc.model or 'N/A':<20} "
              f"{svc.port:<10} {svc.address:<15} "
              f"{svc.status.capitalize():<10}")
    return 0


def _load(args, **kw):
    from aha_tpu_torch.models.loader import load_model

    return load_model(model_id_for(args.path, args.model), args.path,
                      max_seq_len=args.max_seq_len,
                      spec_tokens=args.spec_tokens, **kw)


def run_serv(args) -> int:
    from aha_tpu_torch.server.app import ServerState, start_http_server
    from aha_tpu_torch.utils.device import device

    t0 = time.perf_counter()
    model = _load(args, prefix_cache=args.prefix_cache,
                  batch_slots=args.batch_slots, cuda_graphs=not args.eager)
    print(f"model loaded in {time.perf_counter() - t0:.1f}s on "
          f"{device()}", flush=True)
    state = ServerState(model=model,
                        allow_remote_shutdown=args.allow_remote_shutdown,
                        port=args.port,
                        api_key=args.api_key or os.environ.get("AHA_API_KEY"))
    start_http_server(state, address=args.address, port=args.port)
    return 0


def _as_url(s: str) -> str:
    """Bare paths become file:// URLs."""
    if s.startswith(("http://", "https://", "file://", "data:")):
        return s
    return f"file://{os.path.abspath(s)}"


def _maybe_file_text(s: str) -> str:
    """A file:// input is read as text."""
    if s.startswith("file://"):
        with open(s[7:]) as f:
            return f.read()
    return s


def _chat_req(model_id: str, content, max_tokens: int, greedy: bool):
    from aha_tpu_torch.params import ChatCompletionParameters

    body = {"messages": [{"role": "user", "content": content}],
            "model": model_id, "max_tokens": max_tokens}
    if greedy:
        # speculation engages on greedy requests only: without this a
        # generation_config with temperature > 0 would never speculate
        body["temperature"] = 0.0
    return ChatCompletionParameters.model_validate(body)


def run_run(args) -> int:
    """One request, printing the model-load and generate wall times as
    the JAX CLI's `run` does: text chat (llm), image chat (vlm), an OCR
    model's reading of an image (ocr), an ASR model's transcript of the
    first input as an audio_url (asr), an embedding model's vectors, a
    reranker's ranking, a tts model's WAV, an image model's PNGs."""
    model_id = model_id_for(args.path, args.model)
    entry = registry.lookup(model_id)
    mt = entry.model_type
    if mt not in ("llm", "vlm", "ocr", "asr", "embedding", "reranker", "tts",
                  "image"):
        raise NotImplementedError(
            f"`run` of a {mt} model is not ported to aha_tpu_torch yet")
    inputs: list[str] = args.input
    if mt == "vlm" and len(inputs) < 2:
        print(f"{model_id} needs --input <prompt> --input <image>")
        return 1
    if mt == "reranker" and len(inputs) < 2:
        print("reranker needs --input query --input doc [--input doc ...]")
        return 1
    t0 = time.perf_counter()
    model = _load(args)
    print(f"load model use time: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    if mt == "embedding":
        for v in model.embedding([_maybe_file_text(s) for s in inputs]):
            print(f"embedding dim {len(v)}: {v[:8]}...")
    elif mt == "reranker":
        scores = model.rerank(inputs[0], inputs[1:])
        order = sorted(range(len(scores)), key=lambda i: -scores[i])
        for rank, i in enumerate(order):
            print(f"#{rank + 1} score={scores[i]:.4f}  {inputs[i + 1][:70]}")
    elif mt == "tts":
        from aha_tpu_torch.utils.audio import save_wav

        wav = model.synthesize(_maybe_file_text(inputs[0]))
        out = args.output or f"voxcpm_{int(time.time())}.wav"
        save_wav(out, wav, model.vae.out_sample_rate)
        print(f"Output saved to: {out}")
    elif mt == "image":
        pngs = model.remove_background([_as_url(s) for s in inputs])
        base = args.output or "output.png"
        for i, png in enumerate(pngs):
            dest = base if len(pngs) == 1 else \
                f"{base[:-4] if base.endswith('.png') else base}_{i}.png"
            with open(dest, "wb") as f:
                f.write(png)
            print(f"Output saved to: {dest}")
    if mt in ("embedding", "reranker", "tts", "image"):
        print(f"generate use time: {time.perf_counter() - t0:.2f}s")
        return 0
    greedy = False
    if mt == "vlm":
        content = [{"type": "image_url",
                    "image_url": {"url": _as_url(inputs[1])}},
                   {"type": "text", "text": _maybe_file_text(inputs[0])}]
    elif mt == "ocr":
        prompt = (_maybe_file_text(inputs[1]) if len(inputs) > 1
                  else _OCR_PROMPTS[entry.family])
        content = [{"type": "image_url",
                    "image_url": {"url": _as_url(inputs[0])}},
                   {"type": "text", "text": prompt}]
    elif mt == "asr":
        content = [{"type": "audio_url",
                    "audio_url": {"url": _as_url(inputs[0])}}]
    else:
        content = _maybe_file_text(inputs[0])
        if args.spec_tokens > 0:
            greedy = True
            print("note: --spec-tokens forces greedy sampling "
                  "(speculation is exact only for greedy decoding)")
    resp = model.generate(_chat_req(model_id, content, args.max_tokens,
                                    greedy))
    print(resp.choices[0].message.text() if resp.choices else "")
    print(f"generate use time: {time.perf_counter() - t0:.2f}s")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return {"list": run_list, "delete": run_delete, "ps": run_ps,
            "serv": run_serv, "run": run_run}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
