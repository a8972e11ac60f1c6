"""`python -m aha_tpu_torch serv <path>`: serve a Qwen3 chat checkpoint
on the port (counterpart of `aha serv`, aha_tpu/cli/main.py).
`--batch-slots N` serves N chats at once through the continuous-batching
engine; `AHA_KV_INT8=1` stores the KV cache in int8."""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m aha_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serv", help="serve a local Qwen3 chat checkpoint")
    s.add_argument("path", help="model directory (config.json, tokenizer, "
                                "*.safetensors)")
    s.add_argument("--model", default="Qwen/Qwen3-0.6B",
                   help="registry id the checkpoint is served as")
    s.add_argument("--address", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-seq-len", type=int, default=8192)
    s.add_argument("--batch-slots", type=int, default=1,
                   help="continuous batching: decode up to N chat requests "
                        "together in one batched step (text models)")
    s.add_argument("--prefix-cache", type=int, default=4,
                   help="prompt-prefix KV cache entries (0 disables)")
    s.add_argument("--allow-remote-shutdown", action="store_true")
    s.add_argument("--api-key", help="require 'Authorization: Bearer <key>' "
                                     "(env AHA_API_KEY also works)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # aha_tpu's package __init__ imports jax for its compile cache unless
    # this is set; the port reuses only its jax-free host modules
    os.environ.setdefault("AHA_NO_COMPILE_CACHE", "1")
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.server.app import ServerState, start_http_server

    t0 = time.perf_counter()
    model = load_model(args.model, args.path, max_seq_len=args.max_seq_len,
                       prefix_cache=args.prefix_cache,
                       batch_slots=args.batch_slots)
    print(f"model loaded in {time.perf_counter() - t0:.1f}s on "
          f"{model.engine.device}", flush=True)
    state = ServerState(model=model,
                        allow_remote_shutdown=args.allow_remote_shutdown,
                        port=args.port,
                        api_key=args.api_key or os.environ.get("AHA_API_KEY"))
    start_http_server(state, address=args.address, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
