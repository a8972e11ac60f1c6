"""Chat template rendering with Jinja2 (the port's copy of
aha_tpu/core/chat_template.py).

Equivalent of src/chat_template/mod.rs: discovery order is
tokenizer_config.json `chat_template` → chat_template.json →
chat_template.jinja (:178-223).  The reference rewrites Python-isms for
minijinja (`fix_template`, :148-176); real Jinja2 supports them natively so
no fix-ups are needed — we only reproduce the custom `tojson`/`split`
filters and render with add_generation_prompt=true (:282-301).
"""

from __future__ import annotations

import json
import os
from typing import Any

import jinja2


def _make_env() -> jinja2.Environment:
    env = jinja2.Environment(
        loader=jinja2.BaseLoader(),
        trim_blocks=True,
        lstrip_blocks=True,
        extensions=["jinja2.ext.loopcontrols"],
    )
    env.filters["tojson"] = lambda v, **kw: json.dumps(v, ensure_ascii=False, **kw)
    env.filters["split"] = lambda s, sep=None: s.split(sep)
    env.filters["string"] = str
    env.globals["raise_exception"] = _raise_exception
    return env


def _raise_exception(msg: str):
    raise jinja2.TemplateError(msg)


def discover_template(model_dir: str) -> str | None:
    cfg_path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        tpl = cfg.get("chat_template")
        if isinstance(tpl, str):
            return tpl
        if isinstance(tpl, list):  # named templates; take "default"
            for item in tpl:
                if item.get("name") == "default":
                    return item.get("template")
    json_path = os.path.join(model_dir, "chat_template.json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            return json.load(f).get("chat_template")
    jinja_path = os.path.join(model_dir, "chat_template.jinja")
    if os.path.exists(jinja_path):
        with open(jinja_path) as f:
            return f.read()
    return None


class ChatTemplate:
    def __init__(self, template: str):
        self.source = template
        self.template = _make_env().from_string(template)

    @classmethod
    def init(cls, model_dir: str) -> "ChatTemplate":
        tpl = discover_template(model_dir)
        if tpl is None:
            raise FileNotFoundError(f"no chat template found in {model_dir}")
        return cls(tpl)

    @classmethod
    def str_init(cls, template: str) -> "ChatTemplate":
        return cls(template)

    def apply(self, messages: list[dict[str, Any]],
              add_generation_prompt: bool = True,
              enable_thinking: bool | None = None,
              tools: list[dict] | None = None,
              **extra) -> str:
        ctx: dict[str, Any] = {
            "messages": messages,
            "add_generation_prompt": add_generation_prompt,
            **extra,
        }
        if enable_thinking is not None:
            ctx["enable_thinking"] = enable_thinking
        if tools is not None:
            ctx["tools"] = tools
        return self.template.render(**ctx)
