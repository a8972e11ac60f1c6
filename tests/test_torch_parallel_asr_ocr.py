"""aha_tpu_torch's tensor parallelism over the ASR and OCR families
(Qwen3-ASR, Fun-ASR-Nano, GLM-ASR-Nano, PaddleOCR-VL, HunyuanOCR, GLM-OCR
and DeepSeek-OCR with its routed experts split across the ranks), against
aha_tpu's tp mesh on the JAX package's 8 virtual CPU devices.

- The port's side: its gloo ranks on the CPU, started by two child
  processes at once when the module starts (tests/parallel_asr_ocr_rank0.py,
  rank 0: it spawns the workers): `models` runs every model scenario over
  a tp 2 and (where the tiny geometry divides) a tp 4 group, `served`
  loads every served model through `load_model(..., tp=2)`.  Each test
  below asserts on one result; the tests that need no child run while the
  children work.
- The JAX side: the same numpy weights and inputs, placed by
  `shard_params` with the family's partition rules.
- Cases: each family's multimodal prefill and one decode step (the JAX
  tests' _tp_parity scenario, tests/test_parallel_families.py) within
  1e-4, 1e-3 for DeepSeek-OCR's MoE, and the value-out greedy token equal
  to the gathered logits' argmax; DeepSeek-OCR's experts split in halves
  at tp 2, and capacity drops (a planted router) equal to one device's,
  at the op and through the decoder; every served model's tp 2 greedy
  reply equal to the JAX model's; the port's sharded leaves equal to the
  JAX rules' over each family's parameter paths; the new tp refusals,
  where the JAX mesh runs the same tp by replicating.

Every child process and every request has a deadline.  float32 on the
CPU."""

import base64
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import psutil
import pytest
import torch

from aha_tpu.models import deepseek_ocr as jds
from aha_tpu.models import fun_asr_nano as jfa
from aha_tpu.models import glm_asr_nano as jga
from aha_tpu.models import glm_ocr as jgo
from aha_tpu.models import hunyuan_ocr as jhy
from aha_tpu.models import paddleocr_vl as jpv
from aha_tpu.models import qwen3_asr as jqa
from aha_tpu.models.llama import LlamaConfig as JLlamaConfig
from aha_tpu.models.qwen3 import Qwen3Config as JQwen3Config
from aha_tpu.parallel import mesh as jmesh
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import deepseek_ocr as tds
from aha_tpu_torch.models import fun_asr_nano as tfa
from aha_tpu_torch.models import glm_asr_nano as tga
from aha_tpu_torch.models import glm_ocr as tgo
from aha_tpu_torch.models import hunyuan_ocr as thy
from aha_tpu_torch.models import paddleocr_vl as tpv
from aha_tpu_torch.models import qwen3_asr as tqa
from aha_tpu_torch.models.hunyuan_ocr_served import IMAGE_TOKEN as HY_IMAGE
from aha_tpu_torch.models.llama import LlamaConfig
from aha_tpu_torch.models.qwen3 import Qwen3Config
from aha_tpu_torch.ops import moe as tmoe
from aha_tpu_torch.parallel import mesh
from tests import test_torch_deepseek_ocr as ds
from tests import test_torch_fun_asr as fa
from tests import test_torch_glm_asr as ga
from tests import test_torch_glm_ocr as go
from tests import test_torch_hunyuan_ocr as hy
from tests import test_torch_paddleocr_vl as pv
from tests import test_torch_qwen3_asr as qa
from tests.test_glm_hunyuan_ocr import _hy_params, tiny_hunyuan_config
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK0 = os.path.join(ROOT, "tests", "parallel_asr_ocr_rank0.py")
#: seconds a child may take (groups of 2 and 4 gloo ranks, about 4 s each
#: to start here, and every scenario)
CHILD_SECS = 300
#: the JAX tests' tolerances (tests/test_parallel_families.py): 1e-4, and
#: 1e-3 for DeepSeek-OCR's MoE
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_MOE = dict(atol=1e-3, rtol=1e-4)
#: the ASR decoders at 8 / 4 heads, so tp 4 divides them
QA_TEXT = dict(qa.TEXT, num_attention_heads=8, num_key_value_heads=4)
FA_LLM = dict(fa.LLM, num_attention_heads=8, num_key_value_heads=4)
GA_TEXT = dict(ga.TEXT, num_attention_heads=8, num_key_value_heads=4)
#: DeepSeek-OCR with 32 routed experts: a prompt of N tokens has capacity
#: ceil(N / 4) < N, and the planted router overloads four experts
DROPS_EXPERTS = 32


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _np_mm(mm: dict) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in mm.items()}


def _qwen3_asr(d=None, text=QA_TEXT, audio=qa.AUDIO):
    jcfg = jqa.Qwen3ASRConfig(audio=jqa.Qwen3ASRAudioConfig(**audio),
                              text=JQwen3Config(**text),
                              audio_token_id=qa.AUDIO_TOKEN)
    tcfg = tqa.Qwen3ASRConfig(audio=tqa.Qwen3ASRAudioConfig(**audio),
                              text=Qwen3Config(**text),
                              audio_token_id=qa.AUDIO_TOKEN)
    jm, jp, _, _ = qa.pair(jcfg, tcfg)
    jmm, tmm, n_out = qa.mel_mm(150, 200)
    ids = [1, 2] + [qa.AUDIO_TOKEN] * n_out + [3]
    return jm, _numpy(jp), tcfg, ids, _np_mm(tmm), jmm


def _fun_asr(d=None):
    jm, jp, tm, _ = fa.pair(FA_LLM)
    jmm, tmm, n_tok = fa.speech_mm()
    ids, fmask = fa._prompt(n_tok)
    jmm["fbank_mask"] = jnp.asarray(fmask[:len(ids)])
    tmm = {**_np_mm(tmm), "fbank_mask": fmask}
    return jm, _numpy(jp), tm.config, ids, tmm, jmm


def _glm_asr(d=None):
    jm, jp, tm, _ = ga.pair(GA_TEXT)
    jmm, tmm, n_tok = ga.mel_mm()
    ids = [1, 2] + [ga.AUDIO_TOK] * n_tok + [3, 4, 5]
    return jm, _numpy(jp), tm.config, ids, _np_mm(tmm), jmm


def _paddleocr_vl(d=None):
    jm, jp, _, _ = pv._pair()
    grids = [(1, 4, 6)]
    ids = pv._prompt(grids)
    mm = pv._exact_mm(grids, ids, pv._patches(grids))
    return jm, _numpy(jp), pv.TCFG, ids, mm, pv._jmm(mm)


def _hunyuan_ocr(d=None):
    jc = tiny_hunyuan_config()
    jm = jhy.HunyuanOCRModel(jc, max_rope_len=256)
    jp, _ = _hy_params(jm)
    tcfg = hy.port_config(jc)
    grids = [(1, 4, 4)]
    ids = [3, 5] + [jc.image_token_id] * (2 * (2 + 1) + 2) + [9, 11]
    jmm, _ = hy.both_mm(jm, types.SimpleNamespace(config=tcfg), grids, ids)
    tmm = hy.build_mm(hy.patches_for(jc, grids), grids, ids, tcfg)
    return jm, _numpy(jp), tcfg, ids, tmm, jmm


def _glm_ocr(d):
    """The JAX test's tp model (tests/test_parallel_families.py
    test_tp_glm_ocr): the tiny GLM-OCR repo's weights."""
    from aha_tpu.io.weights import open_weights
    from tests.fixtures import build_tiny_glm_ocr_repo

    repo = str(d / "glm_ocr_weights")
    build_tiny_glm_ocr_repo(repo)
    jc = jgo.GlmOcrConfig.from_file(repo)
    jm = jgo.GlmOcrModel(jc, max_rope_len=512)
    jp = jm.load_params(open_weights(repo), dtype=jnp.float32)
    tcfg = tgo.GlmOcrConfig.from_file(repo)
    grids = [(1, 4, 4)]
    ids = go.image_ids(jc, grids)
    jmm, _ = go.both_mm(jm, types.SimpleNamespace(config=tcfg), grids, ids)
    tmm = go.build_mm(go.patches_for(jc, grids), grids, ids, tcfg)
    return jm, _numpy(jp), tcfg, ids, tmm, jmm


def _deepseek_ocr(d=None):
    jm, jp, tm, _ = ds.build(1)
    mm = ds.mm_for(tm.config, crops=False)
    ids = ds.prompt_for(tm.config, mm)
    return jm, jp, tm.config, ids, mm, ds.jmm(mm)


def _planted(jp: dict, seed: int = 4) -> dict:
    """Every MoE layer's router planted: zero but for experts 0 and E − 1,
    both s·v (E − 1 a shade larger).  A token with h·v > 0 routes to
    {E − 1, 0}; one with h·v < 0 finds them last and the zero scores tied,
    and takes experts 1 and 2 (ties to the lower index): four experts
    share every pair, far past the capacity of ceil(N / 4)."""
    v = np.random.default_rng(seed).standard_normal(
        jp["layers"][1]["moe"]["gate"]["w"].shape[0]).astype(np.float32)
    for lp in jp["layers"]:
        if "moe" in lp:
            w = np.zeros_like(lp["moe"]["gate"]["w"])
            w[:, 0], w[:, -1] = 5.0 * v, 5.05 * v
            lp["moe"]["gate"]["w"] = w
    return jp


def _deepseek_drops(d=None):
    jm, jp, tm, _ = ds.build(1, experts=DROPS_EXPERTS)
    jp = _planted(jp)
    mm = ds.mm_for(tm.config, crops=False)
    ids = ds.prompt_for(tm.config, mm, pre=[(i * 7) % 200 + 1
                                            for i in range(40)])
    return jm, jp, tm.config, ids, mm, ds.jmm(mm)


#: name → (builder, model kind, the tps its tiny geometry divides, the
#: tolerance)
FAMILIES = {
    "qwen3_asr": (_qwen3_asr, "qwen3_asr", (2, 4), TOL),
    "fun_asr": (_fun_asr, "fun_asr", (2, 4), TOL),
    "glm_asr": (_glm_asr, "glm_asr", (2, 4), TOL),
    "paddleocr_vl": (_paddleocr_vl, "paddleocr_vl", (2,), TOL),
    "hunyuan_ocr": (_hunyuan_ocr, "hunyuan_ocr", (2,), TOL),
    "glm_ocr": (_glm_ocr, "glm_ocr", (2,), TOL),
    "deepseek_ocr": (_deepseek_ocr, "deepseek_ocr", (2, 4), TOL_MOE),
    "deepseek_drops": (_deepseek_drops, "deepseek_ocr", (2, 4), TOL_MOE),
}
CACHE_LEN = 128
RUNS = [(name, tp) for name, (_, _, tps, _) in FAMILIES.items()
        for tp in tps]


def _planted_moe():
    """tests/test_torch_deepseek_ocr.py's planted router over 64 experts,
    its shared experts kept, the six winners split across both halves
    (experts 0–2 on rank 0 at tp 2, 61–63 on rank 1): all 128 tokens to
    the same six, C = default_capacity(128, 6, 64) = 48."""
    rng = np.random.default_rng(11)
    D, F, E, K, N = 32, 16, 64, 6, 128
    p = ds.moe_params(rng, D, F, E)
    p["gate"]["w"][:] = 0.0
    p["gate"]["w"][0, [0, 1, 2, 61, 62, 63]] = 10.0 + np.arange(K)
    x = np.abs(rng.standard_normal((N, D)).astype(np.float32)) + 0.5
    return p, x, K, tmoe.default_capacity(N, K, E)


# -- served repos: vocabularies padded to a multiple of 4 (tp 2 and 4 split
# them) with zero rows past the tokenizer's ids ------------------------------

def _pad_vocab(path: str, names: list[str], cfg_keys: list[str]) -> None:
    from safetensors.numpy import load_file, save_file

    weights = os.path.join(path, "model.safetensors")
    tensors = load_file(weights)
    for name in names:
        if name in tensors:
            t = tensors[name]
            pad = -(-t.shape[0] // 4) * 4 - t.shape[0]
            tensors[name] = np.concatenate(
                [t, np.zeros((pad, t.shape[1]), t.dtype)])
    save_file(tensors, weights)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    node = cfg
    for key in cfg_keys[:-1]:
        node = node[key]
    node[cfg_keys[-1]] = -(-node[cfg_keys[-1]] // 4) * 4
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)


def _glm_asr_repo(path: str) -> None:
    """tests/test_torch_glm_asr.py's served repo."""
    from safetensors.torch import save_file
    from tokenizers import AddedToken

    from tests.fixtures import CHAT_TEMPLATE, build_tokenizer

    os.makedirs(path, exist_ok=True)
    tok = build_tokenizer(path)
    tok.add_special_tokens([AddedToken(ga.PAD_AUDIO, special=True)])
    tok.save(os.path.join(path, "tokenizer.json"))
    token = tok.token_to_id(ga.PAD_AUDIO)
    text = {**ga.TEXT, "vocab_size": tok.get_vocab_size(),
            "max_position_embeddings": 4096}
    files = {
        "config.json": {"audio_config": ga.AUDIO, "text_config": text,
                        "audio_token_id": token},
        "generation_config.json": {
            "eos_token_id": [tok.token_to_id("<|im_end|>")]},
        "processor_config.json": {"audio_token": ga.PAD_AUDIO,
                                  "max_audio_len": 60},
        "tokenizer_config.json": {"chat_template": CHAT_TEMPLATE.replace(
            "{{ message.content }}",
            "{% if message.content is string %}{{ message.content }}"
            "{% else %}{% for part in message.content %}"
            "{% if part.type == 'text' %}{{ part.text }}"
            f"{{% elif part.type == 'audio_url' %}}{ga.PAD_AUDIO}"
            "{% endif %}{% endfor %}{% endif %}")}}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    _, _, _, tp = ga.pair(text, token)
    save_file({k: v.contiguous() for k, v in ga._hf_tree(tp).items()},
              os.path.join(path, "model.safetensors"))


def _fun_asr_repo(path: str) -> None:
    fa.build_fun_asr_repo(path)
    _pad_vocab(path, ["llm.model.embed_tokens.weight", "llm.lm_head.weight"],
               ["llm_conf", "vocab_size"])


def _hunyuan_repo(path: str) -> None:
    from tests.fixtures import build_tiny_hunyuan_ocr_repo

    build_tiny_hunyuan_ocr_repo(path)
    _pad_vocab(path, ["model.embed_tokens.weight"], ["vocab_size"])


def _paddle_repo(path: str) -> None:
    from tests.test_torch_paddleocr_vl_served import write_repo

    os.makedirs(path, exist_ok=True)
    write_repo(path)


def _wav_url(secs: float, seed: int = 0) -> str:
    from aha_tpu_torch.utils.audio import wav_bytes

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * secs)) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)
           + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    return ("data:audio/wav;base64,"
            + base64.b64encode(wav_bytes(wav, 16000)).decode())


def _chat(content, max_tokens=6, **kw) -> dict:
    return {"messages": [{"role": "user", "content": content}],
            "model": "m", "max_tokens": max_tokens, "temperature": 0.0, **kw}


def _audio(text=None) -> list:
    parts = [{"type": "audio_url", "audio_url": {"url": _wav_url(1.0)}}]
    return parts + ([{"type": "text", "text": text}] if text else [])


def _image(w, h, text, seed=0) -> list:
    return [{"type": "image_url",
             "image_url": {"url": png_data_url(w, h, seed)}},
            {"type": "text", "text": text}]


def _served_specs(d) -> dict:
    """key → (model id, repo builder, load_model options, chat body)."""
    from tests.fixtures import (build_tiny_deepseek_ocr_repo,
                                build_tiny_glm_ocr_repo)
    from tests.test_asr import build_tiny_asr_repo

    return {
        "qwen3_asr": ("Qwen/Qwen3-ASR-0.6B", build_tiny_asr_repo,
                      dict(max_seq_len=512), _chat(_audio())),
        "fun_asr": ("FunAudioLLM/Fun-ASR-Nano-2512", _fun_asr_repo,
                    dict(max_seq_len=512), _chat(_audio("hello world"))),
        "glm_asr": ("ZhipuAI/GLM-ASR-Nano-2512", _glm_asr_repo,
                    dict(max_seq_len=2048), _chat(_audio("transcribe"))),
        "paddleocr_vl": ("PaddlePaddle/PaddleOCR-VL", _paddle_repo,
                         dict(max_seq_len=512), _chat(
                             [{"type": "image_url", "image_url": {
                                 "url": png_data_url(84, 56)}},
                              {"type": "text", "text": "OCR:"}])),
        "hunyuan_ocr": ("Tencent-Hunyuan/HunyuanOCR", _hunyuan_repo,
                        dict(max_seq_len=2048), _chat(_image(
                            120, 80, f"{HY_IMAGE}Detect text."))),
        "glm_ocr": ("ZhipuAI/GLM-OCR", build_tiny_glm_ocr_repo,
                    dict(max_seq_len=2048),
                    _chat(_image(60, 90, "Read the text."))),
        "deepseek_ocr": ("deepseek-ai/DeepSeek-OCR",
                         build_tiny_deepseek_ocr_repo,
                         dict(max_seq_len=4096),
                         _chat(_image(120, 80, "<image>\nFree OCR."))),
    }


def _child_env() -> dict:
    env = dict(os.environ)
    env["AHA_DEVICE"] = "cpu"
    env["AHA_DTYPE"] = "float32"
    env["PYTHONPATH"] = ROOT
    return env


class _Child:
    """A rank-0 child started at once; `result()` waits for its pickle."""

    def __init__(self, scenario: str, spec: dict, d):
        self.out = d / f"{scenario}.out.pkl"
        with open(d / f"{scenario}.in.pkl", "wb") as f:
            pickle.dump(spec, f)
        self.proc = subprocess.Popen(
            [sys.executable, RANK0, scenario, str(d / f"{scenario}.in.pkl"),
             str(self.out)], env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            try:
                _, err = self.proc.communicate(timeout=CHILD_SECS)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, err[-4000:]
            with open(self.out, "rb") as f:
                self._res = pickle.load(f)
        return self._res

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name → (JAX model, numpy tree, the port's config, ids, the port's
    host mm, the JAX mm)."""
    d = tmp_path_factory.mktemp("tp_asr_ocr_models")
    return {name: fn(d) for name, (fn, _, _, _) in FAMILIES.items()}


@pytest.fixture(scope="module")
def children(tmp_path_factory, built):
    """Both children, started before any test of the module runs."""
    d = tmp_path_factory.mktemp("tp_asr_ocr")
    models = {name: (kind, built[name][2], built[name][1], tps)
              for name, (_, kind, tps, _) in FAMILIES.items()}
    runs = {name: (b[3], b[4], CACHE_LEN) for name, b in built.items()}
    specs = _served_specs(d)
    repos = {}
    for key, (_, make, _, _) in specs.items():
        repos[key] = str(d / key)
        make(repos[key])
    served = {key: (mid, repos[key], kw, body)
              for key, (mid, _, kw, body) in specs.items()}
    kids = {"models": _Child("models", dict(models=models, runs=runs,
                                            moe=_planted_moe()), d),
            "served": _Child("served", served, d), "served_spec": served}
    yield kids
    kids["models"].stop()
    kids["served"].stop()


@pytest.fixture(scope="module")
def runs(children):
    return children["models"].result()


@pytest.fixture(scope="module")
def served(children):
    return children["served"].result()


def _gone(pid: int, secs: float = 30.0) -> bool:
    end = time.monotonic() + secs
    while time.monotonic() < end:
        try:
            if psutil.Process(pid).status() == psutil.STATUS_ZOMBIE:
                return True
        except psutil.NoSuchProcess:
            return True
        time.sleep(0.1)
    return False


def _jmesh(tp: int):
    return jmesh.make_mesh(jmesh.MeshConfig(tp=tp))


def _jax_parity(jm, jp, ids, mm, tp: int) -> list:
    """aha_tpu's _tp_parity run on the tp mesh: a multimodal prefill and
    one decode step; the last prompt row's logits and the step's."""
    ids_a = jnp.asarray([ids])

    def run(p, cache):
        hidden, cache = jm.backbone(p, ids_a, cache, mm=mm)
        lg = jm.logits(p, hidden)[0, -1]
        cache = {**cache, "pos": jnp.int32(len(ids))}
        tok = jnp.argmax(lg)[None, None].astype(jnp.int32)
        h2, _ = jm.backbone(p, tok, cache)
        return [lg, jm.logits(p, h2)[0, 0]]

    jmsh = _jmesh(tp)
    sp = jmesh.shard_params(jax.tree.map(jnp.asarray, jp), jmsh,
                            jm.partition_rules)
    scache = jmesh.shard_params(jm.init_cache(1, CACHE_LEN, jnp.float32),
                                jmsh, jm.cache_rules)
    return [np.asarray(x) for x in jax.jit(run)(sp, scache)]


# -- refusals (no child needed: these run while the children work) ----------

def _tp4():
    return mesh.make_mesh(mesh.MeshConfig(tp=4), ["cpu"] * 4)


def _jax_text_forward(jm, jp, tp: int = 4) -> np.ndarray:
    """A text prefill of the JAX model on the tp mesh (its shard_params
    replicating what tp does not divide)."""
    jmsh = _jmesh(tp)
    sp = jmesh.shard_params(jax.tree.map(jnp.asarray, jp), jmsh,
                            jm.partition_rules)
    ids = jnp.asarray([[3, 1, 4, 1, 5, 9, 2, 6]])

    @jax.jit
    def fwd(p):
        hidden, _ = jm.backbone(p, ids, jm.init_cache(1, 8, jnp.float32))
        return jm.logits(p, hidden)

    with jax.sharding.set_mesh(jmsh):
        return np.asarray(fwd(sp))


def _refused_qwen3_asr():
    audio = dict(qa.AUDIO, encoder_attention_heads=2)
    jm, jp, tcfg, *_ = _qwen3_asr(audio=audio)
    return jm, jp, tcfg, tqa, "audio encoder_attention_heads", 2


def _refused_paddleocr_vl():
    jm, jp, _, _ = pv._pair()
    return jm, _numpy(jp), pv.TCFG, tpv, "num_key_value_heads", 2


def _refused_hunyuan_ocr():
    jc = dataclasses.replace(tiny_hunyuan_config(), vocab_size=258,
                             num_key_value_heads=4)
    jm = jhy.HunyuanOCRModel(jc, max_rope_len=64)
    jp, _ = _hy_params(jm)
    return jm, _numpy(jp), hy.port_config(jc), thy, "vocab_size", 258


def _refused_deepseek(**lang):
    jc = ds.tiny_config()
    jc = dataclasses.replace(jc, language=dataclasses.replace(
        jc.language, **lang))
    jm = jds.DeepseekOCRModel(jc, max_rope_len=64)
    jp = _numpy(jm.init_random(jax.random.PRNGKey(0)))
    return jm, jp, ds.port_config(jc), tds


REFUSALS = {
    "qwen3_asr-audio-heads": (_refused_qwen3_asr, None),
    "paddleocr_vl-kv-heads": (_refused_paddleocr_vl, None),
    "hunyuan_ocr-vocab": (_refused_hunyuan_ocr, None),
    "deepseek_ocr-heads": (_refused_deepseek, (
        dict(num_attention_heads=2, num_key_value_heads=2),
        "num_key_value_heads", 2)),
    "deepseek_ocr-experts": (_refused_deepseek, (
        dict(n_routed_experts=6), "n_routed_experts", 6)),
    "deepseek_ocr-shared-width": (_refused_deepseek, (
        dict(moe_intermediate_size=6, n_shared_experts=1),
        "the shared experts' width", 6)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tp_that_does_not_divide_is_refused_where_jax_runs_it(children,
                                                             case):
    """Departure 1: the JAX mesh replicates a tensor whose dimension tp
    does not divide and runs the model at tp 4; the port refuses, naming
    the dimension, before loading or building a rank's model."""
    fn, deepseek = REFUSALS[case]
    if deepseek is None:
        jm, jp, tcfg, module, name, size = fn()
    else:
        lang, name, size = deepseek
        jm, jp, tcfg, module = fn(**lang)
    assert np.isfinite(_jax_text_forward(jm, jp)).all()
    words = rf"--tp 4 does not divide {re.escape(name)} \({size}\)"
    model_cls = {tqa: tqa.Qwen3ASRModel, tpv: tpv.PaddleOCRVLModel,
                 thy: thy.HunyuanOCRModel, tds: tds.DeepseekOCRModel}[module]
    with pytest.raises(ValueError, match=words):
        module.check_tp(tcfg, 4)
    with pytest.raises(ValueError, match=words):
        model_cls(tcfg, mesh=_tp4())


# -- partition rules ----------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))
    else:
        yield path, tree


PORT_MODELS = {"qwen3_asr": tqa.Qwen3ASRModel, "fun_asr": tfa.FunAsrNanoModel,
               "glm_asr": tga.GlmAsrNanoModel,
               "paddleocr_vl": tpv.PaddleOCRVLModel,
               "hunyuan_ocr": thy.HunyuanOCRModel,
               "glm_ocr": tgo.GlmOcrModel,
               "deepseek_ocr": tds.DeepseekOCRModel}


@pytest.mark.parametrize("family", list(PORT_MODELS))
def test_partition_rules_shard_the_jax_rules_leaves(built, family):
    """Over each family's parameter paths (its tiny tree, carried across
    with params_from_jax): the leaves the port's rules shard are those to
    which the JAX rules give a "tp" spec — a replicated tower stays
    replicated —, the port's layout aside (fc2 by rows, a vocab-major
    head, GLM-OCR's paired gate_up).  The llama rules leave the q / k / v
    and gate / up biases to GSPMD, which slices them with their weights'
    columns; a port rank holds that slice (tests/test_torch_parallel_
    families.py), so such a bias is the one leaf the port adds."""
    jm, jp = built[family][:2]
    jax_tp = {p for p, _ in _leaves(jp)
              if "tp" in tuple(jmesh.spec_for(p, jm.partition_rules))}
    jax_tp = {re.sub(r"^llm\.", "text.", p) for p in jax_tp}
    rules = PORT_MODELS[family].partition_rules
    port = dict(_leaves(params_from_jax(jp)))
    port_tp = {p for p in port
               if any(a is not None for a in mesh.spec_for(p, rules))}
    biases = {p for p in port_tp - jax_tp
              if p.endswith(".b") and p[:-2] + ".w" in jax_tp
              and mesh.spec_for(p[:-2] + ".w", rules)[-1] == "tp"}
    assert port_tp - biases == jax_tp
    assert port_tp, family


def test_cache_rules_split_the_kv_heads():
    for jcls, tcls in ((jhy.HunyuanOCRModel, thy.HunyuanOCRModel),
                       (jgo.GlmOcrModel, tgo.GlmOcrModel),
                       (jds.DeepseekOCRModel, tds.DeepseekOCRModel),
                       (jga.GlmAsrNanoModel, tga.GlmAsrNanoModel),
                       (jpv.PaddleOCRVLModel, tpv.PaddleOCRVLModel)):
        assert tuple(map(tuple, tcls.cache_rules)) == \
            tuple(map(tuple, jcls.cache_rules)), tcls
    assert tqa.Qwen3ASRModel.cache_rules == tfa.FunAsrNanoModel.cache_rules


def test_paired_gate_up_slices_each_half():
    """GLM-OCR's [gate | up] at tp 2: rank r holds gate's and up's r-th
    halves side by side, so the layer's chunk(2) pairs them."""
    I = 8
    w = torch.arange(2 * 2 * I, dtype=torch.float32).reshape(2, 2 * I)
    spec = dict(tgo.GLM_OCR_PARTITION_RULES)[r"text\.layers\.gate_up\.w"]
    for r in range(2):
        m = mesh.make_mesh(mesh.MeshConfig(tp=2), ["cpu"] * 2).at(r)
        placed = mesh.placed_spec(w.shape, spec[1:], m)
        got = mesh.shard_slice(w, placed, m)
        g, u = got.chunk(2, dim=-1)
        torch.testing.assert_close(g, w[:, r * 4:(r + 1) * 4])
        torch.testing.assert_close(u, w[:, I + r * 4:I + (r + 1) * 4])
        assert mesh.local_shape(w.shape, placed, m) == (2, I)


# -- models -------------------------------------------------------------------

@pytest.mark.parametrize("name,tp", RUNS, ids=[f"{n}-tp{t}" for n, t in RUNS])
def test_prefill_and_decode_match_jax_mesh(built, runs, name, tp):
    """Each family's multimodal prefill and one decode step on the port's
    gloo ranks equal aha_tpu's on the tp mesh; the value-out greedy token
    is the gathered logits' argmax."""
    jm, jp, _, ids, _, jmm = built[name]
    tol = FAMILIES[name][3]
    want = _jax_parity(jm, jp, ids, jmm, tp)
    got = runs[f"{name}/{tp}"]
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(g, w, **tol)
    assert got[2] == int(np.argmax(got[1]))


def test_deepseek_experts_split_across_ranks(runs):
    """Each rank holds E/tp whole routed experts: half (a quarter) of the
    expert bytes at tp 2 (tp 4), the same on every rank."""
    for tp in (2, 4):
        rows = runs[f"experts/{tp}"]
        assert [r[1] for r in rows] == [8 // tp] * tp
        total = sum(r[0] for r in rows)
        assert [r[0] for r in rows] == [total / tp] * tp


def test_moe_capacity_drops_equal_one_device(runs):
    """The planted MoE at tp 2: the pairs past C that one device drops are
    dropped on the rank holding their expert (three winners a rank), with
    the shared experts' partial sums in the same reduce; the sum equals
    one device's and aha_tpu's, and both part from the exact routed sum."""
    p, x, K, C = _planted_moe()
    one, want = ds.both_moe(p, x, K, capacity=C)
    exact, _ = ds.both_moe(p, x, K, capacity=x.shape[0] * K)
    np.testing.assert_allclose(runs["moe_drops"], one, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs["moe_drops"], want, rtol=1e-5,
                               atol=1e-5)
    assert ds.rel(one, exact) > 0.1


def test_deepseek_prompt_past_capacity_drops_as_one_device(built, runs,
                                                           monkeypatch):
    """A 60-token DeepSeek-OCR prompt over 32 experts (C = 15 < N) with a
    planted router: the port's one device drops pairs there (its logits
    move when the capacity is lifted to N·K), and the tp 2 and tp 4 ranks
    give one device's logits."""
    jm, jp, tcfg, ids, mm, _ = built["deepseek_drops"]
    model = tds.DeepseekOCRModel(tcfg, max_rope_len=512)
    params = params_from_jax(jp)
    from aha_tpu_torch.core.engine import mm_to

    def last_logits():
        with torch.no_grad():
            cache = model.init_cache(1, CACHE_LEN, torch.float32)
            h = model.backbone(params, torch.tensor([ids]), cache,
                               mm=mm_to(mm, "cpu"))
            return model.logits(params, h)[0, -1].numpy()

    one = last_logits()
    monkeypatch.setattr(tds, "default_capacity", lambda n, k, e: n * k)
    lifted = last_logits()
    assert tmoe.default_capacity(len(ids), 2, DROPS_EXPERTS) < len(ids)
    assert ds.rel(one, lifted) > 1e-3
    for tp in (2, 4):
        np.testing.assert_allclose(runs[f"deepseek_drops/{tp}"][0], one,
                                   **TOL_MOE)


# -- served models through load_model(..., tp=2) ------------------------------

@pytest.mark.parametrize("key", ["qwen3_asr", "fun_asr", "glm_asr",
                                 "paddleocr_vl", "hunyuan_ocr", "glm_ocr",
                                 "deepseek_ocr"])
def test_served_tp2_reply_matches_jax(children, served, key):
    """load_model(..., tp=2) of each family answers the greedy chat as
    aha_tpu's model does, on one TextEngine; its worker is gone after the
    shutdown."""
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu.params import ChatCompletionParameters as JParameters

    model_id, repo, kw, body = children["served_spec"][key]
    want = jload_model(model_id, repo, **kw).generate(
        JParameters.model_validate(body)).choices[0].message.content
    assert served[key] == want
    assert served[f"{key}/engine"] == "TextEngine"
    assert len(served[f"{key}/pids"]) == 1
    assert all(_gone(pid) for pid in served[f"{key}/pids"])
