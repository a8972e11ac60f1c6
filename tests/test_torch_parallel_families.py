"""aha_tpu_torch's tensor parallelism over the llama decoder (MiniCPM4 /
MiniCPM5, Qwen2.5-VL's text), Qwen3-VL, Qwen2.5-VL and the Qwen3 embedder
and reranker, against aha_tpu's tp mesh on the JAX package's 8 virtual
CPU devices.

- The port's side: its gloo ranks on the CPU, started by two child
  processes at once when the module starts (tests/parallel_families_rank0.py,
  rank 0: it spawns the workers): `models` runs every model scenario over
  a tp 2 and a tp 4 group, `served` loads every served model through
  `load_model(..., tp=2)`.  Each test below asserts on one result; the
  tests that need no child run while the children work.
- The JAX side: the same numpy weights and inputs, placed by
  `shard_params` with the family's partition rules.
- Cases: the llama forward at tp 2 and 4 (the config of
  tests/test_parallel.py, a MiniCPM one with the mup scalings, LongRoPE
  and a tied head, an ERNIE one with o / MLP biases) within 1e-4;
  MiniCPM's greedy streams on TextEngine (prefix store warm against
  cold) and a threaded tp 2 BatchEngine equal to the JAX engines' on the
  tp mesh; Qwen3-VL's and Qwen2.5-VL's multimodal prefill and one decode
  step at tp 2 and 4 within atol 3e-4 (tests/test_parallel_families.py's
  scenario); served chats (MiniCPM4, MiniCPM5 on slots, Qwen2.5-VL and
  Qwen3-VL image chats) equal to the JAX model's replies, the embedder's
  vectors and the reranker's scores within atol 2e-5; the refusals of
  the new tp checks, where the JAX mesh runs the same tp by replicating.

Every child process and every request has a deadline.  float32 on the
CPU."""

import json
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import psutil
import pytest
import torch

from aha_tpu.core.batch_engine import BatchEngine as JBatchEngine
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import llama as jllama
from aha_tpu.models import qwen2_5vl as jq25
from aha_tpu.models import qwen3 as jqwen3
from aha_tpu.models import qwen3vl as jq3vl
from aha_tpu.parallel import mesh as jmesh
from aha_tpu_torch.models import llama as tllama
from aha_tpu_torch.models import qwen2_5vl as tq25
from aha_tpu_torch.models import qwen3 as tqwen3
from aha_tpu_torch.models import qwen3vl as tq3vl
from aha_tpu_torch.parallel import mesh
from tests.fixtures import CHAT_TEMPLATE, build_tiny_qwen3_repo
from tests.vision_chat import png_data_url, vision_tokenizer, write_template

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK0 = os.path.join(ROOT, "tests", "parallel_families_rank0.py")
#: seconds a child may take (groups of 2 and 4 gloo ranks, about 4 s each
#: to start here, and every scenario)
CHILD_SECS = 300
JGREEDY = JSampling(temperature=None)
IDS = [3, 1, 4, 1, 5, 9, 2, 6]
BASE = [(i * 7) % 100 + 1 for i in range(40)]
EXT = BASE + [9, 8, 7]
BATCH_PROMPTS = [[(i * 29 + j) % 100 + 1 for j in range(36 + i)]
                 for i in range(3)]
#: tests/test_parallel.py's tp llama (8 / 4 heads, q/k/v bias)
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4)
LLAMAS = {
    "qwen2": dict(LLAMA, qkv_bias=True),
    "minicpm": dict(LLAMA, max_position_embeddings=128,
                    tie_word_embeddings=True, scale_emb=12.0,
                    scale_depth=1.4, dim_model_base=16,
                    rope_scaling={"short_factor": [1.0, 1.2, 1.4, 1.6],
                                  "long_factor": [2.0, 2.4, 2.8, 3.2],
                                  "original_max_position_embeddings": 64}),
    "ernie": dict(LLAMA, qkv_bias=True, o_bias=True, mlp_bias=True),
}
IMG, VID, VSTART = 90, 91, 92
VL_TOKENS = dict(image_token_id=IMG, video_token_id=VID,
                 vision_start_token_id=VSTART)
VL3_VISION = dict(depth=3, hidden_size=32, intermediate_size=64,
                  num_heads=2, in_channels=3, out_hidden_size=48,
                  patch_size=16, spatial_merge_size=2, temporal_patch_size=2,
                  num_position_embeddings=16, deepstack_visual_indexes=(0, 1))
VL3_TEXT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
                num_hidden_layers=3, num_attention_heads=8,
                num_key_value_heads=4, head_dim=12, rope_theta=1e6,
                max_position_embeddings=512, tie_word_embeddings=True)
VL25_VISION = dict(depth=2, hidden_size=32, intermediate_size=64,
                   num_heads=2, in_chans=3, out_hidden_size=48,
                   patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
                   window_size=56, fullatt_block_indexes=(1,))
VL25_TEXT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=8,
                 num_key_value_heads=4, head_dim=12, rope_theta=1e6,
                 max_position_embeddings=512, tie_word_embeddings=True,
                 qkv_bias=True)
GRID = (1, 4, 6)
CHAT = {"max_tokens": 6, "temperature": 0.0,
        "messages": [{"role": "user", "content": "hello world"}]}
IMAGE_CHAT = {"max_tokens": 6, "temperature": 0.0, "messages": [
    {"role": "user", "content": [
        {"type": "text", "text": "describe "},
        {"type": "image_url", "image_url": {"url": png_data_url()}}]}]}
TEXTS = ["hello tensor world", "the quick brown fox jumps over the lazy dog",
         "what is the answer"]
RERANK = ("what is the answer", ["the answer to life", "hello world",
                                 "the quick brown fox"])


def _child_env() -> dict:
    env = dict(os.environ)
    env["AHA_DEVICE"] = "cpu"
    env["AHA_DTYPE"] = "float32"
    env["PYTHONPATH"] = ROOT
    return env


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _random_biases(tree, seed: int):
    """Every bias ("b") of a tree drawn at random: init_random's are
    zeros, which would hide a bias added once per rank, or a bias slice
    taken from the wrong columns."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                        if k == "b" else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(tree)


def _llama(name: str):
    """(JAX model, numpy tree, the port's config) of LLAMAS[name]."""
    kw = LLAMAS[name]
    jm = jllama.LlamaModel(jllama.LlamaConfig(**kw), max_rope_len=256)
    jp = _random_biases(_numpy(jm.init_random(jax.random.PRNGKey(7),
                                              scale=0.3)), 7)
    return jm, jp, tllama.LlamaConfig(**kw)


def _vl3():
    jcfg = jq3vl.Qwen3VLConfig(
        vision=jq3vl.Qwen3VLVisionConfig(**VL3_VISION),
        text=jqwen3.Qwen3Config(**VL3_TEXT), mrope_section=(2, 2, 2),
        **VL_TOKENS)
    tcfg = tq3vl.Qwen3VLConfig(
        vision=tq3vl.Qwen3VLVisionConfig(**VL3_VISION),
        text=tqwen3.Qwen3Config(**VL3_TEXT), mrope_section=(2, 2, 2),
        **VL_TOKENS)
    jm = jq3vl.Qwen3VLModel(jcfg, max_rope_len=256)
    jp = _random_biases(_numpy(jm.init_random(jax.random.PRNGKey(0),
                                              scale=0.3)), 0)
    ids = [1, 2, VSTART] + [IMG] * (GRID[1] * GRID[2] // 4) + [3, 4, 5]
    rng = np.random.default_rng(0)
    patches = rng.standard_normal(
        (GRID[0] * GRID[1] * GRID[2], 3 * 2 * 16 * 16)).astype(np.float32)
    geo = jq3vl.vision_geometry_qwen3vl([GRID], jcfg.vision)
    pos, delta = jq3vl.get_rope_index_qwen3vl(ids, [GRID], jcfg)
    mm = {"patches": patches, **geo, "position_ids": np.asarray(pos),
          "rope_delta": int(delta)}
    return jm, jp, tcfg, ids, mm


def _vl25():
    jcfg = jq25.Qwen2_5VLConfig(
        vision=jq25.VisionConfig(**VL25_VISION),
        text=jllama.LlamaConfig(**VL25_TEXT), mrope_section=(2, 2, 2),
        **VL_TOKENS)
    tcfg = tq25.Qwen2_5VLConfig(
        vision=tq25.VisionConfig(**VL25_VISION),
        text=tllama.LlamaConfig(**VL25_TEXT), mrope_section=(2, 2, 2),
        **VL_TOKENS)
    jm = jq25.Qwen2_5VLModel(jcfg, max_rope_len=256)
    jp = _random_biases(_numpy(jm.init_random(jax.random.PRNGKey(0),
                                              scale=0.3)), 1)
    ids = [1, 2, VSTART] + [IMG] * (GRID[1] * GRID[2] // 4) + [3, 4, 5]
    rng = np.random.default_rng(1)
    patches = rng.standard_normal(
        (GRID[0] * GRID[1] * GRID[2], 3 * 2 * 14 * 14)).astype(np.float32)
    geo = jq25.vision_geometry([GRID], jcfg.vision)
    pos, delta = jq25.get_rope_index(ids, [GRID], jcfg)
    mm = {"patches": patches, **geo, "position_ids": np.asarray(pos),
          "rope_delta": int(delta)}
    return jm, jp, tcfg, ids, mm


# -- served repos: the test tokenizers, the vocab padded to a multiple of 4
# (tp 2 and 4 split it) with zero rows past the tokenizer's ids ------------

def _padded(n: int) -> int:
    return -(-n // 4) * 4


def _zero_rows(tree: dict, n_tok: int) -> dict:
    embed = tree["embed"]["w"].clone()
    embed[n_tok:] = 0
    head = embed if tree["lm_head"]["w"] is tree["embed"]["w"] else \
        tree["lm_head"]["w"].clone().index_fill_(
            0, torch.arange(n_tok, tree["lm_head"]["w"].shape[0]), 0.0)
    return {**tree, "embed": {"w": embed}, "lm_head": {"w": head}}


def _minicpm_repo(path: str) -> str:
    from aha_tpu_torch.io.weights import save_hf_qwen3
    from tests.fixtures import build_tokenizer

    os.makedirs(path, exist_ok=True)
    tok = build_tokenizer(path)
    eos = tok.token_to_id("<|im_end|>")
    kw = {k: v for k, v in LLAMAS["minicpm"].items() if k != "vocab_size"}
    cfg = {**kw, "vocab_size": _padded(tok.get_vocab_size()),
           "architectures": ["MiniCPMForCausalLM"], "model_type": "minicpm",
           "torch_dtype": "float32", "eos_token_id": eos}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT_TEMPLATE}, f)
    model = tllama.LlamaModel(tllama.LlamaConfig.from_dict(cfg))
    params = model.init_random(torch.Generator().manual_seed(2), scale=0.3)
    save_hf_qwen3(_zero_rows(params, tok.get_vocab_size()), path)
    return path


def _vl_ids(tok) -> dict:
    return {"image_token_id": tok.token_to_id("<|image_pad|>"),
            "video_token_id": tok.token_to_id("<|video_pad|>"),
            "vision_start_token_id": tok.token_to_id("<|vision_start|>"),
            "vision_end_token_id": tok.token_to_id("<|vision_end|>")}


def _vl3_repo(path: str) -> str:
    from aha_tpu_torch.io.weights import save_hf_qwen3vl

    os.makedirs(path, exist_ok=True)
    tok = vision_tokenizer(path)
    write_template(path, tok)
    n_tok = tok.get_vocab_size()
    text = dict(VL3_TEXT, vocab_size=_padded(n_tok), num_attention_heads=4,
                num_key_value_heads=2)
    cfg = tq3vl.Qwen3VLConfig(
        vision=tq3vl.Qwen3VLVisionConfig(**VL3_VISION),
        text=tqwen3.Qwen3Config(**text), mrope_section=(2, 2, 2))
    params = tq3vl.Qwen3VLModel(cfg).init_random(
        torch.Generator().manual_seed(3), scale=0.3)
    save_hf_qwen3vl({**params, "text": _zero_rows(params["text"], n_tok)},
                    path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen3VLForConditionalGeneration"],
                   "model_type": "qwen3_vl", "torch_dtype": "float32",
                   "text_config": {**text, "rope_scaling": {
                       "rope_type": "default", "mrope_interleaved": True,
                       "mrope_section": [2, 2, 2]}},
                   "vision_config": {**VL3_VISION,
                                     "deepstack_visual_indexes": [0, 1]},
                   **_vl_ids(tok)}, f)
    return path


def _vl25_repo(path: str) -> str:
    from aha_tpu_torch.io.weights import save_hf_qwen2_5vl

    os.makedirs(path, exist_ok=True)
    tok = vision_tokenizer(path)
    write_template(path, tok)
    n_tok = tok.get_vocab_size()
    text = dict(VL25_TEXT, vocab_size=_padded(n_tok), num_attention_heads=4,
                num_key_value_heads=2)
    cfg = tq25.Qwen2_5VLConfig(
        vision=tq25.VisionConfig(**VL25_VISION),
        text=tllama.LlamaConfig(**text), mrope_section=(2, 2, 2))
    params = tq25.Qwen2_5VLModel(cfg).init_random(
        torch.Generator().manual_seed(4), scale=0.3)
    save_hf_qwen2_5vl({**params, "text": _zero_rows(params["text"], n_tok)},
                      path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**text, "architectures":
                   ["Qwen2_5_VLForConditionalGeneration"],
                   "model_type": "qwen2_5_vl", "torch_dtype": "float32",
                   "rope_scaling": {"type": "mrope",
                                    "mrope_section": [2, 2, 2]},
                   "vision_config": {**VL25_VISION,
                                     "fullatt_block_indexes": [1]},
                   **_vl_ids(tok)}, f)
    return path


def _qwen3_repo(path: str) -> str:
    """The tiny Qwen3 repo with its vocab padded (zero rows)."""
    from safetensors.numpy import load_file, save_file

    cfg = build_tiny_qwen3_repo(path)
    vocab = _padded(cfg["vocab_size"])
    weights = os.path.join(path, "model.safetensors")
    tensors = load_file(weights)
    embed = tensors["model.embed_tokens.weight"]
    tensors["model.embed_tokens.weight"] = np.concatenate(
        [embed, np.zeros((vocab - embed.shape[0], embed.shape[1]),
                         embed.dtype)])
    save_file(tensors, weights)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg, vocab_size=vocab), f)
    return path


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
def children(tmp_path_factory):
    """Both children, started before any test of the module runs."""
    d = tmp_path_factory.mktemp("tp_families")
    vl3, vl25 = _vl3(), _vl25()
    models = {}
    for name in LLAMAS:
        _, jp, cfg = _llama(name)
        models[name] = ("llama", cfg, jp)
    models["vl3"] = ("qwen3vl", vl3[2], vl3[1])
    models["vl25"] = ("qwen2_5vl", vl25[2], vl25[1])
    spec = dict(models=models, llama=list(LLAMAS), ids=IDS, base=BASE,
                ext=EXT, batch_prompts=BATCH_PROMPTS,
                vl={"vl3": (vl3[3], vl3[4]), "vl25": (vl25[3], vl25[4])})
    repos = {k: fn(str(d / k)) for k, fn in (
        ("minicpm", _minicpm_repo), ("vl3", _vl3_repo),
        ("vl25", _vl25_repo), ("qwen3", _qwen3_repo))}
    served = dict(
        chats={"minicpm4": ("OpenBMB/MiniCPM4-0.5B", repos["minicpm"],
                            dict(max_seq_len=128), CHAT),
               "minicpm5": ("OpenBMB/MiniCPM5-1B", repos["minicpm"],
                            dict(max_seq_len=128, batch_slots=2), CHAT),
               "vl3": ("Qwen/Qwen3-VL-8B-Instruct", repos["vl3"],
                       dict(max_seq_len=1024), IMAGE_CHAT),
               "vl25": ("Qwen/Qwen2.5-VL-3B-Instruct", repos["vl25"],
                        dict(max_seq_len=512), IMAGE_CHAT)},
        qwen3_repo=repos["qwen3"], texts=TEXTS, rerank=RERANK)
    kids = {"models": _Child("models", spec, d),
            "served": _Child("served", served, d), "repos": repos}
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


def _jax_forward(jm, jp, tp: int) -> np.ndarray:
    jmsh = _jmesh(tp)
    sharded = jmesh.shard_params(jax.tree.map(jnp.asarray, jp), jmsh,
                                 jm.partition_rules)

    @jax.jit
    def fwd(params, ids):
        cache = jm.init_cache(1, len(IDS), jnp.float32)
        hidden, _ = jm.backbone(params, ids, cache)
        return jm.logits(params, hidden)

    with jax.sharding.set_mesh(jmsh):
        return np.asarray(fwd(sharded, jnp.asarray([IDS])))


# -- refusals (no child needed: these run while the children work) ----------

def _tp4():
    return mesh.make_mesh(mesh.MeshConfig(tp=4), ["cpu"] * 4)


@pytest.mark.parametrize("name,size", [("num_key_value_heads", 2),
                                       ("vocab_size", 130)])
def test_llama_tp_that_does_not_divide_is_refused(children, name, size):
    """Departure: the JAX mesh replicates a tensor whose dimension tp does
    not divide and runs the llama forward at tp 4; the port refuses,
    naming the dimension, before a rank's model is built."""
    kw = dict(LLAMAS["qwen2"], **{name: size})
    jm = jllama.LlamaModel(jllama.LlamaConfig(**kw), max_rope_len=64)
    jp = _numpy(jm.init_random(jax.random.PRNGKey(0)))
    assert np.isfinite(_jax_forward(jm, jp, 4)).all()
    words = rf"--tp 4 does not divide {name} \({size}\)"
    with pytest.raises(ValueError, match=words):
        tllama.check_tp(tllama.LlamaConfig(**kw), 4)
    with pytest.raises(ValueError, match=words):
        tllama.LlamaModel(tllama.LlamaConfig(**kw), mesh=_tp4())


@pytest.mark.parametrize("family", ["qwen3vl", "qwen2_5vl"])
def test_vl_tower_tp_that_does_not_divide_is_refused(children, family):
    """A tower MLP of 66 columns: the JAX mesh replicates fc1 / gate-up
    and runs the tower at tp 4; the port's check refuses it, naming the
    dimension, before loading or building a rank's model."""
    if family == "qwen3vl":
        vis = dict(VL3_VISION, intermediate_size=66)
        jcfg = jq3vl.Qwen3VLConfig(
            vision=jq3vl.Qwen3VLVisionConfig(**vis),
            text=jqwen3.Qwen3Config(**VL3_TEXT), mrope_section=(2, 2, 2),
            **VL_TOKENS)
        jm = jq3vl.Qwen3VLModel(jcfg, max_rope_len=64)
        tcfg = tq3vl.Qwen3VLConfig(
            vision=tq3vl.Qwen3VLVisionConfig(**vis),
            text=tqwen3.Qwen3Config(**VL3_TEXT), mrope_section=(2, 2, 2))
        check, model_cls, mm = tq3vl.check_tp, tq3vl.Qwen3VLModel, _vl3()[4]
    else:
        vis = dict(VL25_VISION, intermediate_size=66)
        jcfg = jq25.Qwen2_5VLConfig(
            vision=jq25.VisionConfig(**vis),
            text=jllama.LlamaConfig(**VL25_TEXT), mrope_section=(2, 2, 2),
            **VL_TOKENS)
        jm = jq25.Qwen2_5VLModel(jcfg, max_rope_len=64)
        tcfg = tq25.Qwen2_5VLConfig(
            vision=tq25.VisionConfig(**vis),
            text=tllama.LlamaConfig(**VL25_TEXT), mrope_section=(2, 2, 2))
        check, model_cls, mm = tq25.check_tp, tq25.Qwen2_5VLModel, _vl25()[4]
    jp = jm.init_random(jax.random.PRNGKey(0))
    jmsh = _jmesh(4)
    sp = jmesh.shard_params(jp, jmsh, jm.partition_rules)
    mm = {k: v if k == "rope_delta" else jnp.asarray(v)
          for k, v in mm.items()}
    feats = jax.jit(jm.encode_vision)(sp["visual"], mm)
    main = feats[0] if isinstance(feats, tuple) else feats
    assert np.isfinite(np.asarray(main)).all()
    words = r"--tp 4 does not divide vision intermediate_size \(66\)"
    with pytest.raises(ValueError, match=words):
        check(tcfg, 4)
    with pytest.raises(ValueError, match=words):
        model_cls(tcfg, mesh=_tp4())


def test_partition_rules_name_the_jax_rules_leaves():
    """Every JAX rule of the three families is one of the port's (the
    head's spec transposed: the port's head is vocab-major); the port
    adds the q/k/v and gate/up bias slices only."""
    for jrules, trules in ((jllama.LLAMA_PARTITION_RULES,
                            tllama.LLAMA_PARTITION_RULES),
                           (jq3vl.QWEN3VL_PARTITION_RULES,
                            tq3vl.QWEN3VL_PARTITION_RULES),
                           (jq25.QWEN2_5VL_PARTITION_RULES,
                            tq25.QWEN2_5VL_PARTITION_RULES)):
        got = dict(trules)
        for pattern, spec in jrules:
            want = tuple(spec)[::-1] if pattern == r"lm_head\.w" else \
                tuple(spec)
            assert got[pattern] == want, pattern
        extra = set(got) - {p for p, _ in jrules}
        assert all(p.endswith(r"\.b") for p in extra), extra
    assert tllama.LLAMA_CACHE_RULES == jllama.LLAMA_CACHE_RULES


# -- the llama decoder --------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(LLAMAS))
def test_llama_forward_matches_jax_mesh(runs, name, tp):
    jm, jp, _ = _llama(name)
    np.testing.assert_allclose(runs[f"forward/{name}/{tp}"],
                               _jax_forward(jm, jp, tp), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def jax_minicpm():
    jm, jp, _ = _llama("minicpm")
    jmsh = _jmesh(2)
    return jm, jmsh, jmesh.shard_params(jax.tree.map(jnp.asarray, jp), jmsh,
                                        jllama.LLAMA_PARTITION_RULES)


def test_minicpm_text_engine_and_prefix_store_match_jax(runs, jax_minicpm):
    """Cold streams at tp 2 and 4 equal aha_tpu's tp 2 engine's; warm
    (prefix store) streams equal cold ones, with two entries stored."""
    jm, jmsh, sharded = jax_minicpm
    eng = JEngine(jm, sharded, eos_token_ids=[], cache_dtype=jnp.float32,
                  max_seq_len=256, mesh=jmsh,
                  cache_rules=jllama.LLAMA_CACHE_RULES)
    want = [eng.generate_tokens(p, JGREEDY, max_tokens=6)
            for p in (BASE, EXT)]
    assert runs["cold/2"] == want
    assert runs["cold/4"] == want
    assert runs["warm"] == [want[0], want[0], want[1]]
    assert runs["warm_entries"] == 2


def test_minicpm_batch_engine_matches_jax(runs, jax_minicpm):
    """A tp 2 BatchEngine of 2 slots, 3 threaded requests: the streams of
    aha_tpu's BatchEngine on the tp 2 mesh."""
    import threading

    jm, jmsh, sharded = jax_minicpm
    jbe = JBatchEngine(jm, sharded, eos_token_ids=[], slots=2,
                       cache_dtype=jnp.float32, max_seq_len=256, mesh=jmsh,
                       cache_rules=jllama.LLAMA_CACHE_RULES)
    want = {}
    try:
        ts = [threading.Thread(target=lambda i=i: want.__setitem__(
            i, jbe.generate_tokens(BATCH_PROMPTS[i], JGREEDY,
                                   max_tokens=10)), daemon=True)
              for i in range(len(BATCH_PROMPTS))]
        [t.start() for t in ts]
        [t.join(60) for t in ts]
    finally:
        jbe.shutdown()
    assert len(want) == len(BATCH_PROMPTS)
    assert runs["batch"] == want


# -- Qwen3-VL and Qwen2.5-VL --------------------------------------------------

def _jax_vl(jm, jp, ids, mm, tp: int) -> list:
    """aha_tpu's _tp_parity run on the tp mesh: a multimodal prefill and
    one decode step; the last prompt row's logits and the step's."""
    ids_a = jnp.asarray([ids])
    jmm = {k: v if k == "rope_delta" else jnp.asarray(v)
           for k, v in mm.items()}
    jmm["rope_delta"] = jnp.int32(mm["rope_delta"])

    def run(p, cache):
        hidden, cache = jm.backbone(p, ids_a, cache, mm=jmm)
        lg = jm.logits(p, hidden)[0, -1]
        cache = {**cache, "pos": jnp.int32(len(ids))}
        tok = jnp.argmax(lg)[None, None].astype(jnp.int32)
        h2, _ = jm.backbone(p, tok, cache)
        return [lg, jm.logits(p, h2)[0, 0]]

    jmsh = _jmesh(tp)
    sp = jmesh.shard_params(jax.tree.map(jnp.asarray, jp), jmsh,
                            jm.partition_rules)
    scache = jmesh.shard_params(jm.init_cache(1, 64, jnp.float32), jmsh,
                                jm.cache_rules)
    return [np.asarray(x) for x in jax.jit(run)(sp, scache)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["vl3", "vl25"])
def test_vl_prefill_and_decode_match_jax_mesh(runs, family, tp):
    jm, jp, _, ids, mm = _vl3() if family == "vl3" else _vl25()
    want = _jax_vl(jm, jp, ids, mm, tp)
    got = runs[f"vl/{family}/{tp}"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-4, rtol=1e-4)


# -- served models through load_model(..., tp=2) ------------------------------

@pytest.fixture(scope="module")
def jax_loader():
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu.params import ChatCompletionParameters as JParameters

    def reply(model_id, path, body, **kw):
        m = jload_model(model_id, path, **kw)
        return m.generate(JParameters.model_validate(body)) \
            .choices[0].message.content

    return reply


@pytest.mark.parametrize("key,model_id,kw,body,engine", [
    ("minicpm4", "OpenBMB/MiniCPM4-0.5B", dict(max_seq_len=128), CHAT,
     "TextEngine"),
    ("minicpm5", "OpenBMB/MiniCPM4-0.5B", dict(max_seq_len=128), CHAT,
     "BatchEngine"),
    ("vl3", "Qwen/Qwen3-VL-8B-Instruct", dict(max_seq_len=1024),
     IMAGE_CHAT, "TextEngine"),
    ("vl25", "Qwen/Qwen2.5-VL-3B-Instruct", dict(max_seq_len=512),
     IMAGE_CHAT, "TextEngine"),
])
def test_served_tp2_replies_match_jax(children, served, jax_loader, key,
                                      model_id, kw, body, engine):
    """load_model(..., tp=2) of each family answers the greedy chat as
    aha_tpu's model does (MiniCPM5 on a BatchEngine of 2 slots, held to
    the same checkpoint's one-stream reply); its worker is gone after the
    shutdown."""
    repo = children["repos"]["minicpm" if "minicpm" in key else key]
    want = jax_loader(model_id, repo, body, **kw)
    assert served[key] == want and want
    assert served[f"{key}/engine"] == engine
    assert len(served[f"{key}/pids"]) == 1
    assert all(_gone(pid) for pid in served[f"{key}/pids"])


def test_served_embedding_tp2_matches_jax(children, served):
    from aha_tpu.models.qwen3_served import Qwen3EmbeddingServed
    from aha_tpu.registry import lookup

    want = Qwen3EmbeddingServed.load(lookup("Qwen/Qwen3-Embedding-0.6B"),
                                     children["repos"]["qwen3"])
    np.testing.assert_allclose(served["embed"], want.embed_arrays(TEXTS),
                               atol=2e-5, rtol=1e-5)
    assert all(_gone(pid) for pid in served["embed/pids"])


def test_served_reranker_tp2_matches_jax(children, served):
    from aha_tpu.models.qwen3_served import Qwen3RerankerServed
    from aha_tpu.registry import lookup

    want = Qwen3RerankerServed.load(lookup("Qwen/Qwen3-Reranker-0.6B"),
                                    children["repos"]["qwen3"])
    np.testing.assert_allclose(served["rerank"], want.rerank(*RERANK),
                               atol=2e-5, rtol=1e-5)


# -- ranks sharing a card -----------------------------------------------------

def test_mesh_devices_take_the_listed_devices(monkeypatch):
    """AHA_MESH_DEVICES lists a mesh's devices in order (a card twice:
    two ranks on it); a list shorter than tp·dp is refused before loading,
    naming both counts."""
    from aha_tpu_torch.utils.device import mesh_devices

    monkeypatch.setenv("AHA_MESH_DEVICES", "cuda:0, cuda:0")
    assert mesh_devices(tp=2) == [torch.device("cuda", 0)] * 2
    assert mesh_devices() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="needs 4 devices.*lists 2"):
        mesh_devices(tp=4)


def test_ranks_sharing_a_card_talk_over_gloo():
    from aha_tpu_torch.parallel.ranks import backend_for

    one = [torch.device("cuda", 0)] * 2
    assert backend_for(one) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) is None
    assert backend_for(None) is None
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(one, "nccl") == "nccl"
    assert mesh.make_mesh(mesh.MeshConfig(tp=2), one,
                          backend_for(one)).backend == "gloo"
