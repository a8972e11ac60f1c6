"""aha_tpu_torch's mesh layer (parallel/) against aha_tpu/parallel/mesh.py
on the JAX package's 8 virtual CPU devices.

- The mesh, its rules and each rank's slice: `make_mesh` shapes and
  refusals, `spec_for`, and `shard_params`, whose slice for rank (i, j)
  must equal JAX's addressable shard on device (i, j) of the same mesh —
  truncated specs and axes that do not divide included.
- Tensor parallelism: the port's gloo ranks on the CPU, started ONCE for
  the module by a child process (tests/parallel_rank0.py, rank 0: it
  spawns the workers) that runs every scenario and writes its results;
  each test below asserts on one scenario.  Same numpy weights and
  prompts as aha_tpu's tp mesh: the sharded forward within 1e-4 (f32),
  greedy streams equal (TextEngine, the prefix store warm against cold,
  the int8 cache, BatchEngine with threaded requests, tp 4, served
  `load_model(tp=2)`), bf16 streams equal to the port's own tp 1, a
  sampled request whose every rank's cache holds rank 0's tokens, a
  stream cut short by the host that leaves the group in step, and two
  streams open at once.
- The head combine against fast_argmax on the full logits (a tie across
  shards, a NaN on one shard).
- Data parallelism: dp 2 BatchEngine replicas stream what aha_tpu's dp 2
  mesh streams, for Qwen3, MiniCPM4 and LFM2.
- Refusals, and no process left behind after a shutdown, a killed rank 0
  or a killed worker.

Every child process and every request has a deadline.  float32 on the
CPU."""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
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
from aha_tpu.models import qwen3 as jqwen3
from aha_tpu.parallel import mesh as jmesh
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig, fast_argmax
from aha_tpu_torch.io.convert import cache_from_jax, params_from_jax
from aha_tpu_torch.models import loader
from aha_tpu_torch.models.qwen3 import (QWEN3_CACHE_RULES,
                                        QWEN3_PARTITION_RULES, Qwen3Config,
                                        Qwen3Model, check_tp)
from aha_tpu_torch.parallel import layers, mesh
from aha_tpu_torch.parallel.replicas import ReplicaEngine
from aha_tpu_torch.parallel.ranks import FAILED_EXIT
from tests.fixtures import build_tiny_qwen3_repo

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK0 = os.path.join(ROOT, "tests", "parallel_rank0.py")
#: seconds the scenarios' rank 0 may take (starting groups of 2 and 4 gloo
#: ranks, about 4 s each here, and every scenario)
RANK0_SECS = 240
#: seconds a lifecycle child, or a process it leaves, may take
LIFE_SECS = 60
DEADLINE = 60.0
GEO = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
           head_dim=16)
JGREEDY = JSampling(temperature=None)
GREEDY = SamplingConfig()
BASE = [(i * 7) % 100 + 1 for i in range(40)]
EXT = BASE + [9, 8, 7]
INT8_PROMPT = [(i * 19) % 100 + 1 for i in range(24)]
BATCH_PROMPTS = [[(i * 29 + j) % 100 + 1 for j in range(36 + i)]
                 for i in range(3)]
IDS = [3, 1, 4, 1, 5, 9, 2, 6]
CHAT = {"model": "Qwen/Qwen3-0.6B", "max_tokens": 6, "temperature": 0.0,
        "messages": [{"role": "user", "content": "hello world"}]}


def _child_env() -> dict:
    env = dict(os.environ)
    env["AHA_DEVICE"] = "cpu"
    env["PYTHONPATH"] = ROOT
    return env


@pytest.fixture(scope="module")
def pair():
    jm = jqwen3.Qwen3Model(jqwen3.Qwen3Config(**GEO), max_rope_len=256)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(3),
                                                 scale=0.3))
    tm = Qwen3Model(Qwen3Config(**GEO), max_rope_len=256)
    return jm, jp, tm, params_from_jax(jp)


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """The tiny Qwen3 repo with its vocab padded to an even size (zero
    rows past the tokenizer's ids, as a published checkpoint pads its
    vocab): tp 2 splits the vocab, and check_tp refuses an odd one."""
    from safetensors.numpy import load_file, save_file

    path = str(tmp_path_factory.mktemp("tiny_qwen3"))
    cfg = build_tiny_qwen3_repo(path)
    vocab = -(-cfg["vocab_size"] // 4) * 4
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


@pytest.fixture(scope="module")
def runs(pair, repo, tmp_path_factory):
    """Every tp scenario, run once by rank 0 (a child process) and its gloo
    workers."""
    _, jp, _, _ = pair
    d = tmp_path_factory.mktemp("tp_runs")
    spec = dict(geo=GEO, tree=jp, base=BASE, ext=EXT, ids=IDS,
                int8_prompt=INT8_PROMPT, batch_prompts=BATCH_PROMPTS,
                repo=repo, chat=CHAT, dump=str(d / "cache"))
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(spec, f)
    p = subprocess.run([sys.executable, RANK0, "scenarios",
                        str(d / "in.pkl"), str(d / "out.pkl")],
                       env=_child_env(), capture_output=True, text=True,
                       timeout=RANK0_SECS)
    assert p.returncode == 0, p.stderr[-4000:]
    with open(d / "out.pkl", "rb") as f:
        res = pickle.load(f)
    res["dump"] = str(d / "cache")
    return res


def _jax_sharded(jm, jp, tp):
    jmsh = jmesh.make_mesh(jmesh.MeshConfig(tp=tp))
    return jmsh, jmesh.shard_params(jax.tree.map(jnp.asarray, jp), jmsh,
                                    jqwen3.QWEN3_PARTITION_RULES)


# -- the mesh, its rules, a rank's slice ------------------------------------

@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 1), (1, 2), (8, 1)])
def test_make_mesh_shapes(dp, tp):
    cfg = (dp, tp)
    got = mesh.make_mesh(mesh.MeshConfig(*cfg), ["cpu"] * 8)
    want = jmesh.make_mesh(jmesh.MeshConfig(*cfg))
    assert got.shape == dict(want.shape)
    assert got.backend == "gloo"


def test_make_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(mesh.MeshConfig(dp=2, tp=8), ["cpu"] * 8)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=8))
    assert "needs 16 devices, have 8" in str(got.value)
    assert "needs 16 devices, have 8" in str(want.value)


def test_backend_follows_the_device():
    """NCCL for cards (one a rank), gloo for the CPU, gloo over one card
    only when asked for."""
    cards = [torch.device("cuda", i) for i in range(2)]
    assert mesh.make_mesh(mesh.MeshConfig(tp=2), cards).backend == "nccl"
    one = [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="one card a rank"):
        mesh.make_mesh(mesh.MeshConfig(tp=2), one)
    m = mesh.make_mesh(mesh.MeshConfig(tp=2), one, backend="gloo")
    assert (m.backend, m.device) == ("gloo", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cuda devices only"):
        mesh.make_mesh(mesh.MeshConfig(tp=2), ["cpu"] * 2, backend="nccl")


@pytest.mark.parametrize("path", ["layers.q.w", "layers.k.w", "layers.o.w",
                                  "layers.mlp.gate.w", "layers.mlp.down.w",
                                  "embed.w", "visual.patch_embed.w",
                                  "norm.w", "layers.q_norm.w", "x.y"])
def test_spec_for_matches_jax(path):
    rules = ((r"layers\.(q|k|v)\.w", (None, None, "tp")),
             (r"layers\.o\.w", (None, "tp", None)),
             (r"(^|\.)embed\.w", ("tp", None)), (r"norm", ()))
    assert mesh.spec_for(path, rules) == tuple(jmesh.spec_for(path, rules))
    assert mesh.spec_for(path, QWEN3_PARTITION_RULES) == tuple(
        jmesh.spec_for(path, jqwen3.QWEN3_PARTITION_RULES))


def _jax_shard(leaf, dev) -> np.ndarray:
    (s,) = [s for s in leaf.addressable_shards if s.device == dev]
    return np.asarray(s.data)


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 2), (1, 8), (1, 1)])
def test_shard_params_is_jax_addressable_shard(pair, dp, tp):
    """Every leaf of the Qwen3 tree (the head transposed: the port's is
    vocab-major) and of a (slots, kv-heads) cache, and a rule set whose
    specs are longer than the leaves and name axes that do not divide
    them (tp 8 does not divide 4 kv heads, nor 130 rows); at 1 x 1 every
    slice is the whole tensor."""
    jm, jp, _, tp_params = pair
    jmsh = jmesh.make_mesh(jmesh.MeshConfig(dp=dp, tp=tp))
    jsharded = jmesh.shard_params(jp, jmsh, jqwen3.QWEN3_PARTITION_RULES)
    jcache = jax.tree.map(np.asarray, jm.init_cache(4, 16, jnp.float32))
    rng = np.random.default_rng(0)
    jcache = {k: (rng.standard_normal(v.shape).astype(np.float32)
                  if k in ("k", "v") else v) for k, v in jcache.items()}
    jscache = jmesh.shard_params(jcache, jmsh, jqwen3.QWEN3_CACHE_RULES)
    odd = {"a": rng.standard_normal((130, 8)).astype(np.float32),
           "b": rng.standard_normal((6, 16)).astype(np.float32)}
    odd_rules = ((r"^a$", ("tp", "dp", None, None)), (r"^b$", ("dp", "tp")))
    jodd = jmesh.shard_params(odd, jmsh, odd_rules)
    tcache = cache_from_jax(jcache)
    todd = {k: torch.from_numpy(v) for k, v in odd.items()}
    for i in range(dp):
        for j in range(tp):
            m = mesh.make_mesh(mesh.MeshConfig(dp=dp, tp=tp), ["cpu"] * 8,
                               rank=i * tp + j)
            dev = jmsh.devices[i, j]
            got = mesh.shard_params(tp_params, m, QWEN3_PARTITION_RULES)
            for path, want in _leaves(jsharded):
                t = _at(got, path)
                if path == "lm_head.w":
                    t = t.t()
                np.testing.assert_array_equal(t.numpy(),
                                              _jax_shard(want, dev), path)
            got_c = mesh.shard_params(tcache, m, QWEN3_CACHE_RULES)
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    got_c[name].numpy(), _jax_shard(jscache[name], dev))
            got_o = mesh.shard_params(todd, m, odd_rules)
            for name in odd:
                np.testing.assert_array_equal(
                    got_o[name].numpy(), _jax_shard(jodd[name], dev))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _at(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 2), (1, 8)])
def test_local_shape_is_the_slice_shape(dp, tp):
    """The shape a rank allocates (a cache by its rules) is the shape of
    the slice shard_params gives it, rule truncated and axes that do not
    divide replicated included."""
    rules = ((r"^a$", ("tp", "dp", None, None)), (r"^b$", ("dp", "tp")),
             (r"^c$", (None, "dp", None, "tp")))
    tree = {"a": torch.zeros(130, 8), "b": torch.zeros(6, 16),
            "c": torch.zeros(2, 4, 3, 64)}
    for rank in range(dp * tp):
        m = mesh.make_mesh(mesh.MeshConfig(dp=dp, tp=tp), ["cpu"] * 8,
                           rank=rank)
        got = mesh.shard_params(tree, m, rules)
        for name, t in tree.items():
            assert mesh.local_shape(t.shape, mesh.spec_for(name, rules),
                                    m) == tuple(got[name].shape), name


@pytest.mark.parametrize("dim", [0, 1])
def test_read_shard_reads_a_rank_slice(tmp_path, dim):
    """A rank's slice read from a safetensors file (its bytes alone) and
    cut from a whole tensor (any other source) are the same."""
    from safetensors.torch import save_file

    from aha_tpu_torch.io.weights import SafetensorsSource, read_shard

    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    save_file({"w": t}, str(tmp_path / "m.safetensors"))
    src = SafetensorsSource([str(tmp_path / "m.safetensors")])
    for index in range(2):
        want = t.chunk(2, dim)[index]
        torch.testing.assert_close(read_shard(src, "w", dim, index, 2), want,
                                   rtol=0, atol=0)
        torch.testing.assert_close(read_shard({"w": t}, "w", dim, index, 2),
                                   want, rtol=0, atol=0)


def test_shard_params_keeps_a_tied_head_one_slice(pair):
    *_, tp_params = pair
    m = mesh.make_mesh(mesh.MeshConfig(tp=2), ["cpu"] * 2, rank=1)
    got = mesh.shard_params(tp_params, m, QWEN3_PARTITION_RULES)
    assert got["lm_head"]["w"] is got["embed"]["w"]
    assert got["embed"]["w"].shape == (GEO["vocab_size"] // 2,
                                       GEO["hidden_size"])


def test_cache_rules_give_the_rank_model_cache():
    """A rank's model allocates exactly its slice of the full cache:
    the flat rows' kv-head groups, and the int8 scales beside them."""
    full = Qwen3Model(Qwen3Config(**GEO))
    for rank in range(2):
        m = mesh.make_mesh(mesh.MeshConfig(tp=2), ["cpu"] * 2, rank=rank)
        local = Qwen3Model(Qwen3Config(**GEO), mesh=m)
        for dtype in (torch.float32, torch.int8):
            want = mesh.shard_params(full.init_cache(3, 32, dtype), m,
                                     QWEN3_CACHE_RULES)
            got = local.init_cache(3, 32, dtype)
            assert {k: v.shape for k, v in got.items()} == \
                {k: v.shape for k, v in want.items()}


# -- the head combine ---------------------------------------------------------

def _packed(logits: torch.Tensor, tp: int) -> torch.Tensor:
    """The (tp, 2) rows the ranks' value-out heads give, as each rank's
    plain version computes them over its vocab shard."""
    V = logits.shape[0]
    rows = []
    for r, part in enumerate(logits.reshape(tp, V // tp)):
        idx = fast_argmax(part)
        nan = torch.isnan(part).any()
        val = torch.where(nan, torch.tensor(float("nan")), part[idx.long()])
        rows.append(torch.stack([val, (idx + r * (V // tp)).float()]))
    return torch.stack(rows)


@pytest.mark.parametrize("case", ["random", "tie_across", "tie_within",
                                  "nan_one_shard", "nan_and_max_elsewhere"])
@pytest.mark.parametrize("tp", [2, 4])
def test_head_combine_matches_fast_argmax(case, tp):
    g = torch.Generator().manual_seed(tp)
    logits = torch.randn(64, generator=g)
    if case == "tie_across":           # the same max on the last two shards
        logits[63] = logits[40] = 9.0
    if case == "tie_within":
        logits[5] = logits[9] = 9.0
    if case == "nan_one_shard":
        logits[33] = float("nan")
    if case == "nan_and_max_elsewhere":
        logits[3], logits[60] = 50.0, float("nan")
    got = layers.pick_token(_packed(logits, tp), 64)
    assert int(got) == int(fast_argmax(logits))
    if "nan" in case:
        assert int(got) == 63


def test_head_value_out_plain_matches_logits():
    from aha_tpu_torch.ops.lm_head import head_argmax_value

    g = torch.Generator().manual_seed(0)
    w, h = torch.randn(96, 32, generator=g), torch.randn(1, 32, generator=g)
    idx, val = head_argmax_value(w, h)
    logits = (h @ w.t())[0]
    assert int(idx) == int(fast_argmax(logits))
    assert float(val) == pytest.approx(float(logits.max()), rel=1e-6)
    w[17] = float("nan")
    idx, val = head_argmax_value(w, h)
    assert int(idx) == 95 and bool(torch.isnan(val))


# -- tensor parallelism over gloo ranks ---------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_jax_mesh(pair, runs, tp):
    jm, jp, _, _ = pair
    jmsh, sharded = _jax_sharded(jm, jp, tp)

    @jax.jit
    def fwd(params, ids):
        cache = jm.init_cache(1, len(IDS), jnp.float32)
        hidden, _ = jm.backbone(params, ids, cache)
        return jm.logits(params, hidden)

    with jax.sharding.set_mesh(jmsh):
        want = np.asarray(fwd(sharded, jnp.asarray([IDS])))
    np.testing.assert_allclose(runs[f"forward{tp}"], want, rtol=1e-4,
                               atol=1e-4)


def test_tp_text_engine_and_prefix_store_match_jax(pair, runs):
    """Cold streams equal aha_tpu's tp 4 engine's; warm (prefix store)
    streams equal cold ones, with two entries stored."""
    jm, jp, _, _ = pair
    jmsh, sharded = _jax_sharded(jm, jp, 4)
    cold = JEngine(jm, sharded, eos_token_ids=[], cache_dtype=jnp.float32,
                   max_seq_len=256, mesh=jmsh,
                   cache_rules=jqwen3.QWEN3_CACHE_RULES)
    want = [cold.generate_tokens(p, JGREEDY, max_tokens=6)
            for p in (BASE, EXT)]
    assert runs["cold"] == want
    assert runs["warm"] == [want[0], want[0], want[1]]
    assert runs["warm_entries"] == 2
    assert runs["cold4"] == want[0]


def test_tp_int8_cache_matches_jax(pair, runs):
    jm, jp, _, _ = pair
    jmsh, sharded = _jax_sharded(jm, jp, 2)
    eng = JEngine(jm, sharded, eos_token_ids=[], cache_dtype=jnp.int8,
                  max_seq_len=256, mesh=jmsh,
                  cache_rules=jqwen3.QWEN3_CACHE_RULES)
    assert runs["int8"] == eng.generate_tokens(INT8_PROMPT, JGREEDY,
                                               max_tokens=12)


def test_tp_bf16_stream_matches_one_device(pair, runs):
    """bf16 parameters and cache: the tp 2 stream equals the port's own
    one-device stream (o and down reduced in f32)."""
    jm, jp, _, _ = pair
    tm = Qwen3Model(Qwen3Config(**GEO), max_rope_len=256)
    eng = TextEngine(tm, params_from_jax(jp, dtype=torch.bfloat16),
                     eos_token_ids=[], max_seq_len=256)
    assert runs["bf16"] == eng.generate_tokens(BASE, GREEDY, 16)


def test_tp_batch_engine_matches_jax(pair, runs):
    jm, jp, _, _ = pair
    plain = JBatchEngine(jm, jax.tree.map(jnp.asarray, jp),
                         eos_token_ids=[], slots=2, cache_dtype=jnp.float32,
                         max_seq_len=256)
    try:
        want = {i: plain.generate_tokens(p, JGREEDY, max_tokens=10)
                for i, p in enumerate(BATCH_PROMPTS)}
    finally:
        plain.shutdown()
    assert runs["batch"] == want


def test_tp_sampled_request_caches_hold_rank0_tokens(pair, runs):
    """After a sampled request every rank's cache rows are its slice of
    the one-device cache of the prompt and rank 0's tokens."""
    _, _, tm, tp_params = pair
    toks = runs["sampled"]
    assert len(toks) == 12
    seq = BASE + toks[:-1]
    cache = tm.init_cache(1, len(seq), torch.float32)
    with torch.no_grad():
        tm.backbone(tp_params, torch.tensor([seq]), cache)
    hd = GEO["num_key_value_heads"] // 2 * GEO["head_dim"]
    for r in range(2):
        got = torch.load(f"{runs['dump']}.rank{r}")
        for name in ("k", "v"):
            want = cache[name][:, :, :, r * hd:(r + 1) * hd]
            torch.testing.assert_close(got[name], want, rtol=1e-4,
                                       atol=1e-4)


def test_tp_stream_cut_by_the_host_keeps_ranks_in_step(runs):
    """A stream closed after 3 tokens (a client gone) returns the cache;
    the next request streams as from a fresh group."""
    assert runs["cut"] == runs["cold"][0][:3]
    assert runs["after_cut"] == runs["cold"][1]


def test_tp_streams_may_overlap(runs):
    """Two streams open at once on one tp engine, drawn in turn: each
    request's operations act on its own cache on every rank."""
    assert runs["overlap"] == runs["cold"]


def test_served_load_model_tp2_matches_jax(repo, runs):
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu.params import ChatCompletionParameters as JParameters

    served = jload_model("Qwen/Qwen3-0.6B", repo, max_seq_len=512, tp=2)
    want = served.generate(JParameters.model_validate(CHAT))
    assert runs["served"] == want.choices[0].message.content
    assert len(runs["served_pids"]) == 1
    for pid in runs["served_pids"]:
        assert _gone(pid)


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_serv_tp2_replies_and_shutdown_stops_its_worker(repo, runs):
    """`serv <repo> --tp 2` in a child on the CPU: it answers the chat as
    load_model(tp=2) did, and POST /shutdown ends it and its worker."""
    import urllib.request

    port = _free_port()
    child = subprocess.Popen(
        [sys.executable, "-m", "aha_tpu_torch", "serv", repo, "--tp", "2",
         "--port", str(port), "--max-seq-len", "512"], cwd=ROOT,
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        end = time.monotonic() + LIFE_SECS
        while True:
            assert child.poll() is None, child.stdout.read()[-3000:]
            assert time.monotonic() < end, "the server did not come up"
            try:
                with urllib.request.urlopen(base + "/health", timeout=2):
                    break
            except OSError:
                time.sleep(0.2)
        workers = [c.pid for c in psutil.Process(child.pid).children()
                   if "spawn_main" in " ".join(c.cmdline())]
        assert len(workers) == 1
        req = urllib.request.Request(
            base + "/v1/chat/completions",
            data=json.dumps({**CHAT, "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=DEADLINE) as r:
            reply = json.loads(r.read())["choices"][0]["message"]
        assert reply["content"] == runs["served"]
        with urllib.request.urlopen(urllib.request.Request(
                base + "/shutdown", method="POST", data=b""), timeout=10):
            pass
        assert child.wait(LIFE_SECS) == 0
        assert all(_gone(w) for w in workers)
    finally:
        if child.poll() is None:
            child.kill()
        child.communicate(timeout=LIFE_SECS)


# -- data parallelism -----------------------------------------------------------

def _dp_pair(family: str):
    if family == "qwen3":
        jm = jqwen3.Qwen3Model(jqwen3.Qwen3Config(**GEO), max_rope_len=256)
        jp = jm.init_random(jax.random.PRNGKey(5), scale=0.3)
        return (jm, jp, jqwen3.QWEN3_PARTITION_RULES,
                jqwen3.QWEN3_CACHE_RULES,
                lambda: Qwen3Model(Qwen3Config(**GEO), max_rope_len=256))
    if family == "minicpm4":
        from aha_tpu.models import llama as jllama
        from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
        from tests.test_torch_llama_batch import BASE as LB, MINICPM

        kw = {**LB, **MINICPM}
        jm = jllama.LlamaModel(jllama.LlamaConfig(**kw), max_rope_len=256)
        jp = jm.init_random(jax.random.PRNGKey(5), scale=0.3)
        return (jm, jp, jllama.LLAMA_PARTITION_RULES,
                jllama.LLAMA_CACHE_RULES,
                lambda: LlamaModel(LlamaConfig.from_dict(kw),
                                   max_rope_len=256))
    from aha_tpu.models import lfm2 as jlfm2
    from aha_tpu_torch.models.lfm2 import Lfm2Config, Lfm2Model
    from tests.test_torch_lfm2 import TINY

    jm = jlfm2.Lfm2Model(jlfm2.Lfm2Config(**TINY), max_rope_len=256)
    jp = jm.init_random(jax.random.PRNGKey(5), scale=0.3)
    return (jm, jp, jlfm2.LFM2_PARTITION_RULES, jlfm2.LFM2_CACHE_RULES,
            lambda: Lfm2Model(Lfm2Config(**TINY), max_rope_len=256))


def _threaded(engine, prompts, cfg, n):
    out, errs = {}, []

    def one(i):
        try:
            out[i] = engine.generate_tokens(prompts[i], cfg, n)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in prompts]
    [t.start() for t in ts]
    [t.join(DEADLINE) for t in ts]
    assert not errs, errs
    assert len(out) == len(prompts), "a request passed its deadline"
    return out


@pytest.mark.parametrize("family", ["qwen3", "minicpm4", "lfm2"])
def test_dp_replicas_match_jax_dp_mesh(family):
    """Two replicas of 2 slots against aha_tpu's BatchEngine of 4 slots
    sharded over a dp 2 mesh: 6 threaded requests, the same streams."""
    jm, jp, prules, crules, make = _dp_pair(family)
    prompts = {i: [(i * 31 + j) % 100 + 1 for j in range(20 + 3 * i)]
               for i in range(6)}
    jmsh = jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=1))
    jbe = JBatchEngine(jm, jmesh.shard_params(jp, jmsh, prules),
                       eos_token_ids=[], slots=4, cache_dtype=jnp.float32,
                       max_seq_len=256, mesh=jmsh, cache_rules=crules)
    try:
        want = _threaded(jbe, prompts, JGREEDY, 8)
    finally:
        jbe.shutdown()
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    eng = ReplicaEngine([BatchEngine(make(), params, eos_token_ids=[],
                                     slots=2, cache_dtype=torch.float32,
                                     max_seq_len=256) for _ in range(2)])
    try:
        got = _threaded(eng, prompts, GREEDY, 8)
    finally:
        eng.shutdown()
    assert got == want


def test_replicas_pick_the_most_free_slots():
    class Fake:
        def __init__(self, slots):
            self.slots, self.eos_token_ids = slots, set()

        def stream_tokens(self, *a):
            yield 1

    eng = ReplicaEngine([Fake(2), Fake(2)])
    picks = [eng._pick() for _ in range(4)]
    assert picks == [0, 1, 0, 1]
    eng._busy = [0, 0]
    assert eng._pick() == 0          # a tie goes to the lowest
    gen = eng.stream_tokens([1], GREEDY)
    assert next(gen) == 1 and eng._busy == [1, 1]
    gen.close()
    assert eng._busy == [1, 0]


# -- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("name,size", [("num_key_value_heads", 2),
                                       ("intermediate_size", 90),
                                       ("vocab_size", 130)])
def test_tp_that_does_not_divide_is_refused_where_jax_runs_it(name, size):
    """Departure: the JAX package replicates a tensor whose dimension tp
    does not divide and lets GSPMD reconcile the rest; the port's ranks
    need equal slices and refuse, naming the dimension, before a rank's
    model is built."""
    cfg = dict(GEO, **{name: size})
    jm3 = jqwen3.Qwen3Model(jqwen3.Qwen3Config(**cfg), max_rope_len=64)
    jp3 = jm3.init_random(jax.random.PRNGKey(0))
    jmsh, sharded = _jax_sharded(jm3, jax.tree.map(np.asarray, jp3), 4)
    cache = jm3.init_cache(1, 8, jnp.float32)
    with jax.sharding.set_mesh(jmsh):
        hidden, _ = jax.jit(jm3.backbone)(sharded, jnp.asarray([IDS]), cache)
    assert np.isfinite(np.asarray(hidden)).all()
    words = rf"--tp 4 does not divide {name} \({size}\)"
    with pytest.raises(ValueError, match=words):
        check_tp(Qwen3Config(**cfg), 4)
    with pytest.raises(ValueError, match=words):
        Qwen3Model(Qwen3Config(**cfg),
                   mesh=mesh.make_mesh(mesh.MeshConfig(tp=4), ["cpu"] * 4))


@pytest.mark.parametrize("model_id,kw,words", [
    ("Qwen/Qwen3-0.6B", dict(tp=2, dp=2, batch_slots=4), "TP_WITH_DP"),
    ("LiquidAI/LFM2-1.2B", dict(tp=2), "sharding of 'lfm2' is not "
                                       "ported"),
    ("Qwen/Qwen3.5-0.8B", dict(tp=2), "sharding of 'qwen3_5' is "
                                      "not ported"),
    ("LiquidAI/LFM2-VL-1.6B", dict(tp=2), "sharding of "
                                          "'lfm2vl'"),
    ("sentence-transformers/all-MiniLM-L6-v2", dict(tp=2),
     "--tp does not apply to 'minilm'"),
    ("OpenBMB/VoxCPM-0.5B", dict(tp=2), "--tp does not apply to 'voxcpm'"),
    ("Qwen/Qwen3-0.6B", dict(tp=2, spec_tokens=4), "SPEC_WITH_TP"),
    ("qwen3.5-gguf", dict(tp=2), "GGUF serving is single-device"),
    ("qwen3.5-gguf", dict(dp=2, batch_slots=2), "GGUF serving is single"),
])
def test_refusals_before_loading(monkeypatch, model_id, kw, words):
    from aha_tpu_torch.core import engine as tengine
    from aha_tpu_torch.models import text_served

    monkeypatch.setenv("AHA_DEVICE", "cpu")
    want = getattr(text_served, words, getattr(tengine, words, words))
    gguf = {"gguf": "/nonexistent.gguf"} if "gguf" in model_id else {}
    with pytest.raises(ValueError) as got:
        loader.load_model(model_id, "/nonexistent", **gguf, **kw)
    assert want in str(got.value)


@pytest.mark.parametrize("kw,n", [(dict(tp=2), 2),
                                  (dict(dp=4, batch_slots=4), 4)])
def test_too_few_cards_refused_before_loading(monkeypatch, kw, n):
    """With the card count patched to 1 and no AHA_DEVICE, --tp 2 and
    --dp 4 are refused before any weights load, naming both counts."""
    monkeypatch.delenv("AHA_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(loader, "FAMILY_LOADERS", {})
    with pytest.raises(ValueError) as got:
        loader.load_model("Qwen/Qwen3-0.6B", "/nonexistent", **kw)
    assert f"needs {n} cards" in str(got.value)
    assert "this host has 1" in str(got.value)


def test_a_rank_never_falls_back_to_the_cpu(monkeypatch):
    from aha_tpu_torch.utils.device import mesh_devices

    monkeypatch.delenv("AHA_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_devices(tp=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_devices(tp=2) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]


# -- no process left behind -----------------------------------------------------

def _gone(pid: int, secs: float = LIFE_SECS) -> bool:
    end = time.monotonic() + secs
    while time.monotonic() < end:
        try:
            if psutil.Process(pid).status() == psutil.STATUS_ZOMBIE:
                return True
        except psutil.NoSuchProcess:
            return True
        time.sleep(0.1)
    return False


@pytest.fixture(scope="module")
def lifecycles(tmp_path_factory):
    """Three tp 2 groups started at once: `shutdown`, `wait` (rank 0 to
    be killed) and `serve` (a worker to be killed mid-request)."""
    d = tmp_path_factory.mktemp("lifecycle")
    procs = {}
    for mode in ("shutdown", "wait", "serve"):
        procs[mode] = (subprocess.Popen(
            [sys.executable, RANK0, "lifecycle", mode, str(d / mode)],
            env=_child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), d / mode)
    yield procs
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate(timeout=LIFE_SECS)


def _pids(path) -> dict:
    end = time.monotonic() + LIFE_SECS
    while not os.path.exists(path):
        assert time.monotonic() < end, "the group did not start"
        time.sleep(0.1)
    with open(path) as f:
        return json.load(f)


def test_no_worker_after_shutdown(lifecycles):
    p, path = lifecycles["shutdown"]
    pids = _pids(path)
    assert p.wait(LIFE_SECS) == 0
    assert all(_gone(w) for w in pids["workers"])


def test_no_worker_after_rank0_is_killed(lifecycles):
    p, path = lifecycles["wait"]
    pids = _pids(path)
    os.kill(pids["rank0"], signal.SIGKILL)
    p.wait(LIFE_SECS)
    assert all(_gone(w) for w in pids["workers"])


def test_killed_worker_fails_the_request_and_rank0(lifecycles):
    p, path = lifecycles["serve"]
    pids = _pids(path)
    time.sleep(0.5)                    # requests are running
    os.kill(pids["workers"][0], signal.SIGKILL)
    assert p.wait(LIFE_SECS) == FAILED_EXIT
    assert "[tp]" in p.stderr.read()
    assert all(_gone(w) for w in pids["workers"])
