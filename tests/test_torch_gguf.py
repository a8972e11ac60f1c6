"""aha_tpu_torch's GGUF path against aha_tpu's: the reader (dequantized
values and metadata), the Qwen3 config and parameters of `load_qwen3_gguf`,
the head each stored format gives, the refusal of layers that mix grids,
and greedy token streams through TextEngine and a 2-slot BatchEngine for a
Q8_0 file, a 4-bit file (Q4_0 / Q4_K, with Q6_K ffn_down on the int8
grid) and an untied file with a quantized head.  float32 on the CPU, the
tiny geometry of tests/test_gguf.py; every engine call has a deadline and
every engine is shut down."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aha_tpu.native
from aha_tpu.core.batch_engine import BatchEngine as JBatchEngine
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.io import gguf as jg
from aha_tpu.io.gguf_models import load_qwen3_gguf as jload
from aha_tpu.io.gguf_models import qwen3_config_from_gguf as jconfig
from aha_tpu.models.qwen3 import Qwen3Config as JConfig
from aha_tpu.models.qwen3 import Qwen3Model as JModel
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io import gguf as tg
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.io.gguf_models import load_qwen3_gguf, qwen3_config_from_gguf
from aha_tpu_torch.models.qwen3 import fuse_decode_params, pack_params
from aha_tpu_torch.ops import quant_matmul as tq

torch.set_num_threads(1)
GEO = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16, tie_word_embeddings=True, max_position_embeddings=256)
META = {
    "general.architecture": "qwen3",
    "qwen3.block_count": 2,
    "qwen3.embedding_length": 64,
    "qwen3.feed_forward_length": 128,
    "qwen3.attention.head_count": 4,
    "qwen3.attention.head_count_kv": 2,
    "qwen3.attention.key_length": 16,
    "qwen3.attention.layer_norm_rms_epsilon": 1e-6,
    "qwen3.rope.freq_base": 1000000.0,
    "qwen3.context_length": 256,
}
#: per-file GGML formats: attention, gate|up, down, token_embd; "untied"
#: adds a Q8_0 output.weight
FORMATS = {
    "q8": (jg.GGML_Q8_0, jg.GGML_Q8_0, jg.GGML_Q8_0, jg.GGML_F32),
    "q4": (jg.GGML_Q4_0, jg.GGML_Q4_K, jg.GGML_Q6_K, jg.GGML_F32),
    "untied": (jg.GGML_Q8_0, jg.GGML_Q4_K, jg.GGML_Q8_0, jg.GGML_F32),
    "tied-q8": (jg.GGML_Q8_0, jg.GGML_Q8_0, jg.GGML_Q8_0, jg.GGML_Q8_0),
}
DEADLINE = 60.0
GREEDY, JGREEDY = SamplingConfig(), JSampling()


def _write(path, params, fmt, layer_fmt=None):
    """A tiny float Qwen3 quantized into a GGUF with llama.cpp naming;
    `layer_fmt(i, name)` may override one tensor's format per layer."""
    attn, gateup, down, embed = FORMATS[fmt]
    tensors = {
        "token_embd.weight": (np.asarray(params["embed"]["w"]), embed),
        "output_norm.weight": (np.asarray(params["norm"]["w"]), jg.GGML_F32),
    }
    if fmt == "untied":
        w = np.random.default_rng(11).standard_normal((128, 64)) * 0.3
        tensors["output.weight"] = (w.astype(np.float32), jg.GGML_Q8_0)
    for i in range(2):
        lp = jax.tree.map(lambda x: np.asarray(x[i]), params["layers"])
        b = f"blk.{i}."
        for name, p in (("attn_norm", lp["ln1"]), ("ffn_norm", lp["ln2"]),
                        ("attn_q_norm", lp["q_norm"]),
                        ("attn_k_norm", lp["k_norm"])):
            tensors[b + name + ".weight"] = (p["w"], jg.GGML_F32)
        # gguf stores (out, in): transpose the (in, out) layout
        for name, p, t in (("attn_q", lp["q"], attn), ("attn_k", lp["k"], attn),
                           ("attn_v", lp["v"], attn),
                           ("attn_output", lp["o"], attn),
                           ("ffn_gate", lp["mlp"]["gate"], gateup),
                           ("ffn_up", lp["mlp"]["up"], gateup),
                           ("ffn_down", lp["mlp"]["down"], down)):
            if layer_fmt is not None:
                t = layer_fmt(i, name) or t
            tensors[b + name + ".weight"] = (np.ascontiguousarray(p["w"].T), t)
    jg.write_gguf(str(path), META, tensors)
    return str(path)


@pytest.fixture(scope="module")
def float_params():
    # scale 0.3: greedy streams that are not one repeated token
    return JModel(JConfig(**GEO)).init_random(jax.random.PRNGKey(7),
                                              scale=0.3)


@pytest.fixture(scope="module")
def files(tmp_path_factory, float_params):
    d = tmp_path_factory.mktemp("gguf")
    return {fmt: _write(d / f"{fmt}.gguf", float_params, fmt)
            for fmt in FORMATS}


@pytest.fixture
def engines(request):
    made = []

    def make(cls, *a, **kw):
        e = cls(*a, **kw)
        made.append(e)
        return e

    request.addfinalizer(lambda: [e.shutdown() for e in made])
    return make


def _deadline(fn, *a):
    out, errs = [None], []

    def run():
        try:
            out[0] = fn(*a)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=DEADLINE)
    assert not t.is_alive(), "an engine call did not finish"
    if errs:
        raise errs[0]
    return out[0]


# -- reader -------------------------------------------------------------------


def test_reader_matches_jax(tmp_path, monkeypatch):
    """F32, F16, BF16, Q8_0, Q4_0, Q4_K and Q6_K tensors: metadata equal,
    dequantized values bit-equal to the JAX reader's numpy path (the port
    carries no C++ dequant), and equal within f32 rounding to its native
    one."""
    rng = np.random.default_rng(0)
    types = {"f32": jg.GGML_F32, "f16": jg.GGML_F16, "q8": jg.GGML_Q8_0,
             "q4_0": jg.GGML_Q4_0, "q4_k": jg.GGML_Q4_K, "q6_k": jg.GGML_Q6_K}
    tensors = {n: ((rng.standard_normal((16, 256)) * 0.1 + 0.01).astype(
        np.float32), t) for n, t in types.items()}
    meta = {**META, "some.list": ["a", "b"], "ints": [1, 2], "flag": True}
    path = str(tmp_path / "t.gguf")
    tg.write_gguf(path, meta, tensors)
    bf = np.ascontiguousarray(tensors["f32"][0].view(np.uint32) >> 16,
                              np.uint16)
    with open(path, "rb") as f:
        assert f.read() == _jax_bytes(tmp_path, meta, tensors)
    port, ref = tg.GGUFFile(path), jg.GGUFFile(path)
    assert port.metadata == ref.metadata
    assert {k: (v.shape, v.ggml_type, v.offset)
            for k, v in port.tensors.items()} == \
        {k: (v.shape, v.ggml_type, v.offset) for k, v in ref.tensors.items()}
    native = {n: ref.dequantize(n) for n in types}
    monkeypatch.setattr(aha_tpu.native, "dequant", lambda *a: None)
    for n in types:
        got = port.dequantize(n)
        np.testing.assert_array_equal(got, ref.dequantize(n))
        np.testing.assert_allclose(got, native[n], rtol=1e-6, atol=1e-7)
    got = tg._dequant(bf.view(np.uint8).reshape(-1), tg.GGML_BF16)
    np.testing.assert_array_equal(got, jg._dequant(bf.view(np.uint8).reshape(
        -1), jg.GGML_BF16))


def _jax_bytes(tmp_path, meta, tensors) -> bytes:
    p = str(tmp_path / "jax.gguf")
    jg.write_gguf(p, meta, tensors)
    with open(p, "rb") as f:
        return f.read()


def test_config_matches_jax(files):
    for fmt, path in files.items():
        got = qwen3_config_from_gguf(tg.GGUFFile(path))
        assert got.__dict__ == jconfig(jg.GGUFFile(path)).__dict__, fmt
    assert not qwen3_config_from_gguf(
        tg.GGUFFile(files["untied"])).tie_word_embeddings


# -- parameters ---------------------------------------------------------------


def _assert_same_params(got, want, path=""):
    """The port's tree against params_from_jax of the JAX loader's: dense
    leaves equal; int8 grids equal over the port's K padding (to 128) with
    the JAX packer's further padding (to 1024 rows) all zeros; 4-bit grids
    equal in their integers and scales and within 1 f32 ulp in the
    dequantized weights (the unfolded mins)."""
    assert set(got) == set(want), path
    if tq.is_quantized(got):
        Kp = tq.grid_k(got)
        dg, dw = tq.dequant(got), tq.dequant(want)
        ulp = np.spacing(np.abs(dg.numpy()).max())
        assert (dg - dw[..., :Kp]).abs().max().item() <= ulp, path
        assert not dw[..., Kp:].any(), path
        if "qt" in got:
            assert torch.equal(got["qt"], want["qt"][..., :Kp]), path
        return
    for k in got:
        if isinstance(got[k], dict):
            _assert_same_params(got[k], want[k], f"{path}.{k}")
        else:
            assert torch.equal(got[k], want[k]), f"{path}.{k}"


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_load_params_match_jax(files, fmt):
    model, params, _ = load_qwen3_gguf(files[fmt], dtype=torch.float32)
    _, jparams, _ = jload(files[fmt], dtype=jnp.float32)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    _assert_same_params(params, want)
    assert model.config.num_hidden_layers == 2


def test_head_follows_stored_type(files, tmp_path, monkeypatch):
    """A tied float embedding is the dense head itself; a tied Q8_0
    embedding packs an int8 head from its dequantized rows; an untied Q8_0
    output.weight stays on the int8 grid, a Q4_K one on the 4-bit grid, an
    F16 one dense (V, K) — and head_argmax sends each to its body."""
    from aha_tpu_torch.ops import lm_head

    seen = []
    for name in ("_bf16_head", "head_argmax_q8", "head_argmax_q4"):
        fn = getattr(lm_head, name)
        monkeypatch.setattr(lm_head, name, lambda *a, _n=name, _f=fn: (
            seen.append(_n), _f(*a))[1])
    g = tg.GGUFFile(files["q8"])
    tensors = {n: (np.ascontiguousarray(g.dequantize(n)), i.ggml_type)
               for n, i in g.tensors.items()}
    w = np.random.default_rng(3).standard_normal((128, 64)).astype(np.float32)
    for t in (jg.GGML_F16, jg.GGML_Q4_K):
        path = str(tmp_path / f"head{t}.gguf")
        tg.write_gguf(path, META, {**tensors, "output.weight": (w, t)})
        files = {**files, t: path}
    h = torch.randn(1, 64)
    for fmt, keys, body in (("q8", {"w"}, "_bf16_head"),
                            ("tied-q8", {"qt", "st"}, "head_argmax_q8"),
                            ("untied", {"qt", "st"}, "head_argmax_q8"),
                            (jg.GGML_Q4_K, {"q4", "s4", "b4"},
                             "head_argmax_q4"),
                            (jg.GGML_F16, {"w"}, "_bf16_head")):
        _, p, _ = load_qwen3_gguf(files[fmt], dtype=torch.float32)
        assert set(p["lm_head"]) == keys, fmt
        if keys == {"w"}:
            assert p["lm_head"]["w"].shape == (128, 64)
        seen.clear()
        lm_head.head_argmax(p["lm_head"], h)
        assert seen == [body], fmt
    _, p, _ = load_qwen3_gguf(files["q8"], dtype=torch.float32)
    assert p["lm_head"]["w"] is p["embed"]["w"]
    _, p, _ = load_qwen3_gguf(files["tied-q8"], dtype=torch.float32)
    assert p["lm_head"]["qt"].shape == (128, 128)


def test_load_defaults_to_the_ports_device(files, monkeypatch):
    """Without device= and dtype= the loader takes the port's device
    (utils/device.py: AHA_DEVICE, else the card when one is visible) and
    that device's compute dtype (AHA_DTYPE, else float32 on the CPU)."""
    monkeypatch.delenv("AHA_DTYPE", raising=False)
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    model, params, _ = load_qwen3_gguf(files["q8"])
    assert model.device == torch.device("cpu")
    assert params["embed"]["w"].dtype == torch.float32
    assert params["layers"]["q"]["qt"].device == torch.device("cpu")
    monkeypatch.setenv("AHA_DTYPE", "bfloat16")
    _, params, _ = load_qwen3_gguf(files["q8"])
    assert params["embed"]["w"].dtype == torch.bfloat16
    monkeypatch.delenv("AHA_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _, _ = load_qwen3_gguf(files["q8"], dtype=torch.float32)
    assert model.device == torch.device("cpu")


def test_layers_mixing_grids_are_refused(tmp_path, float_params):
    """Q4_K_M stores some layers' attn_v / ffn_down as Q6_K (int8 grid)
    and the others as Q4_K (4-bit grid): the JAX loader's tree stacking
    refuses such a file, and so does the port's, with a ValueError."""
    path = _write(tmp_path / "mixed.gguf", float_params, "q4",
                  lambda i, n: jg.GGML_Q6_K if (i, n) == (1, "attn_v")
                  else None)
    with pytest.raises(ValueError):
        jload(path, dtype=jnp.float32)
    with pytest.raises(ValueError, match="layer 1"):
        load_qwen3_gguf(path, dtype=torch.float32)


def test_fused_stack_refuses_quantized_params(files):
    """The one-launch bf16 decode stack's gate stays shut for quantized
    parameters — a GGUF file's, or bf16 weights packed on either grid at a
    geometry the bf16 kernel takes, whose dense form it admits.  The
    quantized stack takes the packed ones (K a multiple of 128 in every
    projection) and not the tiny file's (hidden 64), which runs the per-op
    chain."""
    model, params, _ = load_qwen3_gguf(files["q8"], dtype=torch.bfloat16,
                                       device="cpu")
    fused = fuse_decode_params(params)
    assert "qt" in fused["layers"]["qkv"]
    cache = model.init_cache(1, 64, torch.bfloat16)
    x = torch.zeros((1, 1, 64), dtype=torch.bfloat16)
    assert model._use_fused_stack(fused, x, cache, 64) is None
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    model = Qwen3Model(Qwen3Config(**{**GEO, "hidden_size": 128,
                                      "head_dim": 64}))
    dense = model.init_random(torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    cache = model.init_cache(1, 64, torch.bfloat16)
    x = torch.zeros((1, 1, 128), dtype=torch.bfloat16)
    assert model._use_fused_stack(fuse_decode_params(dense), x, cache,
                                  64) == "bf16"
    for grid in ("q8", "q4"):
        quant = fuse_decode_params(pack_params(dense, grid))
        assert tq.is_quantized(quant["layers"]["mlp"]["gateup"])
        assert model._use_fused_stack(quant, x, cache, 64) == "q8"
        assert model._use_fused_stack(quant, x, cache, None) is None


# -- greedy streams -----------------------------------------------------------


PROMPTS = [[3, 17, 42, 9, 5], [1, 2, 3], list(range(5, 40))]


@pytest.mark.parametrize("fmt", ["q8", "q4", "untied", "tied-q8"])
def test_text_engine_streams_match_jax(files, fmt):
    jm, jp, _ = jload(files[fmt], dtype=jnp.float32, max_rope_len=128)
    tm, tp, _ = load_qwen3_gguf(files[fmt], dtype=torch.float32,
                                max_rope_len=128)
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                 max_seq_len=128)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=128)
    for ids in PROMPTS:
        want = _deadline(je.generate_tokens, ids, JGREEDY, 12)
        got = _deadline(te.generate_tokens, ids, GREEDY, 12)
        assert got == want, (fmt, ids)
        assert len(set(got)) > 1


@pytest.mark.parametrize("fmt", ["q8", "q4", "untied"])
def test_batch_engine_streams_match_jax(files, engines, fmt):
    """Two slots, three ragged prompts (one waits for a slot)."""
    jm, jp, _ = jload(files[fmt], dtype=jnp.float32, max_rope_len=256)
    tm, tp, _ = load_qwen3_gguf(files[fmt], dtype=torch.float32,
                                max_rope_len=256)
    je = engines(JBatchEngine, jm, jp, eos_token_ids=[],
                 cache_dtype=jnp.float32, max_seq_len=256, runahead=4,
                 slots=2)
    te = engines(BatchEngine, tm, tp, eos_token_ids=[],
                 cache_dtype=torch.float32, max_seq_len=256, runahead=4,
                 slots=2)

    def run_all(engine, cfg):
        out = [None] * len(PROMPTS)

        def one(i):
            out[i] = engine.generate_tokens(PROMPTS[i], cfg, 10)

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive(), "an engine request did not finish"
        return out

    want = run_all(je, JGREEDY)
    got = run_all(te, GREEDY)
    assert got == want and all(g is not None for g in got)
