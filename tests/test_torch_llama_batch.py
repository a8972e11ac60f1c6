"""The llama text families (MiniCPM4 / MiniCPM5, and the qwen2 form) on
aha_tpu_torch's continuous-batching engine, against aha_tpu: one per-slot
decode step with a (B,) pos over the 5-D cache (logits and the rows
written, atol 2e-5), greedy streams of the port's BatchEngine equal to
aha_tpu's BatchEngine and to its single-stream TextEngine token for token
(more requests than slots, chunked admission, the prefix store), the
`supports_slot_decode` gate, and the loader's minicpm4 / minicpm5 families
and its refusals before any weights load (the reference's strings).
float32 on the CPU; every stream is read with a deadline and every engine
is shut down by its fixture."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.batch_engine import BatchEngine as JBatchEngine
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models.llama import LlamaConfig as JConfig
from aha_tpu.models.llama import LlamaModel as JModel
from aha_tpu_torch.core.batch_engine import BatchEngine
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.io.weights import save_hf_qwen3
from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
from tests.fixtures import CHAT_TEMPLATE, build_tokenizer

torch.set_num_threads(1)
ATOL = 2e-5
BASE = dict(vocab_size=120, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rope_theta=1e6)
MINICPM = dict(max_position_embeddings=128, scale_emb=12.0, scale_depth=1.4,
               dim_model_base=16,
               rope_scaling={"short_factor": [1.0] * 6,
                             "long_factor": [2.0] * 6,
                             "original_max_position_embeddings": 64})
FORMS = {"qwen2": dict(qkv_bias=True, tie_word_embeddings=True),
         "minicpm": MINICPM}
DEADLINE = 60.0


def _pair(form: str, seed: int = 0):
    kw = {**BASE, **FORMS[form]}
    jm = JModel(JConfig(**kw), max_rope_len=256)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(seed),
                                                 scale=0.3))
    rng = np.random.default_rng(seed)
    for name in ("q", "k", "v"):
        if "b" in jp["layers"][name]:
            jp["layers"][name]["b"] = rng.standard_normal(
                jp["layers"][name]["b"].shape).astype(np.float32) * 0.1
    tm = LlamaModel(LlamaConfig.from_dict(kw), max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


@pytest.fixture(scope="module", params=list(FORMS))
def pair(request):
    return _pair(request.param)


@pytest.fixture
def engines(request):
    made = []

    def make(cls, *a, **kw):
        e = cls(*a, **kw)
        made.append(e)
        return e

    request.addfinalizer(lambda: [e.shutdown() for e in made
                                  if hasattr(e, "shutdown")])
    return make


def _ids(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 119, n)]


def _run_all(engine, prompts, cfg, max_tokens):
    out, errs = [None] * len(prompts), []

    def run(i):
        try:
            out[i] = engine.generate_tokens(prompts[i], cfg, max_tokens)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE)
        assert not t.is_alive(), "an engine request did not finish"
    if errs:
        raise errs[0]
    return out


# -- the model ----------------------------------------------------------------


def test_per_slot_decode_step_matches_jax(pair):
    """Three slots prefilled at batch 1 to ragged lengths, then one (B,)
    pos step: logits and every slot's new K/V row against aha_tpu's
    backbone with a (B,) pos over the same cache."""
    jm, jp, tm, tp = pair
    lens, S = [5, 17, 40], 64
    big = tm.init_cache(3, S, torch.float32, per_slot_pos=True)
    assert big["k"].shape == (2, 3, S, 2, 12) and big["pos"].shape == (3,)
    for b, n in enumerate(lens):
        small = tm.init_cache(1, S, torch.float32)
        tm.backbone(tp, torch.tensor([_ids(b, n)]), small)
        big["k"][:, b] = small["k"][:, 0]
        big["v"][:, b] = small["v"][:, 0]
    big["pos"] = torch.tensor(lens, dtype=torch.int32)
    jc = {"k": jnp.asarray(big["k"].numpy()), "v": jnp.asarray(big["v"].numpy()),
          "pos": jnp.asarray(lens, jnp.int32)}
    toks = [[7], [63], [101]]
    th = tm.backbone(tp, torch.tensor(toks), big)
    jh, jc = jm.backbone(jp, jnp.asarray(toks), jc)
    np.testing.assert_allclose(tm.logits(tp, th).numpy(),
                               np.asarray(jm.logits(jp, jh)), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(big["k"].numpy(), np.asarray(jc["k"]),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(big["v"].numpy(), np.asarray(jc["v"]),
                               rtol=0, atol=ATOL)
    assert big["pos"].tolist() == lens          # the backbone leaves pos
    for b, n in enumerate(lens):                # each row at its own pos
        assert big["k"][:, b, n].abs().sum() > 0
        assert big["k"][:, b, n + 1:].abs().sum() == 0


def test_per_slot_step_equals_single_stream_steps(pair):
    """Each slot of a (B,) pos step equals a scalar-pos step of that slot
    alone (the port against itself)."""
    _, _, tm, tp = pair
    lens = [3, 30]
    big = tm.init_cache(2, 32, torch.float32, per_slot_pos=True)
    want = []
    for b, n in enumerate(lens):
        one = tm.init_cache(1, 32, torch.float32)
        tm.backbone(tp, torch.tensor([_ids(10 + b, n)]), one)
        big["k"][:, b], big["v"][:, b] = one["k"][:, 0], one["v"][:, 0]
        one["pos"].fill_(n)
        want.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[5]]),
                                              one))[0, 0])
    big["pos"] = torch.tensor(lens, dtype=torch.int32)
    got = tm.logits(tp, tm.backbone(tp, torch.tensor([[5], [5]]), big))[:, 0]
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(),
                               rtol=0, atol=ATOL)


# -- the engines --------------------------------------------------------------


def test_batch_streams_match_jax_and_single_stream(pair, engines):
    """More requests than slots, through the port's BatchEngine, aha_tpu's
    BatchEngine and aha_tpu's single-stream TextEngine: the same greedy
    tokens (as tests/test_batch_engine.py holds the JAX engines)."""
    jm, jp, tm, tp = pair
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], _ids(1, 29), [4, 5, 6, 7],
               _ids(2, 50)]
    j = engines(JBatchEngine, jm, jp, eos_token_ids=[], slots=2,
                cache_dtype=jnp.float32, max_seq_len=128, runahead=4)
    t = engines(BatchEngine, tm, tp, eos_token_ids=[], slots=2,
                cache_dtype=torch.float32, max_seq_len=128, runahead=4)
    single = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                     max_seq_len=128)
    want = [single.generate_tokens(p, JSampling(), max_tokens=10)
            for p in prompts]
    assert _run_all(j, prompts, JSampling(), 10) == want
    assert _run_all(t, prompts, SamplingConfig(), 10) == want
    assert len({tuple(x) for x in want}) == len(prompts)


def test_chunked_admission_and_prefix_store_match_jax(pair, engines):
    """A 70-token prompt admitted in chunks of 16 over the 5-D small cache
    (prefill over cached rows), then an extension that restores it from
    the prefix store."""
    jm, jp, tm, tp = pair
    base = _ids(3, 70)
    prompts = [base, base + _ids(4, 9)]
    kw = dict(eos_token_ids=[], slots=2, max_seq_len=128, runahead=4,
              prefill_chunk=16, prefix_cache_entries=4)
    j = engines(JBatchEngine, jm, jp, cache_dtype=jnp.float32, **kw)
    t = engines(BatchEngine, tm, tp, cache_dtype=torch.float32, **kw)
    assert t.prefill_chunk == 16 and t.prefix_cache_entries == 4
    for p in prompts:
        assert _run_all(t, [p], SamplingConfig(), 8) == \
            _run_all(j, [p], JSampling(), 8)
    assert len(t._prefix_entries) == 2


def test_int8_cache_stays_qwen3_only(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="int8"):
        BatchEngine(tm, tp, eos_token_ids=[], slots=2,
                    cache_dtype=torch.int8, max_seq_len=64)


# -- serving: the gate and the loader ----------------------------------------


def test_supports_slot_decode_gate():
    """Both decoders declare per-slot decode as aha_tpu's do; a model
    without it is refused before the engine is built, with the
    reference's message."""
    from aha_tpu.models.llama import LlamaModel as JLlama
    from aha_tpu.models.qwen3 import Qwen3Model as JQwen3
    from aha_tpu_torch.models.qwen3 import Qwen3Model
    from aha_tpu_torch.models.text_served import TextChatModel
    from aha_tpu_torch.registry import lookup

    for port, ref in ((LlamaModel, JLlama), (Qwen3Model, JQwen3)):
        for flag in ("supports_slot_decode", "supports_prefix_cache"):
            assert getattr(port, flag) is getattr(ref, flag) is True

    class NoSlots:
        pass

    built = []

    def build(path, max_seq_len):
        built.append(path)
        return NoSlots(), {}

    with pytest.raises(ValueError) as e:
        TextChatModel.load(lookup("Qwen/Qwen3-0.6B"), "/nonexistent", build,
                           batch_slots=2)
    assert str(e.value) == ("NoSlots does not support per-slot batched "
                            "decode; serve it with --batch-slots 1")
    assert built == ["/nonexistent"]


def _minicpm_repo(path: str, seed: int = 0) -> str:
    """A tiny MiniCPM4-style checkpoint in HF names: the test tokenizer and
    chat template, mup scalings and LongRoPE in config.json, seeded
    weights."""
    os.makedirs(path, exist_ok=True)
    tok = build_tokenizer(path)
    eos = tok.token_to_id("<|im_end|>")
    cfg = {**BASE, **MINICPM, "vocab_size": tok.get_vocab_size(),
           "architectures": ["MiniCPMForCausalLM"], "model_type": "minicpm",
           "torch_dtype": "float32", "eos_token_id": eos}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT_TEMPLATE}, f)
    model = LlamaModel(LlamaConfig.from_dict(cfg))
    save_hf_qwen3(model.init_random(torch.Generator().manual_seed(seed),
                                    scale=0.3), path)
    return path


@pytest.fixture(scope="module")
def minicpm_repo(tmp_path_factory):
    return _minicpm_repo(str(tmp_path_factory.mktemp("minicpm")))


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.setenv("AHA_DTYPE", "float32")


def _chat(text: str, model: str):
    from aha_tpu.params import ChatCompletionParameters as JParams
    from aha_tpu_torch.params import ChatCompletionParameters

    body = {"messages": [{"role": "user", "content": text}], "model": model,
            "max_tokens": 12, "temperature": 0.0}
    return (ChatCompletionParameters.model_validate(body),
            JParams.model_validate(body))


@pytest.mark.parametrize("model_id,slots", [("OpenBMB/MiniCPM4-0.5B", 8),
                                            ("OpenBMB/MiniCPM5-1B", 1)])
def test_loader_serves_the_minicpm_families(cpu, minicpm_repo, model_id,
                                            slots):
    """minicpm4 / minicpm5 load as LlamaModel (the mup scalings and
    LongRoPE from config.json) on a BatchEngine of `slots` slots or a
    TextEngine, and answer a greedy chat as aha_tpu's loader does."""
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu_torch.models.loader import load_model

    served = load_model(model_id, minicpm_repo, max_seq_len=128,
                        batch_slots=slots)
    try:
        eng = served.engine
        assert isinstance(eng, BatchEngine if slots > 1 else TextEngine)
        assert served.concurrent_streams == slots
        assert isinstance(eng.model, LlamaModel)
        assert eng.model.config.scale_emb == 12.0
        assert eng.model.hidden_scale == 16 / 48
        mes, jmes = _chat("the quick brown fox", model_id)
        got = served.generate(mes).choices[0].message
        want = jload_model(model_id, minicpm_repo, max_seq_len=128
                           ).generate(jmes).choices[0].message
        assert got.text() == want.text() and got.text()
    finally:
        if slots > 1:
            served.engine.shutdown()


REFUSALS = [
    ("sentence-transformers/all-MiniLM-L6-v2", dict(batch_slots=2)),
    ("Qwen/Qwen3-Embedding-0.6B", dict(batch_slots=4)),
    ("OpenBMB/MiniCPM4-0.5B", dict(batch_slots=2, spec_tokens=4)),
    ("OpenBMB/MiniCPM5-1B", dict(batch_slots=8, spec_tokens=1)),
]


@pytest.mark.parametrize("model_id,kw", REFUSALS)
def test_loader_refuses_before_loading_as_the_reference(model_id, kw):
    """Refused before any weights load (the path does not exist), with
    aha_tpu's loader's message word for word."""
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu_torch.models.loader import load_model

    with pytest.raises(ValueError) as got:
        load_model(model_id, "/nonexistent", **kw)
    with pytest.raises(ValueError) as want:
        jload_model(model_id, "/nonexistent", **kw)
    assert str(got.value) == str(want.value)


def test_loader_drops_chat_options_for_other_families(monkeypatch):
    """prefix_cache and spec_tokens ride the text-chat engine: a
    non-batchable family's loader never sees them; a batchable one
    keeps them."""
    from aha_tpu_torch.models import loader

    seen = {}
    for family in ("minilm", "qwen3_reranker", "minicpm4", "lfm2"):
        monkeypatch.setitem(loader.FAMILY_LOADERS, family,
                            lambda e, p, _f=family, **kw: seen.update(
                                {_f: kw}))
    loader.load_model("sentence-transformers/all-MiniLM-L6-v2", "/x",
                      prefix_cache=2, spec_tokens=3)
    loader.load_model("Qwen/Qwen3-Reranker-0.6B", "/x", prefix_cache=2)
    loader.load_model("OpenBMB/MiniCPM4-0.5B", "/x", prefix_cache=2,
                      spec_tokens=3, batch_slots=1)
    loader.load_model("LiquidAI/LFM2-1.2B", "/x", batch_slots=2)
    assert seen == {"minilm": {}, "qwen3_reranker": {},
                    "minicpm4": {"prefix_cache": 2, "spec_tokens": 3},
                    "lfm2": {"batch_slots": 2}}
    with pytest.raises(NotImplementedError):
        loader.load_model("ZhipuAI/GLM-OCR", "/x")


def test_minicpm4_geometry():
    """MiniCPM4-0.5B's published widths with the mup scalings and a
    LongRoPE table (short factors within the original context)."""
    from aha_tpu_torch.models.llama import minicpm4_0_5b

    cfg = minicpm4_0_5b(layers=2)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.head_dim_) == (73448, 1024, 3072, 16, 2, 64)
    assert minicpm4_0_5b().num_hidden_layers == 24
    m = LlamaModel(cfg, max_rope_len=512)
    assert m.hidden_scale == 0.25 and m.cos.shape == (512, 32)
    assert m.residual_scale == pytest.approx(1.4 / np.sqrt(2))
    f = np.asarray(cfg.rope_scaling["short_factor"])
    inv = 1.0 / (cfg.rope_theta ** (np.arange(32) / 32)) / f
    np.testing.assert_allclose(m.cos[100].numpy(), np.cos(100 * inv),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_id", ["OpenBMB/MiniCPM4-0.5B",
                                      "Qwen/Qwen3-Embedding-0.6B",
                                      "Qwen/Qwen3-Reranker-0.6B",
                                      "sentence-transformers/all-MiniLM-L6-v2",
                                      "LiquidAI/LFM2-1.2B",
                                      "Qwen/Qwen3.5-0.8B",
                                      "Qwen/Qwen3-VL-8B-Instruct",
                                      "PaddlePaddle/PaddleOCR-VL",
                                      "LiquidAI/LFM2-VL-1.6B",
                                      "deepseek-ai/DeepSeek-OCR",
                                      "Qwen/Qwen3-ASR-0.6B",
                                      "FunAudioLLM/Fun-ASR-Nano-2512",
                                      "ZhipuAI/GLM-ASR-Nano-2512",
                                      "OpenBMB/VoxCPM-0.5B",
                                      "AI-ModelScope/RMBG-2.0"])
def test_new_families_refuse_a_missing_card(minicpm_repo, monkeypatch,
                                            model_id):
    """With AHA_DEVICE unset the loaders run on the card, and where torch
    sees none they raise rather than serve on the CPU."""
    from aha_tpu_torch.models.loader import load_model

    monkeypatch.delenv("AHA_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(model_id, minicpm_repo, max_seq_len=128)
