"""The embedding and rerank path of aha_tpu_torch against aha_tpu on the
same weights: Qwen3-Embedding's vectors over ragged texts across three
length buckets and Qwen3-Reranker's scores (both loaded from one tiny
Qwen3 checkpoint through each package's load_model), BERT (all-MiniLM-L6-v2)
`encode` / `embed` and the served MiniLM's vectors with padding invisible,
params_from_jax on the BERT tree, HF transformers' BertModel, and the
prefill kernel's plain version at B = 4 against the Pallas kernel in
interpret mode.  float32 on the CPU: vectors within atol 1e-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.models.minilm import BertConfig as JBertConfig
from aha_tpu.models.minilm import BertModel as JBertModel
from aha_tpu.ops.flash_attention import flash_attention as jflash
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.models.minilm import BertConfig, BertModel
from aha_tpu_torch.ops.flash_attention import flash_attention
from aha_tpu_torch.ops.norms import l2_normalize, layer_norm
from tests.fixtures import build_tiny_qwen3_repo, build_tokenizer

torch.set_num_threads(1)
ATOL = 1e-5
WORDS = ("hello world how are you today the quick brown fox jumps over "
         "the lazy dog what is the answer").split()
BERT = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The port's loaders run on the card unless asked for the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("AHA_DEVICE", "cpu")
    mp.setenv("AHA_DTYPE", "float32")
    yield
    mp.undo()


def _text(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


# -- Qwen3-Embedding / Qwen3-Reranker ------------------------------------------


@pytest.fixture(scope="module")
def qwen3_repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qwen3_embed"))
    build_tiny_qwen3_repo(path, seed=3)
    return path


@pytest.fixture(scope="module")
def embedders(qwen3_repo):
    mid = "Qwen/Qwen3-Embedding-0.6B"
    return load_model(mid, qwen3_repo), jload_model(mid, qwen3_repo)


def test_qwen3_embedding_matches_jax_across_buckets(embedders):
    """Seven ragged texts over the 32, 64 and 128 buckets (three groups,
    rows padded to 4, 2 and 1): every vector unit-norm and within 1e-5 of
    aha_tpu's."""
    port, ref = embedders
    texts = [_text(n, i) for i, n in enumerate((3, 20, 45, 30, 90, 8, 50))]
    lens = [len(port.tokenizer.encode(t)) for t in texts]
    from aha_tpu_torch.core.engine import bucket_for

    assert {bucket_for(n) for n in lens} == {32, 64, 128}, lens
    got = port.embed_arrays(texts)
    want = ref.embed_arrays(texts)
    assert got.shape == (7, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    # a text alone gives its vector in a group
    np.testing.assert_allclose(port.embed_one_array(texts[4]), got[4],
                               rtol=0, atol=ATOL)
    assert port.embedding(texts[:2]) == got[:2].tolist()


def test_qwen3_embedding_refuses_empty_input(embedders):
    port, ref = embedders
    for model in (port, ref):
        with pytest.raises(ValueError, match="^embedding input cannot be "
                           "empty$"):
            model.embedding([])
        with pytest.raises(ValueError, match="^embedding tokenized input "
                           "cannot be empty$"):
            model.embedding(["hello", ""])


def test_qwen3_reranker_matches_jax(qwen3_repo, embedders):
    """Scores are the dot products of the normalized query and document
    vectors, equal to aha_tpu's within 1e-5."""
    mid = "Qwen/Qwen3-Reranker-0.6B"
    port, ref = load_model(mid, qwen3_repo), jload_model(mid, qwen3_repo)
    query = _text(6, 40)
    docs = [_text(n, 41 + n) for n in (4, 30, 70, 12)]
    got = port.rerank(query, docs)
    np.testing.assert_allclose(got, ref.rerank(query, docs), rtol=0,
                               atol=ATOL)
    vecs = embedders[0].embed_arrays([query] + docs)
    np.testing.assert_allclose(got, vecs[1:] @ vecs[0], rtol=0, atol=1e-6)
    with pytest.raises(Exception, match="does not support embeddings"):
        port.embedding(["x"])


# -- BERT / all-MiniLM-L6-v2 ---------------------------------------------------


def _bert_pair(seed: int = 0, vocab: int = 100):
    jm = JBertModel(JBertConfig(vocab_size=vocab, **BERT))
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(seed),
                                                 scale=0.2))
    rng = np.random.default_rng(seed)

    def perturb(t, name=""):
        if isinstance(t, dict):
            return {k: perturb(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [perturb(v) for v in t]
        if name == "b":
            return rng.standard_normal(t.shape).astype(np.float32) * 0.1
        return t
    jp = perturb(jp)
    for lp in jp["layers"]:
        for n in ("attn_ln", "ffn_ln"):
            lp[n]["w"] = (1 + 0.2 * rng.standard_normal(
                lp[n]["w"].shape)).astype(np.float32)
    tm = BertModel(BertConfig(vocab_size=vocab, **BERT))
    return jm, jp, tm


def test_params_from_jax_takes_the_bert_tree():
    _, jp, _ = _bert_pair()
    tp = params_from_jax(jp)
    assert set(tp) == {"embeddings", "layers"}
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 2
    assert tp["layers"][0]["q"]["w"].shape == (48, 48)           # (in, out)
    assert set(tp["layers"][1]["ffn_ln"]) == {"w", "b"}
    np.testing.assert_array_equal(tp["layers"][1]["ffn_in"]["b"].numpy(),
                                  jp["layers"][1]["ffn_in"]["b"])
    np.testing.assert_array_equal(tp["embeddings"]["position"]["w"].numpy(),
                                  jp["embeddings"]["position"]["w"])


def test_bert_encode_and_embed_match_jax():
    jm, jp, tm = _bert_pair(seed=1)
    tp = params_from_jax(jp)
    ids = np.array([[2, 7, 11, 3, 0, 0], [2, 9, 5, 8, 14, 3]])
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    jh = jm.encode(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids),
                   jnp.asarray(mask))
    th = tm.encode(tp, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(th[0, :4].numpy(), np.asarray(jh)[0, :4],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(th[1].numpy(), np.asarray(jh)[1], rtol=0,
                               atol=ATOL)
    je = jm.embed(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids),
                  jnp.asarray(mask))
    te = tm.embed(tp, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(te.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_bert_padding_is_invisible():
    _, jp, tm = _bert_pair(seed=2)
    tp = params_from_jax(jp)
    short = tm.embed(tp, torch.tensor([[1, 2, 3]]), torch.tensor([[1, 1, 1]]))
    padded = tm.embed(tp, torch.tensor([[1, 2, 3, 9, 9, 9]]),
                      torch.tensor([[1, 1, 1, 0, 0, 0]]))
    np.testing.assert_allclose(short.numpy(), padded.numpy(), rtol=0,
                               atol=1e-6)


def _hf_bert(jp: dict) -> dict:
    """The JAX BERT tree under HF BertModel's names (numpy, (out, in))."""
    out = {}

    def lin(name, p):
        out[name + ".weight"] = np.ascontiguousarray(p["w"].T)
        out[name + ".bias"] = p["b"]

    def norm(name, p):
        out[name + ".weight"], out[name + ".bias"] = p["w"], p["b"]

    e = jp["embeddings"]
    for n in ("word", "position", "token_type"):
        out[f"embeddings.{n}_embeddings.weight"] = e[n]["w"]
    norm("embeddings.LayerNorm", e["ln"])
    for i, lp in enumerate(jp["layers"]):
        p = f"encoder.layer.{i}."
        lin(p + "attention.self.query", lp["q"])
        lin(p + "attention.self.key", lp["k"])
        lin(p + "attention.self.value", lp["v"])
        lin(p + "attention.output.dense", lp["attn_out"])
        norm(p + "attention.output.LayerNorm", lp["attn_ln"])
        lin(p + "intermediate.dense", lp["ffn_in"])
        lin(p + "output.dense", lp["ffn_out"])
        norm(p + "output.LayerNorm", lp["ffn_ln"])
    return out


@pytest.fixture(scope="module")
def minilm_repo(tmp_path_factory):
    """A tiny all-MiniLM-L6-v2 checkpoint: the test tokenizer, a BERT
    config, seeded weights under HF names with the `bert.` prefix."""
    from safetensors.numpy import save_file

    path = str(tmp_path_factory.mktemp("minilm"))
    tok = build_tokenizer(path)
    vocab = tok.get_vocab_size()
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["BertModel"], "model_type": "bert",
                   "vocab_size": vocab, **BERT}, f)
    _, jp, _ = _bert_pair(seed=4, vocab=vocab)
    save_file({"bert." + k: v for k, v in _hf_bert(jp).items()},
              os.path.join(path, "model.safetensors"))
    return path


def test_minilm_served_matches_jax(minilm_repo):
    """Texts over the 16, 32 and 64 buckets, one past the 64 positions
    (truncated): every vector within 1e-5 of aha_tpu's, unit-norm, and a
    text's vector the same alone as in a group."""
    mid = "sentence-transformers/all-MiniLM-L6-v2"
    port, ref = load_model(mid, minilm_repo), jload_model(mid, minilm_repo)
    texts = [_text(n, 60 + n) for n in (3, 12, 25, 40, 90)]
    lens = [len(port.tokenizer.encode(t)) for t in texts]
    assert min(lens) <= 16 < max(lens[:4]) and lens[-1] > 64, lens
    got = np.asarray(port.embedding(texts), np.float32)
    np.testing.assert_allclose(got, np.asarray(ref.embedding(texts)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(port.embedding([texts[2]])[0], got[2],
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="^embedding input cannot be empty$"):
        port.embedding([])
    with pytest.raises(Exception, match="does not support rerank"):
        port.rerank("q", ["d"])


def test_hf_transformers_parity():
    """BertModel.encode against HF transformers' BertModel built from a
    config (nothing downloaded), real rows only; as tests/test_minilm.py
    holds the JAX model (1e-3: the random-init LayerNorms amplify f32
    roundoff)."""
    from transformers import BertConfig as HFConfig
    from transformers import BertModel as HFBert

    hf_cfg = HFConfig(vocab_size=100, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, **BERT)
    torch.manual_seed(0)
    hf = HFBert(hf_cfg).eval()
    model = BertModel(BertConfig(vocab_size=100, **BERT))
    params = model.load_params({k: v.detach().clone()
                                for k, v in hf.state_dict().items()})
    ids = torch.tensor([[2, 7, 11, 3, 0, 0], [2, 9, 5, 8, 14, 3]])
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model.encode(params, ids, mask)
    np.testing.assert_allclose(got[0, :4].numpy(), ref[0, :4].numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-3,
                               atol=1e-3)


def test_layer_norm_and_l2_normalize_match_jax():
    from aha_tpu.ops.norms import l2_normalize as jl2
    from aha_tpu.ops.norms import layer_norm as jln

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    for bias in (b, None):
        got = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         None if bias is None else torch.from_numpy(bias),
                         1e-12)
        want = jln(jnp.asarray(x), jnp.asarray(w),
                   None if bias is None else jnp.asarray(bias), 1e-12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    x[0, 0] = 0.0                               # the 1e-12 floor
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jl2(jnp.asarray(x))), rtol=0,
                               atol=1e-6)


# -- the prefill kernel at B > 1 -----------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_plain_at_batch_4_matches_pallas(causal):
    """The embedding path prefills a bucket group of rows in one forward:
    the prefill wrapper's plain version at B = 4 (16/8 heads over 2,
    D 64) against the Pallas kernel in interpret mode, and each row equal
    to a B = 1 call on that row."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((4, 128, 8, 64)).astype(np.float32)
    k = rng.standard_normal((4, 128, 2, 64)).astype(np.float32)
    v = rng.standard_normal((4, 128, 2, 64)).astype(np.float32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal).numpy()
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=ATOL)
    for b in range(4):
        one = flash_attention(torch.from_numpy(q[b:b + 1]),
                              torch.from_numpy(k[b:b + 1]),
                              torch.from_numpy(v[b:b + 1]),
                              causal=causal).numpy()
        np.testing.assert_allclose(one[0], got[b], rtol=0, atol=1e-6)


def test_bert_checkpoint_round_trip(tmp_path):
    """save_hf_bert writes HF BertModel names that load_params reads back
    to the same tree (what the served MiniLM checkpoint is made of)."""
    from aha_tpu_torch.io.weights import open_weights, save_hf_bert

    _, jp, tm = _bert_pair(seed=7)
    tp = params_from_jax(jp)
    save_hf_bert(tp, str(tmp_path))
    back = tm.load_params(open_weights(str(tmp_path)))

    def leaves(t, path=""):
        items = t.items() if isinstance(t, dict) else enumerate(t)
        out = {}
        for k, v in items:
            if isinstance(v, (dict, list)):
                out.update(leaves(v, f"{path}/{k}"))
            else:
                out[f"{path}/{k}"] = v
        return out
    a, b = leaves(tp), leaves(back)
    assert sorted(a) == sorted(b) and len(a) == 5 + 2 * 16
    assert all(torch.equal(a[k], b[k]) for k in a)
