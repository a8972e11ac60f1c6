"""Qwen3.5's text decoder (models/qwen3_5.py) against
aha_tpu/models/qwen3_5.py on the CPU in float32, at the JAX tests' TINY
geometry (hidden 64, 4 layers: three GatedDeltaNet and one gated
attention; 4/2 heads of 16, partial rotary 0.25; 2 key and 4 value heads
of 16, conv K 4): both delta rules from a nonzero state, the model's
hidden states and caches (padded, chunked, per-slot), the fusion, greedy
streams of both engines (tests/hybrid_streams.py), and the served chat:
a text-only repo on both engines, a repo with a vision_config that refuses
batch slots and answers image and video chats as aha_tpu does.
Tolerances: TOL (1e-4) of max |ref|."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.models import qwen3_5 as J
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import qwen3_5 as T
from tests.hybrid_streams import (batch_engine_streams, engines,  # noqa: F401
                                  ids, readmitted_slot, text_engine_streams)

torch.set_num_threads(1)
#: every comparison, relative to max |ref|
TOL = 1e-4
#: fused against unfused weights, relative to max |ref|
FUSED_TOL = 2e-5
TINY = dict(vocab_size=120, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, rope_theta=10000000.0, partial_rotary_factor=0.25,
            max_position_embeddings=512, full_attention_interval=4,
            linear_num_value_heads=4, linear_num_key_heads=2,
            linear_key_head_dim=16, linear_value_head_dim=16,
            linear_conv_kernel_dim=4)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


# -- the delta rules ----------------------------------------------------------


def _rule_inputs(S: int, seed: int, B: int = 2, H: int = 4, D: int = 16):
    """L2-normalized q / k, v, decays g ≤ 0, beta in (0, 1), and a nonzero
    initial state, as numpy float32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    q, k = (x / np.sqrt((x * x).sum(-1, keepdims=True) + 1e-6) for x in (q, k))
    g = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.1
    beta = (1 / (1 + np.exp(-rng.standard_normal((B, S, H))))).astype(
        np.float32)
    state = rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.3
    return q, k, v, g, beta, state


@pytest.mark.parametrize("S", [1, 37, 64, 100, 300])
def test_delta_rules_match_jax(S):
    """The chunked rule over S tokens and the recurrent rule stepped over
    them, from the same nonzero state: outputs and final states equal to
    aha_tpu's."""
    arrs = _rule_inputs(S, seed=S)
    jout, jst = J.chunk_gated_delta_rule(*map(jnp.asarray, arrs))
    tout, tst = T.chunk_gated_delta_rule(*map(torch.from_numpy, arrs))
    assert _rel(tout.numpy(), jout) <= TOL
    assert _rel(tst.numpy(), jst) <= TOL
    q, k, v, g, beta, state = arrs
    jstate, tstate = jnp.asarray(state), torch.from_numpy(state)
    jouts, touts = [], []
    for t in range(S):
        step = [a[:, t:t + 1] for a in (q, k, v, g, beta)]
        o, jstate = J.recurrent_gated_delta_rule(*map(jnp.asarray, step),
                                                 jstate)
        jouts.append(np.asarray(o))
        o, tstate = T.recurrent_gated_delta_rule(
            *map(torch.from_numpy, step), tstate)
        touts.append(o.numpy())
    assert _rel(np.concatenate(touts, 1), np.concatenate(jouts, 1)) <= TOL
    assert _rel(tstate.numpy(), jstate) <= TOL
    # the two forms agree with each other
    assert _rel(np.concatenate(touts, 1), tout.numpy()) <= TOL


def test_chunk_then_recurrent_consistency():
    """70 tokens chunked, then 10 recurrent steps from its state: the
    outputs and state of 80 tokens chunked at once."""
    q, k, v, g, beta, state = map(torch.from_numpy, _rule_inputs(80, seed=5))
    full, full_state = T.chunk_gated_delta_rule(q, k, v, g, beta, state)
    head, st = T.chunk_gated_delta_rule(q[:, :70], k[:, :70], v[:, :70],
                                        g[:, :70], beta[:, :70], state)
    outs = [head]
    for t in range(70, 80):
        o, st = T.recurrent_gated_delta_rule(
            q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], g[:, t:t + 1],
            beta[:, t:t + 1], st)
        outs.append(o)
    assert _rel(torch.cat(outs, 1).numpy(), full.numpy()) <= TOL
    assert _rel(st.numpy(), full_state.numpy()) <= TOL


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jm = J.Qwen3_5Model(J.Qwen3_5TextConfig(**TINY), max_rope_len=256)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(9),
                                                 scale=0.3))
    rng = np.random.default_rng(9)
    for lp in jp["layers"]:                 # decays other than the init's
        for name in ("a_log", "dt_bias"):
            if name in lp:
                lp[name] = rng.standard_normal(lp[name].shape).astype(
                    np.float32) * 0.5
    tm = T.Qwen3_5Model(T.Qwen3_5TextConfig(**TINY), max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


def _compare_caches(jc, tc, n):
    """k/v rows [0, n), conv windows and recurrent states."""
    for name in ("k", "v"):
        assert _rel(tc[name][:, :, :n].numpy(),
                    np.asarray(jc[name])[:, :, :n]) <= TOL, name
    for name in ("conv", "rec"):
        assert _rel(tc[name].numpy(), jc[name]) <= TOL, name
    assert tc["rec"].dtype == torch.float32


@pytest.mark.parametrize("n,bucket", [(37, 64), (3, 32), (32, 32)])
def test_prefill_and_decode_match_jax(pair, n, bucket):
    """A prompt of n tokens right-padded to `bucket` with its true length
    (3: shorter than the conv window; 32: unpadded), then three decode
    steps: hidden states of the real rows, K/V rows, conv windows and
    recurrent states equal to aha_tpu's."""
    jm, jp, tm, tp = pair
    padded = ids(n, n) + [0] * (bucket - n)
    jc = jm.init_cache(1, 128, jnp.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([padded]), jc,
                         prompt_len=jnp.int32(n))
    tc = tm.init_cache(1, 128, torch.float32)
    th = tm.backbone(tp, torch.tensor([padded]), tc, prompt_len=n)
    assert _rel(th[0, :n].numpy(), np.asarray(jh)[0, :n]) <= TOL
    _compare_caches(jc, tc, n)
    assert int(tc["pos"]) == 0 and int(tc["rope_delta"]) == 0
    jc = {**jc, "pos": jnp.int32(n)}
    tc["pos"].fill_(n)
    for step, tok in enumerate((5, 9, 77)):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        tc["pos"].add_(1)
        assert _rel(tm.logits(tp, th).numpy(),
                    np.asarray(jm.logits(jp, jh))) <= TOL, step
    _compare_caches(jc, tc, n + 3)


def test_padded_prefill_state_invariance(pair):
    """A right-padded prefill leaves the conv windows and recurrent states
    of the exact-length one (padded rows are no-ops), and decoding on
    from it gives the same logits."""
    _, _, tm, tp = pair
    prompt = ids(21, 6)
    exact = tm.init_cache(1, 64, torch.float32)
    tm.backbone(tp, torch.tensor([prompt]), exact)
    padded = tm.init_cache(1, 64, torch.float32)
    tm.backbone(tp, torch.tensor([prompt + [0] * 26]), padded, prompt_len=6)
    for name in ("conv", "rec"):
        assert _rel(padded[name].numpy(), exact[name].numpy()) <= TOL
    outs = []
    for cache in (exact, padded):
        cache["pos"].fill_(6)
        outs.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[31]]),
                                              cache)).numpy())
    assert _rel(outs[1], outs[0]) <= TOL


def test_chunk_over_cached_rows_and_state_matches_jax(pair):
    """20 tokens prefilled, then a from_cache chunk of 45 padded to 64 that
    continues the K/V rows, conv windows and recurrent states: as
    aha_tpu's, and as one 65-token prefill."""
    jm, jp, tm, tp = pair
    prompt = ids(13, 65)
    jc = jm.init_cache(1, 128, jnp.float32)
    _, jc = jm.backbone(jp, jnp.asarray([prompt[:20] + [0] * 12]), jc,
                        prompt_len=jnp.int32(20))
    jc = {**jc, "pos": jnp.int32(20)}
    jh, jc = jm.backbone(jp, jnp.asarray([prompt[20:] + [0] * 19]), jc,
                         prompt_len=jnp.int32(45), from_cache=True)
    tc = tm.init_cache(1, 128, torch.float32)
    tm.backbone(tp, torch.tensor([prompt[:20] + [0] * 12]), tc,
                prompt_len=20)
    tc["pos"].fill_(20)
    th = tm.backbone(tp, torch.tensor([prompt[20:] + [0] * 19]), tc,
                     prompt_len=45, from_cache=True)
    assert _rel(th[0, :45].numpy(), np.asarray(jh)[0, :45]) <= TOL
    _compare_caches(jc, tc, 65)
    whole = tm.init_cache(1, 128, torch.float32)
    wh = tm.backbone(tp, torch.tensor([prompt + [0] * 63]), whole,
                     prompt_len=65)
    assert _rel(th[0, :45].numpy(), wh[0, 20:65].numpy()) <= TOL
    for name in ("conv", "rec"):
        assert _rel(tc[name].numpy(), whole[name].numpy()) <= TOL


def test_per_slot_decode_step_matches_jax(pair):
    """Three slots at ragged lengths, then one (B,) pos step: logits, K/V
    rows and rolling state against aha_tpu's backbone with a (B,) pos, and
    each slot against a one-slot step."""
    jm, jp, tm, tp = pair
    lens, S = [5, 17, 40], 64
    big = tm.init_cache(3, S, torch.float32, per_slot_pos=True)
    assert big["rec"].shape == (3, 3, 4, 16, 16)
    assert big["conv"].shape == (3, 3, 4, tm.conv_dim)
    want = []
    for b, n in enumerate(lens):
        small = tm.init_cache(1, S, torch.float32)
        tm.backbone(tp, torch.tensor([ids(b, n)]), small)
        for name in ("k", "v", "conv", "rec"):
            big[name][:, b] = small[name][:, 0]
        small["pos"].fill_(n)
        want.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[b + 3]]),
                                              small))[0, 0])
    big["pos"] = torch.tensor(lens, dtype=torch.int32)
    # copies: the port's step writes `big` in place
    jc = {name: jnp.asarray(big[name].numpy().copy())
          for name in ("k", "v", "conv", "rec")}
    jc["pos"] = jnp.asarray(lens, jnp.int32)
    jc["rope_delta"] = jnp.int32(0)
    toks = [[3], [4], [5]]
    th = tm.backbone(tp, torch.tensor(toks), big)
    jh, jc = jm.backbone(jp, jnp.asarray(toks), jc)
    got = tm.logits(tp, th)[:, 0]
    assert _rel(got.numpy(), np.asarray(jm.logits(jp, jh))[:, 0]) <= TOL
    assert _rel(got.numpy(), torch.stack(want).numpy()) <= TOL
    _compare_caches(jc, big, S)


def test_fused_params_bit_identical(pair):
    """[q(+gate)|k|v], [qkv|z|b|a] and [gate|up] fused per layer: each
    fused matrix's column blocks are the separate weights bit for bit,
    and the hidden states of a prefill and a decode step equal the
    unfused tree's up to the CPU GEMM's shape-dependent reduction order
    (FUSED_TOL, the JAX test's 2e-5)."""
    _, _, tm, tp = pair
    fused = tm.fuse_params(tp)
    kinds = {k for lp in fused["layers"] for k in lp}
    assert {"qkv", "in_proj"} <= kinds
    assert not {"q", "in_proj_qkv", "in_proj_z"} & kinds
    assert all("gateup" in lp["mlp"] for lp in fused["layers"])
    for lp, fp in zip(tp["layers"], fused["layers"]):
        parts, whole = (([lp[n]["w"] for n in "qkv"], fp["qkv"]["w"])
                        if "q" in lp else
                        ([lp[n]["w"] for n in ("in_proj_qkv", "in_proj_z",
                                               "in_proj_b", "in_proj_a")],
                         fp["in_proj"]["w"]))
        assert torch.equal(torch.cat(parts, -1), whole)
        assert torch.equal(torch.cat([lp["mlp"]["gate"]["w"],
                                      lp["mlp"]["up"]["w"]], -1),
                           fp["mlp"]["gateup"]["w"])
    prompt = torch.tensor([ids(14, 40) + [0] * 24])
    caches = [tm.init_cache(1, 128, torch.float32) for _ in range(2)]
    a = tm.backbone(tp, prompt, caches[0], prompt_len=40)
    b = tm.backbone(fused, prompt, caches[1], prompt_len=40)
    assert _rel(b.numpy(), a.numpy()) <= FUSED_TOL
    for c in caches:
        c["pos"].fill_(40)
    a = tm.backbone(tp, torch.tensor([[7]]), caches[0])
    b = tm.backbone(fused, torch.tensor([[7]]), caches[1])
    assert _rel(b.numpy(), a.numpy()) <= FUSED_TOL


def test_decode_from_a_jax_cache_matches_jax(pair):
    """aha_tpu's cache after a padded prefill, carried across by
    cache_from_jax (5-D K/V kept, rolling state unchanged): four decode
    steps from it give aha_tpu's logits and state."""
    from aha_tpu_torch.io.convert import cache_from_jax

    jm, jp, tm, tp = pair
    jc = jm.init_cache(1, 64, jnp.float32)
    _, jc = jm.backbone(jp, jnp.asarray([ids(15, 21) + [0] * 11]), jc,
                        prompt_len=jnp.int32(21))
    jc = {**jc, "pos": jnp.int32(21)}
    tc = cache_from_jax(jax.tree.map(np.asarray, jc))
    for name in ("k", "v", "conv", "rec"):
        assert tc[name].shape == jc[name].shape, name
    for tok in (3, 30, 60, 90):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        tc["pos"].add_(1)
        assert _rel(tm.logits(tp, th).numpy(),
                    np.asarray(jm.logits(jp, jh))) <= TOL
    _compare_caches(jc, tc, 25)


# -- the engines --------------------------------------------------------------


def test_text_engine_streams_match_jax(pair, engines):  # noqa: F811
    text_engine_streams(*pair, engines)


def test_batch_engine_streams_match_jax(pair, engines):  # noqa: F811
    batch_engine_streams(*pair, engines)


def test_readmitted_slot_streams_as_in_a_fresh_engine(pair,
                                                      engines):  # noqa: F811
    readmitted_slot(pair[2], pair[3], engines)


# -- serving ------------------------------------------------------------------

#: the JAX tests' Qwen3-VL tower geometry, for a config's vision_config
VISION = {"depth": 3, "hidden_size": 32, "intermediate_size": 64,
          "num_heads": 2, "in_channels": 3, "out_hidden_size": 64,
          "patch_size": 16, "spatial_merge_size": 2,
          "temporal_patch_size": 2, "num_position_embeddings": 16,
          "deepstack_visual_indexes": [0, 1]}


def _repo(path: str, vision: bool) -> str:
    """A tiny Qwen3.5 checkpoint in HF names with the test tokenizer (and
    its four vision special tokens, in both kinds, so that the decoders'
    weights are the same draws): a text-only config.json, or (vision) the
    published layout — the decoder under text_config and
    model.language_model.*, a vision_config and the tower under
    model.visual.*, the image and video token ids the tokenizer's — with a
    template that renders image and video parts."""
    from aha_tpu_torch.io.weights import save_hf_qwen3_5
    from aha_tpu_torch.models.qwen3vl import Qwen3VLVisionConfig
    from tests.vision_chat import vision_tokenizer, write_template

    os.makedirs(path, exist_ok=True)
    tok = vision_tokenizer(path)
    eos = tok.token_to_id("<|im_end|>")
    text = {**TINY, "vocab_size": tok.get_vocab_size(),
            "tie_word_embeddings": True, "eos_token_id": eos}
    tokens = {"image_token_id": tok.token_to_id("<|image_pad|>"),
              "video_token_id": tok.token_to_id("<|video_pad|>"),
              "vision_start_token_id": tok.token_to_id("<|vision_start|>")}
    cfg = ({"architectures": ["Qwen3_5ForConditionalGeneration"],
            "text_config": text, "vision_config": VISION, **tokens}
           if vision else {**text, "architectures": ["Qwen3_5ForCausalLM"]})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    write_template(path, tok)
    text_cfg = T.Qwen3_5TextConfig.from_dict(text)
    vl = (T.Qwen3_5Config(text=text_cfg,
                          vision=Qwen3VLVisionConfig.from_dict(VISION),
                          **tokens) if vision else None)
    model = T.Qwen3_5Model(text_cfg, vl_config=vl)
    params = model.init_random(torch.Generator().manual_seed(5), scale=0.3)
    save_hf_qwen3_5(params, path, prefix="model.language_model." if vision
                    else "model.")
    return path


@pytest.fixture(scope="module")
def text_repo(tmp_path_factory):
    return _repo(str(tmp_path_factory.mktemp("q35text")), vision=False)


@pytest.fixture(scope="module")
def vl_repo(tmp_path_factory):
    return _repo(str(tmp_path_factory.mktemp("q35vl")), vision=True)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("AHA_DEVICE", "cpu")
    monkeypatch.setenv("AHA_DTYPE", "float32")


def _chat(content, model="Qwen/Qwen3.5-0.8B"):
    from aha_tpu.params import ChatCompletionParameters as JParams
    from aha_tpu_torch.params import ChatCompletionParameters

    body = {"messages": [{"role": "user", "content": content}],
            "model": model, "max_tokens": 12, "temperature": 0.0}
    return (ChatCompletionParameters.model_validate(body),
            JParams.model_validate(body))


@pytest.mark.parametrize("slots", [1, 2])
def test_text_repo_serves_as_the_reference(cpu, text_repo, slots):
    """A text-only Qwen3.5 checkpoint through load_model on a TextEngine
    or a BatchEngine: the greedy reply of aha_tpu's loader."""
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu_torch.core.batch_engine import BatchEngine
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.models.qwen3_5_served import Qwen3_5Chat

    served = load_model("Qwen/Qwen3.5-0.8B", text_repo, max_seq_len=256,
                        batch_slots=slots)
    try:
        assert isinstance(served, Qwen3_5Chat)
        assert isinstance(served.engine,
                          BatchEngine if slots > 1 else TextEngine)
        assert served.concurrent_streams == slots
        mes, jmes = _chat("the quick brown fox")
        got = served.generate(mes).choices[0].message
        want = jload_model("Qwen/Qwen3.5-0.8B", text_repo, max_seq_len=256
                           ).generate(jmes).choices[0].message
        assert got.text() == want.text() and got.text()
    finally:
        if slots > 1:
            served.engine.shutdown()


def test_vision_repo_refuses_slots_and_images(cpu, vl_repo, text_repo):
    """A checkpoint with a vision_config: --batch-slots 4 refused before
    any weights load with aha_tpu's words, as the GGUF entry without a
    gguf file is; single stream, Qwen3_5VLChat answers a text chat as the
    text-only checkpoint of the same decoder weights does, and an image
    chat and a video chat as aha_tpu's Qwen3_5VLChat does."""
    from aha_tpu.models.loader import load_model as jload_model
    from aha_tpu_torch.models.loader import GGUF_PATH_NEEDED, load_model
    from aha_tpu_torch.models.qwen3_5_served import VL_SLOTS, Qwen3_5VLChat
    from tests.vision_chat import npz_data_url, png_data_url

    with pytest.raises(ValueError) as got:
        load_model("Qwen/Qwen3.5-0.8B", vl_repo, batch_slots=4)
    with pytest.raises(ValueError) as want:
        jload_model("Qwen/Qwen3.5-0.8B", vl_repo, batch_slots=4)
    assert str(got.value) == str(want.value) == VL_SLOTS
    with pytest.raises(ValueError) as got:
        load_model("qwen3.5-gguf", vl_repo)
    with pytest.raises(ValueError) as want:
        jload_model("qwen3.5-gguf", vl_repo)
    assert str(got.value) == str(want.value) == GGUF_PATH_NEEDED
    served = load_model("Qwen/Qwen3.5-0.8B", vl_repo, max_seq_len=1024)
    assert isinstance(served, Qwen3_5VLChat)
    assert served.engine.prefix_cache_entries == 0
    mes, _ = _chat("the quick brown fox")
    plain = load_model("Qwen/Qwen3.5-0.8B", text_repo, max_seq_len=256)
    assert served.generate(mes).choices[0].message.text() == \
        plain.generate(mes).choices[0].message.text()
    jserved = jload_model("Qwen/Qwen3.5-0.8B", vl_repo, max_seq_len=1024)
    for part in ({"type": "image_url",
                  "image_url": {"url": png_data_url(96, 64, seed=3)}},
                 {"type": "video_url", "video_url": {"url": npz_data_url()}}):
        mes, jmes = _chat([{"type": "text", "text": "what is this?"}, part])
        got, want = served.generate(mes), jserved.generate(jmes)
        assert got.usage.prompt_tokens == want.usage.prompt_tokens > 20
        assert got.choices[0].message.text() == \
            want.choices[0].message.text()


def test_config_reads_text_config_and_rope_parameters(vl_repo):
    """from_file reads text_config where it is, rope_parameters /
    rope_scaling for rope_theta and the partial rotary factor; as
    aha_tpu's Qwen3_5TextConfig."""
    got = T.Qwen3_5TextConfig.from_file(vl_repo)
    assert got.__dict__ == J.Qwen3_5TextConfig.from_file(vl_repo).__dict__
    d = {**TINY, "rope_scaling": {"rope_theta": 5e5,
                                  "partial_rotary_factor": 0.5}}
    d.pop("rope_theta"), d.pop("partial_rotary_factor")
    got = T.Qwen3_5TextConfig.from_dict(d)
    assert (got.rope_theta, got.partial_rotary_factor) == (5e5, 0.5)
    assert got.__dict__ == J.Qwen3_5TextConfig.from_dict(d).__dict__
    assert T.qwen3_5_text_default().__dict__ == \
        J.Qwen3_5TextConfig().__dict__
