"""aha_tpu_torch's qwen35 GGUF map against aha_tpu's, on the CPU in float32:
tiny files written from seeded numpy weights with the port's writer (4
layers: three GatedDeltaNet and one gated attention; hidden 64, 2/1 heads
of 32 with rotary 8, 2 key and 4 value linear heads of 16), whose
projections mix Q8_0, Q4_K, Q6_K and Q5_K within a layer and across
layers.  The config, the loaded tensors (dequantized) and the fused ones,
the pad columns, the head each stored type gives, the quantized fusions
against the separate products, the stored ssm_a, logits and greedy
streams through TextEngine and BatchEngine, and the mmproj tower (config,
features, an image chat) — each against the JAX package's loader and
engines on the same file.  Tolerances: logits and tower features within
TOL (1e-4) of max |ref|; tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.io import gguf_models as jgm
from aha_tpu_torch.io import gguf as tg
from aha_tpu_torch.io import gguf_models as tgm
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.qwen3_5 import fuse_qwen3_5_decode_params
from aha_tpu_torch.ops import quant_matmul as tq
from tests.hybrid_streams import (batch_engine_streams, engines,  # noqa: F401
                                  text_engine_streams)

torch.set_num_threads(1)
#: logits and tower features, relative to max |ref|
TOL = 1e-4
H, FF, V = 64, 128, 160
NQ, NKV, HD = 2, 1, 32
HK, HV, DL = 2, 4, 16
CONV = 2 * HK * DL + HV * DL
#: 2 control tokens, 154 user-defined ones (encoded whole, decoded as
#: text), the four vision specials Qwen3-VL's processing looks up
TOKENS = (["<s>", "</s>"] + [f"<t{i}>" for i in range(V - 6)]
          + ["<|vision_start|>", "<|image_pad|>", "<|vision_end|>",
             "<|video_pad|>"])
TOKEN_TYPES = [3, 3] + [4] * (V - 6) + [3] * 4
TEMPLATE = (
    "{% for m in messages %}{% if m.content is string %}{{ m.content }}"
    "{% else %}{% for part in m.content %}"
    "{% if part.type == 'text' %}{{ part.text }}"
    "{% elif part.type == 'image_url' %}"
    "<|vision_start|><|image_pad|><|vision_end|>{% endif %}"
    "{% endfor %}{% endif %}{% endfor %}")
META = {
    "general.architecture": "qwen35",
    "qwen35.block_count": 4,
    "qwen35.embedding_length": H,
    "qwen35.feed_forward_length": FF,
    "qwen35.attention.head_count": NQ,
    "qwen35.attention.head_count_kv": NKV,
    "qwen35.attention.key_length": HD,
    "qwen35.attention.layer_norm_rms_epsilon": 1e-6,
    "qwen35.rope.freq_base": 10000000.0,
    "qwen35.rope.dimension_count": 8,
    "qwen35.rope.dimension_sections": [2, 1, 1, 0],
    "qwen35.full_attention_interval": 4,
    "qwen35.ssm.group_count": HK,
    "qwen35.ssm.time_step_rank": HV,
    "qwen35.ssm.conv_kernel": 4,
    "qwen35.ssm.state_size": DL,
    "qwen35.context_length": 256,
    "tokenizer.ggml.model": "gpt2",
    "tokenizer.ggml.tokens": TOKENS,
    "tokenizer.ggml.merges": [],
    "tokenizer.ggml.token_type": TOKEN_TYPES,
    "tokenizer.ggml.eos_token_id": 1,
    "tokenizer.chat_template": TEMPLATE,
}
Q8, Q4K, Q6K, Q5K = tg.GGML_Q8_0, tg.GGML_Q4_K, tg.GGML_Q6_K, tg.GGML_Q5_K
#: per layer, each projection's GGML type: layer 0 fuses [qkv|z|b|a] on
#: the 4-bit grid, layer 1 on the int8 grid (four int8 formats), layer 2
#: mixes grids in both fusions (they stay separate), layer 3 is the
#: attention layer ([q|k|v] on the int8 grid, padded to 256 columns)
LAYER_TYPES = [
    {"attn_qkv": Q4K, "attn_gate": Q4K, "ssm_beta": Q4K, "ssm_alpha": Q4K,
     "ssm_out": Q5K, "ffn_gate": Q8, "ffn_up": Q8, "ffn_down": Q6K},
    {"attn_qkv": Q8, "attn_gate": Q6K, "ssm_beta": Q8, "ssm_alpha": Q5K,
     "ssm_out": Q4K, "ffn_gate": Q4K, "ffn_up": Q4K, "ffn_down": Q4K},
    {"attn_qkv": Q4K, "attn_gate": Q8, "ssm_beta": Q8, "ssm_alpha": Q8,
     "ssm_out": Q6K, "ffn_gate": Q4K, "ffn_up": Q8, "ffn_down": Q5K},
    {"attn_q": Q8, "attn_k": Q8, "attn_v": Q6K, "attn_output": Q4K,
     "ffn_gate": Q5K, "ffn_up": Q5K, "ffn_down": Q8},
]
#: the head variants: token_embd's type and output.weight's (None: tied)
HEADS = {"tied-q8": (Q8, None), "untied-q4": (tg.GGML_F32, Q4K),
         "untied-f16": (tg.GGML_F32, tg.GGML_F16),
         "tied-f32": (tg.GGML_F32, None)}
#: the tower of the mmproj: 3 blocks at 32 (2 heads of 16), deepstack after
#: blocks 0 and 1, patch 16, merge 2, output at the decoder's width
VIS = dict(depth=3, hidden=32, ff=64, heads=2, patch=16, image=64,
           deepstack=(0, 1))


def decoder_tensors(seed: int = 7, scale: float = 0.3) -> dict:
    """Seeded float weights in llama.cpp's names and (out, in) layout:
    uncentred norms near 1, ssm_a and ssm_dt.bias drawn (nonzero), the
    conv (D, 1, K); types per LAYER_TYPES (norms and the SSM's small
    tensors F32)."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=scale):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def f32(x):
        return (x, tg.GGML_F32)

    t = {"output_norm.weight": f32(1 + w(H, s=0.1))}
    for i, types in enumerate(LAYER_TYPES):
        b = f"blk.{i}."
        t[b + "attn_norm.weight"] = f32(1 + w(H, s=0.1))
        t[b + "post_attention_norm.weight"] = f32(1 + w(H, s=0.1))
        shapes = {"ffn_gate": (FF, H), "ffn_up": (FF, H), "ffn_down": (H, FF),
                  "attn_qkv": (2 * HK * DL + HV * DL, H),
                  "attn_gate": (HV * DL, H), "ssm_beta": (HV, H),
                  "ssm_alpha": (HV, H), "ssm_out": (H, HV * DL),
                  "attn_q": (NQ * 2 * HD, H), "attn_k": (NKV * HD, H),
                  "attn_v": (NKV * HD, H), "attn_output": (H, NQ * HD)}
        for name, gt in types.items():
            t[b + name + ".weight"] = (w(*shapes[name]), gt)
        if "attn_q" in types:
            t[b + "attn_q_norm.weight"] = f32(1 + w(HD, s=0.1))
            t[b + "attn_k_norm.weight"] = f32(1 + w(HD, s=0.1))
        else:
            t[b + "ssm_conv1d.weight"] = f32(w(CONV, 1, 4))
            t[b + "ssm_dt.bias"] = f32(w(HV, s=0.5))
            t[b + "ssm_a"] = f32(-np.exp(w(HV, s=0.5)))
            t[b + "ssm_norm.weight"] = f32(1 + w(DL, s=0.1))
    return t


def write_decoder(path: str, head: str = "tied-q8", seed: int = 7) -> str:
    embd_type, out_type = HEADS[head]
    t = decoder_tensors(seed)
    rng = np.random.default_rng(seed + 100)
    t["token_embd.weight"] = (
        (rng.standard_normal((V, H)) * 0.3).astype(np.float32), embd_type)
    if out_type is not None:
        t["output.weight"] = (
            (rng.standard_normal((V, H)) * 0.3).astype(np.float32), out_type)
    tg.write_gguf(path, META, t)
    return path


def mmproj_tensors(seed: int = 11) -> dict:
    """A Qwen3-VL tower in llama.cpp's mmproj names: the patch embedding
    as two temporal slices, Q8_0 linears, F32 norms and biases."""
    rng = np.random.default_rng(seed)
    d, p = VIS["hidden"], VIS["patch"]
    unit = 4 * d

    def w(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def f32(x):
        return (x, tg.GGML_F32)

    def lin(name, n_out, n_in):
        return {name + ".weight": (w(n_out, n_in), Q8),
                name + ".bias": f32(w(n_out, s=0.02))}

    def norm(name, n):
        return {name + ".weight": f32(1 + w(n)), name + ".bias": f32(w(n))}

    t = {"v.patch_embd.weight": f32(w(d, 3, p, p)),
         "v.patch_embd.weight.1": f32(w(d, 3, p, p)),
         "v.patch_embd.bias": f32(w(d, s=0.02)),
         "v.position_embd.weight": f32(w((VIS["image"] // p) ** 2, d)),
         **norm("v.post_ln", d), **lin("mm.0", unit, unit),
         **lin("mm.2", H, unit)}
    for i in range(VIS["depth"]):
        b = f"v.blk.{i}."
        t.update({**norm(b + "ln1", d), **norm(b + "ln2", d),
                  **lin(b + "attn_qkv", 3 * d, d), **lin(b + "attn_out", d, d),
                  **lin(b + "ffn_up", VIS["ff"], d),
                  **lin(b + "ffn_down", d, VIS["ff"])})
    for i in VIS["deepstack"]:
        b = f"v.deepstack.{i}."
        t.update({**norm(b + "norm", unit), **lin(b + "fc1", unit, unit),
                  **lin(b + "fc2", H, unit)})
    return t


def write_mmproj(path: str) -> str:
    tg.write_gguf(path, {
        "general.architecture": "clip",
        "clip.vision.embedding_length": VIS["hidden"],
        "clip.vision.block_count": VIS["depth"],
        "clip.vision.feed_forward_length": VIS["ff"],
        "clip.vision.attention.head_count": VIS["heads"],
        "clip.vision.attention.layer_norm_epsilon": 1e-6,
        "clip.vision.patch_size": VIS["patch"],
        "clip.vision.image_size": VIS["image"],
        "clip.vision.spatial_merge_size": 2,
        "clip.vision.is_deepstack_layers": [
            int(i in VIS["deepstack"]) for i in range(VIS["depth"])],
    }, mmproj_tensors())
    return path


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf35")
    out = {h: write_decoder(str(d / f"{h}.gguf"), h) for h in HEADS}
    out["mmproj"] = write_mmproj(str(d / "mmproj.gguf"))
    return out


def _loaded(path):
    tm, tp, _ = tgm.load_qwen3_5_gguf(path, dtype=torch.float32,
                                      max_rope_len=256)
    jm, jp, _ = jgm.load_qwen3_5_gguf(path, dtype=jnp.float32,
                                      max_rope_len=256)
    return tm, tp, jm, jp


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


def _assert_same_params(got, want, path=""):
    """The port's tree against params_from_jax of the JAX one: dense
    leaves equal; int8 grids equal over the port's K padding (to 128), the
    JAX packer's further padding (to 1024 rows) all zeros; 4-bit grids
    within 1 f32 ulp dequantized (the unfolded mins)."""
    if isinstance(got, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_params(g, w, f"{path}[{i}]")
        return
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
        if isinstance(got[k], (dict, list)):
            _assert_same_params(got[k], want[k], f"{path}.{k}")
        else:
            assert torch.equal(got[k], want[k]), f"{path}.{k}"


# -- config and parameters ------------------------------------------------------


def test_config_matches_jax(files):
    for head in HEADS:
        got = tgm.qwen3_5_config_from_gguf(tg.GGUFFile(files[head]))
        want = jgm.qwen3_5_config_from_gguf(jgm.GGUFFile(files[head]))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), head
        assert got.tie_word_embeddings == (HEADS[head][1] is None)
    assert got.layer_types == ("linear_attention",) * 3 + ("full_attention",)
    assert got.partial_rotary_factor == 0.25


@pytest.mark.parametrize("head", list(HEADS))
def test_params_match_jax(files, head):
    """Every loaded tensor, and every fused one, equal to the JAX loader's
    (dequantized); the grids follow the stored types layer by layer."""
    tm, tp, jm, jp = _loaded(files[head])
    _assert_same_params(tp, params_from_jax(jax.tree.map(np.asarray, jp)))
    _assert_same_params(
        fuse_qwen3_5_decode_params(tp),
        params_from_jax(jax.tree.map(np.asarray, jm.fuse_params(jp))))
    grids = [{n: "q4" if "q4" in p else "q8" for n, p in lp.items()
              if isinstance(p, dict) and tq.is_quantized(p)}
             for lp in tp["layers"]]
    for types, g in zip(LAYER_TYPES, grids):
        names = {"attn_qkv": "in_proj_qkv", "attn_gate": "in_proj_z",
                 "ssm_beta": "in_proj_b", "ssm_alpha": "in_proj_a",
                 "ssm_out": "out_proj", "attn_q": "q", "attn_k": "k",
                 "attn_v": "v", "attn_output": "o"}
        assert g == {names[n]: "q4" if t in tq.Q4_TYPES else "q8"
                     for n, t in types.items() if n in names}


def test_norms_and_ssm_tensors_as_stored(files):
    """Norms are read as stored (a GGUF file's are uncentred: no w + 1
    fold, unlike the HF loader); ssm_conv1d (D, 1, K) is the (K, D) conv;
    ssm_dt.bias and ssm_a stay float32 at a bf16 load."""
    g = tg.GGUFFile(files["tied-q8"])
    _, tp, _ = tgm.load_qwen3_5_gguf(files["tied-q8"], dtype=torch.bfloat16)
    lp = tp["layers"][0]
    want = torch.from_numpy(g.dequantize("blk.0.attn_norm.weight"))
    assert torch.equal(lp["ln1"]["w"], want.to(torch.bfloat16))
    assert torch.equal(tp["norm"]["w"], torch.from_numpy(
        g.dequantize("output_norm.weight")).to(torch.bfloat16))
    conv = g.dequantize("blk.0.ssm_conv1d.weight")
    assert lp["conv"]["w"].dtype == torch.float32
    assert torch.equal(lp["conv"]["w"], torch.from_numpy(conv[:, 0, :].T))
    for k in ("dt_bias", "a_log"):
        assert lp[k].dtype == torch.float32


def test_ssm_a_is_read_into_a_log_as_stored(files):
    """The reference reads ssm_a straight into a_log
    (aha_tpu/io/gguf_models.py:225), and its block takes g =
    −exp(a_log)·softplus(a + dt_bias) (aha_tpu/models/qwen3_5.py:422).  To
    our knowledge llama.cpp's converter stores −exp(A_log) under ssm_a, so
    a real file's decay would be −exp(−exp(A_log))·softplus(…); the port
    copies the reference's numbers (ROADMAP queue 3, departures copied),
    and this pins it: a_log is the stored ssm_a, bit for bit, in both
    packages, and the decay the block computes is the reference's."""
    g = tg.GGUFFile(files["tied-q8"])
    _, tp, jm, jp = _loaded(files["tied-q8"])
    for i in range(3):
        stored = g.dequantize(f"blk.{i}.ssm_a")
        assert (stored < 0).all()
        assert np.array_equal(tp["layers"][i]["a_log"].numpy(), stored)
        assert np.array_equal(np.asarray(jp["layers"][i]["a_log"]), stored)
    a = torch.randn(HV)
    lp = tp["layers"][0]
    g_port = -lp["a_log"].exp() * torch.nn.functional.softplus(
        a + lp["dt_bias"])
    g_ref = -np.exp(g.dequantize("blk.0.ssm_a")) * np.log1p(np.exp(
        a.numpy() + g.dequantize("blk.0.ssm_dt.bias")))
    np.testing.assert_allclose(g_port.numpy(), g_ref, rtol=1e-6)


def test_heads_follow_the_stored_type(files):
    """A tied Q8_0 embedding packs an int8 head from its dequantized rows;
    an untied Q4_K output.weight stays on the 4-bit grid; an F16 one is a
    dense vocab-major (V, K) head; a tied F32 embedding is the head
    itself.  Each against the JAX head."""
    for head, keys in (("tied-q8", {"qt", "st"}),
                       ("untied-q4", {"q4", "s4", "b4"}),
                       ("untied-f16", {"w"}), ("tied-f32", {"w"})):
        tm, tp, jm, jp = _loaded(files[head])
        assert set(tp["lm_head"]) == keys, head
        if keys == {"w"}:
            assert tp["lm_head"]["w"].shape == (V, H)
        h = torch.randn(1, 3, H)
        got = tm.logits(tp, h)
        want = np.asarray(jm.logits(jp, jnp.asarray(h.numpy())))
        assert got.shape == (1, 3, V)
        assert _rel(got.numpy(), want) <= TOL, head
    _, tp, _, _ = _loaded(files["tied-f32"])
    assert tp["lm_head"]["w"] is tp["embed"]["w"]
    _, tp, _, _ = _loaded(files["tied-q8"])
    assert tp["lm_head"]["qt"].shape == (V, 128)


# -- the quantized fusions ------------------------------------------------------


def test_quantized_fusions_are_bit_identical(files):
    """Each fused product equals the separate products side by side, bit
    for bit, through the kernels' plain versions (activation quantization)
    and through the dequantize path the CPU takes; the pad columns of
    [q|k|v] (192 → 256) and [qkv|z|b|a] (200 → 256) are zero integers and
    scales, give zeros, and never reach the blocks; [gate|up] is not
    padded; mixed-grid parts stay separate (layer 2)."""
    _, tp, _, _ = _loaded(files["tied-q8"])
    fused = fuse_qwen3_5_decode_params(tp)["layers"]
    x = torch.randn(5, H)
    parts = {"in_proj": ("in_proj_qkv", "in_proj_z", "in_proj_b",
                         "in_proj_a"),
             "qkv": ("q", "k", "v")}
    seen = set()
    for lp, fp in zip(tp["layers"], fused):
        for into, names in parts.items():
            if into not in fp:
                continue
            seen.add(into)
            f = fp[into]
            n = sum(tq.grid_info(lp[m])[2] for m in names)
            assert tq.grid_info(f)[2] == 256 and n in (192, 200)
            for k, v in f.items():
                assert not v[n:].any(), k
            for route in (tq.quant_linear, _plain):
                got = route(f, x)
                want = torch.cat([route(lp[m], x) for m in names], dim=-1)
                assert torch.equal(got[:, :n], want)
                assert not got[:, n:].any()
        mlp, fmlp = lp["mlp"], fp["mlp"]
        if "gateup" in fmlp:
            seen.add("gateup")
            assert tq.grid_info(fmlp["gateup"])[2] == 2 * FF
            for route in (tq.quant_linear, _plain):
                assert torch.equal(route(fmlp["gateup"], x), torch.cat(
                    [route(mlp["gate"], x), route(mlp["up"], x)], dim=-1))
    assert seen == {"in_proj", "qkv", "gateup"}
    assert {"in_proj_qkv", "in_proj_z", "in_proj_b", "in_proj_a"} <= set(
        fused[2]) and "in_proj" not in fused[2]
    assert {"gate", "up"} <= set(fused[2]["mlp"])


def _plain(p, x):
    grid = "q4" if "q4" in p else "q8"
    fn = tq.quant_matmul_q4_plain if grid == "q4" else tq.quant_matmul_plain
    return fn(x, *[p[k] for k in tq.GRID_KEYS[grid]])


def test_pad_quant_cols():
    """Zero columns to the next multiple (on the port's column axis −2),
    every grid tensor alike; a multiple and a dense dict pass through."""
    w = torch.randn(200, 256)
    for q4 in (False, True):
        p = tq.pack_rows(w, q4)
        padded = tq.pad_quant_cols(p)
        for k, v in padded.items():
            assert v.shape[-2] == 256 and torch.equal(v[:200], p[k])
            assert not v[200:].any()
        assert torch.equal(tq.dequant(padded)[:200], tq.dequant(p))
        assert tq.pad_quant_cols(padded) is padded
    dense = {"w": torch.randn(64, 200)}
    assert tq.pad_quant_cols(dense) is dense


# -- streams --------------------------------------------------------------------


@pytest.mark.parametrize("head", ["tied-q8", "untied-q4"])
def test_logits_match_jax(files, head):
    """A 37-token prefill and 8 decode steps: the port's logits within TOL
    of max |ref| of the JAX model's, on the fused parameters."""
    tm, tp, jm, jp = _loaded(files[head])
    tp, jp = fuse_qwen3_5_decode_params(tp), jm.fuse_params(jp)
    ids = [int(t) for t in np.random.default_rng(5).integers(2, 150, 37)]
    tc = tm.init_cache(1, 64, torch.float32)
    jc = jm.init_cache(1, 64, jnp.float32)
    x, jx = [ids], [ids]
    for step in range(9):
        h = tm.backbone(tp, torch.tensor(x), tc)
        got = tm.logits(tp, h[:, -1:])
        tc["pos"] += h.shape[1]
        jh, jc = jm.backbone(jp, jnp.asarray(jx), jc)
        want = np.asarray(jm.logits(jp, jh[:, -1:]))
        jc = {**jc, "pos": jc["pos"] + jh.shape[1]}
        assert _rel(got.numpy(), want) <= TOL, step
        nxt = int(np.argmax(want[0, -1]))
        x = jx = [[nxt]]


def test_text_engine_streams_match_jax(files, engines):  # noqa: F811
    tm, tp, jm, jp = _loaded(files["tied-q8"])
    text_engine_streams(jm, jp, tm, tp, engines)


def test_batch_engine_streams_match_jax(files, engines):  # noqa: F811
    tm, tp, jm, jp = _loaded(files["untied-q4"])
    batch_engine_streams(jm, jp, tm, tp, engines)


# -- the mmproj tower -----------------------------------------------------------


def test_mmproj_config_and_tower_match_jax(files):
    """The tower's config equals the JAX one's; its tensors equal it
    (dequantized); main and deepstack features within TOL of max |ref| on
    a 4 x 6 patch grid."""
    from aha_tpu.models.qwen3vl import Qwen3VLVisionTower as JTower
    from aha_tpu.models.qwen3vl import vision_geometry_qwen3vl as jgeo
    from aha_tpu_torch.models.qwen2_5vl import mm_to
    from aha_tpu_torch.models.qwen3vl import Qwen3VLVisionTower
    from aha_tpu_torch.models.qwen3vl_served import build_mm

    vcfg, visual = tgm.load_qwen3vl_tower_mmproj(files["mmproj"],
                                                 dtype=torch.float32)
    jcfg, jvisual = jgm.load_qwen3vl_tower_mmproj(files["mmproj"],
                                                  dtype=jnp.float32)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jcfg)
    assert vcfg.deepstack_visual_indexes == VIS["deepstack"]
    assert vcfg.out_hidden_size == H and vcfg.num_position_embeddings == 16
    _assert_same_params(visual, params_from_jax(
        jax.tree.map(np.asarray, jvisual)))
    grid = (1, 4, 6)
    patches = np.random.default_rng(1).standard_normal(
        (24, 3 * 2 * 16 * 16)).astype(np.float32)
    geo = jgeo([grid], jcfg)
    jmain, jds = JTower(jcfg).encode(jvisual, {
        "patches": jnp.asarray(patches),
        **{k: jnp.asarray(v) for k, v in geo.items()}})
    cfg = type("C", (), {"vision": vcfg, "image_token_id": V - 3,
                         "video_token_id": V - 1,
                         "vision_start_token_id": V - 4})
    ids = [5, V - 4] + [V - 3] * 6 + [V - 2, 7]
    mm = mm_to(build_mm([patches], [grid], ids, cfg), torch.device("cpu"))
    main, ds = Qwen3VLVisionTower(vcfg).encode(visual, mm)
    assert _rel(main[:6].numpy(), np.asarray(jmain)[:6]) <= TOL
    assert _rel(ds[:, :6].numpy(), np.asarray(jds)[:, :6]) <= TOL


def test_vl_loader_matches_jax(files):
    """load_qwen3_5_gguf_vl: the VL config (M-RoPE sections from
    qwen35.rope.dimension_sections without its last entry, the vision
    token ids from the file's token list) equals the JAX one; the tower
    sits under params["visual"]."""
    tm, tp, _, vl = tgm.load_qwen3_5_gguf_vl(
        files["tied-q8"], files["mmproj"], dtype=torch.float32)
    _, jp, _, jvl = jgm.load_qwen3_5_gguf_vl(
        files["tied-q8"], files["mmproj"], dtype=jnp.float32)
    assert vl.mrope_section == tuple(jvl.mrope_section) == (2, 1, 1)
    assert (vl.image_token_id, vl.video_token_id,
            vl.vision_start_token_id) == (
        jvl.image_token_id, jvl.video_token_id,
        jvl.vision_start_token_id) == (V - 3, V - 1, V - 4)
    assert dataclasses.asdict(vl.vision) == dataclasses.asdict(jvl.vision)
    assert tm.tower is not None and tm.vl is vl
    _assert_same_params(tp["visual"], params_from_jax(
        jax.tree.map(np.asarray, jp["visual"])))
