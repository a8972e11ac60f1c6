"""The port's DeepSeek-OCR (aha_tpu_torch/models/deepseek_ocr.py, ops/moe.py,
ops/conv.py, utils/interpolate.py) against aha_tpu's at the JAX tests'
tiny geometry (tests/test_deepseek_ocr.py tiny_config), float32 on the
CPU, both packages fed the same numpy weights through params_from_jax:
the resize weights, the convolutions, the MoE gate and FFN (the capacity
rule's dropped pairs included), SAM (window and global blocks, the
position and relative-position resizes), CLIP, encode_views for version
1 and 2, the Gundam layout's goldens, the backbone's logits at prefill
and decode, and greedy streams through both TextEngines with and without
crops.

Tolerances are relative to max |ref|: 1e-5 for single ops (the same
float32 arithmetic in another order), 1e-4 for the towers and the
decoder's logits (a few hundred float32 ops deep)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JTextEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import deepseek_ocr as J
from aha_tpu.models.llama import LlamaConfig as JLlamaConfig
from aha_tpu.models.llama import LlamaModel as JLlamaModel
from aha_tpu.ops import conv as Jconv
from aha_tpu.ops import moe as Jmoe
from aha_tpu.utils import interpolate as Jinterp
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import deepseek_ocr as T
from aha_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aha_tpu_torch.ops import conv as Tconv
from aha_tpu_torch.ops import moe as Tmoe
from aha_tpu_torch.utils import interpolate as Tinterp
from tests.test_deepseek_ocr import tiny_config

torch.set_num_threads(1)
TOL_OP = 1e-5
TOL_DEEP = 1e-4


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def port_config(jc) -> T.DeepseekOCRConfig:
    d = dataclasses.asdict(jc)
    return T.DeepseekOCRConfig(
        language=T.DeepseekV2Config(**d.pop("language")),
        sam=T.SamViTConfig(**d.pop("sam")),
        clip=T.ClipViTConfig(**d.pop("clip")), **d)


#: version 2's encoder cut to the JAX test's tiny Qwen2 (hidden 48 = the
#: tiny SAM's net3 channels)
TINY_QWEN2 = dict(vocab_size=64, hidden_size=48, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, qkv_bias=True)


def build(version: int = 1, experts: int | None = None):
    """(jax model, jax params, port model, port params) of tiny_config
    (`experts` routed experts instead of 8), the JAX tree's numbers in
    both; version 2 with the tiny Qwen2 encoder and its queries."""
    jc = tiny_config(version)
    if experts:
        jc = dataclasses.replace(jc, language=dataclasses.replace(
            jc.language, n_routed_experts=experts))
    jm = J.DeepseekOCRModel(jc, max_rope_len=512)
    jp = jm.init_random(jax.random.PRNGKey(version))
    tm = T.DeepseekOCRModel(port_config(jc), max_rope_len=512)
    if version == 2:
        jm.qwen2_model = JLlamaModel(JLlamaConfig(**TINY_QWEN2),
                                     max_rope_len=256)
        tm.qwen2_model = LlamaModel(LlamaConfig(**TINY_QWEN2),
                                    max_rope_len=256)
        n = (jc.sam.img_size // 64) ** 2
        jp["qwen2enc"] = {
            "params": jm.qwen2_model.init_random(jax.random.PRNGKey(2),
                                                 scale=0.1),
            "query_768": jax.random.normal(jax.random.PRNGKey(3),
                                           (144, 48)) * .1,
            "query_1024": jax.random.normal(jax.random.PRNGKey(4),
                                            (n, 48)) * .1}
        jp["projector"] = {
            "w": jax.random.normal(jax.random.PRNGKey(5),
                                   (48, jc.projector_n_embed)) * 0.1,
            "b": jnp.zeros(jc.projector_n_embed)}
    jp = jax.tree.map(np.asarray, jp)
    return jm, jp, tm, params_from_jax(jp)


@pytest.fixture(scope="module")
def v1():
    return build(1)


@pytest.fixture(scope="module")
def v2():
    return build(2)


def pixels(n: int, side: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 3, side, side)).astype(np.float32)


# -- host modules and ops -----------------------------------------------------


@pytest.mark.parametrize("size,mode,aa,shape", [
    (79, "linear", False, (1, 8, 127)),          # a rel-pos table, shrunk
    (27, "linear", False, (1, 4, 13)),           # grown
    ((40, 40), "bicubic", True, (1, 6, 64, 64)),  # SAM's table at 640 px
    ((10, 10), "bicubic", True, (1, 5, 16, 16)),  # CLIP's at 640 px
    ((24, 24), "bicubic", True, (1, 3, 16, 16)),  # grown
    ((7, 11), "bilinear", False, (2, 3, 5, 9))])
def test_interpolate_matches_jax(size, mode, aa, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = Jinterp.interpolate(jnp.asarray(x), size, mode, antialias=aa)
    got = Tinterp.interpolate(torch.from_numpy(x), size, mode, antialias=aa)
    assert rel(got, want) <= TOL_OP
    n_in = shape[-1] if isinstance(size, int) else shape[-2]
    n_out = size if isinstance(size, int) else size[0]
    m1 = "linear" if isinstance(size, int) else mode[2:]
    np.testing.assert_array_equal(
        Tinterp.resize_weights_1d(n_in, n_out, m1, aa),
        Jinterp.resize_weights_1d(n_in, n_out, m1, False, aa))


@pytest.mark.parametrize("stride,padding,bias", [(16, 0, True), (1, 1, False),
                                                 (2, 1, False)])
def test_conv2d_and_layer_norm_2d_match_jax(stride, padding, bias):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 6, 32, 32)).astype(np.float32)
    k = 16 if stride == 16 else 3
    p = {"w": rng.standard_normal((8, 6, k, k)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(8).astype(np.float32)
    want = Jconv.conv2d({n: jnp.asarray(v) for n, v in p.items()},
                        jnp.asarray(x), stride=stride, padding=padding)
    got = Tconv.conv2d({n: torch.from_numpy(v) for n, v in p.items()},
                       torch.from_numpy(x), stride=stride, padding=padding)
    assert got.shape == want.shape and rel(got, want) <= TOL_OP
    ln = {"w": rng.standard_normal(8).astype(np.float32),
          "b": rng.standard_normal(8).astype(np.float32)}
    want = Jconv.layer_norm_2d({n: jnp.asarray(v) for n, v in ln.items()},
                               want)
    got = Tconv.layer_norm_2d({n: torch.from_numpy(v) for n, v in ln.items()},
                              got)
    assert rel(got, want) <= TOL_OP


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("norm", [False, True])
def test_moe_gate_matches_jax(scoring, norm):
    rng = np.random.default_rng(7)
    gw = rng.standard_normal((32, 64)).astype(np.float32)
    x = rng.standard_normal((37, 32)).astype(np.float32)
    kw = dict(scoring=scoring, norm_topk_prob=norm, routed_scaling_factor=2.5)
    jw, ji = Jmoe.moe_gate(jnp.asarray(gw), jnp.asarray(x), 6, **kw)
    tw, ti = Tmoe.moe_gate(torch.from_numpy(gw), torch.from_numpy(x), 6, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == torch.float32 and rel(tw, jw) <= TOL_OP
    with pytest.raises(ValueError) as got:
        Tmoe.moe_gate(torch.from_numpy(gw), torch.from_numpy(x), 6,
                      scoring="tanh")
    with pytest.raises(ValueError) as want:
        Jmoe.moe_gate(jnp.asarray(gw), jnp.asarray(x), 6, scoring="tanh")
    assert str(got.value) == str(want.value)


def moe_params(rng, D: int, F: int, E: int, scale: float = 0.3) -> dict:
    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32) * scale

    return {"gate": {"w": mk(D, E)},
            "experts": {"gate": {"w": mk(E, D, F)}, "up": {"w": mk(E, D, F)},
                        "down": {"w": mk(E, F, D)}},
            "shared": {"gate": {"w": mk(D, 2 * F)}, "up": {"w": mk(D, 2 * F)},
                       "down": {"w": mk(2 * F, D)}}}


def both_moe(p: dict, x: np.ndarray, k: int, **kw):
    want = Jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), k, **kw)
    got = Tmoe.moe_ffn(jax.tree.map(torch.from_numpy, p),
                       torch.from_numpy(x), k, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("S,capacity", [(17, None), (17, 51), (17, 8),
                                        (1, None), (5, None)],
                         ids=["default-C", "C-S*K", "C-8-drops",
                              "decode", "5-tokens"])
def test_moe_ffn_matches_jax(S, capacity):
    """The gathered form (N ≤ C) and the capacity buffer (C = 8 < 17
    tokens: some pairs past their expert's 8 slots dropped)."""
    rng = np.random.default_rng(S)
    p = moe_params(rng, 32, 24, 8)
    x = rng.standard_normal((S, 32)).astype(np.float32) * 0.3
    got, want = both_moe(p, x, 3, norm_topk_prob=True,
                         routed_scaling_factor=1.5, capacity=capacity)
    assert rel(got, want) <= TOL_OP


def test_default_capacity_matches_jax():
    for n, k, e in [(1, 6, 64), (512, 6, 64), (1024, 6, 64), (128, 6, 64),
                    (32, 2, 8), (7, 3, 8)]:
        assert Tmoe.default_capacity(n, k, e) == \
            Jmoe.default_capacity(n, k, e)
    assert Tmoe.default_capacity(1024, 6, 64) == 384
    assert Tmoe.default_capacity(1, 6, 64) == 6


def test_capacity_drops_are_aha_tpus():
    """A planted router sends all 128 tokens of a 128-row bucket to the
    same 6 experts (top-6 of 64): C = default_capacity(128, 6, 64) = 48, so
    80 of each expert's 128 pairs fall past their slots and contribute 0.
    The port equals aha_tpu's moe_ffn, and both part from the exact routed
    sum (every pair counted), which the reference's moe_infer computes."""
    rng = np.random.default_rng(11)
    D, F, E, K, N = 32, 16, 64, 6, 128
    p = moe_params(rng, D, F, E)
    del p["shared"]
    p["gate"]["w"][:] = 0.0
    p["gate"]["w"][0, :K] = 10.0 + np.arange(K)       # experts 0..5
    x = np.abs(rng.standard_normal((N, D)).astype(np.float32)) + 0.5
    C = Tmoe.default_capacity(N, K, E)
    assert C == 48
    got, want = both_moe(p, x, K, capacity=C)
    assert rel(got, want) <= TOL_OP
    exact, _ = both_moe(p, x, K, capacity=N * K)
    np.testing.assert_allclose(got[:C], exact[:C], rtol=1e-5, atol=1e-6)
    assert np.abs(got[C:]).max() == 0.0       # every pair of these dropped
    assert np.abs(exact[C:]).min(axis=-1).max() > 0.0
    assert rel(got, exact) > 0.5


# -- towers -------------------------------------------------------------------


@pytest.mark.parametrize("side", [64, 96], ids=["native", "resize-96"])
def test_sam_encode_matches_jax(v1, side):
    """One window block, one global, one window (tiny_config): at 64 px
    the tables as drawn; at 96 px the position table resized
    bicubic-antialias (4 → 6) and the global block's rel-pos tables
    linearly (7 → 11 rows); windows of 2 tile the 6 patches."""
    jm, jp, tm, tp = v1
    x = pixels(2, side, side)
    want = jax.jit(J.sam_encode, static_argnums=2)(
        jax.tree.map(jnp.asarray, jp["sam"]), jnp.asarray(x), jm.config.sam)
    got = T.sam_encode(tp["sam"], torch.from_numpy(x), tm.config.sam)
    n = -(-side // 64)                 # the two stride-2 convs round up
    assert got.shape == want.shape == (2, 48, n, n)
    assert rel(got, want) <= TOL_DEEP


def test_sam_window_padding_round_trips():
    x = torch.randn(2, 5, 7, 3)
    win, pad = T._window_partition(x, 2)
    assert win.shape == (2 * 3 * 4, 2, 2, 3) and pad == (6, 8)
    assert torch.equal(T._window_unpartition(win, 2, pad, (5, 7)), x)


@pytest.mark.parametrize("grid", [2, 3], ids=["native", "resize"])
def test_clip_encode_matches_jax(v1, grid):
    """SAM-shaped patch embeddings (48 channels = CLIP's width); the 2 x 2
    table as drawn, or resized bicubic-antialias to 3 x 3."""
    jm, jp, tm, tp = v1
    x = np.random.default_rng(grid).standard_normal(
        (2, 48, grid, grid)).astype(np.float32)
    want = jax.jit(J.clip_encode, static_argnums=2)(
        jax.tree.map(jnp.asarray, jp["clip"]), jnp.asarray(x), jm.config.clip)
    got = T.clip_encode(tp["clip"], torch.from_numpy(x), tm.config.clip)
    assert got.shape == want.shape == (2, 1 + grid * grid, 48)
    assert rel(got, want) <= TOL_DEEP


@pytest.mark.parametrize("version", [1, 2])
def test_encode_views_matches_jax(v1, v2, version):
    jm, jp, tm, tp = v1 if version == 1 else v2
    x = pixels(3, 64, 5)
    want = jax.jit(jm.encode_views)(jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x))
    got = tm.encode_views(tp, torch.from_numpy(x))
    assert got.shape == want.shape == (3, 1, 64)
    assert rel(got, want) <= TOL_DEEP


# -- the Gundam layout --------------------------------------------------------


@pytest.mark.parametrize("layout,version,total,golden", [
    ({"nq": 2, "nb": 2, "wr": 1, "hr": 1}, 1, None, [0, 1, 4, 2, 3, 4, 5]),
    ({"nq": 1, "nb": 1, "wr": 2, "hr": 1}, 1, None, [0, 1, 3, 2, 3, 4]),
    ({"nq": 2, "nb": 2, "wr": 1, "hr": 1}, 2, None, [0, 1, 2, 3, 4]),
    ({"nq": 1, "nb": 1, "wr": 2, "hr": 1}, 1, 4, [0, 1, 5, 4, 5, 6])],
    ids=["no-crops-v1", "crops-v1", "v2-no-newline", "padded-crop-rows"])
def test_vision_layout_goldens(layout, version, total, golden):
    got = T.deepseek_vision_layout([layout], version, total)
    np.testing.assert_array_equal(got, golden)
    np.testing.assert_array_equal(
        got, J.deepseek_vision_layout([layout], version, total))


def test_vision_layout_two_images_match_jax():
    layout = [{"nq": 10, "nb": 16, "wr": 2, "hr": 3},
              {"nq": 10, "nb": 10, "wr": 1, "hr": 1},
              {"nq": 10, "nb": 16, "wr": 3, "hr": 1}]
    for version in (1, 2):
        np.testing.assert_array_equal(
            T.deepseek_vision_layout(layout, version),
            J.deepseek_vision_layout(layout, version))


# -- the decoder --------------------------------------------------------------


def mm_for(cfg, crops: bool, seed: int = 3) -> dict:
    """Host inputs at the tiny image size: one global view, and with
    `crops` a 2 x 1 grid of crop views of the same size."""
    s = cfg.sam.img_size
    nb = s // 64
    layout = [{"nq": nb, "nb": nb, "wr": 2 if crops else 1, "hr": 1}]
    mm = {"global": pixels(1, s, seed),
          "gather_idx": T.deepseek_vision_layout(layout, cfg.version)}
    if crops:
        mm["crops"] = pixels(2, s, seed + 1)
    return mm


def jmm(mm):
    return {k: jnp.asarray(v) for k, v in mm.items()}


def tmm(mm):
    return {k: torch.from_numpy(np.array(v)) for k, v in mm.items()}


def prompt_for(cfg, mm, pre=(0, 5, 7), post=(9, 11)):
    return list(pre) + [cfg.image_token_id] * len(mm["gather_idx"]) + \
        list(post)


def test_backbone_logits_match_jax():
    """Prefill (one view) then 3 decode steps, at 32 routed experts: the
    prefill's capacity C = ceil(4 · 32 · 2 / 32) = 8 < 32 padded tokens
    takes the capacity buffer's form, a decode step the gathered one."""
    from aha_tpu.core import cache as jkv
    from aha_tpu_torch.core import cache as tkv

    jm, jp, tm, tp = build(1, experts=32)
    cfg = tm.config
    mm = mm_for(cfg, crops=False)
    ids = prompt_for(cfg, mm)
    S = len(ids)
    pad = ids + [0] * (32 - S)
    jpj = jax.tree.map(jnp.asarray, jp)
    jc = jm.init_cache(1, 64, jnp.float32)
    step = jax.jit(jm.backbone)     # one trace per shape beats eager ops
    h, jc = step(jpj, jnp.asarray([pad], jnp.int32), jc, mm=jmm(mm),
                 prompt_len=jnp.int32(S))
    jc = jkv.advance(jc, S)
    want = [np.asarray(jm.logits(jpj, h)[0, :S])]
    tc = tm.init_cache(1, 64, torch.float32)
    with torch.no_grad():
        h = tm.backbone(tp, torch.tensor([pad]), tc, mm=tmm(mm),
                        prompt_len=S)
        tkv.advance(tc, S)
        got = [tm.logits(tp, h)[0, :S].numpy()]
        for tok in (17, 3, 101):
            h, jc = step(jpj, jnp.asarray([[tok]], jnp.int32), jc)
            jc = jkv.advance(jc, 1)
            want.append(np.asarray(jm.logits(jpj, h)[0]))
            h = tm.backbone(tp, torch.tensor([[tok]]), tc)
            tkv.advance(tc, 1)
            got.append(tm.logits(tp, h)[0].numpy())
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL_DEEP


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("crops", [False, True], ids=["global", "crops"])
def test_greedy_streams_match_jax(v1, v2, version, crops):
    jm, jp, tm, tp = v1 if version == 1 else v2
    cfg = tm.config
    mm = mm_for(cfg, crops, seed=version + 2 * crops)
    ids = prompt_for(cfg, mm, pre=(0, 5, 7, 42, 17), post=(9, 11, 13))
    jeng = JTextEngine(jm, jax.tree.map(jnp.asarray, jp), eos_token_ids=[],
                       cache_dtype=jnp.float32, max_seq_len=256)
    want = jeng.generate_tokens(ids, JSampling(), max_tokens=12, mm=jmm(mm))
    eng = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256)
    got = eng.generate_tokens(ids, SamplingConfig(), max_tokens=12,
                              mm=tmm(mm))
    assert got == list(want) and len(got) == 12


def test_version_2_encoder_loads_its_names():
    """load_qwen2_encoder reads the Qwen2 stack's layers and norm under
    model.qwen2_model.model.model. (float32 whatever the load dtype; the
    embedding is left out) and the two query sets."""
    from aha_tpu_torch.io.weights import _hf_decoder

    enc = LlamaModel(LlamaConfig(**TINY_QWEN2), max_rope_len=64)
    p = enc.init_random(torch.Generator().manual_seed(5))
    src = _hf_decoder(p, "model.qwen2_model.model.model.")
    src["lm_head.weight"] = p["lm_head"]["w"]
    q = {n: torch.randn(k, 48) for n, k in (("query_768", 144),
                                             ("query_1024", 256))}
    src.update({f"model.qwen2_model.{n}.weight": t for n, t in q.items()})
    got = T.load_qwen2_encoder(enc, src, torch.float32)
    for n in q:
        assert torch.equal(got[n], q[n])

    def same(a, b):
        if isinstance(b, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in b)
        return torch.equal(a, b)

    assert same(got["params"], {k: p[k] for k in ("layers", "norm")})
    half = T.load_qwen2_encoder(enc, src, torch.bfloat16)["params"]
    assert all(t.dtype == torch.float32 for t in
               (half["norm"]["w"], *half["layers"]["q"].values()))
