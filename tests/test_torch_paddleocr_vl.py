"""aha_tpu_torch's PaddleOCR-VL against aha_tpu's on the same parameters
(made in JAX from a seed, biases and norms randomized, carried across with
params_from_jax): the host geometry (coordinates, 4-tap half-pixel taps,
segments, the 2 x 2 merge gather) and the M-RoPE ids exactly, for t > 1,
non-square grids and two images; the tower (also at heads 72 wide, the
published tower's D) exact and padded to a patch bucket; the backbone
with an image, its decode steps and the three rope_delta branches; greedy
streams through both TextEngines; the two images of one request in one
segment (the JAX package's choice, pinned); ERNIE's use_bias; the
parameter and HF-checkpoint round trips.  float32 on the CPU: hidden
states within rtol 1e-4, atol 1e-5; the tower's features within 1e-4 of
max |ref| (its sums run in other orders, over features of O(10)); token
streams exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import paddleocr_vl as J
from aha_tpu.models.llama import LlamaConfig as JLlamaConfig
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import paddleocr_vl as T
from aha_tpu_torch.models.llama import LlamaConfig
from aha_tpu_torch.models.paddleocr_vl_served import build_mm
from aha_tpu_torch.models.qwen2_5vl import mm_to

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
#: the tower's features: max abs error over max |ref|
TOL_VISION_REL = 1e-4
IMG, VID, VSTART = 90, 91, 92
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=56, patch_size=14,
              spatial_merge_size=2)
#: heads 72 wide, as the published tower's 1152 / 16
VISION_D72 = {**VISION, "hidden_size": 144, "intermediate_size": 96}
TEXT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=12, rope_theta=500000.0, max_position_embeddings=512,
            tie_word_embeddings=True, qkv_bias=True, o_bias=True,
            mlp_bias=True)
TOKENS = dict(mrope_section=(2, 2, 2), image_token_id=IMG,
              video_token_id=VID, vision_start_token_id=VSTART)
IN_DIM = 3 * 14 * 14
CPU = torch.device("cpu")


def _cfgs(vision=VISION):
    return (J.PaddleOCRVLConfig(vision=J.PaddleVisionConfig(**vision),
                                text=JLlamaConfig(**TEXT), **TOKENS),
            T.PaddleOCRVLConfig(vision=T.PaddleVisionConfig(**vision),
                                text=LlamaConfig(**TEXT), **TOKENS))


JCFG, TCFG = _cfgs()


def _randomized(jp, seed):
    """Random biases and norm shifts: the JAX init leaves them 0 / 1,
    where a dropped one would go unnoticed."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        a = np.asarray(t)
        if name == "b":
            return rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return a

    out = walk(jp)
    for blk in out["visual"]["layers"]:
        for norm in ("ln1", "ln2"):
            blk[norm]["w"] = (1 + 0.2 * rng.standard_normal(
                blk[norm]["w"].shape)).astype(np.float32)
    return out


def _pair(vision=VISION, seed=3):
    jcfg, tcfg = _cfgs(vision)
    jm = J.PaddleOCRVLModel(jcfg, max_rope_len=512)
    jp = _randomized(jax.tree.map(np.asarray, jm.init_random(
        jax.random.PRNGKey(seed), scale=0.3)), seed)
    tm = T.PaddleOCRVLModel(tcfg, max_rope_len=512)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompt(grids, n_text=6):
    n_units = sum(t * (h // 2) * (w // 2) for t, h, w in grids)
    text = [int(x) for x in np.random.default_rng(n_units).integers(
        1, 80, n_text)]
    return text[:2] + [VSTART] + [IMG] * n_units + text[2:]


def _close_rel(got, want, rel=TOL_VISION_REL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _patches(grids, seed=0):
    n = sum(t * h * w for t, h, w in grids)
    return np.random.default_rng(seed).standard_normal(
        (n, IN_DIM)).astype(np.float32)


def _jmm(mm: dict) -> dict:
    return {k: (jnp.int32(v) if k == "rope_delta" else jnp.asarray(v))
            for k, v in mm.items()}


def _exact_mm(grids, ids, patches, cfg=TCFG) -> dict:
    """The unpadded inputs, as the JAX tests build them."""
    pos, delta = T.get_rope_index(ids, grids, cfg)
    return {"patches": patches,
            **T.paddle_vision_geometry(grids, cfg.vision),
            "position_ids": pos, "rope_delta": delta}


GRIDS = [[(1, 4, 6)], [(1, 8, 8)], [(1, 10, 14)], [(2, 4, 6)],
         [(1, 6, 10), (1, 4, 4)], [(1, 12, 4)], [(1, 40, 30)]]


@pytest.mark.parametrize("grids", GRIDS, ids=str)
def test_geometry_and_rope_index_equal_jax(grids):
    """t > 1, non-square grids, two images, and grids wider than the 4 x 4
    learned table's side."""
    want = J.paddle_vision_geometry(grids, JCFG.vision)
    got = T.paddle_vision_geometry(grids, TCFG.vision)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ids = [1, 2]
    for t, h, w in grids:
        ids += [VSTART] + [IMG] * (t * (h // 2) * (w // 2)) + [3]
    ids += [4, 5]
    jpos, jdelta = J.get_rope_index(ids, grids, JCFG)
    pos, delta = T.get_rope_index(ids, grids, TCFG)
    np.testing.assert_array_equal(pos, jpos)
    assert delta == jdelta


def test_two_images_are_one_segment():
    """Every image of a request is segment 0 (the JAX package's choice):
    the tower lets two images attend each other."""
    geo = T.paddle_vision_geometry([(1, 4, 6), (1, 6, 4)], TCFG.vision)
    np.testing.assert_array_equal(geo["seg"], np.zeros(48, np.int32))
    g = T.paddle_vision_geometry([(1, 4, 4)], TCFG.vision)["merge_gather"]
    np.testing.assert_array_equal(g.reshape(4, 4)[:2],
                                  [[0, 1, 4, 5], [2, 3, 6, 7]])


@pytest.mark.parametrize("vision", [VISION, VISION_D72], ids=["d16", "d72"])
@pytest.mark.parametrize("grids,padded", [
    ([(1, 4, 6)], False), ([(1, 8, 12)], True), ([(1, 4, 6), (1, 6, 8)], True)])
def test_encode_matches_jax(vision, grids, padded):
    """The projected features: exact patch counts, and the served form
    padded to a patch bucket (pad rows of seg −1)."""
    jm, jp, tm, tp = _pair(vision)
    cfg = tm.config
    assert cfg.vision.head_dim == (72 if vision is VISION_D72 else 16)
    patches = _patches(grids, seed=1)
    ids = _prompt(grids)
    mm = (build_mm([patches], grids, ids, cfg) if padded
          else _exact_mm(grids, ids, patches, cfg))
    want = jm.encode_vision(jp["visual"], _jmm(mm))
    got = tm.encode_vision(tp["visual"], mm_to(mm, CPU))
    n_units = sum(t * h * w for t, h, w in grids) // 4
    _close_rel(got.numpy()[:n_units], np.asarray(want)[:n_units])


def test_two_images_attend_each_other(pair):
    """The first image's features change when a second image shares its
    request: one segment, pinned (per-image attention would leave them)."""
    _, _, tm, tp = pair
    a, b = [(1, 4, 6)], [(1, 6, 4)]
    pa, pb = _patches(a, seed=7), _patches(b, seed=8)
    alone = tm.encode_vision(tp["visual"], mm_to(
        _exact_mm(a, _prompt(a), pa), CPU))
    both = tm.encode_vision(tp["visual"], mm_to(
        _exact_mm(a + b, _prompt(a + b), np.concatenate([pa, pb])), CPU))
    err = (both[:6] - alone).abs().max() / alone.abs().max()
    assert err > 100 * TOL_VISION_REL


def test_backbone_decode_and_rope_delta_branches(pair):
    """An image prefill stores rope_delta; decode steps add it; a
    text-only prefill resets it to 0 — hidden states and logits equal to
    aha_tpu's at every step."""
    jm, jp, tm, tp = pair
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    S = len(ids)
    mm = _exact_mm(grids, ids, _patches(grids))
    assert mm["rope_delta"] < 0
    jc = jm.init_cache(1, 64, jnp.float32)
    tc = tm.init_cache(1, 64, torch.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([ids]), jc, mm=_jmm(mm))
    th = tm.backbone(tp, torch.tensor([ids]), tc, mm=mm_to(mm, CPU))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert int(tc["rope_delta"]) == int(jc["rope_delta"]) == mm["rope_delta"]
    jc = {**jc, "pos": jnp.int32(S)}
    tc["pos"].fill_(S)
    for tok in (7, 8, 9):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        kv.advance(tc, 1)
        np.testing.assert_allclose(tm.logits(tp, th).numpy(),
                                   np.asarray(jm.logits(jp, jh)), **TOL)
    text = [11, 12, 13, 14, 15]
    jc = jm.init_cache(1, 64, jnp.float32)
    jc = {**jc, "rope_delta": jnp.int32(mm["rope_delta"])}
    tc = tm.init_cache(1, 64, torch.float32)
    tc["rope_delta"].fill_(mm["rope_delta"])
    jh, jc = jm.backbone(jp, jnp.asarray([text]), jc)
    th = tm.backbone(tp, torch.tensor([text]), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert int(tc["rope_delta"]) == int(jc["rope_delta"]) == 0


def test_incremental_decode_equals_full_forward(pair):
    """The image prompt's last logits and the next step's equal a full
    forward of prompt + token (the JAX package's own check, at 1e-4)."""
    _, _, tm, tp = pair
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    full = ids + [7]
    patches = _patches(grids, seed=1)
    mm_full = mm_to(_exact_mm(grids, full, patches), CPU)
    ref = tm.logits(tp, tm.backbone(tp, torch.tensor([full]),
                                    tm.init_cache(1, 32, torch.float32),
                                    mm=mm_full))[0]
    tc = tm.init_cache(1, 32, torch.float32)
    h = tm.backbone(tp, torch.tensor([ids]), tc,
                    mm=mm_to(_exact_mm(grids, ids, patches), CPU))
    kv.advance(tc, len(ids))
    got = [tm.logits(tp, h)[0, -1]]
    h = tm.backbone(tp, torch.tensor([[7]]), tc)
    got.append(tm.logits(tp, h)[0, 0])
    np.testing.assert_allclose(torch.stack(got).numpy(),
                               ref[len(ids) - 1:].numpy(), rtol=1e-4,
                               atol=1e-4)


def _engines(pair):
    jm, jp, tm, tp = pair
    return (JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                    max_seq_len=256),
            TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256))


@pytest.mark.parametrize("grids", [[(1, 4, 6)], [(1, 8, 12)],
                                   [(1, 4, 6), (1, 6, 8)]],
                         ids=["image", "image-bucketed", "two-images"])
def test_greedy_streams_identical(pair, grids):
    je, te = _engines(pair)
    ids = _prompt(grids, n_text=8)
    mm = build_mm([_patches(grids, seed=5)], grids, ids, TCFG)
    want = je.generate_tokens(ids, JSampling(), max_tokens=16, mm=_jmm(mm))
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=16,
                             mm=mm_to(mm, te.device))
    assert got == want
    assert len(set(want)) > 1


def test_text_only_request_after_an_image(pair):
    """rope_delta of an earlier image request is reset to 0."""
    je, te = _engines(pair)
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    mm = build_mm([_patches(grids)], grids, ids, TCFG)
    te.generate_tokens(ids, SamplingConfig(), max_tokens=4,
                       mm=mm_to(mm, te.device))
    je.generate_tokens(ids, JSampling(), max_tokens=4, mm=_jmm(mm))
    text = [int(x) for x in np.random.default_rng(9).integers(1, 80, 30)]
    assert te.generate_tokens(text, SamplingConfig(), max_tokens=12) == \
        je.generate_tokens(text, JSampling(), max_tokens=12)


def test_use_bias_sets_every_decoder_bias(tmp_path):
    """config.json's use_bias gives ERNIE q/k/v, o and MLP biases, in the
    port's config as in aha_tpu's, and init_random's tree has them."""
    import json

    d = {**{k: v for k, v in TEXT.items() if not k.endswith("_bias")},
         "use_bias": True, "vision_config": VISION,
         "rope_scaling": {"mrope_section": [2, 2, 2]}, "image_token_id": IMG}
    (tmp_path / "config.json").write_text(json.dumps(d))
    cfg = T.PaddleOCRVLConfig.from_file(str(tmp_path))
    jcfg = J.PaddleOCRVLConfig.from_file(str(tmp_path))
    for flag in ("qkv_bias", "o_bias", "mlp_bias"):
        assert getattr(cfg.text, flag) is getattr(jcfg.text, flag) is True
    assert cfg.mrope_section == (2, 2, 2) and cfg.image_token_id == IMG
    tree = T.PaddleOCRVLModel(cfg, max_rope_len=64).init_random(
        torch.Generator().manual_seed(0))
    lay = tree["text"]["layers"]
    assert all("b" in lay[n] for n in "qkvo")
    assert all("b" in lay["mlp"][n] for n in ("gate", "up", "down"))
    d["use_bias"] = False
    (tmp_path / "config.json").write_text(json.dumps(d))
    cfg = T.PaddleOCRVLConfig.from_file(str(tmp_path))
    assert not (cfg.text.qkv_bias or cfg.text.o_bias or cfg.text.mlp_bias)


def test_fused_decoder_equals_unfused(pair):
    """The engine's fusion ([q|k|v] and [gate|up] with their biases) leaves
    the image prefill's hidden states as they were."""
    _, _, tm, tp = pair
    fused = tm.fuse_params(tp)
    assert "b" in fused["text"]["layers"]["qkv"]
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    mm = mm_to(_exact_mm(grids, ids, _patches(grids)), CPU)
    a = tm.backbone(tp, torch.tensor([ids]),
                    tm.init_cache(1, 32, torch.float32), mm=mm)
    b = tm.backbone(fused, torch.tensor([ids]),
                    tm.init_cache(1, 32, torch.float32), mm=mm)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _leaves(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k])
    elif isinstance(t, list):
        for x in t:
            yield from _leaves(x)
    else:
        yield t


def test_params_from_jax_round_trip(pair):
    _, jp, _, tp = pair
    assert isinstance(tp["visual"]["layers"], list)
    for got, want in zip(_leaves(tp["visual"]),
                         _leaves(jax.tree.map(np.asarray, jp["visual"])),
                         strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    assert tp["text"]["lm_head"]["w"] is tp["text"]["embed"]["w"]


def test_checkpoint_round_trip_and_jax_loader(pair, tmp_path):
    """save_hf_paddleocr_vl writes what load_params reads back, and what
    aha_tpu's load_params reads to the same tree."""
    from aha_tpu.io.weights import open_weights as jopen_weights
    from aha_tpu_torch.io.weights import open_weights, save_hf_paddleocr_vl

    jm, _, tm, tp = pair
    save_hf_paddleocr_vl(tp, str(tmp_path))
    src = open_weights(str(tmp_path))
    assert tuple(src["visual.vision_model.embeddings.patch_embedding"
                     ".weight"].shape) == (32, 3, 14, 14)
    back = tm.load_params(src, dtype=torch.float32)
    assert back["text"]["lm_head"]["w"] is back["text"]["embed"]["w"]
    for a, b in zip(_leaves(tp), _leaves(back), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jback = params_from_jax(jax.tree.map(np.asarray, jm.load_params(
        jopen_weights(str(tmp_path)), dtype=jnp.float32)))
    for a, b in zip(_leaves(tp), _leaves(jback), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_paddleocr_vl_0_9b_geometry():
    c = T.paddleocr_vl_0_9b()
    v = c.vision
    assert (v.num_hidden_layers, v.hidden_size, v.intermediate_size,
            v.num_attention_heads, v.head_dim, v.patch_size,
            v.image_size // v.patch_size, v.spatial_merge_size) == \
        (27, 1152, 4304, 16, 72, 14, 27, 2)
    t = c.text
    assert (t.num_hidden_layers, t.hidden_size, t.intermediate_size,
            t.num_attention_heads, t.num_key_value_heads, t.head_dim_,
            t.vocab_size, t.rope_theta, t.rms_norm_eps,
            t.tie_word_embeddings, t.qkv_bias, t.o_bias, t.mlp_bias) == \
        (18, 1024, 3072, 16, 2, 128, 103424, 500000.0, 1e-5, True, False,
         False, False)
    assert (c.mrope_section, c.image_token_id, c.video_token_id,
            c.vision_start_token_id) == ((16, 24, 24), 100295, 100296, 101305)
    cut = T.paddleocr_vl_0_9b(depth=4, layers=4)
    assert cut.vision.num_hidden_layers == cut.text.num_hidden_layers == 4
