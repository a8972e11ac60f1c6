"""The port's GLM-OCR (aha_tpu_torch/models/glm_ocr.py) against aha_tpu's
at the JAX tests' tiny geometry (tests/test_glm_hunyuan_ocr.py
tiny_glm_config), float32 on the CPU, both packages loading the same
seeded transformers Glm4vForConditionalGeneration state dict through their
own load_params and fed the same numpy patches: the host geometry
(blocked coordinates, glm_rope_index and its rope_delta, the vision cos /
sin, the position-resample matrix), the tower, the partial interleaved
M-RoPE and its rotation, the prefill logits and 3 decode steps with an
image (decode at pos + rope_delta), then a text-only prefill on the same
pooled cache that resets the delta, and padded-bucket invariance.

Tolerances are relative to max |ref|: 1e-5 for a module (the same
float32 arithmetic in another order), 1e-4 end to end."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import cache as jkv
from aha_tpu.io.weights import DictSource
from aha_tpu.models import glm_ocr as J
from aha_tpu_torch.core import cache as tkv
from aha_tpu_torch.models import glm_ocr as T
from aha_tpu_torch.models.glm_ocr_served import build_mm
from aha_tpu_torch.models.qwen2_5vl import mm_to
from tests.test_glm_hunyuan_ocr import tiny_glm_config

torch.set_num_threads(1)
TOL_OP = 1e-5
TOL_DEEP = 1e-4


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def port_config(jc) -> T.GlmOcrConfig:
    d = dataclasses.asdict(jc)
    return T.GlmOcrConfig(vision=T.GlmOcrVisionConfig(**d.pop("vision")),
                          text=T.GlmOcrTextConfig(**d.pop("text")), **d)


def hf_state_dict(seed: int) -> dict:
    """A seeded transformers Glm4vForConditionalGeneration at the tiny
    geometry (the JAX tests' HF config), its state dict as torch
    tensors; the q / k / v biases drawn too (HF leaves them zero)."""
    from transformers import Glm4vConfig, Glm4vForConditionalGeneration

    torch.manual_seed(seed)
    hf_cfg = Glm4vConfig(
        vision_config=dict(
            depth=2, hidden_size=32, num_heads=4, image_size=28,
            patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
            out_hidden_size=64, intermediate_size=48, attention_bias=False,
            hidden_act="silu", rms_norm_eps=1e-5, in_channels=3),
        text_config=dict(
            vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, partial_rotary_factor=0.5,
            rope_scaling={"rope_type": "default",
                          "mrope_section": [2, 1, 1]},
            max_position_embeddings=512, rms_norm_eps=1e-5,
            hidden_act="silu", attention_bias=True),
        image_token_id=120, image_start_token_id=121,
        image_end_token_id=122, video_token_id=123,
        video_start_token_id=124, video_end_token_id=125)
    sd = Glm4vForConditionalGeneration(hf_cfg).eval().state_dict()
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) * 0.05
                if k.endswith("_proj.bias") else v.detach().clone())
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) on the same
    checkpoint."""
    jc = tiny_glm_config()
    sd = hf_state_dict(0)
    jm = J.GlmOcrModel(jc, max_rope_len=512)
    jp = jm.load_params(DictSource({k: v.numpy() for k, v in sd.items()}),
                        dtype=jnp.float32)
    tm = T.GlmOcrModel(port_config(jc), max_rope_len=512)
    tp = tm.load_params(sd, dtype=torch.float32)
    return jm, jp, tm, tp


def patches_for(cfg, grids, seed=1) -> list[np.ndarray]:
    v = cfg.vision
    dim = v.in_channels * v.temporal_patch_size * v.patch_size ** 2
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t * gh * gw, dim)).astype(np.float32)
            for (t, gh, gw) in grids]


def image_ids(c, grids) -> list[int]:
    ids = [1, 5]
    for (t, gh, gw) in grids:
        ids += ([c.image_start_token_id]
                + [c.image_token_id] * (t * (gh // 2) * (gw // 2))
                + [c.image_end_token_id])
    return ids + [9, 11, 3]


def both_mm(jm, tm, grids, ids, bucket=None):
    """The JAX mm (its functions, its dense pads) and the port's
    (build_mm) over the same patches, the JAX side padded to `bucket` (the
    port's by default)."""
    c = jm.config
    v = c.vision
    plist = patches_for(c, grids)
    tmm = build_mm(plist, grids, ids, tm.config)
    nb = bucket or tmm["patches"].shape[0]
    geom = J.glm_vision_geometry(grids, v)
    cos, sin = J.glm_vision_rope(geom["h"], geom["w"], v)
    resample = J.glm_pos_resample_matrix(geom, grids,
                                         v.image_size // v.patch_size)
    patches = np.concatenate(plist)
    n = len(patches)

    def pad(a):
        out = np.zeros((nb,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out

    pmask = np.zeros((1, 1, 1, nb), np.float32)
    pmask[..., n:] = np.finfo(np.float32).min
    pos, delta = J.glm_rope_index(ids, grids, c)
    jmm = {"patches": jnp.asarray(pad(patches)),
           "vis_cos": jnp.asarray(pad(cos)), "vis_sin": jnp.asarray(pad(sin)),
           "pos_resample": jnp.asarray(pad(resample)),
           "patch_mask": jnp.asarray(pmask),
           "position_ids": jnp.asarray(pos), "rope_delta": jnp.int32(delta)}
    return jmm, mm_to(tmm, torch.device("cpu"))


GRIDS = {"one": [(1, 4, 4)], "two": [(1, 4, 6), (1, 2, 2)],
         "two-frames": [(2, 2, 4)]}


@pytest.mark.parametrize("name", list(GRIDS))
def test_host_geometry_matches_jax(name):
    c = port_config(tiny_glm_config())
    grids = GRIDS[name]
    got, want = T.glm_vision_geometry(grids, c.vision), \
        J.glm_vision_geometry(grids, tiny_glm_config().vision)
    for k in ("h", "w", "seg"):
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(T.glm_vision_rope(got["h"], got["w"], c.vision),
                    J.glm_vision_rope(want["h"], want["w"],
                                      tiny_glm_config().vision)):
        np.testing.assert_array_equal(a, b)
    for g in (2, 24):
        np.testing.assert_allclose(
            T.glm_pos_resample_matrix(got, grids, g),
            J.glm_pos_resample_matrix(want, grids, g), rtol=0, atol=1e-7)
    ids = image_ids(c, grids)
    (gp, gd), (wp, wd) = (T.glm_rope_index(ids, grids, c),
                          J.glm_rope_index(ids, grids, tiny_glm_config()))
    np.testing.assert_array_equal(gp, wp)
    assert gd == wd and gd < 0


def test_tower_matches_jax(models):
    jm, jp, tm, tp = models
    grids = GRIDS["two"]
    ids = image_ids(tm.config, grids)
    jmm, tmm = both_mm(jm, tm, grids, ids)
    want = np.asarray(jm.tower.encode(jp["visual"], jmm))
    got = tm.tower.encode(tp["visual"], tmm).numpy()
    n = sum(gh * gw for _, gh, gw in grids) // 4
    assert rel(got[:n], want[:n]) <= TOL_DEEP


def test_mrope_and_partial_rotation_match_jax():
    """_glm_mrope_cos_sin at the tiny sections and the default (8, 12,
    12) over head_dim 128, and the rotation of the first rotary_dim
    channels in interleaved pairs."""
    for tc in (tiny_glm_config().text, J.GlmOcrTextConfig()):
        tt = T.GlmOcrTextConfig(**dataclasses.asdict(tc))
        pos = np.random.default_rng(4).integers(0, 3000, (3, 7))
        wc, ws = J._glm_mrope_cos_sin(jnp.asarray(pos), tc)
        gc, gs = T._glm_mrope_cos_sin(
            torch.from_numpy(pos), tt, T.glm_inv_freq(tt, "cpu"),
            torch.from_numpy(T.glm_mrope_axes(tt)))
        assert rel(gc.numpy(), wc) <= TOL_OP and rel(gs.numpy(), ws) <= TOL_OP
        x = np.random.default_rng(5).standard_normal(
            (1, 7, 3, tt.head_dim_)).astype(np.float32)
        want = J._apply_partial_interleaved(jnp.asarray(x), wc, ws)
        got = T._apply_partial_interleaved(torch.from_numpy(x), gc, gs)
        assert rel(got.numpy(), want) <= TOL_OP
        np.testing.assert_array_equal(got[..., tt.rotary_dim:].numpy(),
                                      x[..., tt.rotary_dim:])


def test_prefill_decode_then_text_prefill_match_jax(models):
    """An image prefill and 3 decode steps (at pos + rope_delta), then a
    text-only prefill on the same pooled cache (rewound) and one step: the
    port resets the delta and takes plain positions, as JAX does on a
    fresh cache."""
    jm, jp, tm, tp = models
    grids = GRIDS["one"]
    ids = image_ids(tm.config, grids)
    jmm, tmm = both_mm(jm, tm, grids, ids)
    S = len(ids)

    jc = jm.init_cache(1, 64, jnp.float32)
    h, jc = jm.backbone(jp, jnp.asarray([ids], jnp.int32), jc, mm=jmm)
    want = [np.asarray(jm.logits(jp, h))[0]]
    jc = jkv.advance(jc, S)
    tc = tm.init_cache(1, 64, torch.float32)
    got = [tm.logits(tp, tm.backbone(tp, torch.tensor([ids]), tc,
                                     mm=tmm))[0].numpy()]
    tkv.advance(tc, S)
    assert int(tc["rope_delta"]) == int(jc["rope_delta"]) < 0
    for tok in (7, 30, 2):
        h, jc = jm.backbone(jp, jnp.asarray([[tok]], jnp.int32), jc)
        want.append(np.asarray(jm.logits(jp, h))[0])
        jc = jkv.advance(jc, 1)
        got.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[tok]]),
                                             tc))[0].numpy())
        tkv.advance(tc, 1)
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL_DEEP
    text = [1, 40, 41, 42, 9]
    jc = jm.init_cache(1, 64, jnp.float32)
    h, jc = jm.backbone(jp, jnp.asarray([text], jnp.int32), jc)
    want = [np.asarray(jm.logits(jp, h))[0]]
    jc = jkv.advance(jc, len(text))
    h, jc = jm.backbone(jp, jnp.asarray([[12]], jnp.int32), jc)
    want.append(np.asarray(jm.logits(jp, h))[0])
    tkv.reset(tc)
    got = [tm.logits(tp, tm.backbone(tp, torch.tensor([text]),
                                     tc))[0].numpy()]
    assert int(tc["rope_delta"]) == 0
    tkv.advance(tc, len(text))
    got.append(tm.logits(tp, tm.backbone(tp, torch.tensor([[12]]),
                                         tc))[0].numpy())
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL_DEEP


def test_padded_bucket_invariance(models):
    """Patches padded to 64 rows (pad keys masked) give the exact-size
    features."""
    _, _, tm, tp = models
    grids = GRIDS["one"]
    ids = image_ids(tm.config, grids)
    mm = mm_to(build_mm(patches_for(tm.config, grids), grids, ids,
                        tm.config), "cpu")
    n = 16
    exact = {**{k: mm[k][:n] for k in ("patches", "vis_cos", "vis_sin",
                                        "pos_resample")},
             "patch_mask": None}
    padded = {k: mm[k][:64] for k in ("patches", "vis_cos", "vis_sin",
                                      "pos_resample")}
    padded["patch_mask"] = mm["patch_mask"][..., :64]
    f1 = tm.tower.encode(tp["visual"], exact)
    f2 = tm.tower.encode(tp["visual"], padded)[:n // 4]
    assert rel(f2.numpy(), f1.numpy()) <= TOL_OP


def test_init_random_covers_the_loader():
    """init_random draws every parameter load_params reads, in its
    shapes."""
    c = port_config(tiny_glm_config())
    tm = T.GlmOcrModel(c, max_rope_len=64)
    drawn = tm.init_random(torch.Generator().manual_seed(0))
    loaded = tm.load_params(hf_state_dict(1), dtype=torch.float32)

    def shapes(tree, pre=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes(v, f"{pre}{k}."))
            return out
        return {pre: tuple(tree.shape)}

    got, want = shapes(drawn), shapes(loaded)
    assert set(got) >= set(want)
    assert all(got[k] == want[k] for k in want)


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}{k}.")
    else:
        yield pre, tree


def test_params_from_jax_and_writer_match_load_params(models, tmp_path):
    """params_from_jax carries the JAX tree across to the port's
    load_params tree (the head vocab-major), and save_hf_glm_ocr writes
    what load_params reads back, config.json included."""
    import jax

    from aha_tpu_torch.io.convert import params_from_jax
    from aha_tpu_torch.io.weights import open_weights, save_hf_glm_ocr
    from tests.fixtures import build_tokenizer

    jm, jp, tm, tp = models
    carried = params_from_jax(jax.tree.map(np.asarray, jp))
    want = dict(_leaves(tp))
    got = dict(_leaves(carried))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    out = str(tmp_path / "glm")
    save_hf_glm_ocr(tp, tm.config, build_tokenizer(str(tmp_path)), out)
    assert T.GlmOcrConfig.from_file(out) == tm.config
    again = tm.load_params(open_weights(out), dtype=torch.float32)
    for k, v in _leaves(again):
        assert torch.equal(v, want[k]), k
