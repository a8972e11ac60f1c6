"""aha_tpu_torch's Qwen2.5-VL against aha_tpu's on the same parameters (made
in JAX from a seed, carried across with params_from_jax): the host
geometry (window permutation, segments, rotary coordinates, M-RoPE ids)
exactly, the vision tower and the backbone with an image, and greedy
streams through both TextEngines with an image, after a multimodal
prefix-cache hit and with text only.  float32 on the CPU: hidden states
within rtol 1e-4, atol 1e-5 (the vision tower's 2e-4: its two blocks' sums
run in other orders over 24-96 patches), token streams exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import qwen2_5vl as J
from aha_tpu.models.llama import LlamaConfig as JLlamaConfig
from aha_tpu.ops.rope import mrope_cos_sin as jmrope_cos_sin
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models.llama import LlamaConfig
from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLConfig, Qwen2_5VLModel,
                                            VisionConfig, get_rope_index,
                                            mm_to, vision_geometry)
from aha_tpu_torch.models.qwen2_5vl_served import build_mm

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_VISION = dict(rtol=2e-4, atol=2e-5)
IMG, VID, VSTART = 90, 91, 92
VISION = dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
              in_chans=3, out_hidden_size=48, patch_size=14,
              spatial_merge_size=2, temporal_patch_size=2, window_size=56,
              fullatt_block_indexes=(1,))
TEXT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=1e6, max_position_embeddings=512,
            tie_word_embeddings=True, qkv_bias=True)
TOKENS = dict(mrope_section=(2, 2, 2), image_token_id=IMG,
              video_token_id=VID, vision_start_token_id=VSTART)
JCFG = J.Qwen2_5VLConfig(vision=J.VisionConfig(**VISION),
                         text=JLlamaConfig(**TEXT), **TOKENS)
TCFG = Qwen2_5VLConfig(vision=VisionConfig(**VISION),
                       text=LlamaConfig(**TEXT), **TOKENS)
IN_DIM = 3 * 2 * 14 * 14


@pytest.fixture(scope="module")
def pair():
    jm = J.Qwen2_5VLModel(JCFG, max_rope_len=512)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(3),
                                                 scale=0.3))
    # random biases: the JAX init leaves them 0, where a dropped bias would
    # go unnoticed
    rng = np.random.default_rng(0)
    for blk in jp["visual"]["blocks"]:
        blk["qkv"]["b"] = rng.standard_normal(blk["qkv"]["b"].shape).astype(
            np.float32) * 0.1
    jp["text"]["layers"]["q"]["b"] = rng.standard_normal(
        jp["text"]["layers"]["q"]["b"].shape).astype(np.float32) * 0.1
    tm = Qwen2_5VLModel(TCFG, max_rope_len=512)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


def _prompt(grid, n_text=6):
    t, h, w = grid
    n_units = t * (h // 2) * (w // 2)
    text = [int(x) for x in np.random.default_rng(n_units).integers(
        1, 80, n_text)]
    return text[:2] + [VSTART] + [IMG] * n_units + text[2:]


def _patches(grid, seed=0):
    n = grid[0] * grid[1] * grid[2]
    return np.random.default_rng(seed).standard_normal(
        (n, IN_DIM)).astype(np.float32)


def _jmm(mm: dict) -> dict:
    return {k: (jnp.int32(v) if k == "rope_delta" else jnp.asarray(v))
            for k, v in mm.items()}


GRIDS = [[(1, 4, 6)], [(1, 8, 8)], [(1, 10, 14)], [(1, 6, 10), (1, 4, 4)],
         [(2, 4, 6)]]


@pytest.mark.parametrize("grids", GRIDS, ids=str)
def test_geometry_and_rope_index_equal_jax(grids):
    """Grids not divisible by the window (5 x 7 merge units over windows of
    2) and several images included."""
    want, got = (J.vision_geometry(grids, JCFG.vision),
                 vision_geometry(grids, TCFG.vision))
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ids = [1, 2]
    for t, h, w in grids:
        ids += [VSTART] + [IMG] * (t * (h // 2) * (w // 2)) + [3]
    ids += [4, 5]
    jpos, jdelta = J.get_rope_index(ids, grids, JCFG)
    pos, delta = get_rope_index(ids, grids, TCFG)
    np.testing.assert_array_equal(pos, jpos)
    assert delta == jdelta


def test_geometry_at_the_published_tower():
    """The 3B tower's windows (112 px) over a 980 x 980 image (70 x 70
    patches): every window ≤ 64 patches and the ids sorted."""
    v = VisionConfig()
    got = vision_geometry([(1, 70, 70)], v)
    want = J.vision_geometry([(1, 70, 70)], J.VisionConfig())
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    seg = got["window_seg"]
    assert len(seg) == 4900 and (np.diff(seg) >= 0).all()
    assert np.bincount(seg).max() == 64


def test_mrope_cos_sin_matches_jax(pair):
    jm, _, tm, _ = pair
    ids = _prompt((1, 4, 6))
    pos, _ = get_rope_index(ids, [(1, 4, 6)], TCFG)
    from aha_tpu_torch.ops.rope import mrope_cos_sin

    got = mrope_cos_sin(tm.text.cos, tm.text.sin, torch.from_numpy(pos),
                        tm.sections)
    want = jmrope_cos_sin(jm.text.cos, jm.text.sin, jnp.asarray(pos),
                          JCFG.mrope_section)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("grid,bucket", [((1, 4, 6), None), ((1, 8, 12), 256)])
def test_encode_vision_matches_jax(pair, grid, bucket):
    """Exact patch counts, and the served form padded to a patch bucket
    (pad rows of seg −1, which the segment route gives 0)."""
    jm, jp, tm, tp = pair
    patches = _patches(grid, seed=1)
    mm = build_mm([patches], [grid], _prompt(grid), TCFG)
    if bucket is None:
        geo = vision_geometry([grid], TCFG.vision)
        mm = {**mm, "patches": patches, **geo}
    else:
        assert mm["patches"].shape[0] == bucket
    want = np.asarray(jm.encode_vision(jp["visual"], _jmm(mm)))
    got = tm.encode_vision(tp["visual"], mm_to(mm, torch.device("cpu")))
    n_units = grid[0] * grid[1] * grid[2] // 4
    np.testing.assert_allclose(got.numpy()[:n_units], want[:n_units],
                               **TOL_VISION)


def test_padding_leaves_real_features_alone(pair):
    _, _, tm, tp = pair
    grid = (1, 8, 12)
    patches = _patches(grid, seed=2)
    mm = build_mm([patches], [grid], _prompt(grid), TCFG)
    exact = {**mm, "patches": patches, **vision_geometry([grid],
                                                         TCFG.vision)}
    cpu = torch.device("cpu")
    a = tm.encode_vision(tp["visual"], mm_to(exact, cpu))
    b = tm.encode_vision(tp["visual"], mm_to(mm, cpu))[:len(a)]
    np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def test_backbone_and_decode_with_image_match_jax(pair):
    jm, jp, tm, tp = pair
    grid = (1, 4, 6)
    ids = _prompt(grid)
    mm = build_mm([_patches(grid)], [grid], ids, TCFG)
    S = len(ids)
    mm["position_ids"] = mm["position_ids"][:, :S]   # unbucketed prompt
    jc = jm.init_cache(1, 64, jnp.float32)
    tc = tm.init_cache(1, 64, torch.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([ids]), jc, mm=_jmm(mm))
    th = tm.backbone(tp, torch.tensor([ids]), tc,
                     mm=mm_to(mm, torch.device("cpu")))
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


def _engines(pair, prefix=0):
    jm, jp, tm, tp = pair
    return (JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                    max_seq_len=256, prefix_cache_entries=prefix),
            TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256,
                       prefix_cache_entries=prefix))


@pytest.mark.parametrize("grid", [(1, 4, 6), (1, 8, 12)])
def test_greedy_streams_with_image_identical(pair, grid):
    je, te = _engines(pair)
    ids = _prompt(grid, n_text=8)
    mm = build_mm([_patches(grid, seed=5)], [grid], ids, TCFG)
    want = je.generate_tokens(ids, JSampling(), max_tokens=16, mm=_jmm(mm))
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=16,
                             mm=mm_to(mm, te.device))
    assert got == want
    assert len(set(want)) > 1


def test_prefix_cache_stream_matches_cold(pair):
    """A same-image prompt that extends a stored one restores its rows and
    rope_delta and prefills only the suffix: the stream equals a cold
    engine's, and aha_tpu's.  Another image, or none, never hits it."""
    grid = (1, 8, 8)
    base = _prompt(grid) + [(i * 7) % 80 + 1 for i in range(20)]
    ext = base + [11, 12, 13, 14]
    patches = _patches(grid, seed=4)
    kw = dict(mm_key="img-digest", mm_token_ids=(IMG, VID))
    _, cold = _engines(pair)
    jwarm, warm = _engines(pair, prefix=4)

    def mm(ids):
        return build_mm([patches], [grid], ids, TCFG)

    cpu = torch.device("cpu")
    first = warm.generate_tokens(base, SamplingConfig(), max_tokens=5,
                                 mm=mm_to(mm(base), cpu), **kw)
    assert first == jwarm.generate_tokens(base, JSampling(), max_tokens=5,
                                          mm=_jmm(mm(base)), **kw)
    assert len(warm._prefix_entries) == 1
    entry = next(iter(warm._prefix_entries._entries.values()))
    assert int(entry["rope_delta"]) == mm(base)["rope_delta"] < 0
    # nothing of another image's key or of a text prompt matches it
    assert warm._prefix_entries.match(ext, "other")[0] is None
    assert warm._prefix_entries.match(ext, None)[0] is None
    assert warm._prefix_entries.match(ext, "img-digest")[1] == len(base)
    got = warm.generate_tokens(ext, SamplingConfig(), max_tokens=5,
                               mm=mm_to(mm(ext), cpu), **kw)
    want = cold.generate_tokens(ext, SamplingConfig(), max_tokens=5,
                                mm=mm_to(mm(ext), cpu))
    assert got == want == jwarm.generate_tokens(
        ext, JSampling(), max_tokens=5, mm=_jmm(mm(ext)), **kw)


def test_prefix_refused_when_suffix_holds_image_tokens(pair):
    grid = (1, 4, 6)
    _, warm = _engines(pair, prefix=4)
    head = [(i * 5) % 80 + 1 for i in range(40)]
    ids = head + _prompt(grid)              # the image after a text prefix
    warm.generate_tokens(head, SamplingConfig(), max_tokens=3,
                         mm=mm_to(build_mm([_patches(grid)], [grid], head,
                                           TCFG), torch.device("cpu")),
                         mm_key="k", mm_token_ids=(IMG, VID))
    _, cold = _engines(pair)
    mm = build_mm([_patches(grid)], [grid], ids, TCFG)
    got = warm.generate_tokens(ids, SamplingConfig(), max_tokens=5,
                               mm=mm_to(mm, torch.device("cpu")),
                               mm_key="k", mm_token_ids=(IMG, VID))
    assert got == cold.generate_tokens(ids, SamplingConfig(), max_tokens=5,
                                       mm=mm_to(mm, torch.device("cpu")))


def test_text_only_request_through_vl_model(pair):
    """rope_delta of an earlier image request is reset to 0."""
    je, te = _engines(pair)
    grid = (1, 4, 6)
    ids = _prompt(grid)
    mm = build_mm([_patches(grid)], [grid], ids, TCFG)
    te.generate_tokens(ids, SamplingConfig(), max_tokens=4,
                       mm=mm_to(mm, te.device))
    je.generate_tokens(ids, JSampling(), max_tokens=4, mm=_jmm(mm))
    text = [int(x) for x in np.random.default_rng(9).integers(1, 80, 30)]
    assert te.generate_tokens(text, SamplingConfig(), max_tokens=12) == \
        je.generate_tokens(text, JSampling(), max_tokens=12)


def test_params_from_jax_round_trip(pair):
    _, jp, _, tp = pair
    assert isinstance(tp["visual"]["blocks"], list)
    assert len(tp["visual"]["blocks"]) == 2
    np.testing.assert_array_equal(
        tp["visual"]["blocks"][1]["qkv"]["b"].numpy(),
        np.asarray(jp["visual"]["blocks"][1]["qkv"]["b"]))
    np.testing.assert_array_equal(tp["visual"]["patch_embed"]["w"].numpy(),
                                  np.asarray(jp["visual"]["patch_embed"]["w"]))
    np.testing.assert_array_equal(tp["text"]["layers"]["q"]["b"].numpy(),
                                  np.asarray(jp["text"]["layers"]["q"]["b"]))
    # tied head: the embedding's own storage
    assert tp["text"]["lm_head"]["w"] is tp["text"]["embed"]["w"]


def test_checkpoint_save_load_round_trip(pair, tmp_path):
    """save_hf_qwen2_5vl writes what load_params reads back."""
    from aha_tpu_torch.io.weights import open_weights, save_hf_qwen2_5vl

    _, _, tm, tp = pair
    save_hf_qwen2_5vl(tp, str(tmp_path))
    back = tm.load_params(open_weights(str(tmp_path)), dtype=torch.float32)
    assert back["text"]["lm_head"]["w"] is back["text"]["embed"]["w"]

    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k])
        elif isinstance(t, list):
            for x in t:
                yield from leaves(x)
        else:
            yield t

    for a, b in zip(leaves(tp), leaves(back), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
