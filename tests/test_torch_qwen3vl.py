"""aha_tpu_torch's Qwen3-VL against
aha_tpu's on the same parameters (made in JAX from a seed, carried across
with params_from_jax): the host geometry (merge-unit order, frame
segments, 4-tap position indices) and M-RoPE ids exactly, for image grids
and a video's per-frame grids; the interleaved channel map; the tower's
main and deepstack features; the backbone with an image and the decode
steps after it; greedy streams through both TextEngines with an image, a
video, after a multimodal prefix-store hit and with text only.  float32
on the CPU: hidden states within rtol 1e-4, atol 1e-5 (the tower's
features 2e-4 / 2e-5: its sums run in other orders), token streams
exactly.  Swapping the blocks' tanh GELU for the exact one (the trap the
HF parity test of the JAX package cannot see) breaks the tower's bound.
The tower on the Qwen3.5 decoder: tests/test_torch_qwen3_5_vl.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import qwen3vl as J
from aha_tpu.models.qwen3 import Qwen3Config as JQwen3Config
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import qwen3vl as T
from aha_tpu_torch.models.qwen2_5vl import mm_to
from aha_tpu_torch.models.qwen3 import Qwen3Config
from aha_tpu_torch.models.qwen3vl_served import build_mm

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_VISION = dict(rtol=2e-4, atol=2e-5)
IMG, VID, VSTART = 90, 91, 92
VISION = dict(depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
              in_channels=3, out_hidden_size=48, patch_size=16,
              spatial_merge_size=2, temporal_patch_size=2,
              num_position_embeddings=16, deepstack_visual_indexes=(0, 1))
TEXT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            head_dim=12, rope_theta=1e6, max_position_embeddings=512,
            tie_word_embeddings=True)
TOKENS = dict(mrope_section=(2, 2, 2), image_token_id=IMG,
              video_token_id=VID, vision_start_token_id=VSTART)
JCFG = J.Qwen3VLConfig(vision=J.Qwen3VLVisionConfig(**VISION),
                       text=JQwen3Config(**TEXT), **TOKENS)
TCFG = T.Qwen3VLConfig(vision=T.Qwen3VLVisionConfig(**VISION),
                       text=Qwen3Config(**TEXT), **TOKENS)
IN_DIM = 3 * 2 * 16 * 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    jm = J.Qwen3VLModel(JCFG, max_rope_len=512)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(3),
                                                 scale=0.3))
    # random biases and norm shifts: the JAX init leaves them 0 / 1, where
    # a dropped one would go unnoticed
    rng = np.random.default_rng(0)
    vis = jp["visual"]
    for blk in vis["blocks"]:
        for name in ("qkv", "fc1"):
            blk[name]["b"] = rng.standard_normal(
                blk[name]["b"].shape).astype(np.float32) * 0.1
        blk["norm1"]["b"] = rng.standard_normal(
            blk["norm1"]["b"].shape).astype(np.float32) * 0.1
    vis["patch_embed"]["b"] = rng.standard_normal(
        vis["patch_embed"]["b"].shape).astype(np.float32) * 0.1
    for mp in [vis["merger"]] + vis["ds_mergers"]:
        mp["norm"]["b"] = rng.standard_normal(
            mp["norm"]["b"].shape).astype(np.float32) * 0.1
        mp["fc2"]["b"] = rng.standard_normal(
            mp["fc2"]["b"].shape).astype(np.float32) * 0.1
    tm = T.Qwen3VLModel(TCFG, max_rope_len=512)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


def _prompt(grids, tok=IMG, n_text=6):
    n_units = sum(t * (h // 2) * (w // 2) for t, h, w in grids)
    text = [int(x) for x in np.random.default_rng(n_units).integers(
        1, 80, n_text)]
    return text[:2] + [VSTART] + [tok] * n_units + text[2:]


def _patches(grids, seed=0):
    n = sum(t * h * w for t, h, w in grids)
    return np.random.default_rng(seed).standard_normal(
        (n, IN_DIM)).astype(np.float32)


def _jmm(mm: dict) -> dict:
    return {k: (jnp.int32(v) if k == "rope_delta" else jnp.asarray(v))
            for k, v in mm.items()}


def _exact_mm(grids, ids, patches) -> dict:
    """The unpadded inputs, as the JAX tests build them."""
    pos, delta = T.get_rope_index_qwen3vl(ids, grids, TCFG)
    return {"patches": patches,
            **T.vision_geometry_qwen3vl(grids, TCFG.vision),
            "position_ids": pos, "rope_delta": delta}


GRIDS = [[(1, 4, 6)], [(1, 8, 8)], [(1, 10, 14)], [(1, 6, 10), (1, 4, 4)],
         [(1, 4, 6)] * 3, [(1, 62, 62)]]


@pytest.mark.parametrize("grids", GRIDS, ids=str)
@pytest.mark.parametrize("tok", [IMG, VID])
def test_geometry_and_rope_index_equal_jax(grids, tok):
    """Image grids, several images, a video as its per-frame (1, h, w)
    grids, and a grid wider than the 4 x 4 learned table's side."""
    want, got = (J.vision_geometry_qwen3vl(grids, JCFG.vision),
                 T.vision_geometry_qwen3vl(grids, TCFG.vision))
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ids = [1, 2]
    for t, h, w in grids:
        ids += [VSTART] + [tok] * (t * (h // 2) * (w // 2)) + [3]
    ids += [4, 5]
    jpos, jdelta = J.get_rope_index_qwen3vl(ids, grids, JCFG)
    pos, delta = T.get_rope_index_qwen3vl(ids, grids, TCFG)
    np.testing.assert_array_equal(pos, jpos)
    assert delta == jdelta


def test_video_frames_take_one_t_each():
    """A video's frames as per-frame grids: t advances one a frame, and the
    frame segments count up in merge-unit order."""
    grids = [(1, 4, 4)] * 3
    ids = [1, VSTART] + [VID] * 4 + [2, VSTART] + [VID] * 4 + [3, VSTART] \
        + [VID] * 4 + [4]
    pos, _ = T.get_rope_index_qwen3vl(ids, grids, TCFG)
    starts = [pos[0, i] for i, t in enumerate(ids) if t == VID][::4]
    assert list(np.diff(starts)) == [4, 4]      # 2 h/w rows + 2 text tokens
    seg = T.vision_geometry_qwen3vl(grids, TCFG.vision)["seg"]
    np.testing.assert_array_equal(seg, np.repeat(np.arange(3), 16))


@pytest.mark.parametrize("head_dim,sections", [(128, (24, 20, 20)),
                                               (12, (2, 2, 2))])
def test_interleaved_map_equal_jax(head_dim, sections):
    """The channel → axis map against the JAX model's `_mrope_sel` over the
    full table (Qwen3.5's partial one: tests/test_torch_qwen3_5_vl.py)."""
    from aha_tpu_torch.ops.rope import mrope_interleaved_sections

    jm = J.Qwen3VLModel(J.Qwen3VLConfig(
        vision=J.Qwen3VLVisionConfig(**VISION),
        text=JQwen3Config(**{**TEXT, "head_dim": head_dim}),
        **{**TOKENS, "mrope_section": sections}), max_rope_len=16)
    got = mrope_interleaved_sections(jm._mrope_sel.shape[0], sections)
    np.testing.assert_array_equal(got, jm._mrope_sel)


def test_model_maps_equal_jax(pair):
    jm, _, tm, _ = pair
    np.testing.assert_array_equal(tm.sections.numpy(), jm._mrope_sel)
    ids = _prompt([(1, 4, 6)])
    pos, _ = T.get_rope_index_qwen3vl(ids, [(1, 4, 6)], TCFG)
    from aha_tpu_torch.ops.rope import mrope_cos_sin

    got = mrope_cos_sin(tm.text.cos, tm.text.sin, torch.from_numpy(pos),
                        tm.sections)
    want = jm._mrope_cos_sin(jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("grids,padded", [
    ([(1, 4, 6)], False), ([(1, 8, 12)], True), ([(1, 4, 6)] * 2, True)])
def test_encode_matches_jax(pair, grids, padded):
    """The main features and every deepstack level: exact patch counts,
    and the served form padded to a patch bucket (pad rows of seg −1)."""
    jm, jp, tm, tp = pair
    patches = _patches(grids, seed=1)
    ids = _prompt(grids)
    mm = (build_mm([patches], grids, ids, TCFG) if padded
          else _exact_mm(grids, ids, patches))
    jmain, jds = jm.encode_vision(jp["visual"], _jmm(mm))
    main, ds = tm.encode_vision(tp["visual"], mm_to(mm, CPU))
    n_units = sum(t * h * w for t, h, w in grids) // 4
    assert ds.shape == (2, main.shape[0], 48)
    np.testing.assert_allclose(main.numpy()[:n_units],
                               np.asarray(jmain)[:n_units], **TOL_VISION)
    np.testing.assert_allclose(ds.numpy()[:, :n_units],
                               np.asarray(jds)[:, :n_units], **TOL_VISION)


def test_swapped_gelu_breaks_parity(pair, monkeypatch):
    """The blocks use the tanh GELU and the mergers the exact one; swapping
    the two forms moves the features past the tower's bound."""
    jm, jp, tm, tp = pair
    grids = [(1, 8, 12)]
    mm = _exact_mm(grids, _prompt(grids), _patches(grids, seed=6))
    jmain, jds = jm.encode_vision(jp["visual"], _jmm(mm))
    real = torch.nn.functional.gelu

    def swapped(x, approximate="none"):
        return real(x, approximate="none" if approximate == "tanh"
                    else "tanh")

    monkeypatch.setattr(T.F, "gelu", swapped)
    main, ds = tm.encode_vision(tp["visual"], mm_to(mm, CPU))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(main.numpy(), np.asarray(jmain),
                                   **TOL_VISION)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ds.numpy(), np.asarray(jds), **TOL_VISION)


def test_backbone_and_decode_with_image_match_jax(pair):
    jm, jp, tm, tp = pair
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    S = len(ids)
    mm = _exact_mm(grids, ids, _patches(grids))
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


def test_deepstack_changes_output(pair):
    """Zeroing the deepstack mergers' output moves the hidden states: the
    injection is live."""
    _, _, tm, tp = pair
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    mm = mm_to(_exact_mm(grids, ids, _patches(grids, seed=2)), CPU)
    h1 = tm.backbone(tp, torch.tensor([ids]), tm.init_cache(1, 64,
                                                            torch.float32),
                     mm=mm)
    vis = dict(tp["visual"])
    vis["ds_mergers"] = [{**mp, "fc2": {k: torch.zeros_like(t)
                                       for k, t in mp["fc2"].items()}}
                         for mp in vis["ds_mergers"]]
    h2 = tm.backbone({**tp, "visual": vis}, torch.tensor([ids]),
                     tm.init_cache(1, 64, torch.float32), mm=mm)
    assert not torch.allclose(h1, h2)


def _engines(pair, prefix=0):
    jm, jp, tm, tp = pair
    return (JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                    max_seq_len=256, prefix_cache_entries=prefix),
            TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256,
                       prefix_cache_entries=prefix))


@pytest.mark.parametrize("grids,tok", [([(1, 4, 6)], IMG),
                                       ([(1, 8, 12)], IMG),
                                       ([(1, 4, 8)] * 4, VID)],
                         ids=["image", "image-bucketed", "video"])
def test_greedy_streams_identical(pair, grids, tok):
    je, te = _engines(pair)
    ids = _prompt(grids, tok, n_text=8)
    mm = build_mm([_patches(grids, seed=5)], grids, ids, TCFG)
    want = je.generate_tokens(ids, JSampling(), max_tokens=16, mm=_jmm(mm))
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=16,
                             mm=mm_to(mm, te.device))
    assert got == want
    assert len(set(want)) > 1


def test_prefix_store_stream_matches_cold(pair):
    """A same-image prompt that extends a stored one restores its rows and
    rope_delta and prefills only the suffix: the stream equals a cold
    engine's and aha_tpu's; another image's key, or none, never hits."""
    grids = [(1, 8, 8)]
    base = _prompt(grids) + [(i * 7) % 80 + 1 for i in range(20)]
    ext = base + [11, 12, 13, 14]
    patches = _patches(grids, seed=4)
    kw = dict(mm_key="img-digest", mm_token_ids=(IMG, VID))
    _, cold = _engines(pair)
    jwarm, warm = _engines(pair, prefix=4)

    def mm(ids):
        return build_mm([patches], grids, ids, TCFG)

    first = warm.generate_tokens(base, SamplingConfig(), max_tokens=5,
                                 mm=mm_to(mm(base), CPU), **kw)
    assert first == jwarm.generate_tokens(base, JSampling(), max_tokens=5,
                                          mm=_jmm(mm(base)), **kw)
    entry = next(iter(warm._prefix_entries._entries.values()))
    assert int(entry["rope_delta"]) == mm(base)["rope_delta"] < 0
    assert warm._prefix_entries.match(ext, "other")[0] is None
    assert warm._prefix_entries.match(ext, None)[0] is None
    got = warm.generate_tokens(ext, SamplingConfig(), max_tokens=5,
                               mm=mm_to(mm(ext), CPU), **kw)
    want = cold.generate_tokens(ext, SamplingConfig(), max_tokens=5,
                                mm=mm_to(mm(ext), CPU))
    assert got == want == jwarm.generate_tokens(
        ext, JSampling(), max_tokens=5, mm=_jmm(mm(ext)), **kw)


def test_text_only_request_through_vl_model(pair):
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
    assert isinstance(tp["visual"]["blocks"], list)
    assert len(tp["visual"]["ds_mergers"]) == 2
    for got, want in zip(_leaves(tp["visual"]),
                         _leaves(jax.tree.map(np.asarray, jp["visual"])),
                         strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    assert tp["text"]["lm_head"]["w"] is tp["text"]["embed"]["w"]


def test_checkpoint_round_trip_and_jax_loader(pair, tmp_path):
    """save_hf_qwen3vl writes what load_params reads back, and what
    aha_tpu's load_params reads to the same tree."""
    from aha_tpu.io.weights import open_weights as jopen_weights
    from aha_tpu_torch.io.weights import open_weights, save_hf_qwen3vl

    jm, _, tm, tp = pair
    save_hf_qwen3vl(tp, str(tmp_path))
    back = tm.load_params(open_weights(str(tmp_path)), dtype=torch.float32)
    assert back["text"]["lm_head"]["w"] is back["text"]["embed"]["w"]
    for a, b in zip(_leaves(tp), _leaves(back), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jback = params_from_jax(jax.tree.map(np.asarray, jm.load_params(
        jopen_weights(str(tmp_path)), dtype=jnp.float32)))
    for a, b in zip(_leaves(tp), _leaves(jback), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_qwen3vl_8b_geometry():
    c = T.qwen3vl_8b()
    assert (c.vision.head_dim, c.vision.depth, c.vision.out_hidden_size,
            c.vision.deepstack_visual_indexes) == (72, 27, 4096, (8, 16, 24))
    assert (c.text.hidden_size, c.text.num_hidden_layers,
            c.text.num_attention_heads, c.text.num_key_value_heads,
            c.text.tie_word_embeddings) == (4096, 36, 32, 8, False)
    cut = T.qwen3vl_8b(depth=4, layers=4, deepstack=(1, 2, 3))
    assert cut.vision.depth == cut.text.num_hidden_layers == 4
