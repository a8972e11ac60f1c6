"""The Qwen3-VL tower on aha_tpu_torch's Qwen3.5 decoder against aha_tpu's
Qwen3_5Model(vl_config=...), on the same parameters (made in JAX from a
seed, carried across with params_from_jax): the interleaved M-RoPE map
over the partial rotary table (clipped where the sections pass it), the
"visual" subtree, the prefill's hidden states and rope_delta with an
image and with a video's per-frame grids, decode steps after it, and
greedy streams through both TextEngines.  float32 on the CPU: max error
within 1e-4 of max |ref|, as tests/test_torch_qwen3_5.py holds that
decoder; token streams exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import qwen3_5 as J35
from aha_tpu.models import qwen3vl as J
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import qwen3_5 as T35
from aha_tpu_torch.models import qwen3vl as T
from aha_tpu_torch.models.qwen2_5vl import mm_to
from aha_tpu_torch.models.qwen3vl_served import build_mm

torch.set_num_threads(1)
#: every comparison, relative to max |ref|
TOL_Q35_REL = 1e-4
IMG, VID, VSTART = 90, 91, 92
IN_DIM = 3 * 2 * 16 * 16
CPU = torch.device("cpu")

Q35_TEXT = dict(vocab_size=100, hidden_size=64, intermediate_size=96,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=2, head_dim=32, linear_num_value_heads=4,
                linear_num_key_heads=2, linear_key_head_dim=16,
                linear_value_head_dim=16, max_position_embeddings=512)
Q35_VISION = dict(depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
                  in_channels=3, out_hidden_size=64, patch_size=16,
                  spatial_merge_size=2, temporal_patch_size=2,
                  num_position_embeddings=16, deepstack_visual_indexes=(0, 1))
Q35_TOKENS = dict(mrope_section=(8, 4, 4), image_token_id=IMG,
                  video_token_id=VID, vision_start_token_id=VSTART)


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


def _leaves(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k])
    elif isinstance(t, list):
        for x in t:
            yield from _leaves(x)
    else:
        yield t


@pytest.mark.parametrize("head_dim,sections", [(128, (8, 4, 4)),
                                               (64, (8, 4, 4))])
def test_partial_map_equal_jax(head_dim, sections):
    """The map over the partial table against the JAX model's
    `_mrope_sel`: at head_dim 64 its 8 pairs clip the h / w ranges."""
    from aha_tpu_torch.ops.rope import mrope_interleaved_sections

    text = J35.Qwen3_5TextConfig(**{**Q35_TEXT, "head_dim": head_dim})
    vl = J35.Qwen3_5Config(text=text,
                           vision=J.Qwen3VLVisionConfig(**Q35_VISION),
                           **{**Q35_TOKENS, "mrope_section": sections})
    jm = J35.Qwen3_5Model(text, max_rope_len=16, vl_config=vl)
    got = mrope_interleaved_sections(jm._mrope_sel.shape[0], sections)
    np.testing.assert_array_equal(got, jm._mrope_sel)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


@pytest.fixture(scope="module")
def pair35():
    jcfg = J35.Qwen3_5Config(text=J35.Qwen3_5TextConfig(**Q35_TEXT),
                             vision=J.Qwen3VLVisionConfig(**Q35_VISION),
                             **Q35_TOKENS)
    tcfg = T35.Qwen3_5Config(text=T35.Qwen3_5TextConfig(**Q35_TEXT),
                             vision=T.Qwen3VLVisionConfig(**Q35_VISION),
                             **Q35_TOKENS)
    jm = J35.Qwen3_5Model(jcfg.text, max_rope_len=512, vl_config=jcfg)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(7),
                                                 scale=0.3))
    tm = T35.Qwen3_5Model(tcfg.text, max_rope_len=512, vl_config=tcfg)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp), tcfg


def test_qwen3_5_partial_map_and_tree(pair35):
    jm, jp, tm, tp, _ = pair35
    np.testing.assert_array_equal(tm.sections.numpy(), jm._mrope_sel)
    assert tm.sections.shape == (4,)        # rotary 32 · 0.25 → 4 pairs
    assert set(tp) == {"embed", "layers", "norm", "lm_head", "visual"}
    for a, b in zip(_leaves(tp["visual"]),
                    _leaves(jax.tree.map(np.asarray, jp["visual"])),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), b)


def test_images_on_a_decoder_without_tower_raise(pair35):
    """A multimodal prompt on a text-only Qwen3_5Model raises rather than
    running its placeholder ids as text."""
    _, _, _, tp, tcfg = pair35
    text = T35.Qwen3_5Model(tcfg.text, max_rope_len=512)
    grids = [(1, 4, 6)]
    ids = _prompt(grids)
    mm = build_mm([_patches(grids)], grids, ids, tcfg)
    with pytest.raises(ValueError, match="without a vision tower"):
        text.backbone({k: v for k, v in tp.items() if k != "visual"},
                      torch.tensor([ids]), text.init_cache(1, 64,
                                                           torch.float32),
                      mm=mm_to(mm, CPU))


@pytest.mark.parametrize("grids,tok", [([(1, 4, 6)], IMG),
                                       ([(1, 4, 4)] * 2, VID)],
                         ids=["image", "video"])
def test_qwen3_5_backbone_and_streams_match_jax(pair35, grids, tok):
    """The hybrid decoder with the tower: the prefill's hidden states and
    rope_delta, decode steps after it, and greedy streams."""
    jm, jp, tm, tp, tcfg = pair35
    ids = _prompt(grids, tok)
    S = len(ids)
    mm = build_mm([_patches(grids, seed=3)], grids, ids, tcfg)
    mm_s = {**mm, "position_ids": mm["position_ids"][:, :S]}
    jc = jm.init_cache(1, 64, jnp.float32)
    tc = tm.init_cache(1, 64, torch.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([ids]), jc, mm=_jmm(mm_s))
    th = tm.backbone(tp, torch.tensor([ids]), tc, mm=mm_to(mm_s, CPU))
    assert _rel(th, jh) <= TOL_Q35_REL
    assert int(tc["rope_delta"]) == int(jc["rope_delta"]) == mm["rope_delta"]
    jc = {**jc, "pos": jnp.int32(S)}
    tc["pos"].fill_(S)
    for t in (7, 8):
        jh, jc = jm.backbone(jp, jnp.asarray([[t]]), jc)
        th = tm.backbone(tp, torch.tensor([[t]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        kv.advance(tc, 1)
        assert _rel(tm.logits(tp, th), jm.logits(jp, jh)) <= TOL_Q35_REL
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                 max_seq_len=256)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256)
    want = je.generate_tokens(ids, JSampling(), max_tokens=12, mm=_jmm(mm))
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=12,
                             mm=mm_to(mm, te.device))
    assert got == want and len(set(want)) > 1
