"""aha_tpu_torch's LFM2-VL against aha_tpu's on the same parameters (made
in JAX from a seed, biases and LayerNorms randomized, carried across with
params_from_jax): resize_pos_embeddings against the reference's
jax.image.resize growing, shrinking (antialiased) and non-square; the
unshuffle gather; the tower, the projected features, and the backbone
with the features spliced into LFM2's input embeddings over the hybrid
cache, then decode steps; greedy streams through both TextEngines with
one image and a tiled batch; the exact-GELU departure measured against
transformers' Lfm2VlForConditionalGeneration (tanh GELU).  float32 on the
CPU: hidden states within 1e-4 of max |ref|, the position tables within
1e-6 of max |ref|, token streams exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu.core.sampling import SamplingConfig as JSampling
from aha_tpu.models import lfm2vl as J
from aha_tpu.models.lfm2 import Lfm2Config as JLfm2Config
from aha_tpu_torch.core import cache as kv
from aha_tpu_torch.core.engine import TextEngine
from aha_tpu_torch.core.sampling import SamplingConfig
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import lfm2vl as T
from aha_tpu_torch.models.lfm2 import Lfm2Config
from aha_tpu_torch.models.lfm2vl_served import build_mm
from aha_tpu_torch.models.qwen2_5vl import mm_to

torch.set_num_threads(1)
#: hidden states and features: max abs error over max |ref|
TOL = 1e-4
#: the host-resized position tables: max abs error over max |ref|
TOL_TABLE = 1e-6
IMG = 90
TEXT = dict(vocab_size=128, hidden_size=48, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, block_ff_dim=96,
            conv_L_cache=3, block_multiple_of=16,
            block_auto_adjust_ff_dim=False,
            layer_types=("conv", "full_attention", "conv", "full_attention"),
            max_position_embeddings=256, norm_eps=1e-5, rope_theta=1e6)
VISION = dict(hidden_size=32, intermediate_size=64, num_attention_heads=2,
              num_hidden_layers=2, num_patches=16, patch_size=4)
PROJ = dict(image_token_id=IMG, downsample_factor=2, projector_hidden_size=64)
JCFG = J.Lfm2VLConfig(text=JLfm2Config(**TEXT),
                      vision=J.Lfm2VLVisionConfig(**VISION), **PROJ)
TCFG = T.Lfm2VLConfig(text=Lfm2Config(**TEXT),
                      vision=T.Lfm2VLVisionConfig(**VISION), **PROJ)
IN_DIM = 3 * 4 * 4
CPU = torch.device("cpu")


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    jm = J.Lfm2VLModel(JCFG, max_rope_len=256)
    jp = jax.tree.map(np.asarray, jm.init_random(jax.random.PRNGKey(3),
                                                 scale=0.3))
    # random biases and LayerNorm shifts: the JAX init leaves them 0 / 1
    rng = np.random.default_rng(0)
    vis = jp["visual"]
    for lp in vis["layers"]:
        for name in ("q", "v", "fc1", "o"):
            lp[name]["b"] = rng.standard_normal(
                lp[name]["b"].shape).astype(np.float32) * 0.1
        lp["ln1"]["b"] = rng.standard_normal(
            lp["ln1"]["b"].shape).astype(np.float32) * 0.1
    vis["patch_embedding"]["b"] = rng.standard_normal(
        vis["patch_embedding"]["b"].shape).astype(np.float32) * 0.1
    jp["projector"]["ln"]["b"] = rng.standard_normal(
        jp["projector"]["ln"]["b"].shape).astype(np.float32) * 0.1
    tm = T.Lfm2VLModel(TCFG, max_rope_len=256)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(jp)


@pytest.mark.parametrize("side,h,w", [(4, 32, 32), (16, 8, 12), (16, 24, 40),
                                      (16, 8, 40), (16, 16, 12), (4, 4, 4)],
                         ids=["grow", "shrink", "non-square", "shrink-grow",
                              "one-axis", "same"])
def test_resize_pos_embeddings_equal_jax(side, h, w):
    """The host resize against the reference's jax.image.resize
    "bilinear" (antialiased when shrinking), padded with row 0."""
    table = np.random.default_rng(side + h + w).standard_normal(
        (side * side, 6)).astype(np.float32)
    max_len = h * w + 5
    want = J.resize_pos_embeddings(table, h, w, max_len)
    got = T.resize_pos_embeddings(table, h, w, max_len)
    assert got.shape == want.shape == (max_len, 6)
    assert _rel(got, want) <= TOL_TABLE
    np.testing.assert_array_equal(got[h * w:], np.repeat(got[:1], 5, 0))


@pytest.mark.parametrize("shapes,factor,bucket", [
    ([(4, 4)], 2, None), ([(8, 6), (4, 4)], 2, None), ([(6, 6)], 3, 8),
    ([(32, 32)] * 3 + [(38, 26)], 2, None)])
def test_unshuffle_gather_equal_jax(shapes, factor, bucket):
    n_padded = max(h * w for h, w in shapes)
    np.testing.assert_array_equal(
        T.unshuffle_gather(shapes, n_padded, factor, bucket),
        J.unshuffle_gather(shapes, n_padded, factor, bucket))


def _batch(shapes, seed=0):
    """Per-image patches (h·w, IN_DIM) at N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((h * w, IN_DIM)) * 0.5).astype(np.float32)
            for h, w in shapes]


def _mm(tp, shapes, seed=0):
    table = tp["visual"]["pos_table"].numpy()
    return build_mm(_batch(shapes, seed), shapes, table, TCFG)


def _jmm(mm):
    return {k: jnp.asarray(v) for k, v in mm.items()}


def _prompt(shapes, n_text=6):
    n_units = sum((h // 2) * (w // 2) for h, w in shapes)
    text = [int(x) for x in np.random.default_rng(n_units).integers(
        1, 80, n_text)]
    return text[:2] + [IMG] * n_units + text[2:]


@pytest.mark.parametrize("shapes", [[(4, 4)], [(8, 6)], [(8, 8), (6, 4)]],
                         ids=["one", "non-square", "tiles"])
def test_tower_and_features_match_jax(pair, shapes):
    """The tower's hidden states on the real patches of each packed row,
    and the projected features."""
    jm, jp, tm, tp = pair
    mm = _mm(tp, shapes, seed=1)
    jh = jm.tower.encode(jp["visual"], *(jnp.asarray(mm[k]) for k in
                                         ("pixels", "pixel_mask",
                                          "pos_embeds")))
    t = mm_to(mm, CPU)
    th = tm.tower.encode(tp["visual"], t["pixels"], t["pixel_mask"],
                         t["pos_embeds"])
    for i, (h, w) in enumerate(shapes):
        assert _rel(th[i, :h * w].numpy(), np.asarray(jh)[i, :h * w]) <= TOL
    assert _rel(tm.encode_vision(tp, t).numpy(),
                jm.encode_vision(jp, _jmm(mm))) <= TOL


def test_backbone_with_image_and_decode_match_jax(pair):
    """The features spliced into the input embeddings (inputs_embeds)
    through the hybrid decoder, a padded prefill with its true length,
    then decode steps: hidden states, K/V rows and the conv windows equal
    to aha_tpu's."""
    jm, jp, tm, tp = pair
    shapes = [(8, 6)]
    ids = _prompt(shapes)
    n = len(ids)
    padded = ids + [0] * (32 - n)
    mm = _mm(tp, shapes, seed=2)
    jc = jm.init_cache(1, 64, jnp.float32)
    tc = tm.init_cache(1, 64, torch.float32)
    jh, jc = jm.backbone(jp, jnp.asarray([padded]), jc, mm=_jmm(mm),
                         prompt_len=jnp.int32(n))
    th = tm.backbone(tp, torch.tensor([padded]), tc, mm=mm_to(mm, CPU),
                     prompt_len=n)
    assert _rel(th[0, :n].numpy(), np.asarray(jh)[0, :n]) <= TOL
    assert _rel(tc["conv"].numpy(), jc["conv"]) <= TOL
    for name in ("k", "v"):
        assert _rel(tc[name][:, :, :n].numpy(),
                    np.asarray(jc[name])[:, :, :n]) <= TOL
    jc = {**jc, "pos": jnp.int32(n)}
    tc["pos"].fill_(n)
    for tok in (7, 8, 9):
        jh, jc = jm.backbone(jp, jnp.asarray([[tok]]), jc)
        th = tm.backbone(tp, torch.tensor([[tok]]), tc)
        jc = {**jc, "pos": jc["pos"] + 1}
        kv.advance(tc, 1)
        assert _rel(tm.logits(tp, th).numpy(), jm.logits(jp, jh)) <= TOL


def test_image_changes_output_and_text_embeds_stay(pair):
    """Another image moves the last hidden state; a prompt without image
    tokens gives the plain decoder's states through inputs_embeds."""
    _, _, tm, tp = pair
    shapes = [(4, 4)]
    ids = torch.tensor([_prompt(shapes)])

    def run(mm):
        return tm.backbone(tp, ids, tm.init_cache(1, 32, torch.float32),
                           mm=mm_to(mm, CPU))[0, -1]

    assert not torch.allclose(run(_mm(tp, shapes, 3)), run(_mm(tp, shapes, 4)))
    text = torch.tensor([[5, 6, 7, 8]])
    a = tm.backbone(tp, text, tm.init_cache(1, 16, torch.float32),
                    mm=mm_to(_mm(tp, shapes, 3), CPU))
    b = tm.text.backbone(tp, text, tm.init_cache(1, 16, torch.float32))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("shapes", [[(4, 4)], [(8, 8)] * 2 + [(6, 8)]],
                         ids=["image", "tiles-and-thumbnail"])
def test_greedy_streams_identical(pair, shapes):
    jm, jp, tm, tp = pair
    je = JEngine(jm, jp, eos_token_ids=[], cache_dtype=jnp.float32,
                 max_seq_len=256)
    te = TextEngine(tm, tp, eos_token_ids=[], max_seq_len=256)
    ids = _prompt(shapes, n_text=8)
    mm = _mm(tp, shapes, seed=5)
    want = je.generate_tokens(ids, JSampling(), max_tokens=16, mm=_jmm(mm))
    got = te.generate_tokens(ids, SamplingConfig(), max_tokens=16,
                             mm=mm_to(mm, te.device))
    assert got == want
    assert len(set(want)) > 1
    text = [int(x) for x in np.random.default_rng(9).integers(1, 80, 20)]
    assert te.generate_tokens(text, SamplingConfig(), max_tokens=8) == \
        je.generate_tokens(text, JSampling(), max_tokens=8)


def _leaves(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k])
    elif isinstance(t, list):
        for x in t:
            yield from _leaves(x)
    else:
        yield t


def test_checkpoint_round_trip_and_jax_loader(pair, tmp_path):
    """save_hf_lfm2vl writes what load_params reads back (the position
    table float32 at any dtype), and what aha_tpu's load_params reads to
    the same tree."""
    from aha_tpu.io.weights import open_weights as jopen_weights
    from aha_tpu_torch.io.weights import open_weights, save_hf_lfm2vl

    jm, _, tm, tp = pair
    assert tp["lm_head"]["w"] is tp["embed"]["w"]
    save_hf_lfm2vl(tp, str(tmp_path))
    back = tm.load_params(open_weights(str(tmp_path)), dtype=torch.float32)
    assert back["lm_head"]["w"] is back["embed"]["w"]
    for a, b in zip(_leaves(tp), _leaves(back), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jback = params_from_jax(jax.tree.map(np.asarray, jm.load_params(
        jopen_weights(str(tmp_path)), dtype=jnp.float32)))
    for a, b in zip(_leaves(tp), _leaves(jback), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    half = tm.load_params(open_weights(str(tmp_path)), dtype=torch.bfloat16)
    assert half["visual"]["pos_table"].dtype == torch.float32
    assert params_from_jax(jax.tree.map(np.asarray, jm.init_random(
        jax.random.PRNGKey(0))), dtype=torch.bfloat16)["visual"][
            "pos_table"].dtype == torch.float32


def test_lfm2vl_1_6b_geometry():
    c = T.lfm2vl_1_6b()
    v = c.vision
    assert (v.num_hidden_layers, v.hidden_size, v.intermediate_size,
            v.num_attention_heads, v.head_dim, v.patch_size,
            v.num_patches) == (26, 1152, 4304, 16, 72, 16, 256)
    assert (c.projector_hidden_size, c.downsample_factor,
            c.image_token_id) == (2560, 2, 396)
    t = c.text
    assert (t.num_hidden_layers, t.hidden_size, t.vocab_size,
            t.intermediate_size) == (16, 2048, 65536, 8192)
    cut = T.lfm2vl_1_6b(depth=4, layers=4)
    assert cut.vision.num_hidden_layers == cut.text.num_hidden_layers == 4


def test_exact_gelu_departure_against_transformers(monkeypatch):
    """The JAX package's tower takes the exact GELU where transformers'
    SigLIP2 (hidden_act gelu_pytorch_tanh) takes the tanh one.  On an HF
    model's weights the port with its exact GELU parts from HF's logits by
    more than 1e-4 of max |ref|; the same port with the tanh GELU swapped
    into the tower agrees within 1e-4: the departure is the GELU and only
    the GELU."""
    pytest.importorskip("transformers")
    from transformers import Lfm2VlConfig
    from transformers.models.lfm2_vl import Lfm2VlForConditionalGeneration

    hf_cfg = Lfm2VlConfig(
        text_config={**TEXT, "layer_types": list(TEXT["layer_types"])},
        vision_config={**VISION, "hidden_act": "gelu_pytorch_tanh",
                       "attention_dropout": 0.0},
        projector_bias=True, projector_use_layernorm=True, **PROJ)
    torch.manual_seed(0)
    hf = Lfm2VlForConditionalGeneration(hf_cfg).eval()
    tm = T.Lfm2VLModel(TCFG, max_rope_len=128)
    tp = tm.load_params({k: v.detach() for k, v in hf.state_dict().items()},
                        dtype=torch.float32)
    shapes = [(4, 4)]
    pixels = _batch(shapes, seed=6)[0][None]
    ids = [1, 2] + [IMG] * 4 + [3, 4, 5]
    mm = build_mm([pixels[0]], shapes, tp["visual"]["pos_table"].numpy(),
                  TCFG)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor([ids]),
                 pixel_values=torch.from_numpy(pixels),
                 pixel_attention_mask=torch.ones((1, 16), dtype=torch.bool),
                 spatial_shapes=torch.tensor(shapes)).logits[0].numpy()

    def logits():
        h = tm.backbone(tp, torch.tensor([ids]),
                        tm.init_cache(1, 16, torch.float32),
                        mm=mm_to(mm, CPU))
        return tm.logits(tp, h)[0].detach().numpy()

    exact = _rel(logits(), ref)
    real = torch.nn.functional.gelu
    monkeypatch.setattr(T.F, "gelu", lambda x, approximate="none": real(
        x, approximate="tanh"))
    # the projector's GELU is exact in both: only the tower's may change
    monkeypatch.setattr(T.Lfm2VLModel, "encode_vision", _projector_exact(
        T.Lfm2VLModel.encode_vision, real))
    tanh = _rel(logits(), ref)
    assert tanh <= TOL < exact, (tanh, exact)


def _projector_exact(encode, real):
    """encode_vision with the tower under the patched GELU and the
    projector's GELU exact again (HF's projector takes the exact one)."""
    def wrapped(self, params, mm):
        hidden = self.tower.encode(params["visual"], mm["pixels"],
                                   mm["pixel_mask"], mm["pos_embeds"])
        flat = hidden.reshape(-1, hidden.shape[-1])
        x = flat[mm["gather"].long()].reshape(mm["gather"].shape[0], -1)
        p = params["projector"]
        x = T.layer_norm(x, p["ln"]["w"], p["ln"]["b"],
                         self.config.vision.layer_norm_eps)
        return T.nn.linear(p["l2"], real(T.nn.linear(p["l1"], x)))
    return wrapped
