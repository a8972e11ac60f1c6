"""The port's HunyuanOCR (aha_tpu_torch/models/hunyuan_ocr.py) against
aha_tpu's at the JAX tests' tiny geometry (tests/test_glm_hunyuan_ocr.py
tiny_hunyuan_config / _hy_params), float32 on the CPU, both packages fed
the same numpy weights (the JAX tree through params_from_jax) and the same
numpy patches: the separable position resample against the reference's
dense (N, g²) matrix (one image, two, a grid past the table, two
frames), the tower's encode, perceive and its geometry (a padded unit
bucket too), the 4-channel position ids and xdrope's cos / sin (the tiny
config's 4 sections and the default (16, 24, 24), both cycling), the
prefill logits and 3 decode steps with an image and without, and
padded-patch invariance.

Tolerances are relative to max |ref|: 1e-5 for a module (the same
float32 arithmetic in another order), 1e-4 end to end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import cache as jkv
from aha_tpu.models import hunyuan_ocr as J
from aha_tpu_torch.core import cache as tkv
from aha_tpu_torch.io.convert import params_from_jax
from aha_tpu_torch.models import hunyuan_ocr as T
from aha_tpu_torch.models.hunyuan_ocr_served import build_mm
from aha_tpu_torch.models.qwen2_5vl import mm_to
from tests.test_glm_hunyuan_ocr import _hy_params, tiny_hunyuan_config

torch.set_num_threads(1)
TOL_OP = 1e-5
TOL_DEEP = 1e-4


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def port_config(jc) -> T.HunyuanOCRConfig:
    d = dataclasses.asdict(jc)
    return T.HunyuanOCRConfig(vision=T.HunyuanVisionConfig(**d.pop("vision")),
                              **d)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) on the same
    numbers."""
    jc = tiny_hunyuan_config()
    jm = J.HunyuanOCRModel(jc, max_rope_len=256)
    jp, _ = _hy_params(jm)
    tm = T.HunyuanOCRModel(port_config(jc), max_rope_len=256)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def patches_for(cfg, grids, seed=1) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    dim = 3 * cfg.vision.patch_size ** 2
    return [rng.standard_normal((t * gh * gw, dim)).astype(np.float32)
            for (t, gh, gw) in grids]


def image_ids(c, grids) -> list[int]:
    """Text ids around each image's ph·(pw + 1) + 2 image tokens."""
    ids = [3, 5]
    for (t, gh, gw) in grids:
        ids += [c.image_token_id] * (t * ((gh // 2) * (gw // 2 + 1) + 2))
        ids += [9]
    return ids


def both_mm(jm, tm, grids, ids=None, bucket=None):
    """The JAX mm (aha_tpu's dense resample matrix, its geometry) and the
    port's (build_mm: separable weights) over the same patches; `bucket`
    pads the JAX side's patches as the port's bucket does."""
    c = jm.config
    v = c.vision
    m = v.spatial_merge_size
    ids = ids or image_ids(c, grids)
    plist = patches_for(c, grids)
    tmm = build_mm(plist, grids, ids, tm.config)
    nb = bucket or tmm["patches"].shape[0]
    patches = np.concatenate(plist)
    n = len(patches)

    def pad(a):
        out = np.zeros((nb,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out

    pmask = np.zeros((1, 1, 1, nb), np.float32)
    pmask[..., n:] = np.finfo(np.float32).min
    n_units = sum((gh // m) * (gw // m) for _, gh, gw in grids)
    ug, tg = J.hunyuan_vision_geometry(grids, m, max(nb // (m * m), n_units))
    jmm = {"patches": jnp.asarray(pad(patches)),
           "pos_resample": jnp.asarray(pad(J.hunyuan_pos_resample_matrix(
               grids, v.max_image_size // v.patch_size))),
           "patch_mask": jnp.asarray(pmask),
           "unit_gather": jnp.asarray(ug), "token_gather": jnp.asarray(tg),
           "position_ids": jnp.asarray(tmm["position_ids"][:, :len(ids)])}
    return jmm, mm_to(tmm, torch.device("cpu"))


GRIDS = {"one": [(1, 4, 4)], "two": [(1, 4, 6), (1, 2, 2)],
         "past-the-table": [(1, 8, 10)], "two-frames": [(2, 4, 2)]}


@pytest.mark.parametrize("name", list(GRIDS))
def test_pos_resample_is_the_dense_product(name):
    """The separable form (two 1-D resizes of the (g, g, D) table) gives
    the rows of the reference's hunyuan_pos_resample_matrix @ table; the
    host weights' outer product is that matrix; pad rows are zero."""
    grids, g, D = GRIDS[name], 4, 24
    table = np.random.default_rng(3).standard_normal((g * g, D)).astype(
        np.float32)
    dense = J.hunyuan_pos_resample_matrix(grids, g)
    want = dense @ table
    weights = T.hunyuan_pos_weights(grids, g)
    outer = np.concatenate([np.tile(
        (wh[:, None, :, None] * ww[None, :, None, :]).reshape(
            wh.shape[0] * ww.shape[0], g * g), (t, 1))
        for (wh, ww), (t, _, _) in zip(weights, grids)])
    assert rel(outer, dense) <= TOL_OP
    got = T.hunyuan_pos_embed(
        torch.from_numpy(table),
        torch.from_numpy(np.concatenate([w[0] for w in weights])),
        torch.from_numpy(np.concatenate([w[1] for w in weights])),
        grids, len(want) + 5, g)
    assert rel(got[:len(want)].numpy(), want) <= TOL_OP
    assert not got[len(want):].any()


def test_tower_encode_matches_jax(models):
    jm, jp, tm, tp = models
    grids = GRIDS["two"]
    jmm, tmm = both_mm(jm, tm, grids)
    want = np.asarray(jm.tower.encode(jp["visual"], jmm))
    got = tm.tower.encode(tp["visual"], tmm).numpy()
    n = sum(gh * gw for _, gh, gw in grids)
    assert rel(got[:n], want[:n]) <= TOL_OP


@pytest.mark.parametrize("grids,bucket", [([(1, 4, 8)], None),
                                          ([(1, 4, 4), (1, 2, 6)], 256)],
                         ids=["exact", "padded-units"])
def test_perceive_and_geometry_match_jax(models, grids, bucket):
    """The unit and token gathers equal the JAX function's (a padded unit
    bucket too: newline / begin / end past it), and perceive's tokens."""
    jm, jp, tm, tp = models
    m = 2
    n_units = sum((gh // m) * (gw // m) for _, gh, gw in grids)
    ub = max((bucket or 0) // 4, n_units)
    for got, want in zip(T.hunyuan_vision_geometry(grids, m, ub),
                         J.hunyuan_vision_geometry(grids, m, ub)):
        np.testing.assert_array_equal(got, want)
    jmm, tmm = both_mm(jm, tm, grids, bucket=bucket)
    if bucket:
        assert tmm["patches"].shape[0] == bucket
        assert tmm["unit_gather"].shape[0] == bucket // 4
    want = np.asarray(jm.encode_vision(jp["visual"], jmm))
    got = tm.encode_vision(tp["visual"], tmm).numpy()
    assert got.shape == want.shape == (sum(
        (gh // m) * (gw // m + 1) + 2 for _, gh, gw in grids), 64)
    assert rel(got, want) <= TOL_DEEP


def test_position_ids_match_jax():
    grids = [(1, 4, 6), (1, 2, 2)]
    img = 250
    n1, n2 = 2 * (3 + 1) + 2, 1 * (1 + 1) + 2
    ids = [1, 2, img] + [img] * (n1 - 1) + [7, img] + [img] * (n2 - 1) + [9]
    got = T.hunyuan_position_ids(ids, grids, 2, img)
    want = J.hunyuan_position_ids(ids, grids, 2, img)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, len(ids))


@pytest.mark.parametrize("section", [(2, 2, 2, 2), (16, 24, 24)],
                         ids=["tiny-4", "default-3"])
def test_xd_cos_sin_matches_jax(section):
    """Both section layouts cycle channels: the tiny config's 4 over
    head_dim 16, the default 3 over head_dim 128 (the 4th channel, t,
    unused)."""
    hd = 2 * sum(section)
    jc = dataclasses.replace(tiny_hunyuan_config(), head_dim=hd,
                             xdrope_section=section)
    jm = J.HunyuanOCRModel(jc, max_rope_len=256)
    tm = T.HunyuanOCRModel(port_config(jc), max_rope_len=256)
    pos4 = np.random.default_rng(2).integers(0, 200, size=(4, 9))
    wc, ws = jm._xd_cos_sin(jnp.asarray(pos4))
    gc, gs = tm._xd_cos_sin(torch.from_numpy(pos4))
    assert rel(gc.numpy(), wc) <= TOL_OP and rel(gs.numpy(), ws) <= TOL_OP
    ch = T.xdrope_channels(hd, section)
    assert set(ch.tolist()) == set(range(len(section)))


def _steps(backbone, logits, advance, prefill_ids, steps, cache):
    """Prefill logits (every row) then one logit row per decode step."""
    out = []
    h, cache = backbone(prefill_ids, cache, True)
    out.append(logits(h)[0])
    cache = advance(cache, len(prefill_ids))
    for tok in steps:
        h, cache = backbone([tok], cache, False)
        out.append(logits(h)[0])
        cache = advance(cache, 1)
    return out


@pytest.mark.parametrize("with_image", [True, False],
                         ids=["image", "text"])
def test_prefill_and_decode_match_jax(models, with_image):
    jm, jp, tm, tp = models
    c = jm.config
    grids = [(1, 4, 4)]
    n_tok = 2 * (2 + 1) + 2
    ids = ([3, 5] + [c.image_token_id] * n_tok + [9, 11] if with_image
           else [3, 5, 9, 11, 13, 2, 7])
    jmm, tmm = both_mm(jm, tm, grids, ids) if with_image else (None, None)
    steps = [17, 4, 99]

    def jb(toks, cache, first):
        return jm.backbone(jp, jnp.asarray([toks], jnp.int32), cache,
                           mm=jmm if first else None,
                           prompt_len=jnp.int32(len(toks)))

    def tb(toks, cache, first):
        h = tm.backbone(tp, torch.tensor([toks]), cache,
                        mm=tmm if first else None)
        return h, cache

    want = _steps(jb, lambda h: np.asarray(jm.logits(jp, h)),
                  jkv.advance, ids, steps, jm.init_cache(1, 64, jnp.float32))
    got = _steps(tb, lambda h: tm.logits(tp, h).numpy(),
                 tkv.advance, ids, steps, tm.init_cache(1, 64, torch.float32))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL_DEEP


def test_padded_patch_invariance(models):
    """A 64-row patch bucket (pad rows masked out of every key) gives the
    exact-size tokens."""
    _, _, tm, tp = models
    grids = [(1, 4, 4)]
    ids = image_ids(tm.config, grids)
    plist = patches_for(tm.config, grids)
    exact = mm_to(build_mm(plist, grids, ids, tm.config), "cpu")
    padded = dict(exact)
    n, nb = 16, 64
    padded["patches"] = torch.nn.functional.pad(exact["patches"][:n],
                                                (0, 0, 0, nb - n))
    mask = torch.zeros((1, 1, 1, nb))
    mask[..., n:] = torch.finfo(torch.float32).min
    padded["patch_mask"] = mask
    ug, tg = T.hunyuan_vision_geometry(grids, 2, nb // 4)
    padded["unit_gather"] = torch.from_numpy(ug)
    padded["token_gather"] = torch.from_numpy(tg)
    f1 = tm.encode_vision(tp["visual"], {**exact, "patches":
                                         exact["patches"][:n],
                                         "patch_mask": None})
    f2 = tm.encode_vision(tp["visual"], padded)
    assert rel(f2.numpy(), f1.numpy()) <= TOL_OP


def test_default_geometry_and_init_random():
    """hunyuan_ocr_default is the JAX package's defaults; init_random
    draws every parameter the loader reads, the head tied."""
    j = dataclasses.asdict(J.HunyuanOCRConfig())
    t = dataclasses.asdict(T.hunyuan_ocr_default())
    assert j == t
    small = T.hunyuan_ocr_default(depth=1, layers=1)
    assert small.vision.num_hidden_layers == 1 \
        and small.num_hidden_layers == 1
    tiny = port_config(tiny_hunyuan_config())
    tm = T.HunyuanOCRModel(tiny, max_rope_len=64)
    p = tm.init_random(torch.Generator().manual_seed(0))
    assert p["lm_head"]["w"] is p["embed"]["w"]
    v = tiny.vision
    assert p["visual"]["pos_embed"].shape == (v.table_grid ** 2,
                                              v.hidden_size)
    assert p["visual"]["blocks"]["q"]["w"].shape == (
        v.num_hidden_layers, v.hidden_size, v.hidden_size)


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{pre}{i}.")
    else:
        yield pre, tree


def test_load_params_and_writer_match_params_from_jax(models, tmp_path):
    """The port's load_params over the checkpoint's names equals the JAX
    tree carried across by params_from_jax (CLS row dropped, head tied),
    and save_hf_hunyuan_ocr writes what load_params reads back."""
    from aha_tpu_torch.io.weights import open_weights, save_hf_hunyuan_ocr
    from tests.fixtures import build_tokenizer

    jm, jp, tm, tp = models
    _, sd = _hy_params(jm)
    loaded = tm.load_params({k: torch.from_numpy(v) for k, v in sd.items()},
                            dtype=torch.float32)
    want = dict(_leaves(tp))
    got = dict(_leaves(loaded))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert loaded["lm_head"]["w"] is loaded["embed"]["w"]
    out = str(tmp_path / "hy")
    save_hf_hunyuan_ocr(loaded, tm.config, build_tokenizer(str(tmp_path)),
                        out)
    again = tm.load_params(open_weights(out), dtype=torch.float32)
    assert T.HunyuanOCRConfig.from_file(out) == tm.config
    for k, v in _leaves(again):
        assert torch.equal(v, want[k]), k
