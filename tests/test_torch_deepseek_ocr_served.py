"""The port's served DeepSeek-OCR on the tiny repo of tests/fixtures.py
(build_tiny_deepseek_ocr_repo: SAM + CLIP + a 3-layer MoE decoder with the
test tokenizer and its <image> token), loaded through both packages'
load_model, float32 on the CPU: greedy replies and prompt-token counts
equal aha_tpu's for a text-only prompt, the default 640 view, crop_mode
on a wide image (a 2 x 1 grid of 640 tiles) and a disallowed image_size
(back to 640); the request's inputs equal aha_tpu's for every layout
(ids, views, the real crops — aha_tpu pads the crop batch to a bucket,
the port does not — and the gather index, remapped past aha_tpu's pad
rows), with the image-token count equal to the gather length; version
2's pinned 1024 / 768 sizes and 768 tiles on a version-2 config; the
loader builds one stream without a prefix store, eos then bos as stop
ids, and refuses slots with the reference's words; the checkpoint
writer's names are the ones both loaders read.  (`run` of the id:
tests/test_torch_cli.py.)"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from aha_tpu.models.deepseek_ocr_served import \
    DeepseekOCRChat as JDeepseekOCRChat
from aha_tpu.models.loader import load_model as jload_model
from aha_tpu.params import ChatCompletionParameters as JParameters
from aha_tpu_torch.models.deepseek_ocr_served import DeepseekOCRChat
from aha_tpu_torch.models.loader import load_model
from aha_tpu_torch.params import ChatCompletionParameters
from tests.fixtures import build_tiny_deepseek_ocr_repo
from tests.vision_chat import png_data_url

torch.set_num_threads(1)
MODEL = "deepseek-ai/DeepSeek-OCR"


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port's loaders run on the card unless the CPU is asked for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AHA_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dsocr-tiny"))
    build_tiny_deepseek_ocr_repo(path)
    return path


@pytest.fixture(scope="module")
def both(repo):
    return (load_model(MODEL, repo, max_seq_len=4096),
            jload_model(MODEL, repo, max_seq_len=4096))


def body(content, max_tokens=6, **metadata):
    b = {"messages": [{"role": "user", "content": content}], "model": MODEL,
         "max_tokens": max_tokens, "temperature": 0.0}
    if metadata:
        b["metadata"] = metadata
    return b


def image(w, h, seed=0, text="<image>\nFree OCR."):
    return [{"type": "image_url", "image_url": {"url": png_data_url(w, h,
                                                                    seed)}},
            {"type": "text", "text": text}]


#: request → its layout: (content, metadata)
REQUESTS = {
    "text": ("hello world how are you", {}),
    "view-640": (image(120, 80), {}),
    "crop-wide": (image(1400, 700, seed=1), {"crop_mode": "true"}),
    "bad-size": (image(120, 80), {"image_size": "700", "base_size": "99"}),
}
LAYOUTS = {
    **{k: v for k, v in REQUESTS.items() if k != "text"},
    "crop-small": (image(500, 300, seed=2), {"crop_mode": "true"}),
    "crop-tall-base-1024": (image(700, 2100, seed=3),
                            {"crop_mode": "true", "base_size": "1024"}),
    "view-1024-padded": (image(300, 120, seed=4), {"image_size": "1024"}),
    "two-images": ([*image(90, 60, seed=5, text="<image> a"),
                    *image(60, 90, seed=6, text=" <image> b")], {}),
}


def test_loads_one_stream_without_a_prefix_store(both, repo):
    port, jax_model = both
    assert isinstance(port, DeepseekOCRChat)
    eng = port.engine
    assert eng.prefix_cache_entries == 0 and eng.cache_dtype == torch.float32
    lc = port.ocr_model.config.language
    assert eng.eos_token_ids == {lc.eos_token_id, lc.bos_token_id} == \
        set(jax_model.engine.eos_token_ids)
    assert port.ocr_model.config.version == 1
    with pytest.raises(ValueError) as got:
        load_model(MODEL, repo, batch_slots=2)
    with pytest.raises(ValueError) as want:
        jload_model(MODEL, repo, batch_slots=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", list(REQUESTS))
def test_reply_matches_jax(both, name):
    port, jax_model = both
    content, md = REQUESTS[name]
    b = body(content, **md)
    got = port.generate(ChatCompletionParameters.model_validate(b))
    want = jax_model.generate(JParameters.model_validate(b))
    assert got.usage.prompt_tokens == want.usage.prompt_tokens
    assert got.choices[0].message.content == want.choices[0].message.content


def gather_without_pads(jmm: dict, n: int, n_crops: int, q2: int):
    """aha_tpu's gather index over its padded rows → the index over the
    real crops' rows: rows past the real crops shift down by the pad
    crops' rows."""
    g = np.asarray(jmm["gather_idx"])[:n].astype(np.int64)
    if "crops" not in jmm:
        return g
    pad_rows = (jmm["crops"].shape[0] - n_crops) * q2
    return np.where(g < n_crops * q2, g, g - pad_rows)


def check_inputs_equal(port, jax_model, b, n_views: int):
    got = port.get_data(ChatCompletionParameters.model_validate(b))
    want = jax_model.get_data(JParameters.model_validate(b))
    assert got.input_ids == list(want.input_ids)
    n_img = got.input_ids.count(port.ocr_model.config.image_token_id)
    gather = got.mm["gather_idx"].numpy()
    assert len(gather) == n_img > 0
    np.testing.assert_array_equal(got.mm["global"].numpy(),
                                  np.asarray(want.mm["global"]))
    assert got.mm["global"].shape[0] == n_views
    n_crops = got.mm["crops"].shape[0] if "crops" in got.mm else 0
    q2 = 0
    if n_crops:
        wc = np.asarray(want.mm["crops"])
        np.testing.assert_array_equal(got.mm["crops"].numpy(), wc[:n_crops])
        assert not wc[n_crops:].any()
        q2 = (got.mm["crops"].shape[-1] // 64) ** 2
    np.testing.assert_array_equal(
        gather, gather_without_pads(want.mm, n_img, n_crops, q2))
    return got, n_crops


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_request_inputs_equal_jax(both, name):
    port, jax_model = both
    content, md = LAYOUTS[name]
    got, n_crops = check_inputs_equal(port, jax_model, body(content, **md),
                                      2 if name == "two-images" else 1)
    if name == "crop-wide":
        # 1400 x 700 at 640: a 2 x 1 grid; base 640 (10 queries a side)
        assert n_crops == 2
        assert len(got.mm["gather_idx"]) == 10 * 10 + 10 + 1 + \
            (10 * 2 + 1) * 10
    if name == "bad-size":
        default = port.get_data(ChatCompletionParameters.model_validate(
            body(*REQUESTS["view-640"][:1])))
        assert got.input_ids == default.input_ids
        assert torch.equal(got.mm["global"], default.mm["global"])


def test_a4_page_token_count(both):
    """(aa2)'s page: 1654 x 2339 in crop mode at base 1024 is 2 x 3 tiles
    of 640 and 16² + 16 + 1 + (2·10 + 1)·(3·10) = 903 image tokens."""
    port, jax_model = both
    b = body(image(1654, 2339, seed=7), crop_mode="true", base_size="1024")
    got, n_crops = check_inputs_equal(port, jax_model, b, 1)
    assert n_crops == 6 and len(got.mm["gather_idx"]) == 903
    assert got.mm["global"].shape == (1, 3, 1024, 1024)


@pytest.mark.parametrize("md,crops", [({}, 0), ({"crop_mode": "true"}, 2),
                                      ({"image_size": "512",
                                        "base_size": "640"}, 0)],
                         ids=["pinned", "crop-768", "sizes-ignored"])
def test_version_2_pins_its_sizes(both, md, crops):
    """A version-2 config: base 1024 / image 768 whatever the metadata,
    768-px tiles at most 6, no newline rows; inputs equal aha_tpu's."""
    port, jax_model = both

    def as_v2(served, cls):
        s = cls.__new__(cls)
        cfg = dataclasses.replace(served.ocr_model.config, version=2)
        s.ocr_model = types.SimpleNamespace(config=cfg)
        s.tokenizer = served.tokenizer
        s.engine = served.engine
        return s

    b = body(image(1500, 700, seed=8), **md)
    got, n_crops = check_inputs_equal(as_v2(port, DeepseekOCRChat),
                                      as_v2(jax_model, JDeepseekOCRChat), b,
                                      1)
    assert n_crops == crops
    side = 1024 if crops else 768
    assert got.mm["global"].shape[-1] == side
    if crops:
        assert got.mm["crops"].shape[-1] == 768
        # 16² + 1 base rows, (12·2)·12 tile rows, no newlines
        assert len(got.mm["gather_idx"]) == 16 * 16 + 1 + 24 * 12
    else:
        assert len(got.mm["gather_idx"]) == 12 * 12 + 1


def test_stream_chunks_match_jax(both):
    port, jax_model = both
    b = body(*REQUESTS["view-640"][:1])

    def deltas(chunks):
        chunks = list(chunks)
        return ([ch.delta.content for c in chunks for ch in c.choices],
                chunks[-1].usage.prompt_tokens)

    assert deltas(port.generate_stream(
        ChatCompletionParameters.model_validate(b))) == \
        deltas(jax_model.generate_stream(JParameters.model_validate(b)))


def test_checkpoint_writer_round_trips(tmp_path):
    """save_hf_deepseek_ocr writes the names DeepseekOCRModel.load_params
    reads (every tensor back equal) and aha_tpu's load_params reads the
    same numbers from it."""
    from aha_tpu.io.weights import open_weights as jopen_weights
    from aha_tpu.models.deepseek_ocr import DeepseekOCRModel as JModel
    from aha_tpu_torch.io.convert import params_from_jax
    from aha_tpu_torch.io.weights import open_weights, save_hf_deepseek_ocr
    from aha_tpu_torch.models.deepseek_ocr import DeepseekOCRModel
    from tests.test_deepseek_ocr import tiny_config
    from tests.test_torch_deepseek_ocr import port_config

    jc = tiny_config()
    model = DeepseekOCRModel(port_config(jc), max_rope_len=256)
    params = model.init_random(torch.Generator().manual_seed(4))
    save_hf_deepseek_ocr(params, str(tmp_path))
    back = model.load_params(open_weights(str(tmp_path)), torch.float32)
    jback = params_from_jax(jax_tree_np(JModel(jc, max_rope_len=256)
                                        .load_params(jopen_weights(
                                            str(tmp_path)), np.float32)))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}{i}.")
        else:
            yield prefix, tree

    want = dict(flat(params))
    for tree in (back, jback):
        got = dict(flat(tree))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k


def jax_tree_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)
