"""The captured decode blocks' host side, on the CPU (where the engines run
eagerly; tests/test_torch_cuda.py replays the graphs on a card): the window
key against aha_tpu's `_live_window` and the fused-stack gate, the
sampler's device-side inputs against their host forms and aha_tpu's, the
batch engine's step inputs updated in place, and the launch accounting of
core/graphs.py."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.core import sampling as js
from aha_tpu.core.engine import TextEngine as JEngine
from aha_tpu_torch.core import graphs
from aha_tpu_torch.core import sampling as ts
from aha_tpu_torch.core.engine import CACHE_BUCKETS, TextEngine, window_key
from aha_tpu_torch.ops import launches

torch.set_num_threads(1)


def _live_rows(cache_len: int) -> list[int]:
    """Every live-row count a block can end on that sits at or beside a
    bucket, up to the cache length."""
    near = {1, cache_len}
    for b in CACHE_BUCKETS:
        near |= {b - 1, b, b + 1}
    return sorted(n for n in near if 1 <= n <= cache_len)


@pytest.fixture(scope="module")
def tiny_bf16():
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)

    cfg = Qwen3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=64)
    model = Qwen3Model(cfg, max_rope_len=64)
    params = fuse_decode_params(model.init_random(
        torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    return model, params


@pytest.mark.parametrize("cache_len", CACHE_BUCKETS)
def test_window_key_keeps_the_gate_and_jax_window(cache_len, tiny_bf16,
                                                  monkeypatch):
    """For every live-row count near a bucket: the key covers the rows, is
    a bucket or the cache length, equals aha_tpu's _live_window wherever
    that gives a window, and the fused-stack gate chooses with the key as
    it does with the exact rows."""
    monkeypatch.setenv("AHA_FUSED_LAYER", "1")
    model, params = tiny_bf16
    x = torch.zeros((1, 1, 32), dtype=torch.bfloat16)
    cache = {"k": torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16),
             "pos": torch.zeros((), dtype=torch.int32)}
    for rows in _live_rows(cache_len):
        key = window_key(rows, cache_len)
        assert rows <= key <= cache_len
        assert key in CACHE_BUCKETS or key == cache_len
        jw = JEngine._live_window(rows, cache_len)
        assert key == (cache_len if jw is None else jw), rows
        assert model._use_fused_stack(params, x, cache, key) == \
            model._use_fused_stack(params, x, cache, rows), rows


def test_engine_passes_the_window_key(tiny_bf16):
    """Every decode block of a request runs under the window key of its
    live rows: the bucket past 256 rows, the cache length before."""
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    cfg = Qwen3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=16)
    model = Qwen3Model(cfg, max_rope_len=2048)
    params = model.init_random(torch.Generator().manual_seed(1))
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=2048)
    seen = []
    real = model.backbone

    def spy(*a, window=None, **kw):
        if window is not None:
            seen.append(window)
        return real(*a, window=window, **kw)

    model.backbone = spy
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, 64, 100)]
    out = eng.generate_tokens(prompt, ts.SamplingConfig(), 200)
    assert len(out) == 200 and eng.graphs is None
    # cache 512; 13 blocks of 16 steps end on 117, 133, ..., 309 live rows:
    # nine under the 256 bucket, four over it
    assert seen == [256] * 9 * 16 + [512] * 4 * 16


@pytest.mark.parametrize("n_valid", [0, 1, 5, 17, 63, 64, 100])
@pytest.mark.parametrize("kw", [dict(temperature=0.5, top_k=5,
                                     repeat_penalty=1.3),
                                dict(temperature=1.0, top_k=50, top_p=0.95,
                                     repeat_penalty=0.8),
                                dict(repeat_penalty=1.2)])
def test_device_n_valid_equals_host_int_and_jax(n_valid, kw):
    """filter_logits / sample_token with n_valid a 0-dim tensor equal the
    host-int form bit for bit, and aha_tpu's penalty: the same finite set
    and values, and the same token given the same noise."""
    rng = np.random.default_rng(n_valid)
    logits = (rng.standard_normal(300) * 3).astype(np.float32)
    # the ring repeats tokens and holds the top logits
    ring = np.concatenate([np.argsort(-logits)[:40],
                           rng.integers(0, 300, 24)]).astype(np.int32)
    noise = rng.gumbel(size=300).astype(np.float32)
    cfg = ts.SamplingConfig(**kw)
    lt, rt = torch.from_numpy(logits), torch.from_numpy(ring)
    dev_n = torch.tensor(n_valid, dtype=torch.int32)
    host = ts.filter_logits(lt, cfg, rt, n_valid)
    dev = ts.filter_logits(lt, cfg, rt, dev_n)
    assert torch.equal(host, dev)
    want = np.asarray(js.apply_repeat_penalty(
        jnp.asarray(logits), jnp.asarray(ring), jnp.int32(min(n_valid, 64)),
        cfg.repeat_penalty))
    pen = ts.apply_repeat_penalty(lt, rt, dev_n, cfg.repeat_penalty).numpy()
    np.testing.assert_array_equal(pen != logits, want != logits)
    np.testing.assert_allclose(pen, want, rtol=1e-6, atol=0)
    nz = torch.from_numpy(noise)
    assert int(ts.sample_token(lt, cfg, None, rt, dev_n, noise=nz)) == \
        int(ts.sample_token(lt, cfg, None, rt, n_valid, noise=nz))


def _old_sample_tokens_batch(logits, sp, rings, n_gen, noise):
    """sample_tokens_batch as it read with its per-step upload of W."""
    logits = logits.float()
    W = rings.shape[1]
    n_valid = torch.minimum(torch.minimum(n_gen, sp["repeat_last_n"]),
                            torch.tensor(W, device=n_gen.device))
    lg = ts._penalized(logits, rings, n_valid, sp["repeat_penalty"])
    greedy_tok = ts.fast_argmax(lg)
    temp = sp["temperature"]
    sl = lg / temp.clamp_min(1e-7)[:, None]
    sl = ts._mask_top_k_dyn(sl, sp["top_k"])
    sl = ts._mask_top_p_dyn(sl, sp["top_p"])
    return torch.where(temp < 1e-7, greedy_tok, ts.fast_argmax(sl + noise))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_sampler_without_upload_equals_old(seed, monkeypatch):
    """sample_tokens_batch clamps by the host int: bit-equal to the form
    that uploaded W every step, over counts below, at and past the ring,
    and it builds no tensor from host values."""
    rng = np.random.default_rng(seed)
    cfgs = [ts.SamplingConfig(), ts.SamplingConfig(repeat_penalty=1.3),
            ts.SamplingConfig(temperature=0.8, top_k=7, repeat_penalty=0.7,
                              repeat_last_n=100),
            ts.SamplingConfig(temperature=1.1, top_p=0.6, repeat_last_n=3)]
    sp = ts.pack_sampling_params(cfgs)
    B, V, W = len(cfgs), 200, 64
    logits = torch.from_numpy((rng.standard_normal((B, V)) * 3)
                              .astype(np.float32))
    rings = torch.from_numpy(rng.integers(0, V, (B, W)).astype(np.int32))
    n_gen = torch.from_numpy(np.array([0, 64, 65, 500][seed:] +
                                      [7, 63, 64, 200][:seed], np.int32))
    noise = torch.from_numpy(rng.gumbel(size=(B, V)).astype(np.float32))
    want = _old_sample_tokens_batch(logits, sp, rings, n_gen, noise)

    def no_upload(*a, **k):
        raise AssertionError("sample_tokens_batch built a tensor from host "
                             "values")

    monkeypatch.setattr(torch, "tensor", no_upload)
    got = ts.sample_tokens_batch(logits, sp, rings, n_gen, noise=noise)
    assert torch.equal(got, want)


def test_batch_step_inputs_keep_their_storage():
    """_refresh_step_inputs and _step write the step inputs in place: the
    same storage before and after (a captured block reads it), with the
    new slot set's values."""
    from aha_tpu_torch.core.batch_engine import BatchEngine, _Request
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    cfg = Qwen3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=16)
    model = Qwen3Model(cfg, max_rope_len=256)
    params = model.init_random(torch.Generator().manual_seed(2))
    eng = BatchEngine(model, params, eos_token_ids=[], slots=3,
                      max_seq_len=256)
    assert eng.graphs is None

    def ptrs():
        return {"tokens": eng._tokens.data_ptr(),
                "active": eng._active.data_ptr(),
                "active_i32": eng._active_i32.data_ptr(),
                "rings": eng._rings.data_ptr(),
                "n_gen": eng._n_gen.data_ptr(),
                **{k: v.data_ptr() for k, v in eng._sp.items()}}

    before = ptrs()
    sampled = ts.SamplingConfig(temperature=0.7, top_k=9, repeat_penalty=1.2,
                                repeat_last_n=10)
    eng._slot_req[1] = _Request([1, 2], sampled, 8, None)
    eng._refresh_step_inputs([False, True, False])
    assert ptrs() == before
    assert eng._active.tolist() == [False, True, False]
    assert eng._active_i32.tolist() == [0, 1, 0]
    assert eng._mode == "general"
    assert eng._sp["top_k"].tolist() == [0, 9, 0]
    assert eng._sp["repeat_last_n"].tolist() == [64, 10, 64]
    with torch.no_grad():
        for _ in range(3):
            toks = eng._step()
            assert ptrs() == before
            assert torch.equal(eng._tokens, toks)
    assert eng._n_gen.tolist() == [0, 3, 0] and eng.decode_steps == 0
    with torch.no_grad():
        seq = eng._decode_n(2)
    assert seq.shape == (2, 3) and eng.decode_steps == 2
    assert ptrs() == before


def _counter():
    def fn():
        return None

    fn.launches = 0
    return fn


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_accounting_adds_the_capture_delta_per_replay():
    """A capture's launches are taken back and its delta added once per
    replay: after k replays each count is k times the block's launches."""
    a, b, c = _counter(), _counter(), _counter()
    fns = [a, b, c]
    a.launches, c.launches = 5, 2
    counted = {}
    with launches.recording(counted):
        launches.count(a, 3)     # what one capture of the block "launched"
        launches.count(b, 28)
    delta = list(counted.items())
    assert delta == [(a, 3), (b, 28)]
    graphs.add_launches(delta, -1)
    assert [fn.launches for fn in fns] == [5, 0, 2]
    fake = _FakeGraph()
    out = torch.zeros(4)
    cap = graphs.Captured(fake, out, delta)
    for _ in range(4):
        assert cap.replay() is out
    assert fake.replays == cap.replays == 4
    assert [fn.launches for fn in fns] == [5 + 12, 112, 2]


def test_a_capture_takes_back_only_its_own_launches():
    """dp replicas' scheduler threads launch while one of them captures:
    the capture's record holds its own thread's launches only, and counts
    added from many threads at once are all kept."""
    a = _counter()
    counted, started, done = {}, threading.Event(), threading.Event()

    def other():
        started.wait()
        for _ in range(7):
            launches.count(a)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with launches.recording(counted):
        launches.count(a, 3)
        started.set()
        assert done.wait(10)
    t.join()
    assert counted == {a: 3} and a.launches == 10
    graphs.add_launches(list(counted.items()), -1)
    assert a.launches == 7

    def many():
        for _ in range(2000):
            launches.count(a)

    ts = [threading.Thread(target=many) for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert a.launches == 7 + 8 * 2000


def test_decode_graphs_capture_once_then_replay(monkeypatch):
    """run(): a key's first call returns the eager block's result and
    captures; every later call replays, whatever the block would return;
    a new key captures again.  Counts graphs."""
    dg = graphs.DecodeGraphs.__new__(graphs.DecodeGraphs)
    dg.captured, dg.capture_secs = 0, 0.0
    calls = []
    monkeypatch.setattr(dg, "_eager_on_stream",
                        lambda block: calls.append("eager") or block(),
                        raising=False)

    def capture(block, generators):
        calls.append(("capture", generators))
        return graphs.Captured(_FakeGraph(), torch.full((2,), 7), [])

    monkeypatch.setattr(dg, "_capture", capture, raising=False)
    table = {}

    def block():
        return torch.full((2,), len(calls))

    assert dg.run(table, ("greedy", 4), block).tolist() == [1, 1]
    assert calls == ["eager", ("capture", ())]
    for _ in range(3):
        assert dg.run(table, ("greedy", 4), block).tolist() == [7, 7]
    assert len(calls) == 2 and table[("greedy", 4)].replays == 3
    gen = torch.Generator()
    dg.run(table, ("general", 4), block, (gen,))
    assert calls[-1] == ("capture", (gen,))
    assert dg.stats()["graphs"] == 2 and len(table) == 2


def test_counted_wrappers_finds_every_kernel_wrapper():
    """The census of counts covers the wrappers chip_smoke counts."""
    import aha_tpu_torch.ops.flash_attention  # noqa: F401
    import aha_tpu_torch.ops.fused_layer  # noqa: F401
    import aha_tpu_torch.ops.lm_head  # noqa: F401
    import aha_tpu_torch.ops.quant_matmul  # noqa: F401

    names = {fn.__name__ for fn in graphs.counted_wrappers()}
    assert {"flash_decode_at_layer_flat", "flash_decode_at_layer_q8_batched",
            "flash_decode_at_layer", "head_argmax", "head_argmax_q4",
            "fused_decode_stack", "fused_decode_stack_q8", "quant_matmul",
            "quant_matmul_q4", "quant_swiglu",
            "flash_attention_segmented"} <= names
    assert len(names) == len(graphs.counted_wrappers())


def test_engines_run_eagerly_off_the_card():
    """cuda_graphs is a request for the card: on a CPU device both engines
    hold no graphs, whatever it says."""
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    cfg = Qwen3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=16)
    model = Qwen3Model(cfg, max_rope_len=256)
    params = model.init_random(torch.Generator().manual_seed(3))
    for flag in (True, False):
        assert TextEngine(model, params, [], cuda_graphs=flag).graphs is None
