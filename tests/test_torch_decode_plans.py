"""The work plans of two of the port's CUDA kernels, as pure functions on
the CPU: the int8-cache decode's split of a slot's live rows
(csrc/decode_attention_q8.cu), checked by walking it — a flash-decoding
pass over its splits, then their fold, in float32 — against aha_tpu's
dequantizing decode (1e-5); the quantized fused stack's partial-buffer
size over its 32-column x 512-byte units (csrc/fused_decode_stack_q8.cu)
for every grid mix; and the decomposition study's edits of that stack's
source (studies/stack_parts.py --grids q8|q4)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops import attention as jattn
from aha_tpu_torch.ops import flash_attention as fa
from aha_tpu_torch.ops import fused_layer

torch.set_num_threads(1)


@pytest.mark.parametrize("valid", [0, 1, 63, 64, 65, 1000, 2047, 2048,
                                   16000])
@pytest.mark.parametrize("S,Hkv", [(2048, 8), (16384, 8), (4096, 2),
                                   (65536, 1)])
def test_q8_split_plan_covers_live_rows(valid, S, Hkv):
    """Each live row in exactly one split, in order; at most
    ⌈valid / 64⌉ splits and at most the grid's; splits of at most 64 rows
    until the grid's cap, equal shares after; the grid fixed by S and Hkv
    alone, so a slot's plan never depends on the batch.  The all-int8
    variant requantizes p over the rows a warp holds at one step (two per
    sub-warp of D/16 lanes), at most 64 at D 64 and 128."""
    valid = min(valid, S)
    maxsplit = fa.decode_splits(S, Hkv, fa.Q8_MIN_ROWS)
    assert maxsplit == min(256 // Hkv, -(-S // 64))
    plan = fa.split_rows(valid, maxsplit, fa.Q8_MIN_ROWS)
    rows = [r for split in plan for r in split]
    assert rows == list(range(valid))
    assert 1 <= len(plan) <= maxsplit
    assert len(plan) <= max(1, -(-valid // 64))
    if len(plan) < maxsplit:
        assert len(plan[0]) <= 64
    assert all(len(s) == len(plan[0]) for s in plan[:-1])
    assert len(plan[-1]) <= len(plan[0])
    for D in (64, 128):
        assert 2 * 32 // (D // 16) <= fa.Q8_MIN_ROWS


def _split_decode(q, k, v, ks, vs, valid, scale):
    """One slot's cast-variant decode by the kernel's plan: per split and
    kv-head the partial (m, l, Σ e^(s-m)·vs·v), then the fold weighted by
    e^(m - M), all in float32."""
    Hq, D = q.shape
    Hkv = k.shape[1] // D
    G = Hq // Hkv
    plan = fa.split_rows(valid, fa.decode_splits(k.shape[0], Hkv, fa.Q8_MIN_ROWS),
                         fa.Q8_MIN_ROWS)
    out = torch.zeros(Hq, D)
    for h in range(Hkv):
        kh = k[:, h * D:(h + 1) * D].float()
        vh = v[:, h * D:(h + 1) * D].float()
        for g in range(G):
            qh = q[h * G + g].float()
            parts = []
            for split in plan:
                r = torch.tensor(list(split), dtype=torch.long)
                if len(r) == 0:
                    continue
                s = (kh[r] @ qh) * scale * ks[r, h]
                m = s.max()
                p = torch.exp(s - m)
                parts.append((m, p.sum(), (p * vs[r, h]) @ vh[r]))
            M = max(m for m, _, _ in parts)
            w = [torch.exp(m - M) for m, _, _ in parts]
            out[h * G + g] = (sum(a * wi for (_, _, a), wi in zip(parts, w))
                              / sum(l * wi for (_, l, _), wi in zip(parts, w)))
    return out


def test_q8_split_fold_matches_jax_fallback():
    """Walking the split plan (cast numerics) gives aha_tpu's dequantizing
    int8 decode, per slot of a ragged batch of a 4096-row cache (lengths
    on either side of the 64-row split and past the grid's cap): within
    1e-5."""
    rng = np.random.default_rng(9)
    L, S, Hq, Hkv, D, li = 2, 4096, 4, 2, 64, 1
    lens = [1, 63, 64, 65, 1000, 2100, 4096]
    B = len(lens)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.integers(-127, 128, (L, B, S, Hkv * D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, B, S, Hkv * D)).astype(np.int8)
    ks = (rng.random((L, B, Hkv, S)) * 0.01 + 0.002).astype(np.float32)
    vs = (rng.random((L, B, Hkv, S)) * 0.01 + 0.002).astype(np.float32)
    want = np.asarray(jattn.attention_decode_at_q8(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs)), jnp.int32(li),
        jnp.asarray(np.asarray(lens, np.int32) - 1)))
    for b, valid in enumerate(lens):
        got = _split_decode(torch.from_numpy(q[b, 0]),
                            torch.from_numpy(k[li, b]),
                            torch.from_numpy(v[li, b]),
                            torch.from_numpy(ks[li, b].T),
                            torch.from_numpy(vs[li, b].T), valid, D ** -0.5)
        np.testing.assert_allclose(got.numpy(), want[b, 0], rtol=1e-5,
                                   atol=1e-5)


GRID_MIXES = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("geo", [
    dict(H=1024, NQ=2048, HD=1024, NI=3072),     # Qwen3-0.6B
    dict(H=2560, NQ=4096, HD=1024, NI=9728),     # Qwen3-4B
    dict(H=256, NQ=384, HD=384, NI=512),         # the card tests' widths
])
def test_quant_partials_cover_every_unit(geo):
    """The quantized stack's partial buffer holds a run partial for every
    32-column x 512-byte unit of every projection, each on either grid
    (int8: K bytes a column, 4-bit: K/2), and is exactly the largest
    projection's: the plan writes partial u·32 + c of unit u's column c."""
    n = dict(geo)
    H, NQ, HD, NI = geo["H"], geo["NQ"], geo["HD"], geo["NI"]
    kn = ((H, NQ + 2 * HD), (NQ, H), (H, 2 * NI), (NI, H))
    for q4 in GRID_MIXES:
        size = fused_layer._quant_partials(n, list(q4))
        needs = []
        for (K, N), g4 in zip(kn, q4):
            kb = K // 2 if g4 else K
            units = [(ct, rt) for ct in range(-(-N // 32))
                     for rt in range(-(-kb // 512))]
            # the last unit's partials, u·32 + 31, within the buffer
            assert (len(units) - 1) * 32 + 31 < size
            needs.append(len(units) * 32)
        assert size == max(needs), q4


def test_group_padding_keeps_the_scales():
    """Scales of a width whose group count is not a multiple of 4 get zero
    columns appended (16-byte rows for the tensor maps), the rest as is."""
    t = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(2, 3, 6)
    p = fused_layer._group_padded(t)
    assert p.shape == (2, 3, 8) and torch.equal(p[..., :6], t)
    assert torch.equal(p[..., 6:], torch.zeros(2, 3, 2))
    t8 = torch.ones(2, 3, 8)
    assert fused_layer._group_padded(t8) is t8


def test_stack_parts_edits_the_q8_stack_source():
    """studies/stack_parts.py --grids q8|q4 reads the quantized stack's
    source: five grid barriers a layer, all emptied for reading (b), with
    the attention call, the parentheses balanced."""
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.studies import stack_parts as sp

    for grids in ("q8", "q4"):
        src = (kernels.CSRC / sp.STACK_SOURCES[grids]).read_text()
        assert sp.barriers_per_step(src) == 5 * sp.L
        cut = sp.drop_calls(src, sp.DROPPED)
        assert sp.BARRIER not in cut and "attention_phase<" not in cut
        assert cut.count("(") == cut.count(")")
