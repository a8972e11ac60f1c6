"""Each CUDA kernel against its plain PyTorch version on the card, at small
shapes (bf16 inputs; attention tolerance 2e-2 abs against the f32 plain
version; the GGUF-grid kernels relative to max |ref|, each stated at its
test).  Marked `cuda`: skipped where torch sees no CUDA device.  Run on
a card with `python -m pytest tests/test_torch_cuda.py -m cuda`."""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf(g, *shape):
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("D,G,valid", [(128, 2, 300), (64, 4, 1), (128, 1, 512),
                                       (128, 3, 300), (64, 5, 77),
                                       (128, 7, 500)])
def test_decode_kernel_matches_plain(dev, D, G, valid):
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_flat, flash_decode_at_layer_flat_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    L, S, Hkv = 3, 512, 2
    q = _bf(g, 1, 1, Hkv * G, D)
    k, v = _bf(g, L, 1, S, Hkv * D), _bf(g, L, 1, S, Hkv * D)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    vl = torch.tensor([valid], dtype=torch.int32, device=dev)
    n0 = flash_decode_at_layer_flat.launches
    got = flash_decode_at_layer_flat(q, k, v, layer, vl)
    ref = flash_decode_at_layer_flat_plain(q.float(), k.float(), v.float(),
                                           layer, vl)
    torch.cuda.synchronize()
    assert flash_decode_at_layer_flat.launches == n0 + 1
    assert (got.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_kernel_matches_plain(dev, causal):
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = _bf(g, 1, 192, 4, 64), _bf(g, 1, 192, 2, 64), _bf(g, 1, 192, 2, 64)
    got = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 2e-2


def test_head_argmax_kernel_matches_plain(dev):
    from aha_tpu_torch.ops.lm_head import head_argmax, head_argmax_plain

    g = torch.Generator(device=dev).manual_seed(2)
    w, h = _bf(g, 5000, 256), _bf(g, 1, 256)
    assert int(head_argmax({"w": w}, h)) == int(head_argmax_plain(w, h))
    wt = torch.zeros(5000, 256, dtype=torch.bfloat16, device=dev)
    wt[4000, 0] = wt[37, 0] = 1.0
    e0 = torch.zeros(1, 256, dtype=torch.bfloat16, device=dev)
    e0[0, 0] = 1.0
    assert int(head_argmax({"w": wt}, e0)) == 37
    nan = torch.full((1, 256), float("nan"), dtype=torch.bfloat16, device=dev)
    assert int(head_argmax({"w": w}, nan)) == 4999 == \
        int(head_argmax_plain(w, nan))


def _fused_layers(g, L, H, hq, hkv, D, NI):
    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.05).to(
            torch.bfloat16)

    def norm(*shape):
        return (1 + 0.1 * torch.randn(shape, generator=g, device="cuda")).to(
            torch.bfloat16)

    return {"ln1": {"w": norm(L, H)}, "ln2": {"w": norm(L, H)},
            "qkv": {"w": w(L, H, (hq + 2 * hkv) * D)},
            "o": {"w": w(L, hq * D, H)},
            "q_norm": {"w": norm(L, D)}, "k_norm": {"w": norm(L, D)},
            "mlp": {"gateup": {"w": w(L, H, 2 * NI)},
                    "down": {"w": w(L, NI, H)}}}


@pytest.mark.parametrize("D,hq,hkv,pos", [(128, 4, 2, 100), (64, 6, 2, 0),
                                          (128, 3, 3, 255)])
def test_fused_stack_kernel_matches_plain(dev, D, hq, hkv, pos):
    """The one-launch decode stack against its plain version (f32 from the
    same bf16 inputs): hidden state and the in-place cache rows within
    2e-2 of max |ref|; rows other than `pos` untouched."""
    from aha_tpu_torch.ops.fused_layer import (fused_decode_stack,
                                               fused_decode_stack_plain)
    from aha_tpu_torch.ops.rope import rope_table

    g = torch.Generator(device=dev).manual_seed(3)
    L, H, NI, S = 2, 256, 512, 256
    lyr = _fused_layers(g, L, H, hq, hkv, D, NI)
    x = _bf(g, 1, 1, H)
    kc, vc = _bf(g, L, 1, S, hkv * D), _bf(g, L, 1, S, hkv * D)
    cos, sin = rope_table(D, S, 1e6, device=dev)
    cosr = torch.cat([cos[pos], cos[pos]])[None]
    sinr = torch.cat([sin[pos], sin[pos]])[None]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kp, vp = kc.clone(), vc.clone()
    n0 = fused_decode_stack.launches
    got = fused_decode_stack(x, lyr, p, cosr, sinr, kc, vc, 1e-6)
    ref = fused_decode_stack_plain(x, lyr, p, cosr, sinr, kp, vp, 1e-6)
    torch.cuda.synchronize()
    assert fused_decode_stack.launches == n0 + 1
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2 * top
    for new, want in ((kc, kp), (vc, vp)):
        rows = want[:, 0, pos].float()
        assert (new[:, 0, pos].float() - rows).abs().max().item() <= \
            2e-2 * rows.abs().max().item()
        keep = torch.ones(S, dtype=torch.bool, device=dev)
        keep[pos] = False
        assert torch.equal(new[:, 0, keep], want[:, 0, keep])


RAGGED = [1, 5, 64, 100, 128, 200, 511, 512]


def test_batched_decode_matches_plain_and_per_slot(dev):
    """The batched wrapper at B = 8 with ragged lengths (a parked slot of
    1, split boundaries 64 and 128, the full 512): within 2e-2 of the f32
    plain version, and bit-equal to eight B = 1 launches of the kernel."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_flat, flash_decode_at_layer_flat_batched,
        flash_decode_at_layer_flat_plain)

    g = torch.Generator(device=dev).manual_seed(4)
    L, B, S, Hkv, D = 3, 8, 512, 2, 128
    q = _bf(g, B, 1, 2 * Hkv, D)
    k, v = _bf(g, L, B, S, Hkv * D), _bf(g, L, B, S, Hkv * D)
    layer = torch.tensor(2, dtype=torch.int32, device=dev)
    vl = torch.tensor(RAGGED, dtype=torch.int32, device=dev)
    n0 = flash_decode_at_layer_flat_batched.launches
    got = flash_decode_at_layer_flat_batched(q, k, v, layer, vl)
    ref = flash_decode_at_layer_flat_plain(q.float(), k.float(), v.float(),
                                           layer, vl)
    assert flash_decode_at_layer_flat_batched.launches == n0 + 1
    assert (got.float() - ref).abs().max().item() <= 2e-2
    for b in range(B):
        one = flash_decode_at_layer_flat(
            q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
            v[:, b:b + 1].contiguous(), layer, vl[b:b + 1].contiguous())
        assert torch.equal(one, got[b:b + 1]), b


def _q8_inputs(g, dev, L, B, S, Hq, Hkv, D):
    k = torch.randint(-127, 128, (L, B, S, Hkv * D), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (L, B, S, Hkv * D), generator=g, device=dev,
                      dtype=torch.int8)
    ks = torch.rand((L, B, S, Hkv), generator=g, device=dev) * 0.01 + 0.002
    vs = torch.rand((L, B, S, Hkv), generator=g, device=dev) * 0.01 + 0.002
    # q 4× wider than N(0, 1): peaked scores, outputs of O(1)
    q = (torch.randn((B, 1, Hq, D), generator=g, device=dev) * 4).to(
        torch.bfloat16)
    return q, k, v, ks, vs


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("D,G,B", [(128, 2, 1), (64, 4, 1), (128, 2, 8),
                                   (64, 1, 8), (128, 3, 1), (64, 5, 1),
                                   (128, 7, 1), (128, 7, 8)])
def test_q8_decode_kernel_matches_plain(dev, mxu, D, G, B):
    """Both q8 variants against the f32 plain version (the dequantizing
    fallback) on the same int8 rows, max error relative to max |ref|: the
    cast variant within 6e-3 (the bf16 rounding of its output), the
    all-int8 one within 8e-2 (its q and p requantization), as chip_smoke
    holds them.  B = 8 runs the batched wrapper over ragged lengths."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_q8, flash_decode_at_layer_q8_batched,
        flash_decode_at_layer_q8_plain)

    g = torch.Generator(device=dev).manual_seed(5 + D + G + B)
    L, S, Hkv = 2, 512, 2
    q, k, v, ks, vs = _q8_inputs(g, dev, L, B, S, Hkv * G, Hkv, D)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    vl = torch.tensor(RAGGED if B == 8 else [300], dtype=torch.int32,
                      device=dev)
    fn = flash_decode_at_layer_q8_batched if B > 1 else \
        flash_decode_at_layer_q8
    n0 = fn.launches
    got = fn(q, k, v, ks, vs, layer, vl, mxu=mxu)
    ref = flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, layer, vl)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= (8e-2 if mxu else 6e-3), rel


def test_q8_mxu_default_follows_env(dev, monkeypatch):
    """AHA_Q8_MXU, read at call time: unset or "1" is the all-int8
    variant, "0" the cast variant."""
    from aha_tpu_torch.ops.flash_attention import flash_decode_at_layer_q8

    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, ks, vs = _q8_inputs(g, dev, 1, 1, 256, 4, 2, 128)
    layer = torch.tensor(0, dtype=torch.int32, device=dev)
    vl = torch.tensor([200], dtype=torch.int32, device=dev)
    args = (q, k, v, ks, vs, layer, vl)
    monkeypatch.delenv("AHA_Q8_MXU", raising=False)
    assert torch.equal(flash_decode_at_layer_q8(*args),
                       flash_decode_at_layer_q8(*args, mxu=True))
    monkeypatch.setenv("AHA_Q8_MXU", "0")
    assert torch.equal(flash_decode_at_layer_q8(*args),
                       flash_decode_at_layer_q8(*args, mxu=False))


def test_cuda_tensors_never_take_the_plain_path(dev):
    """An unsupported shape on the card raises; it does not fall back."""
    from aha_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 100, 4, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    # a bf16 cache handed to the q8 kernel
    from aha_tpu_torch.ops.flash_attention import flash_decode_at_layer_q8

    q1 = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16, device=dev)
    kv = torch.zeros(1, 1, 64, 128, dtype=torch.bfloat16, device=dev)
    sc = torch.zeros(1, 1, 64, 2, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_decode_at_layer_q8(q1, kv, kv, sc, sc, one[0], one)


def _packed(g, n, k, grid, shift=0.0):
    from aha_tpu_torch.ops.quant_matmul import pack_rows

    w = torch.randn((n, k), generator=g, device="cuda") * 0.02 + shift
    return pack_rows(w, grid == "q4")


@pytest.mark.parametrize("grid", ["q8", "q4"])
@pytest.mark.parametrize("M", [1, 3, 8, 37, 64])
def test_quant_matmul_kernel_matches_plain(dev, grid, M):
    """Both grids at the M the decode paths give (1, a batch of 8, the
    chunked-admission and short-prefill rows up to 64), K ragged against
    128 (x narrower than the packed Kp) and N ragged against the warps:
    the bf16 output within 5e-3 of max |ref| of the f32 plain version on
    the same bf16 inputs (its bf16 rounding)."""
    from aha_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(40 + M)
    K, N = 1000, 1001
    p = _packed(g, N, K, grid, 0.01 if grid == "q4" else 0.0)
    x = _bf(g, M, K)
    fn, plain = ((qm.quant_matmul_q4, qm.quant_matmul_q4_plain)
                 if grid == "q4" else (qm.quant_matmul, qm.quant_matmul_plain))
    args = [p[k] for k in (("q4", "s4", "b4") if grid == "q4" else ("qt", "st"))]
    n0 = fn.launches
    got = fn(x, *args)
    ref = plain(x.float(), *args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and got.shape == (M, N)
    top = ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= 5e-3 * top
    zero = plain(x.float(), *[a if i != 1 else torch.zeros_like(a)
                              for i, a in enumerate(args)])
    assert (zero - ref).abs().max().item() > 5e-3 * top


@pytest.mark.parametrize("gu_fmt,dn_fmt", [("q8", "q8"), ("q4", "q4"),
                                           ("q4", "q8"), ("q8", "q4")])
@pytest.mark.parametrize("M", [1, 8, 37])
def test_quant_swiglu_kernel_matches_plain(dev, gu_fmt, dn_fmt, M):
    """The one-launch fused MLP in all four grid pairs against its f32 plain
    version on the same bf16 inputs: within 1e-2 of max |ref|.  The output
    is rounded to bf16 (≤ 2^-8 of max |ref|), and the kernel's a =
    SiLU(g)·u differs from the plain one in f32 summation order, so a rare
    value of a/sa at a .5 boundary requantizes one step apart, moving an
    output by max|a_g|/127 · |w_down| (≤ 3.2e-3 of max |ref| measured on an
    H100 over these cases).  Zeroed down scales are off by ~1 and fail."""
    from aha_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(50 + M)
    H, I = 384, 512
    gu = {k: torch.cat([a, b], 0) for (k, a), b in zip(
        _packed(g, I, H, gu_fmt).items(),
        _packed(g, I, H, gu_fmt, 0.01).values())}
    dn = _packed(g, H, I, dn_fmt)
    x = _bf(g, 1, M, H) * 4
    n0 = qm.quant_swiglu.launches
    got = qm.quant_swiglu(gu, dn, x)
    ref = qm.quant_swiglu_plain(gu, dn, x.reshape(M, H).float())
    torch.cuda.synchronize()
    assert qm.quant_swiglu.launches == n0 + 1 and got.shape == (1, M, H)
    top = ref.abs().max().item()
    assert (got.reshape(M, H).float() - ref).abs().max().item() <= 1e-2 * top
    bad = qm.quant_swiglu_plain(
        gu, {k: torch.zeros_like(v) if k in ("st", "s4") else v
             for k, v in dn.items()}, x.reshape(M, H).float())
    assert (bad - ref).abs().max().item() > 1e-2 * top


@pytest.mark.parametrize("grid", ["q8", "q4"])
def test_quant_head_argmax_matches_plain(dev, grid):
    """The quantized greedy heads: the plain index on random rows, a tie
    planted across blocks going to the smaller index, a NaN row giving
    V − 1."""
    from aha_tpu_torch.ops import lm_head
    from aha_tpu_torch.ops.quant_matmul import pack_rows

    g = torch.Generator(device=dev).manual_seed(60)
    V, K = 5000, 256
    p = _packed(g, V, K, grid)
    fn = lm_head.head_argmax_q4 if grid == "q4" else lm_head.head_argmax_q8
    n0 = fn.launches
    for _ in range(3):
        h = _bf(g, 1, K)
        got = int(lm_head.head_argmax(p, h))
        ref = int(lm_head.quant_head_plain(p, h))
        assert got == ref
    assert fn.launches == n0 + 3
    wt = torch.zeros(V, K, device=dev)
    wt[4000, :5] = wt[37, :5] = 1.0
    wt[1000, :5] = 0.5
    e0 = torch.zeros(1, K, dtype=torch.bfloat16, device=dev)
    e0[0, :5] = 1.0
    assert int(lm_head.head_argmax(pack_rows(wt, grid == "q4"), e0)) == 37
    nan = torch.full((1, K), float("nan"), dtype=torch.bfloat16, device=dev)
    assert int(lm_head.head_argmax(p, nan)) == V - 1 == \
        int(lm_head.quant_head_plain(p, nan))


def _quant_layers(lyr, grids):
    """_fused_layers with q|k|v, o, gate|up and down packed on `grids`."""
    from aha_tpu_torch.ops.quant_matmul import pack_rows

    def pack(p, grid):
        return pack_rows(p["w"].float().transpose(-1, -2), grid == "q4")

    mlp = lyr["mlp"]
    return {**lyr, "qkv": pack(lyr["qkv"], grids[0]),
            "o": pack(lyr["o"], grids[1]),
            "mlp": {"gateup": pack(mlp["gateup"], grids[2]),
                    "down": pack(mlp["down"], grids[3])}}


@pytest.mark.parametrize("grids,D,hq,hkv,pos", [
    (("q8", "q8", "q8", "q8"), 128, 4, 2, 100),
    (("q4", "q4", "q4", "q4"), 128, 4, 2, 0),
    (("q4", "q4", "q4", "q8"), 64, 6, 2, 255),
    (("q8", "q4", "q8", "q4"), 128, 3, 3, 37)])
def test_fused_stack_q8_kernel_matches_plain(dev, grids, D, hq, hkv, pos):
    """The one-launch decode stack over the GGUF grids, each projection on
    its own grid, against its plain version on the same inputs: hidden
    state and the in-place cache rows within 2e-2 of max |ref| on the int8
    grid and 8e-2 with a 4-bit one; rows other than `pos` untouched; zeroed
    down scales fail the bound.  Both sides quantize the activations from
    f32 values that differ in rounding (the attention's exp and split
    order; on the 4-bit grid also the order of the n·s·sx·Σxq and xsum·b
    terms, which cancel), so a value at a .5 boundary requantizes one step
    apart and moves every column of the next product; the 4-bit grid's
    w − b ≥ 0 moves them one way.  Measured on an H100 in these cases: ≤ 7.4e-3
    int8, ≤ 3.5e-2 with a 4-bit grid."""
    from aha_tpu_torch.ops.fused_layer import (fused_decode_stack_q8,
                                               fused_decode_stack_q8_plain)
    from aha_tpu_torch.ops.rope import rope_table

    g = torch.Generator(device=dev).manual_seed(4)
    L, H, NI, S = 2, 256, 512, 256
    lyr = _quant_layers(_fused_layers(g, L, H, hq, hkv, D, NI), grids)
    x = _bf(g, 1, 1, H)
    kc, vc = _bf(g, L, 1, S, hkv * D), _bf(g, L, 1, S, hkv * D)
    cos, sin = rope_table(D, S, 1e6, device=dev)
    cosr = torch.cat([cos[pos], cos[pos]])[None]
    sinr = torch.cat([sin[pos], sin[pos]])[None]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kp, vp = kc.clone(), vc.clone()
    n0 = fused_decode_stack_q8.launches
    got = fused_decode_stack_q8(x, lyr, p, cosr, sinr, kc, vc, 1e-6)
    ref = fused_decode_stack_q8_plain(x, lyr, p, cosr, sinr, kp, vp, 1e-6)
    torch.cuda.synchronize()
    assert fused_decode_stack_q8.launches == n0 + 1
    tol = 8e-2 if "q4" in grids else 2e-2
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol * top
    for new, want in ((kc, kp), (vc, vp)):
        rows = want[:, 0, pos].float()
        assert (new[:, 0, pos].float() - rows).abs().max().item() <= \
            tol * rows.abs().max().item()
        keep = torch.ones(S, dtype=torch.bool, device=dev)
        keep[pos] = False
        assert torch.equal(new[:, 0, keep], want[:, 0, keep])
    dn = lyr["mlp"]["down"]
    zeroed = {**lyr, "mlp": {**lyr["mlp"], "down": {
        k: torch.zeros_like(v) if k in ("st", "s4") else v
        for k, v in dn.items()}}}
    bad = fused_decode_stack_q8_plain(x, zeroed, p, cosr, sinr, kp.clone(),
                                      vp.clone(), 1e-6)
    assert (bad.float() - ref.float()).abs().max().item() > tol * top


@pytest.mark.parametrize("grid", ["q8", "q4"])
def test_quant_kernels_wide_intermediate(dev, grid):
    """Qwen3-14B's intermediate width (17408) at M = 37: 16 staged rows
    would pass the block's shared memory, so both kernels take 8 per pass
    (pass_rows) and agree with their plain versions as at narrow widths."""
    from aha_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(70)
    H, I, M = 256, 17408, 37
    gu = _packed(g, 2 * I, H, grid)
    dn = _packed(g, H, I, grid)
    x = _bf(g, 1, M, H) * 4
    got = qm.quant_swiglu(gu, dn, x)
    ref = qm.quant_swiglu_plain(gu, dn, x.reshape(M, H).float())
    a = _bf(g, M, I)
    keys = qm.GRID_KEYS[grid]
    fn = qm.quant_matmul_q4 if grid == "q4" else qm.quant_matmul
    plain = qm.quant_matmul_q4_plain if grid == "q4" else qm.quant_matmul_plain
    got_mm = fn(a, *[dn[k] for k in keys])
    ref_mm = plain(a.float(), *[dn[k] for k in keys])
    torch.cuda.synchronize()
    assert (got.reshape(M, H).float() - ref).abs().max().item() <= \
        1e-2 * ref.abs().max().item()
    assert (got_mm.float() - ref_mm).abs().max().item() <= \
        5e-3 * ref_mm.abs().max().item()


def _windows(rng, S, pad):
    """Sorted segments of 1-64 rows that straddle the 64-row tiles, then
    `pad` rows of seg -1 (a patch bucket's tail)."""
    import numpy as np

    sizes = rng.integers(1, 65, S)
    seg = np.repeat(np.arange(S), sizes)[:S - pad]
    return np.concatenate([seg, -np.ones(pad, np.int64)]).astype(np.int32)


@pytest.mark.parametrize("kind", ["windows", "full"])
@pytest.mark.parametrize("S,H,Hkv,D,pad", [
    (1024, 4, 4, 80, 200),      # the tower's D 80, a pad tail
    (300, 4, 2, 64, 0),         # ragged S, G 2
    (640, 2, 2, 128, 37),
])
def test_segment_flash_kernel_matches_plain(dev, kind, S, H, Hkv, D, pad):
    """bf16 kernel vs the f32 plain version on the same inputs, every row
    (pad rows included: both give them 0), 2e-2 abs."""
    import numpy as np

    from aha_tpu_torch.ops.flash_attention import (
        flash_attention_segmented, flash_attention_segmented_plain)

    rng = np.random.default_rng(S + D)
    seg = (_windows(rng, S, pad) if kind == "windows" else
           np.concatenate([np.zeros(S - pad, np.int32),
                           -np.ones(pad, np.int32)]))
    seg = torch.from_numpy(seg).to(dev)
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = _bf(g, 1, S, H, D), _bf(g, 1, S, Hkv, D), _bf(g, 1, S, Hkv, D)
    n0 = flash_attention_segmented.launches
    got = flash_attention_segmented(q, k, v, seg)
    ref = flash_attention_segmented_plain(q.float(), k.float(), v.float(),
                                          seg)
    torch.cuda.synchronize()
    assert flash_attention_segmented.launches == n0 + 1
    assert (got.float() - ref).abs().max().item() <= 2e-2


def test_segment_flash_reads_strided_qkv(dev):
    """Thirds of one fused qkv product, as the vision tower hands them."""
    from aha_tpu_torch.ops.flash_attention import flash_attention_segmented

    g = torch.Generator(device=dev).manual_seed(5)
    qkv = _bf(g, 1, 512, 3, 4, 80)
    seg = torch.arange(512, device=dev, dtype=torch.int32) // 48
    views = [qkv[:, :, i] for i in range(3)]
    got = flash_attention_segmented(*views, seg)
    want = flash_attention_segmented(*[t.contiguous() for t in views], seg)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,lens", [(1, (1,)), (1, (1000,)), (2, (77, 512))])
def test_stacked_decode_wrappers_match_plain(dev, B, lens):
    """flash_decode_at_layer over the 5-D cache at G 8 (Qwen2.5-VL's 16/2)
    and flash_decode over one layer of it, 2e-2 abs."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(9)
    L, S, Hq, Hkv, D = 3, 1024, 16, 2, 128
    q = _bf(g, B, 1, Hq, D)
    k, v = _bf(g, L, B, S, Hkv, D), _bf(g, L, B, S, Hkv, D)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    layer = torch.tensor(2, dtype=torch.int32, device=dev)
    got = fa.flash_decode_at_layer(q, k, v, layer, vl)
    ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                         layer, vl)
    one = fa.flash_decode(q, k[1].contiguous(), v[1].contiguous(), vl)
    ref1 = fa.flash_decode_plain(q.float(), k[1].float(), v[1].float(), vl)
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 2e-2
    assert (one.float() - ref1).abs().max().item() <= 2e-2


def test_prefill_kernel_at_group_8(dev):
    """Qwen2.5-VL-3B's text decoder: 16 query heads over 2 KV heads."""
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(10)
    q, k, v = _bf(g, 1, 256, 16, 128), _bf(g, 1, 256, 2, 128), \
        _bf(g, 1, 256, 2, 128)
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("D,hq,hkv,pos,window", [
    (128, 4, 2, 0, 256), (128, 4, 2, 100, 256), (64, 6, 2, 37, 256),
    (128, 8, 1, 200, 64)])
def test_fused_layer_kernel_matches_plain(dev, D, hq, hkv, pos, window):
    """The one-layer fused decode block against its plain version (f32 from
    the same bf16 inputs) at layers 0 and 1: x_out and the returned k/v
    rows within 2e-2 of max |ref| (the stack's bound: f32 summation order
    and the bf16 roundings it moves); the caches bit-unchanged."""
    from aha_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                               fused_decode_layer_plain)
    from aha_tpu_torch.ops.rope import rope_table

    g = torch.Generator(device=dev).manual_seed(11)
    L, H, NI, S = 2, 256, 512, 256
    lyr = _fused_layers(g, L, H, hq, hkv, D, NI)
    x = _bf(g, 1, 1, H)
    kc, vc = _bf(g, L, 1, S, hkv * D), _bf(g, L, 1, S, hkv * D)
    k0, v0 = kc.clone(), vc.clone()
    cos, sin = rope_table(D, S, 1e6, device=dev)
    cosr = torch.cat([cos[pos], cos[pos]])[None]
    sinr = torch.cat([sin[pos], sin[pos]])[None]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    for li in range(L):
        lt = torch.tensor(li, dtype=torch.int32, device=dev)
        n0 = fused_decode_layer.launches
        got = fused_decode_layer(x, lyr, lt, p, cosr, sinr, kc, vc, window,
                                 1e-6)
        ref = fused_decode_layer_plain(x, lyr, lt, p, cosr, sinr, kc, vc,
                                       window, 1e-6)
        torch.cuda.synchronize()
        assert fused_decode_layer.launches == n0 + 1
        assert got[1].shape == got[2].shape == (hkv, D)
        for a, b in zip(got, ref):
            top = b.float().abs().max().item()
            assert (a.float() - b.float()).abs().max().item() <= 2e-2 * top
    assert torch.equal(kc, k0) and torch.equal(vc, v0)


def _prefill_check(q, k, v, causal):
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert (got.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("S", [128, 192, 2048])
@pytest.mark.parametrize("D,G", [(128, 1), (64, 2), (128, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_prefill_redesign_strided_qkv(dev, S, D, G, causal):
    """The prefill kernel on q/k/v read in place as strided slices of one
    fused (B, S, (Hq + 2·Hkv)·D) projection, as the models hand them:
    2e-2 abs against the f32 plain version, Sq = Skv (a 192-row prompt
    leaves half a 128-row q tile)."""
    g = torch.Generator(device=dev).manual_seed(S + D + G + causal)
    Hkv = 2
    Hq = Hkv * G
    qkv = _bf(g, 2, S, (Hq + 2 * Hkv) * D)
    q = qkv[..., :Hq * D].view(2, S, Hq, D)
    k = qkv[..., Hq * D:(Hq + Hkv) * D].view(2, S, Hkv, D)
    v = qkv[..., (Hq + Hkv) * D:].view(2, S, Hkv, D)
    _prefill_check(q, k, v, causal)


def test_prefill_refuses_a_misaligned_view(dev):
    """The 16-byte row copies need 16-byte aligned bases and strides: a view
    4 elements into its storage raises instead of reading misaligned."""
    from aha_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(12)
    base = _bf(g, 1, 128, 4 * 64 + 4)
    q = base[..., 4:].view(1, 128, 4, 64)
    k, v = _bf(g, 1, 128, 2, 64), _bf(g, 1, 128, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_redesign_lengths_and_repeats(dev, G, D):
    """The one-launch decode at live lengths 1, 63, 64, 65, 1000 and S over
    a 2048-row cache: 2e-2 abs against the f32 plain version, and a second
    launch bit-equal to the first (the ticketed fold is deterministic)."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_flat, flash_decode_at_layer_flat_plain)

    g = torch.Generator(device=dev).manual_seed(13 + G + D)
    L, S, Hkv = 2, 2048, 2
    q = _bf(g, 1, 1, Hkv * G, D)
    k, v = _bf(g, L, 1, S, Hkv * D), _bf(g, L, 1, S, Hkv * D)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    for valid in (1, 63, 64, 65, 1000, S):
        vl = torch.tensor([valid], dtype=torch.int32, device=dev)
        got = flash_decode_at_layer_flat(q, k, v, layer, vl)
        again = flash_decode_at_layer_flat(q, k, v, layer, vl)
        ref = flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                               v.float(), layer, vl)
        torch.cuda.synchronize()
        assert (got.float() - ref).abs().max().item() <= 2e-2, valid
        assert torch.equal(got, again), valid


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 7, 8])
def test_decode_redesign_ragged_slots(dev, G):
    """B = 8 slots of a 4096-row cache with ragged lengths: within 2e-2 of
    the plain version, each slot bit-equal to a B = 1 launch on it alone,
    and a repeated launch bit-equal."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(14 + G)
    L, B, S, Hkv, D = 2, 8, 4096, 2, 128
    lens = [1, 63, 64, 65, 1000, 2047, 3000, 4096]
    q = _bf(g, B, 1, Hkv * G, D)
    k, v = _bf(g, L, B, S, Hkv * D), _bf(g, L, B, S, Hkv * D)
    layer = torch.tensor(0, dtype=torch.int32, device=dev)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = fa.flash_decode_at_layer_flat_batched(q, k, v, layer, vl)
    again = fa.flash_decode_at_layer_flat_batched(q, k, v, layer, vl)
    ref = fa.flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                              v.float(), layer, vl)
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 2e-2
    assert torch.equal(got, again)
    for b in range(B):
        one = fa.flash_decode_at_layer_flat(
            q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
            v[:, b:b + 1].contiguous(), layer, vl[b:b + 1].contiguous())
        assert torch.equal(one, got[b:b + 1]), b


# -- the H100 design studies (aha_tpu_torch/studies/) ------------------------


@pytest.mark.parametrize("bn,N", [(2048, 2 * 2048 + 136), (2048, 2 * 2048 + 40),
                                  (4096, 4096)])
def test_study_stream_sum_matches_plain(dev, bn, N):
    """The block sum's (1, 128) tile within 1e-5 of max |ref|, and its total
    of every element within 1e-5 of Σ|w|; a ragged last block (136 or 40
    columns) counts the columns it has."""
    from aha_tpu_torch.studies import exp_gemv as eg

    g = torch.Generator(device=dev).manual_seed(N)
    w, x = _bf(g, 256, N), _bf(g, 1, 256)
    n0 = eg.stream_sum.launches
    out, total = eg.stream_sum(x, w, bn)
    ref, ref_total = eg.stream_sum_plain(x, w, bn)
    torch.cuda.synchronize()
    assert eg.stream_sum.launches == n0 + 1
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    assert abs(float(total) - float(ref_total)) <= \
        1e-5 * float(w.float().abs().sum())


@pytest.mark.parametrize("bn", [256, 1024, 8192])
def test_study_gemv_m8_matches_plain(dev, bn):
    """The M = 8 GEMV at three block widths over a ragged N, within 1e-5 of
    max |ref|."""
    from aha_tpu_torch.studies import exp_gemv as eg

    g = torch.Generator(device=dev).manual_seed(bn)
    N = 3 * 1024 + 40
    w, xp = _bf(g, 512, N), _bf(g, 8, 512)
    got = eg.gemv_m8(xp, w, bn)
    ref = eg.gemv_m8_plain(xp, w)
    torch.cuda.synchronize()
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("bn", [256, 1024, 2048])
def test_study_gemv_argmax_matches_plain(dev, bn):
    """The argmax head over a ragged N: the maximum planted in the last
    columns is found, a tie goes to the smaller index, and random inputs
    agree with the plain version; head_once counts its own launches."""
    from aha_tpu_torch.studies import exp_gemv as eg

    g = torch.Generator(device=dev).manual_seed(bn + 1)
    K, N = 512, 2 * 2048 + 40
    w, x = _bf(g, K, N), _bf(g, 1, K)
    assert eg.argmax_agrees(eg.gemv_argmax(x, w, bn), x, w)
    planted = w.clone()
    planted[:, N - 3] = torch.sign(x[0]) * 4
    val, idx = eg.gemv_argmax(x, planted, bn)
    assert int(idx) == N - 3
    tie = planted.clone()
    tie[:, 5] = tie[:, N - 3]
    assert int(eg.gemv_argmax(x, tie, bn)[1]) == 5
    n0, n1 = eg.head_once.launches, eg.gemv_argmax.launches
    assert int(eg.head_once(x, tie)[1]) == 5
    torch.cuda.synchronize()
    assert (eg.head_once.launches, eg.gemv_argmax.launches) == (n0 + 1, n1)


@pytest.mark.parametrize("N", [2048 + 40, 4096])
def test_study_int4_kernels_bit_equal(dev, N):
    """i4_upcast, i4_tensorcore and i4_packed_k bit-equal to the plain
    version and to each other, a ragged last block included; a zero row
    (sx = 0) gives zeros."""
    from aha_tpu_torch.studies import exp_int4 as e4

    g = torch.Generator(device=dev).manual_seed(N)
    K = 256
    x = _bf(g, 8, K) * 3
    x[3] = 0
    w4 = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    words, packed = e4.pack_k8(w4), e4.pack_k(w4)
    ref = e4.int4_matmul_plain(x, w4)
    for fn, w in ((e4.i4_upcast, words), (e4.i4_tensorcore, words),
                  (e4.i4_packed_k, packed)):
        n0 = fn.launches
        got = fn(x, w)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        assert torch.equal(got, ref), fn.__name__
    assert torch.equal(ref[3], torch.zeros_like(ref[3]))


def test_study_fused_layer_matches_plain(dev):
    """Every (tile, NBUF) variant of the one-launch layer at the script's
    widths, two layers: within 2^-7 of max |ref| of the plain version,
    bit-equal on a repeat, the tickets left zero."""
    from aha_tpu_torch.studies import exp_fused_layer as efl

    ws, x = efl.weights(dev, n_layers=2, seed=3)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    ref = efl.fused_layer_stream_plain(x, *ws, layer)
    for tile, nbuf in efl.VARIANTS:
        got = efl.fused_layer_stream(x, *ws, layer, tile=tile, nbuf=nbuf)
        again = efl.fused_layer_stream(x, *ws, layer, tile=tile, nbuf=nbuf)
        torch.cuda.synchronize()
        rel = ((got.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel <= 2.0 ** -7, (tile, nbuf, rel)
        assert torch.equal(got, again), (tile, nbuf)
    from aha_tpu_torch.ops.flash_attention import ticket_counters

    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(ticket_counters(dev, stream, 16)[:16].abs().sum()) == 0


def _tower_segments(kind, real=4900, bucket=6400):
    """(n2)'s seg ids: a 70 x 70 patch grid (980 px) under the published
    tower's 112-pixel windows, in a 6400-row bucket, pad rows -1; cut to
    the first `bucket` rows when that is smaller."""
    import numpy as np

    from aha_tpu_torch.models.qwen2_5vl import VisionConfig, vision_geometry

    geo = vision_geometry([(1, 70, 70)], VisionConfig())
    seg = geo["window_seg" if kind == "window" else "full_seg"][:real]
    seg = np.concatenate([seg, -np.ones(max(bucket - len(seg), 0), np.int32)])
    return torch.from_numpy(seg[:bucket].astype(np.int32))


@pytest.mark.parametrize("kind", ["window", "full"])
@pytest.mark.parametrize("B,real,bucket", [
    (1, 4900, 6400),     # the tower's bucket: q tile 38 straddles real / pad
    (2, 4900, 6400),     # two batch rows share seg
    (1, 100, 100),       # S < 128: one ragged q and k tile
    (1, 300, 448),       # a short bucket with a pad tail
])
def test_segment_flash_at_the_tower_geometry(dev, kind, B, real, bucket):
    """The segment kernel at Qwen2.5-VL-3B's tower geometry (H 16, D 80,
    strided thirds of one fused qkv product, peaked q): every row within
    2e-2 of max |ref| of the f32 plain version (pad rows 0 in both), and a
    repeat bit-equal."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_attention_segmented, flash_attention_segmented_plain)

    H, D = 16, 80
    seg = _tower_segments(kind, real, bucket).to(dev)
    g = torch.Generator(device=dev).manual_seed(bucket + B)
    qkv = torch.randn((B, bucket, 3, H, D), generator=g, device=dev)
    qkv[:, :, 0] *= 4
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    got = flash_attention_segmented(q, k, v, seg)
    again = flash_attention_segmented(q, k, v, seg)
    ref = flash_attention_segmented_plain(q.float(), k.float(), v.float(),
                                          seg)
    torch.cuda.synchronize()
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2 * top
    assert torch.equal(got, again)
    assert torch.equal(got[:, seg < 0], torch.zeros_like(got[:, seg < 0]))


@pytest.mark.parametrize("pos", [0, 2047])
def test_fused_stack_at_qwen3_widths(dev, pos):
    """The bf16 stack at Qwen3-0.6B's widths (H 1024, NI 3072, 16/8 heads,
    D 128), 2 layers, a 2048-row cache: hidden state and the written rows
    within 2e-2 of max |ref| of the plain version, other rows untouched,
    two calls bit-equal (the same cache row rewritten the same)."""
    from aha_tpu_torch.ops.fused_layer import (fused_decode_stack,
                                               fused_decode_stack_plain)
    from aha_tpu_torch.ops.rope import rope_table

    g = torch.Generator(device=dev).manual_seed(30 + pos)
    L, H, NI, S, hq, hkv, D = 2, 1024, 3072, 2048, 16, 8, 128
    lyr = _fused_layers(g, L, H, hq, hkv, D, NI)
    x = _bf(g, 1, 1, H)
    kc, vc = _bf(g, L, 1, S, hkv * D), _bf(g, L, 1, S, hkv * D)
    cos, sin = rope_table(D, S, 1e6, device=dev)
    cosr = torch.cat([cos[pos], cos[pos]])[None]
    sinr = torch.cat([sin[pos], sin[pos]])[None]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kp, vp = kc.clone(), vc.clone()
    got = fused_decode_stack(x, lyr, p, cosr, sinr, kc, vc, 1e-6)
    again = fused_decode_stack(x, lyr, p, cosr, sinr, kc, vc, 1e-6)
    ref = fused_decode_stack_plain(x, lyr, p, cosr, sinr, kp, vp, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2 * top
    keep = torch.ones(S, dtype=torch.bool, device=dev)
    keep[pos] = False
    for new, want in ((kc, kp), (vc, vp)):
        rows = want[:, 0, pos].float()
        assert (new[:, 0, pos].float() - rows).abs().max().item() <= \
            2e-2 * rows.abs().max().item()
        assert torch.equal(new[:, 0, keep], want[:, 0, keep])


# -- the one-launch int8 decode and the streamed quantized stack ---------------

Q8_TOL = {False: 6e-3, True: 8e-2}      # chip_smoke.py's TOL_Q8_REL


def _q8_check(got, ref, valid, mxu):
    """A slot with live rows within Q8_TOL of max |ref| of the plain
    version; a slot with none is 0 (the plain version averages its masked
    rows)."""
    if valid == 0:
        assert torch.equal(got, torch.zeros_like(got))
        return
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= Q8_TOL[mxu], (valid, mxu, rel)


def _tickets_zero(dev):
    from aha_tpu_torch.ops import flash_attention as fa, kernels

    t = fa.ticket_counters(dev, kernels.stream_handle(
        torch.empty(1, device=dev)), 1)
    return int(t.abs().sum()) == 0


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_q8_decode_redesign_lengths_and_repeats(dev, G, D):
    """The one-launch int8 decode, both variants, at live lengths 0, 1, 63,
    64, 65, 1000 and S of a 2048-row cache: within TOL_Q8_REL of max |ref|
    of the plain version, a second launch bit-equal to the first, and the
    ticket counters left at zero."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_q8, flash_decode_at_layer_q8_plain)

    g = torch.Generator(device=dev).manual_seed(40 + G + D)
    L, S, Hkv = 2, 2048, 2
    q, k, v, ks, vs = _q8_inputs(g, dev, L, 1, S, Hkv * G, Hkv, D)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    for valid in (0, 1, 63, 64, 65, 1000, S):
        vl = torch.tensor([valid], dtype=torch.int32, device=dev)
        ref = flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, layer,
                                             vl)
        for mxu in (False, True):
            got = flash_decode_at_layer_q8(q, k, v, ks, vs, layer, vl,
                                           mxu=mxu)
            again = flash_decode_at_layer_q8(q, k, v, ks, vs, layer, vl,
                                             mxu=mxu)
            torch.cuda.synchronize()
            _q8_check(got, ref, valid, mxu)
            assert torch.equal(got, again), (valid, mxu)
    assert _tickets_zero(dev)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("D,G", [(128, 1), (128, 2), (64, 4), (128, 7),
                                 (128, 8)])
def test_q8_decode_redesign_ragged_slots(dev, mxu, D, G):
    """B = 8 slots of a 4096-row int8 cache with ragged lengths (0, 1, 63,
    64, 65, 1000, 3000, the full cache): each slot within TOL_Q8_REL of the
    plain version and bit-equal to a B = 1 launch on that slot alone; a
    repeat bit-equal; the ticket counters left at zero."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(50 + D + G)
    L, B, S, Hkv = 2, 8, 4096, 2
    lens = [0, 1, 63, 64, 65, 1000, 3000, 4096]
    q, k, v, ks, vs = _q8_inputs(g, dev, L, B, S, Hkv * G, Hkv, D)
    layer = torch.tensor(0, dtype=torch.int32, device=dev)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = fa.flash_decode_at_layer_q8_batched(q, k, v, ks, vs, layer, vl,
                                              mxu=mxu)
    again = fa.flash_decode_at_layer_q8_batched(q, k, v, ks, vs, layer, vl,
                                                mxu=mxu)
    ref = fa.flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, layer,
                                            vl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for b in range(B):
        _q8_check(got[b:b + 1], ref[b:b + 1], lens[b], mxu)
        one = fa.flash_decode_at_layer_q8(
            q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
            v[:, b:b + 1].contiguous(), ks[:, b:b + 1].contiguous(),
            vs[:, b:b + 1].contiguous(), layer, vl[b:b + 1].contiguous(),
            mxu=mxu)
        assert torch.equal(one, got[b:b + 1]), b
    assert _tickets_zero(dev)


@pytest.mark.parametrize("grids", [("q8",) * 4, ("q4",) * 4,
                                   ("q4", "q4", "q4", "q8")])
def test_fused_stack_q8_deep_repeat(dev, grids):
    """The streamed quantized stack over Qwen3-0.6B's 28 layers (its
    widths, seeded weights as the engine makes them, a 2048-row cache, pos
    1000): two calls bit-equal (the partials summed in plan order, the
    attention fold in split order), the hidden state within chip_smoke's
    deep tolerance of the plain version (5e-2 of max |ref| on the int8
    grid, 1.2e-1 with a 4-bit one), the ticket counters left at zero."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops.fused_layer import (fused_decode_stack_q8,
                                               fused_decode_stack_q8_plain)

    cfg = Qwen3Config()
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device=dev).manual_seed(60)
    lyr = _quant_layers(fuse_decode_params(
        model.init_random(g, dtype=torch.bfloat16))["layers"], grids)
    L, S, pos = cfg.num_hidden_layers, 2048, 1000
    HD = cfg.num_key_value_heads * cfg.head_dim
    x = _bf(g, 1, 1, cfg.hidden_size)
    kc, vc = _bf(g, L, 1, S, HD), _bf(g, L, 1, S, HD)
    cosr = torch.cat([model.cos[pos], model.cos[pos]])[None]
    sinr = torch.cat([model.sin[pos], model.sin[pos]])[None]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kp, vp = kc.clone(), vc.clone()
    eps = cfg.rms_norm_eps
    got = fused_decode_stack_q8(x, lyr, p, cosr, sinr, kc, vc, eps)
    again = fused_decode_stack_q8(x, lyr, p, cosr, sinr, kc, vc, eps)
    ref = fused_decode_stack_q8_plain(x, lyr, p, cosr, sinr, kp, vp, eps)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 1.2e-1 if "q4" in grids else 5e-2
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol * top
    assert _tickets_zero(dev)


# -- the tensor-core GGUF kernels (quant_mma.cuh) ------------------------------

#: Qwen3-0.6B's decode projections (in, out), as chip_smoke.PROJECTIONS
QWEN3_PROJECTIONS = {"qkv": (1024, 4096), "o": (2048, 1024),
                     "gateup": (1024, 6144), "down": (3072, 1024)}


def _qmm(grid):
    from aha_tpu_torch.ops import quant_matmul as qm

    if grid == "q4":
        return qm.quant_matmul_q4, qm.quant_matmul_q4_plain, ("q4", "s4", "b4")
    return qm.quant_matmul, qm.quant_matmul_plain, ("qt", "st")


def _fault(grid, args):
    """Zeroed scales (q8) or a dropped xsum·b term (zeroed mins, q4)."""
    i = 2 if grid == "q4" else 1
    return [torch.zeros_like(a) if j == i else a for j, a in enumerate(args)]


def _check_qmm(dev, grid, p, x):
    """Kernel within 5e-3 of max |ref| of the f32 plain version, bit-equal
    on a repeat; the fault off by more than the bound.  Returns the
    kernel's output."""
    fn, plain, keys = _qmm(grid)
    args = [p[k] for k in keys]
    got = fn(x, *args)
    again = fn(x, *args)
    ref = plain(x.float(), *args)
    bad = plain(x.float(), *_fault(grid, args))
    torch.cuda.synchronize()
    top = ref.abs().max().item()
    assert torch.equal(got, again)
    assert (got.float() - ref).abs().max().item() <= 5e-3 * top
    assert (bad - ref).abs().max().item() > 5e-3 * top
    return got


@pytest.mark.parametrize("grid", ["q8", "q4"])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 37, 64])
@pytest.mark.parametrize("K,N", [(1000, 1001), (128, 1001)])
def test_quant_matmul_mma_ragged(dev, grid, M, K, N):
    """The tensor-core matmul at every pass shape (1–8 rows in one n-tile's
    upper half, 9–16 in both halves, 17 and up in passes), x narrower than
    Kp (K 1000), one group a column (Kp 128) and a ragged last unit (N
    1001): within the bound, bit-equal on a repeat, the fault rejected."""
    g = torch.Generator(device=dev).manual_seed(80 + M)
    p = _packed(g, N, K, grid, 0.01 if grid == "q4" else 0.0)
    _check_qmm(dev, grid, p, _bf(g, M, K))


@pytest.mark.parametrize("grid", ["q8", "q4"])
@pytest.mark.parametrize("proj", list(QWEN3_PROJECTIONS) + ["head"])
def test_quant_matmul_mma_qwen3_shapes(dev, grid, proj):
    """Qwen3-0.6B's four projections at M 1 and 8 (o and down split their
    K over a cluster) and the head logits of an 8-slot step (K 1024 x N
    151936, M 8)."""
    K, N = QWEN3_PROJECTIONS.get(proj, (1024, 151936))
    g = torch.Generator(device=dev).manual_seed(90)
    p = _packed(g, N, K, grid, 0.01 if grid == "q4" else 0.0)
    for M in ((8,) if proj == "head" else (1, 8)):
        _check_qmm(dev, grid, p, _bf(g, M, K))


@pytest.mark.parametrize("grid", ["q8", "q4"])
@pytest.mark.parametrize("K,N", [(1000, 1001), (2048, 1024), (1024, 4096)])
def test_quant_matmul_rows_do_not_depend_on_m(dev, grid, K, N):
    """Row r of an M 8 (and an M 37) launch is bit-equal to an M 1 launch
    of row r alone: the plan does not depend on M and each row's sums run
    in a fixed order."""
    fn, _, keys = _qmm(grid)
    g = torch.Generator(device=dev).manual_seed(91)
    p = _packed(g, N, K, grid, 0.01 if grid == "q4" else 0.0)
    args = [p[k] for k in keys]
    x = _bf(g, 37, K)
    for M in (8, 37):
        many = fn(x[:M].contiguous(), *args)
        for r in range(0, M, 5):
            assert torch.equal(many[r], fn(x[r:r + 1].contiguous(), *args)[0])


def _swiglu_weights(g, H, inter, gu_fmt, dn_fmt):
    gu = {k: torch.cat([a, b], 0) for (k, a), b in zip(
        _packed(g, inter, H, gu_fmt).items(),
        _packed(g, inter, H, gu_fmt, 0.01).values())}
    return gu, _packed(g, H, inter, dn_fmt)


def _check_swiglu(dev, gu, dn, x):
    """Within 1e-2 of max |ref| (test_quant_swiglu_kernel_matches_plain
    gives the reason), bit-equal on a repeat, zeroed down scales rejected.
    Returns the kernel's (M, Hout) output."""
    from aha_tpu_torch.ops import quant_matmul as qm

    M, H = x.shape
    got = qm.quant_swiglu(gu, dn, x)
    again = qm.quant_swiglu(gu, dn, x)
    ref = qm.quant_swiglu_plain(gu, dn, x.float())
    bad = qm.quant_swiglu_plain(
        gu, {k: torch.zeros_like(v) if k in ("st", "s4") else v
             for k, v in dn.items()}, x.float())
    torch.cuda.synchronize()
    top = ref.abs().max().item()
    assert torch.equal(got, again)
    assert (got.float() - ref).abs().max().item() <= 1e-2 * top
    assert (bad - ref).abs().max().item() > 1e-2 * top
    return got


@pytest.mark.parametrize("gu_fmt,dn_fmt", [("q8", "q8"), ("q4", "q4"),
                                           ("q4", "q8"), ("q8", "q4")])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 37, 64])
@pytest.mark.parametrize("H,K,inter", [(384, 384, 512), (128, 100, 128)])
def test_quant_swiglu_mma_shapes(dev, gu_fmt, dn_fmt, M, H, K, inter):
    """The one-launch MLP on the tensor-core dot in all four grid pairs at
    every pass shape, with one group a column (H 128, I 128) and x
    narrower than the gate|up grid's Kp (K 100 of 128)."""
    g = torch.Generator(device=dev).manual_seed(100 + M)
    gu, dn = _swiglu_weights(g, H, inter, gu_fmt, dn_fmt)
    _check_swiglu(dev, gu, dn, _bf(g, M, K) * 4)


@pytest.mark.parametrize("grid", ["q8", "q4"])
def test_quant_swiglu_mma_qwen3_width_rows(dev, grid):
    """Qwen3-0.6B's MLP (H 1024, I 3072) at M 1 and 8; row r of the M 8
    launch bit-equal to an M 1 launch of row r alone."""
    from aha_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(110)
    gu, dn = _swiglu_weights(g, 1024, 3072, grid, grid)
    x = _bf(g, 8, 1024) * 4
    many = _check_swiglu(dev, gu, dn, x)
    for r in range(8):
        one = _check_swiglu(dev, gu, dn, x[r:r + 1].contiguous())
        assert torch.equal(many[r], one[0])
    assert qm.quant_swiglu.launches > 0
