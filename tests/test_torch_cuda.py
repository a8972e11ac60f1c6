"""Each CUDA kernel against its plain PyTorch version on the card, at small
shapes (bf16 inputs; attention tolerance 2e-2 abs against the f32 plain
version; the GGUF-grid kernels relative to max |ref|, each stated at its
test), and each engine path's decode blocks replayed from captured CUDA
graphs against the eager loop (`-k graphs`).  Marked `cuda`: skipped
where torch sees no CUDA device.  Run on a card with `python -m pytest
tests/test_torch_cuda.py -m cuda`."""

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
    (1024, 4, 4, 72, 200),      # Qwen3-VL's D 72, a pad tail
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


def _frames_seg(frames: int, rows: int, bucket: int) -> torch.Tensor:
    """One segment a frame of `rows` patches, then pad rows of -1 up to
    `bucket` (Qwen3-VL's per-frame blocks)."""
    import numpy as np

    seg = np.repeat(np.arange(frames, dtype=np.int32), rows)
    return torch.from_numpy(np.concatenate(
        [seg, -np.ones(bucket - len(seg), np.int32)]))


@pytest.mark.parametrize("frames,rows,bucket", [
    (1, 4096, 4096),     # a 1024 x 1024 image: one segment, no pad
    (4, 784, 4096),      # 8 frames of 448 x 448: 4 segments + 960 pad rows
    (2, 196, 512),       # a short bucket with a ragged tail
])
def test_segment_flash_at_d72(dev, frames, rows, bucket):
    """The D 72 instance at Qwen3-VL-8B's tower (H 16), q/k/v the strided
    thirds of one fused qkv product whose heads differ: within 2e-2 of max
    |ref| of the f32 plain version, a repeat bit-equal, pad rows 0, and the
    kernel launched.  A tail box read past column 72 would add head h + 1's
    first 8 columns (other random values) to every score."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_attention_segmented, flash_attention_segmented_plain)

    H, D = 16, 72
    seg = _frames_seg(frames, rows, bucket).to(dev)
    g = torch.Generator(device=dev).manual_seed(bucket + frames)
    qkv = torch.randn((1, bucket, 3, H, D), generator=g, device=dev)
    qkv[:, :, 0] *= 4
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    n0 = flash_attention_segmented.launches
    got = flash_attention_segmented(q, k, v, seg)
    again = flash_attention_segmented(q, k, v, seg)
    ref = flash_attention_segmented_plain(q.float(), k.float(), v.float(),
                                          seg)
    torch.cuda.synchronize()
    assert flash_attention_segmented.launches == n0 + 2
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2 * top
    assert torch.equal(got, again)
    assert torch.equal(got[:, seg < 0], torch.zeros_like(got[:, seg < 0]))


def test_segment_flash_refuses_other_head_dims(dev):
    """A head the kernel is not built for raises on the card; nothing
    falls back to sdpa or the plain version."""
    from aha_tpu_torch.ops.flash_attention import flash_attention_segmented

    g = torch.Generator(device=dev).manual_seed(1)
    q = _bf(g, 1, 256, 2, 96)
    seg = torch.zeros(256, dtype=torch.int32, device=dev)
    n0 = flash_attention_segmented.launches
    with pytest.raises(ValueError, match="D in"):
        flash_attention_segmented(q, q, q, seg)
    assert flash_attention_segmented.launches == n0


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


def test_stacked_decode_at_minicpm_slots(dev):
    """Row 8 as MiniCPM4-0.5B's 8-slot step reads it: the 5-D cache at D 64,
    16 query heads over 2, ragged per-slot lengths (a parked slot of 1,
    the split boundaries, the whole cache); within 2e-2 of the plain
    version, and each slot bit-equal to a B = 1 launch on that slot."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(15)
    L, B, S, Hq, Hkv, D = 3, 8, 1024, 16, 2, 64
    lens = (1, 31, 32, 33, 300, 777, 1000, 1024)
    q = _bf(g, B, 1, Hq, D)
    k, v = _bf(g, L, B, S, Hkv, D), _bf(g, L, B, S, Hkv, D)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    for li in (0, L - 1):
        layer = torch.tensor(li, dtype=torch.int32, device=dev)
        got = fa.flash_decode_at_layer(q, k, v, layer, vl)
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             layer, vl)
        assert (got.float() - ref).abs().max().item() <= 2e-2
        for b in range(B):
            one = fa.flash_decode_at_layer(
                q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                v[:, b:b + 1].contiguous(), layer, vl[b:b + 1].contiguous())
            assert torch.equal(one, got[b:b + 1]), f"slot {b}"


@pytest.mark.parametrize("Hkv,D", [(8, 128), (2, 64)])
def test_prefill_kernel_rows_equal_batch_1(dev, Hkv, D):
    """Row 1 at B = 4 (an embedding group's rows): within 2e-2 of the
    plain version, and each row bit-equal to a B = 1 launch on it."""
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(16)
    B, S, Hq = 4, 256, 16
    q, k, v = _bf(g, B, S, Hq, D), _bf(g, B, S, Hkv, D), _bf(g, B, S, Hkv, D)
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 2e-2
    for b in range(B):
        one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1])
        assert torch.equal(one, got[b:b + 1]), f"row {b}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,G", [(192, 2), (256, 2), (128, 16), (256, 16),
                                 (192, 16)])
def test_attention_kernels_at_wide_heads_and_groups(dev, D, G, causal):
    """Prefill and decode (flat, batched, stacked, unstacked, int8 both
    variants) through the routers at head widths 192 and 256 and a group
    of 16: each kernel launches once a call and agrees with its plain
    version — prefill and bf16 decode within 2e-2 abs of the f32 plain
    version, int8 decode within 6e-3 (cast) and 8e-2 (all-int8) of max
    |ref|, as test_q8_decode_kernel_matches_plain holds them.  The prefill
    prompt is 320 rows: past D 128 the kernel's K/V tiles are 64 rows, so
    the causal diagonal falls inside a 128-row q tile's second K tile."""
    from aha_tpu_torch.ops import attention as at
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(D + G + causal)
    Hkv, S, L = 2, 320, 2
    q, k, v = _bf(g, 1, S, Hkv * G, D), _bf(g, 1, S, Hkv, D), \
        _bf(g, 1, S, Hkv, D)
    n0 = fa.flash_attention.launches
    got = at.attention_prefill(q, k, v, causal=causal)
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    assert (got.float() - ref).abs().max().item() <= 2e-2
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    for B, lens in ((1, [200]), (2, [1, 320])):
        q1 = _bf(g, B, 1, Hkv * G, D)
        kf, vf = _bf(g, L, B, S, Hkv * D), _bf(g, L, B, S, Hkv * D)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref = fa.flash_decode_at_layer_flat_plain(q1.float(), kf.float(),
                                                  vf.float(), layer, vl)
        k5, v5 = kf.view(L, B, S, Hkv, D), vf.view(L, B, S, Hkv, D)
        flat = (fa.flash_decode_at_layer_flat_batched if B > 1
                else fa.flash_decode_at_layer_flat)
        for fn, call in (
                (flat, lambda: at.attention_decode_at(q1, kf, vf, layer, vl)),
                (fa.flash_decode_at_layer,
                 lambda: at.attention_decode_at(q1, k5, v5, layer, vl)),
                (fa.flash_decode,
                 lambda: at.attention_decode(q1, k5[1], v5[1], vl - 1))):
            n0 = fn.launches
            out = call()
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1, fn.__name__
            assert (out.float() - ref).abs().max().item() <= 2e-2, fn.__name__
        k8, ks = at.quantize_kv_rows(k5)
        v8, vs = at.quantize_kv_rows(v5)
        k8, v8 = k8.view(L, B, S, Hkv * D), v8.view(L, B, S, Hkv * D)
        ref = fa.flash_decode_at_layer_q8_plain(q1.float(), k8, v8, ks, vs,
                                                layer, vl)
        fn = (fa.flash_decode_at_layer_q8_batched if B > 1
              else fa.flash_decode_at_layer_q8)
        for mxu, tol in ((False, 6e-3), (True, 8e-2)):
            n0 = fn.launches
            out = fn(q1, k8, v8, ks, vs, layer, vl, mxu=mxu)
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1
            rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            assert rel <= tol, (mxu, rel)
        assert torch.equal(at.attention_decode_at_q8(q1, k8, v8, ks, vs, layer,
                                                     vl),
                           fn(q1, k8, v8, ks, vs, layer, vl))


def test_attention_wrappers_raise_past_the_kernels_limits(dev):
    """D 320 is past every attention kernel's head widths: on the card the
    routers hand it to the wrappers, as the reference's gates hand it to
    its TPU kernels, and the wrappers raise rather than run a plain form."""
    from aha_tpu_torch.ops import attention as at

    D, Hkv = 320, 2
    q = torch.zeros(1, 128, 4, D, dtype=torch.bfloat16, device=dev)
    kv = torch.zeros(1, 128, Hkv, D, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        at.attention_prefill(q, kv, kv)
    q1 = torch.zeros(1, 1, 4, D, dtype=torch.bfloat16, device=dev)
    cache = torch.zeros(1, 1, 64, Hkv * D, dtype=torch.bfloat16, device=dev)
    layer = torch.zeros((), dtype=torch.int32, device=dev)
    vl = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        at.attention_decode_at(q1, cache, cache, layer, vl)
    c8 = torch.zeros(1, 1, 64, Hkv * D, dtype=torch.int8, device=dev)
    sc = torch.ones(1, 1, 64, Hkv, device=dev)
    with pytest.raises(ValueError):
        at.attention_decode_at_q8(q1, c8, c8, sc, sc, layer, vl)


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
    n0 = eg.gemv_m8.launches
    got = eg.gemv_m8(xp, w, bn)
    ref = eg.gemv_m8_plain(xp, w)
    torch.cuda.synchronize()
    assert eg.gemv_m8.launches == n0 + 1
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


# the head's width and a ragged one (not a whole number of 128-column tiles)
GEMV_NS = [151936, 2 * 2048 + 40]


@pytest.mark.parametrize("N", GEMV_NS)
def test_study_gemv_every_bn(dev, N):
    """Both GEMV kernels at every bn of the sweep, K 1024: the M = 8 output
    within 1e-5 of max |ref| and bit-equal on a repeat, the argmax agreeing
    with the plain version and its index the same at every bn; each call
    counts one launch of its own wrapper."""
    from aha_tpu_torch.studies import exp_gemv as eg

    g = torch.Generator(device=dev).manual_seed(N + 3)
    w, xp = _bf(g, 1024, N), _bf(g, 8, 1024)
    x = xp[:1].contiguous()
    ref = eg.gemv_m8_plain(xp, w)
    idx = set()
    for bn in eg.GEMV_BNS:
        n0, n1 = eg.gemv_m8.launches, eg.gemv_argmax.launches
        got = eg.gemv_m8(xp, w, bn)
        assert torch.equal(got, eg.gemv_m8(xp, w, bn))
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5
        am = eg.gemv_argmax(x, w, bn)
        torch.cuda.synchronize()
        assert eg.argmax_agrees(am, x, w)
        idx.add(int(am[1]))
        assert (eg.gemv_m8.launches, eg.gemv_argmax.launches) == (n0 + 2,
                                                                  n1 + 1)
    assert len(idx) == 1


@pytest.mark.parametrize("N", [1000] + GEMV_NS)
def test_study_gemv_argmax_masks_the_zero_fill(dev, N):
    """Every logit negative, the largest in the last column: TMA fills the
    columns past N with zeros, whose logit 0 would win unless they are
    masked by index.  The planted logit is exact (K · -2^-10 = -1)."""
    from aha_tpu_torch.studies import exp_gemv as eg

    g = torch.Generator(device=dev).manual_seed(N)
    K = 1024
    w = -(torch.rand((K, N), generator=g, device=dev) + 0.01).to(
        torch.bfloat16)
    w[:, N - 1] = -2.0 ** -10
    x = torch.ones((1, K), dtype=torch.bfloat16, device=dev)
    for bn in eg.GEMV_BNS:
        val, i = eg.gemv_argmax(x, w, bn)
        assert (int(i), float(val)) == (N - 1, -1.0)
    val, i = eg.head_once(x, w)
    assert (int(i), float(val)) == (N - 1, -1.0)
    got = eg.gemv_m8(x.expand(8, K).contiguous(), w)
    torch.cuda.synchronize()
    assert got.shape == (8, N) and (got[:, N - 1] == -1.0).all()


def test_study_gemv_argmax_ties_go_to_the_smaller_index(dev):
    """Equal maxima (exact: K ones times 1.0) across two blocks' partials
    (the larger index in block 0's second tile, the smaller in block 1's
    first), across a tile boundary, across warpgroups of one tile and
    across the two rows a thread holds: the smallest index, at every bn."""
    from aha_tpu_torch.studies import exp_gemv as eg

    N, K = 151936, 1024
    tile, grid = eg.gemv_plan(N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert grid >= 8
    g = torch.Generator(device=dev).manual_seed(5)
    base = (_bf(g, K, N) * 0.01)
    x = torch.ones((1, K), dtype=torch.bfloat16, device=dev)
    cases = [((grid * tile + 3, tile + 7), tile + 7),
             ((6 * tile, 6 * tile - 1), 6 * tile - 1),
             ((64 + 2, 60), 60),
             ((7 * tile + 8 + 1, 7 * tile + 1), 7 * tile + 1)]
    for cols, want in cases:
        w = base.clone()
        w[:, list(cols)] = 1.0
        for bn in eg.GEMV_BNS:
            val, i = eg.gemv_argmax(x, w, bn)
            assert (int(i), float(val)) == (want, float(K)), (cols, bn)


@pytest.mark.parametrize("K", [32, 1024])
@pytest.mark.parametrize("N", [8, 24, 2048 + 40, 4096, 132 * 128,
                               132 * 256])
def test_study_int4_kernels_bit_equal(dev, monkeypatch, N, K):
    """i4_upcast, i4_tensorcore and i4_packed_k bit-equal to the plain
    version and to each other, a ragged last block included (i4_packed_k:
    N % 16 == 8, whose packed rows are no multiple of 16 bytes; K/4 rows
    short of one TMA box at K 32; packed_k_plan's tiles of 128 columns up
    to N 132·128 and of 256 at N 132·256 on 132 SMs); a zero row (sx = 0)
    gives zeros.  i4_packed_k and i4_upcast (K/8 rows short of one box at
    K 32; boxes wholly past N at N 8 and 24) also on their plans for 114
    SMs and for one (a block walking every tile, its ring running across
    them), the SM count they plan for faked."""
    from aha_tpu_torch.studies import exp_int4 as e4

    g = torch.Generator(device=dev).manual_seed(N + K)
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
    for sms in (114, 1):
        monkeypatch.setattr(e4, "sm_count", lambda device, n=sms: n)
        assert torch.equal(e4.i4_packed_k(x, packed), ref), sms
        assert torch.equal(e4.i4_upcast(x, words), ref), sms
    assert torch.equal(ref[3], torch.zeros_like(ref[3]))


@pytest.mark.parametrize("N", [4096, 132 * 256])
def test_study_int4_packed_k_at_its_longest_k(dev, N):
    """i4_packed_k at K = PACKED_K_MAX (9,984), at tiles of 128 and of 256
    columns (the larger stage, the tighter shared memory): bit-equal to the
    plain version; one step of 32 past it is refused."""
    from aha_tpu_torch.studies import exp_int4 as e4

    K = e4.PACKED_K_MAX
    g = torch.Generator(device=dev).manual_seed(N)
    x = _bf(g, 8, K) * 3
    w4 = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    got = e4.i4_packed_k(x, e4.pack_k(w4))
    assert torch.equal(got, e4.int4_matmul_plain(x, w4))
    w4 = torch.zeros((K + 32, N), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):
        e4.i4_packed_k(_bf(g, 8, K + 32), e4.pack_k(w4))


@pytest.mark.parametrize("N", [4096, 132 * 256])
def test_study_int4_upcast_at_its_longest_k(dev, N):
    """i4_upcast at K = UPCAST_K_MAX (12,288), at tiles of 128 and of 256
    columns (the larger stage, the tighter shared memory; past K = 1024·H
    a thread's pieces of x beyond those it holds are read again from L2):
    bit-equal to the plain version; one step of 32 past it is refused."""
    from aha_tpu_torch.studies import exp_int4 as e4

    K = e4.UPCAST_K_MAX
    g = torch.Generator(device=dev).manual_seed(N + 1)
    x = _bf(g, 8, K) * 3
    w4 = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    got = e4.i4_upcast(x, e4.pack_k8(w4))
    assert torch.equal(got, e4.int4_matmul_plain(x, w4))
    w4 = torch.zeros((K + 32, N), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):
        e4.i4_upcast(_bf(g, 8, K + 32), e4.pack_k8(w4))


def test_study_fused_layer_matches_plain(dev, monkeypatch):
    """Every (box rows, ring depth) variant of the one-launch layer at the
    script's widths, two layers, and the default variant on the plans for
    114 SMs and for one (the SM count it plans for faked; the kernel takes
    its units from the plan's table): within 2^-7 of max |ref| of the plain version, bit-equal on a
    repeat, the tickets left zero."""
    from aha_tpu_torch.studies import exp_fused_layer as efl

    ws, x = efl.weights(dev, n_layers=2, seed=3)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    ref = efl.fused_layer_stream_plain(x, *ws, layer)
    runs = [(rows, depth, None) for rows, depth in efl.VARIANTS]
    runs += [(*efl.VARIANTS[0], sms) for sms in (114, 1)]
    card = efl.sm_count(dev)
    for rows, depth, sms in runs:
        monkeypatch.setattr(efl, "sm_count", lambda device, n=sms or card: n)
        got = efl.fused_layer_stream(x, *ws, layer, rows=rows, depth=depth)
        again = efl.fused_layer_stream(x, *ws, layer, rows=rows, depth=depth)
        torch.cuda.synchronize()
        rel = ((got.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel <= 2.0 ** -7, (rows, depth, sms, rel)
        assert torch.equal(got, again), (rows, depth, sms)
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


@pytest.mark.parametrize("grid", ["q8", "q4"])
@pytest.mark.parametrize("M", [5, 9])
def test_quant_kernels_at_verify_rows(dev, grid, M):
    """A speculative round's verify pass at 4 and 8 drafts (M = 5 and 9
    rows, the second in two pass halves): Qwen3-0.6B's four projections,
    the head (K 1024 x N 151936) and the MLP (H 1024, I 3072) at M rows,
    within the bounds the M = 8 tests hold; each row bit-equal to an M = 1
    launch of that row alone."""
    fn, _, keys = _qmm(grid)
    g = torch.Generator(device=dev).manual_seed(120 + M)
    for proj, (K, N) in {**QWEN3_PROJECTIONS, "head": (1024, 151936)}.items():
        p = _packed(g, N, K, grid, 0.01 if grid == "q4" else 0.0)
        x = _bf(g, M, K)
        many = _check_qmm(dev, grid, p, x)
        args = [p[k] for k in keys]
        for r in range(M):
            assert torch.equal(many[r], fn(x[r:r + 1].contiguous(), *args)[0])
    gu, dn = _swiglu_weights(g, 1024, 3072, grid, grid)
    x = _bf(g, M, 1024) * 4
    many = _check_swiglu(dev, gu, dn, x)
    for r in range(M):
        one = _check_swiglu(dev, gu, dn, x[r:r + 1].contiguous())
        assert torch.equal(many[r], one[0])


# -- captured decode blocks (core/graphs.py) ----------------------------------
#
# Each engine path twice on the card, once through an engine that replays
# captured graphs (the default) and once through one built with
# cuda_graphs=False: the same tokens bit for bit (greedy, and sampled from
# the same seed), and every kernel's launch count the same.

_GREEDY = dict()
_SAMPLED = dict(temperature=0.7, top_k=20, top_p=0.9, repeat_penalty=1.1,
                seed=1234)


def _launches() -> dict:
    from aha_tpu_torch.core.graphs import counted_wrappers

    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def _counted(fn):
    """fn's result and the launches it made, by wrapper (those > 0)."""
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    after = _launches()
    return out, {k: n - before.get(k, 0) for k, n in after.items()
                 if n != before.get(k, 0)}


def _qwen3_tiny(dev, grid=None):
    """Qwen3 at a narrow width the fused stacks take (H 256, 4/2 heads of
    128, I 512, 2 layers, vocab 512), seeded bf16; packed on a GGUF grid
    with `grid`."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            pack_params)

    cfg = Qwen3Config(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=128)
    model = Qwen3Model(cfg, max_rope_len=8192, device=dev)
    params = model.init_random(torch.Generator(device=dev).manual_seed(7),
                               dtype=torch.bfloat16, scale=0.05)
    return model, (pack_params(params, grid) if grid else params)


def _text_requests(eng, prompts, **kw):
    from aha_tpu_torch.core.sampling import SamplingConfig

    return [eng.generate_tokens(ids, SamplingConfig(**cfg), n, **kw)
            for ids, cfg, n in prompts]


def _prompt_ids(n, seed, vocab=512):
    import numpy as np

    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


@pytest.mark.parametrize("path", ["bf16-stack", "per-op-past-2048",
                                  "int8-cache", "q8-stack", "q4-stack",
                                  "q8-per-op", "q4-per-op"])
def test_text_engine_graphs_equal_eager(dev, path, monkeypatch):
    """TextEngine's decode blocks replayed from graphs against the eager
    loop on each Qwen3 path: greedy and sampled tokens bit-equal, the same
    launches of every kernel, and a second request on the same keys
    capturing nothing new."""
    from aha_tpu_torch.core.engine import TextEngine

    grid = path[:2] if path[:2] in ("q8", "q4") else None
    if path.endswith("per-op"):
        monkeypatch.setenv("AHA_FUSED_LAYER", "0")
    model, params = _qwen3_tiny(dev, grid)
    kw = dict(cache_dtype=torch.int8) if path == "int8-cache" else {}
    n_prompt = 2100 if path == "per-op-past-2048" else 40
    # 40 tokens: two whole blocks, an overshooting block; the sampled
    # request's bucket-end tail (cache 256 - 220 prompt rows) runs n = 1
    reqs = [(_prompt_ids(n_prompt, 1), _GREEDY, 40),
            (_prompt_ids(220, 2), _SAMPLED, 60)]
    engines = {g: TextEngine(model, params, eos_token_ids=[],
                             max_seq_len=8192, cuda_graphs=g, **kw)
               for g in (True, False)}
    got = {g: _counted(lambda: _text_requests(e, reqs))
           for g, e in engines.items()}
    assert got[True][0] == got[False][0]
    assert got[True][1] == got[False][1]
    stack = {"bf16-stack": "fused_decode_stack", "q8-stack":
             "fused_decode_stack_q8", "q4-stack": "fused_decode_stack_q8"}
    if path in stack:
        assert got[True][1][stack[path]] > 0
    graphs = engines[True].graphs
    n_graphs = graphs.stats()["graphs"]
    assert n_graphs >= 3            # greedy 16, sampled 16, sampled 1
    again = _counted(lambda: _text_requests(engines[True], reqs))
    assert again == got[True] and graphs.stats()["graphs"] == n_graphs
    assert engines[False].graphs is None


@pytest.mark.parametrize("path", ["bf16", "int8-cache", "q4"])
def test_text_engine_spec_graphs_equal_eager(dev, path):
    """Speculative rounds replayed from graphs (keys ("spec", G1, R))
    against the same rounds run eagerly: a cyclic prompt whose drafts are
    accepted, and a prompt near the 256-row bucket's end whose rounds hand
    over to single rounds and the decode blocks.  Tokens, every round's
    accepted count and every kernel's launches equal; the verify pass of
    the q4 pack launches the quantized matmul and MLP kernels."""
    from aha_tpu_torch.core.engine import TextEngine

    model, params = _qwen3_tiny(dev, "q4" if path == "q4" else None)
    kw = dict(cache_dtype=torch.int8) if path == "int8-cache" else {}
    cyclic = [(i % 11) + 3 for i in range(60)]
    reqs = [(cyclic, _GREEDY, 96), (_prompt_ids(200, 3), _GREEDY, 56)]
    engines = {g: TextEngine(model, params, eos_token_ids=[],
                             max_seq_len=8192, spec_tokens=8,
                             cuda_graphs=g, **kw)
               for g in (True, False)}

    def run(eng):
        out = []
        for req in reqs:
            out.append((_text_requests(eng, [req]), list(eng.last_spec_a)))
        return out

    got = {g: _counted(lambda: run(e)) for g, e in engines.items()}
    assert got[True] == got[False]
    assert all(a for _, a in got[True][0])
    assert max(got[True][0][0][1]) > 0
    keys = {k for st in engines[True]._cache_pool.values()
            for k in st.graphs}
    assert {("spec", 9, 8), ("spec", 9, 1)} <= keys
    if path == "q4":
        assert got[True][1]["quant_matmul_q4"] > 0
        assert got[True][1]["quant_swiglu"] > 0


def test_verify_logits_rank_as_the_greedy_head(dev):
    """The verify pass's f32 logits (Qwen3Model.logits_f32, one bf16 GEMM
    with f32 sums) give each row the index head_argmax gives it alone, or
    one whose f32 logit ties it within 1e-3 of max |logit| (the
    tolerance check_head holds head_argmax to)."""
    from aha_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    model = Qwen3Model(Qwen3Config(vocab_size=151936, hidden_size=1024,
                                   num_hidden_layers=1), max_rope_len=64,
                       device=dev)
    g = torch.Generator(device=dev).manual_seed(130)
    params = {"lm_head": {"w": _bf(g, 151936, 1024) * 0.05}}
    hidden = _bf(g, 1, 9, 1024)
    logits = model.logits_f32(params, hidden)
    assert logits.dtype == torch.float32 and logits.shape == (1, 9, 151936)
    ref = hidden[0].float() @ params["lm_head"]["w"].float().t()
    top = ref.abs().max().item()
    assert (logits[0] - ref).abs().max().item() <= 1e-4 * top
    for r in range(9):
        want = int(model.greedy_token(params, hidden[:, r:r + 1]))
        got = int(logits[0, r].argmax())
        assert got == want or abs(ref[r, got] - ref[r, want]) <= 1e-3 * top


def _vl_tiny(dev):
    from aha_tpu_torch.models.llama import LlamaConfig
    from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLConfig,
                                                Qwen2_5VLModel, VisionConfig)

    cfg = Qwen2_5VLConfig(
        vision=VisionConfig(depth=2, hidden_size=128, intermediate_size=256,
                            num_heads=2, in_chans=3, out_hidden_size=256,
                            patch_size=14, spatial_merge_size=2,
                            temporal_patch_size=2, window_size=56,
                            fullatt_block_indexes=(1,)),
        text=LlamaConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         rope_theta=1e6, max_position_embeddings=8192,
                         tie_word_embeddings=True, qkv_bias=True),
        mrope_section=(16, 8, 8), image_token_id=500, video_token_id=501,
        vision_start_token_id=502)
    model = Qwen2_5VLModel(cfg, max_rope_len=8192, device=dev)
    params = model.init_random(torch.Generator(device=dev).manual_seed(8),
                               dtype=torch.bfloat16)
    return cfg, model, params


def test_vl_text_decode_graphs_equal_eager(dev):
    """Qwen2.5-VL's llama decoder over the 5-D cache: an image prompt (its
    rope_delta read on the device) and a text one, graphed against eager:
    tokens bit-equal, launches equal."""
    import numpy as np

    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.models.qwen2_5vl import mm_to
    from aha_tpu_torch.models.qwen2_5vl_served import build_mm

    cfg, model, params = _vl_tiny(dev)
    grid = (1, 8, 8)
    patches = np.random.default_rng(0).standard_normal(
        (64, 3 * 2 * 14 * 14)).astype(np.float32)
    ids = _prompt_ids(4, 3, 400) + [502] + [500] * 16 + _prompt_ids(6, 4, 400)
    mm = mm_to(build_mm([patches], [grid], ids, cfg), dev)
    engines = {g: TextEngine(model, params, eos_token_ids=[],
                             max_seq_len=8192, cuda_graphs=g)
               for g in (True, False)}

    def run(eng):
        from aha_tpu_torch.core.sampling import SamplingConfig

        return (eng.generate_tokens(ids, SamplingConfig(), 40, mm=mm),
                _text_requests(eng, [(_prompt_ids(30, 5, 400), _SAMPLED,
                                      24)]))

    got = {g: _counted(lambda: run(e)) for g, e in engines.items()}
    assert got[True] == got[False]
    assert got[True][1]["flash_decode_at_layer"] > 0


def _batch_blocks(eng, prompts, cfgs, n_blocks):
    """A BatchEngine driven without its scheduler thread: each prompt
    admitted into its slot, then `n_blocks` decode blocks, each read back
    through _HostCopy enqueued right after the block (before the next
    replay overwrites the graph's output).  The first tokens and the
    (n_blocks · decode_block, B) rows."""
    import queue

    from aha_tpu_torch.core.batch_engine import _HostCopy, _Request

    firsts = []
    with torch.no_grad():
        for slot, (ids, cfg) in enumerate(zip(prompts, cfgs)):
            req = _Request(ids, cfg, 64, queue.Queue())
            eng._begin_admission(req, slot)
            entry = None
            while entry is None:
                entry = eng._advance_admission()
                assert req.out.empty(), req.out.get()
            firsts.append(entry[1].get())
        eng._refresh_step_inputs(eng._active_mask())
        copies = [_HostCopy(eng._decode_n(eng.decode_block))
                  for _ in range(n_blocks)]
    return firsts, [row for c in copies for row in c.get()]


@pytest.mark.parametrize("grid,cache", [(None, torch.bfloat16),
                                        (None, torch.int8),
                                        ("q4", torch.bfloat16)])
@pytest.mark.parametrize("sampled", [False, True])
def test_batch_engine_graphs_equal_eager(dev, grid, cache, sampled):
    """BatchEngine's (mode, n_steps) blocks replayed against eager ones on
    the same admissions: every row of tokens bit-equal, launches equal,
    the host copies of back-to-back replays each holding its own block;
    then a concurrent run through the scheduler gives the same tokens."""
    from aha_tpu_torch.core.batch_engine import BatchEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    model, params = _qwen3_tiny(dev, grid)
    prompts = [_prompt_ids(n, 10 + n) for n in (5, 40, 90, 300)]
    cfgs = [SamplingConfig()] * 4
    if sampled:
        cfgs[2] = SamplingConfig(**_SAMPLED)
    got = {}
    for g in (True, False):
        eng = BatchEngine(model, params, eos_token_ids=[], slots=4,
                          cache_dtype=cache, max_seq_len=1024,
                          cuda_graphs=g)
        got[g] = _counted(lambda: _batch_blocks(eng, prompts, cfgs, 6))
        if g:
            assert eng.graphs.stats()["graphs"] == 1
    assert got[True] == got[False]
    firsts, rows = got[True][0]
    assert len(rows) == 24 and len({tuple(r) for r in rows}) > 1

    from aha_tpu_torch.utils.profile_decode import drive_concurrent

    outs = {}
    for g in (True, False):
        eng = BatchEngine(model, params, eos_token_ids=[], slots=4,
                          cache_dtype=cache, max_seq_len=1024,
                          cuda_graphs=g)
        try:
            outs[g] = drive_concurrent(eng, prompts + prompts[:2],
                                       cfgs + cfgs[:2], 24)[0]
        finally:
            eng.shutdown()
    assert outs[True] == outs[False]


# -- the hybrid families (LFM2, Qwen3.5) --------------------------------------


@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 64), (16, 2, 128)])
def test_stacked_decode_at_hybrid_slots(dev, Hq, Hkv, D):
    """Row 8 at the hybrids' 8-slot steps: LFM2-1.2B's 32/8 heads of 64 and
    Qwen3.5's 16/2 of 128 over a 6-layer attention stack, ragged lengths;
    within 2e-2 of the plain version, each slot bit-equal to a B = 1
    launch on that slot."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(Hq + D)
    L, B, S = 6, 8, 1024
    lens = (1, 31, 32, 33, 300, 777, 1000, 1024)
    q = _bf(g, B, 1, Hq, D)
    k, v = _bf(g, L, B, S, Hkv, D), _bf(g, L, B, S, Hkv, D)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    for li in (0, L - 1):
        layer = torch.tensor(li, dtype=torch.int32, device=dev)
        got = fa.flash_decode_at_layer(q, k, v, layer, vl)
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             layer, vl)
        assert (got.float() - ref).abs().max().item() <= 2e-2
        for b in range(B):
            one = fa.flash_decode_at_layer(
                q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                v[:, b:b + 1].contiguous(), layer, vl[b:b + 1].contiguous())
            assert torch.equal(one, got[b:b + 1]), f"slot {b}"


def _hybrid_tiny(dev, family):
    """LFM2 or Qwen3.5 at a narrow width whose heads the kernels take (D 64
    / 128), 4 layers of both kinds, seeded bf16."""
    if family == "lfm2":
        from aha_tpu_torch.models.lfm2 import Lfm2Config, Lfm2Model

        cfg = Lfm2Config(vocab_size=512, hidden_size=256,
                         num_hidden_layers=4, num_attention_heads=4,
                         num_key_value_heads=2, block_ff_dim=512,
                         block_auto_adjust_ff_dim=False,
                         layer_types=("conv", "full_attention", "conv",
                                      "full_attention"))
        model = Lfm2Model(cfg, max_rope_len=8192, device=dev)
    else:
        from aha_tpu_torch.models.qwen3_5 import (Qwen3_5Model,
                                                  Qwen3_5TextConfig)

        cfg = Qwen3_5TextConfig(vocab_size=512, hidden_size=256,
                                intermediate_size=512, num_hidden_layers=4,
                                num_attention_heads=4, num_key_value_heads=2,
                                head_dim=128, linear_num_value_heads=4,
                                linear_num_key_heads=2,
                                linear_key_head_dim=64,
                                linear_value_head_dim=64)
        model = Qwen3_5Model(cfg, max_rope_len=8192, device=dev)
    params = model.init_random(torch.Generator(device=dev).manual_seed(16),
                               dtype=torch.bfloat16, scale=0.05)
    return model, params


@pytest.mark.parametrize("family", ["lfm2", "qwen3_5"])
def test_hybrid_decode_graphs_equal_eager(dev, family):
    """A hybrid decoder's decode blocks — the conv window roll and the
    recurrent state written in place into the pooled cache — replayed from
    graphs against the eager loop: TextEngine greedy and sampled (a
    300-token prompt, the prefill kernel, then a prefix-store extension),
    and BatchEngine blocks of 4 slots; tokens bit-equal, launches equal."""
    from aha_tpu_torch.core.batch_engine import BatchEngine
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    model, params = _hybrid_tiny(dev, family)
    base = _prompt_ids(300, 3)
    reqs = [(base, _GREEDY, 40), (base + _prompt_ids(9, 4), _GREEDY, 24),
            (_prompt_ids(50, 5), _SAMPLED, 24)]
    got = {}
    for g in (True, False):
        eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                         prefix_cache_entries=4, cuda_graphs=g)
        got[g] = _counted(lambda: _text_requests(eng, reqs))
    assert got[True] == got[False]
    assert got[True][1]["flash_decode_at_layer"] > 0
    assert got[True][1]["flash_attention"] > 0
    prompts = [_prompt_ids(n, 20 + n) for n in (5, 40, 90, 300)]
    cfgs = [SamplingConfig()] * 3 + [SamplingConfig(**_SAMPLED)]
    blocks = {}
    for g in (True, False):
        eng = BatchEngine(model, params, eos_token_ids=[], slots=4,
                          max_seq_len=1024, cuda_graphs=g)
        blocks[g] = _counted(lambda: _batch_blocks(eng, prompts, cfgs, 6))
    assert blocks[True] == blocks[False]
    assert len({tuple(r) for r in blocks[True][0][1]}) > 1


# -- the SigLIP-tower families: PaddleOCR-VL's page, both graphed ------------


def _segment_plain_rows(q, k, v, seg, rows=1024):
    """The segment kernel's plain version in chunks of `rows` q rows (the
    whole would hold S² f32 scores a head): f32 masked sdpa, pad rows 0."""
    from aha_tpu_torch.ops.attention import sdpa

    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, q.shape[1], rows):
        sq = seg[r0:r0 + rows]
        mask = (sq[:, None] == seg[None, :]) & (seg[None, :] >= 0)
        o = sdpa(q[:, r0:r0 + rows].float(), k.float(), v.float(),
                 mask[None, None])
        out[:, r0:r0 + rows] = torch.where((sq >= 0)[None, :, None, None],
                                           o, 0.0)
    return out


@pytest.mark.parametrize("real,bucket", [
    (11088, 16384),      # an A4 page at 150 dpi: one segment, 5,296 pad
    (1792, 2048),        # (y2)'s two images in one segment
    (1000, 1024),        # a ragged last k tile
])
def test_segment_flash_at_paddleocr_layout(dev, real, bucket):
    """The D 72 instance at PaddleOCR-VL's tower (H 16): q, k, v three
    separate contiguous tensors (each head's tail box right before the
    next head's columns), one segment of `real` rows and pad rows of −1 up
    to the patch bucket: within 2e-2 of max |ref| of the f32 plain version
    (in chunks of q rows), a repeat bit-equal, pad rows 0, the same result
    from strided thirds of one fused product holding the same values, and
    the kernel launched."""
    from aha_tpu_torch.ops.flash_attention import flash_attention_segmented

    H, D = 16, 72
    seg = torch.cat([torch.zeros(real, dtype=torch.int32),
                     -torch.ones(bucket - real, dtype=torch.int32)]).to(dev)
    g = torch.Generator(device=dev).manual_seed(real)
    q = (torch.randn((1, bucket, H, D), generator=g, device=dev) * 4).bfloat16()
    k, v = _bf(g, 1, bucket, H, D), _bf(g, 1, bucket, H, D)
    n0 = flash_attention_segmented.launches
    got = flash_attention_segmented(q, k, v, seg)
    again = flash_attention_segmented(q, k, v, seg)
    fused = torch.stack([q, k, v], dim=2)          # (1, S, 3, H, D)
    strided = flash_attention_segmented(*(fused[:, :, i] for i in range(3)),
                                        seg)
    ref = _segment_plain_rows(q, k, v, seg)
    torch.cuda.synchronize()
    assert flash_attention_segmented.launches == n0 + 3
    top = ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= 2e-2 * top
    assert torch.equal(got, again) and torch.equal(got, strided)
    assert torch.equal(got[:, real:], torch.zeros_like(got[:, real:]))


def _siglip_tiny(dev, family):
    """PaddleOCR-VL (a tower of 2 heads of 72 on an ERNIE of 2 heads of 64)
    or LFM2-VL (its SigLIP2 tower on LFM2 at 2 heads of 64) at narrow
    widths the kernels take, seeded bf16; (model, params, image prompt ids,
    host mm)."""
    import numpy as np

    from aha_tpu_torch.models.llama import LlamaConfig

    rng = np.random.default_rng(3)
    if family == "paddleocr_vl":
        from aha_tpu_torch.models.paddleocr_vl import (PaddleOCRVLConfig,
                                                       PaddleOCRVLModel,
                                                       PaddleVisionConfig)
        from aha_tpu_torch.models.paddleocr_vl_served import build_mm

        cfg = PaddleOCRVLConfig(
            vision=PaddleVisionConfig(hidden_size=144, intermediate_size=256,
                                      num_hidden_layers=2,
                                      num_attention_heads=2),
            text=LlamaConfig(vocab_size=512, hidden_size=128,
                             intermediate_size=256, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1,
                             rope_theta=5e5, max_position_embeddings=8192,
                             tie_word_embeddings=True, qkv_bias=True,
                             o_bias=True, mlp_bias=True),
            mrope_section=(8, 12, 12), image_token_id=500,
            video_token_id=501, vision_start_token_id=502)
        model = PaddleOCRVLModel(cfg, max_rope_len=8192, device=dev)
        grids = [(1, 12, 16), (1, 8, 8)]
        patches = rng.standard_normal((256, 3 * 14 * 14)).astype(np.float32)
        ids = (_prompt_ids(4, 3, 400) + [502] + [500] * 48 + [7, 502]
               + [500] * 16 + _prompt_ids(140, 4, 400))
        mm = build_mm([patches], grids, ids, cfg)
    else:
        from aha_tpu_torch.models.lfm2 import Lfm2Config
        from aha_tpu_torch.models.lfm2vl import (Lfm2VLConfig, Lfm2VLModel,
                                                 Lfm2VLVisionConfig)
        from aha_tpu_torch.models.lfm2vl_served import build_mm

        cfg = Lfm2VLConfig(
            text=Lfm2Config(vocab_size=512, hidden_size=128,
                            num_hidden_layers=4, num_attention_heads=2,
                            num_key_value_heads=1, block_ff_dim=256,
                            block_auto_adjust_ff_dim=False,
                            layer_types=("conv", "full_attention", "conv",
                                         "full_attention")),
            vision=Lfm2VLVisionConfig(hidden_size=144, intermediate_size=256,
                                      num_attention_heads=2,
                                      num_hidden_layers=2, num_patches=256,
                                      patch_size=16),
            image_token_id=500, projector_hidden_size=256)
        model = Lfm2VLModel(cfg, max_rope_len=8192, device=dev)
        shapes = [(16, 16), (16, 16), (10, 14)]
        per = [rng.standard_normal((h * w, 768)).astype(np.float32)
               for h, w in shapes]
        table = rng.standard_normal((256, 144)).astype(np.float32)
        ids = (_prompt_ids(4, 3, 400) + [500] * 163
               + _prompt_ids(20, 4, 400))
        mm = build_mm(per, shapes, table, cfg)
    params = model.init_random(torch.Generator(device=dev).manual_seed(9),
                               dtype=torch.bfloat16)
    return model, params, ids, mm


@pytest.mark.parametrize("family", ["paddleocr_vl", "lfm2vl"])
def test_siglip_families_graphs_equal_eager(dev, family):
    """PaddleOCR-VL and LFM2-VL on TextEngine: an image prompt of >= 128
    rows (PaddleOCR-VL's two images in one segment; LFM2-VL's three packed
    images) and a sampled text one, graphed against eager: tokens
    bit-equal, launches equal; the segment kernel 2 a PaddleOCR-VL image
    prefill and never for LFM2-VL; the prefill and 5-D decode kernels
    launched."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    model, params, ids, mm_np = _siglip_tiny(dev, family)
    mm = mm_to(mm_np, dev)
    engines = {g: TextEngine(model, params, eos_token_ids=[],
                             max_seq_len=8192, cuda_graphs=g)
               for g in (True, False)}

    def run(eng):
        return (eng.generate_tokens(ids, SamplingConfig(), 40, mm=mm),
                _text_requests(eng, [(_prompt_ids(30, 5, 400), _SAMPLED,
                                      24)]))

    got = {g: _counted(lambda: run(e)) for g, e in engines.items()}
    assert got[True] == got[False]
    launches = got[True][1]
    assert launches.get("flash_attention_segmented", 0) == \
        (2 if family == "paddleocr_vl" else 0)
    assert launches["flash_attention"] > 0
    assert launches["flash_decode_at_layer"] > 0
    assert engines[True].graphs.stats()["graphs"] >= 2


def _deepseek_ocr_tiny(dev):
    """DeepSeek-OCR with its towers at the JAX tests' tiny widths (SAM at
    64 px, CLIP at 48) over a decoder of 2 heads of 64 over 2 (G 1, as
    the published 10 / 10), 16 routed experts top-2 (a prefill of N
    tokens takes the capacity buffer, C = N / 2), seeded bf16; (model,
    params, image prompt ids of >= 128 rows, host mm)."""
    from aha_tpu_torch.models.deepseek_ocr import (ClipViTConfig,
                                                   DeepseekOCRConfig,
                                                   DeepseekOCRModel,
                                                   DeepseekV2Config,
                                                   SamViTConfig)
    import numpy as np
    from PIL import Image

    from aha_tpu_torch.models.deepseek_ocr_served import build_mm, image_views

    cfg = DeepseekOCRConfig(
        language=DeepseekV2Config(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            moe_intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=2, num_key_value_heads=2,
            n_routed_experts=16, num_experts_per_tok=2),
        sam=SamViTConfig(img_size=64, embed_dim=32, depth=3, num_heads=4,
                         out_chans=16, window_size=2,
                         global_attn_indexes=(1,), net2_chans=24,
                         net3_chans=48),
        clip=ClipViTConfig(image_size=28, num_layers=2, hidden_size=48,
                           num_heads=4, ffn_hidden_size=96),
        projector_input_dim=96, projector_n_embed=128, image_token_id=500)
    model = DeepseekOCRModel(cfg, max_rope_len=8192, device=dev)
    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 255, (700, 1400, 3),
                                       dtype=np.uint8))
    view = image_views(img, 1, 640, 640, True)          # 2 tiles of 640
    ids = _prompt_ids(6, 3, 400) + [500] * view[3] + _prompt_ids(9, 4, 400)
    params = model.init_random(torch.Generator(device=dev).manual_seed(9),
                               dtype=torch.bfloat16)
    return model, params, ids, build_mm([view], 1)


def test_deepseek_ocr_graphs_equal_eager(dev):
    """DeepSeek-OCR on TextEngine: a crop-mode image prompt (321 image
    tokens, the 512 bucket) and a sampled text one, graphed against eager:
    tokens bit-equal, launches equal; the prefill kernel and the 5-D
    decode kernel launched, the segment kernel never (the towers attend
    plainly); the MoE's decode form captured."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    model, params, ids, mm_np = _deepseek_ocr_tiny(dev)
    mm = mm_to(mm_np, dev)
    engines = {g: TextEngine(model, params, eos_token_ids=[],
                             max_seq_len=8192, cuda_graphs=g)
               for g in (True, False)}

    def run(eng):
        return (eng.generate_tokens(ids, SamplingConfig(), 40, mm=mm),
                _text_requests(eng, [(_prompt_ids(30, 5, 400), _SAMPLED,
                                      24)]))

    got = {g: _counted(lambda: run(e)) for g, e in engines.items()}
    assert got[True] == got[False]
    launches = got[True][1]
    assert launches.get("flash_attention_segmented", 0) == 0
    assert launches["flash_attention"] == 3
    assert launches["flash_decode_at_layer"] % 3 == 0 and \
        launches["flash_decode_at_layer"] > 0
    assert engines[True].graphs.stats()["graphs"] >= 2


@pytest.mark.parametrize("n", [1, 4, 96], ids=["decode", "4-tokens",
                                               "capacity-buffer"])
def test_moe_ffn_on_the_card_matches_the_cpu(dev, n):
    """moe_ffn in bf16 on the card (the gathered form at n ≤ C, the
    capacity buffer past it) against float32 on the CPU on the same bf16
    numbers, routed by the same float32 gate: within 2e-2 of max |ref|
    (the bf16 rounding of the expert products)."""
    from aha_tpu_torch.ops.moe import default_capacity, moe_ffn

    g = torch.Generator(device="cpu").manual_seed(n)

    def mk(*shape):
        return (torch.randn(shape, generator=g) * 0.05).bfloat16()

    D, F, E, K = 256, 128, 64, 6
    p = {"gate": {"w": torch.randn((D, E), generator=g)},
         "experts": {"gate": {"w": mk(E, D, F)}, "up": {"w": mk(E, D, F)},
                     "down": {"w": mk(E, F, D)}},
         "shared": {"gate": {"w": mk(D, 2 * F)}, "up": {"w": mk(D, 2 * F)},
                    "down": {"w": mk(2 * F, D)}}}
    x = torch.randn((n, D), generator=g).bfloat16()
    C = default_capacity(n, K, E)
    assert (n <= C) == (n < 96)

    def to(tree, device, dtype):
        if isinstance(tree, dict):
            return {k: to(v, device, torch.float32 if k == "gate"
                          and "experts" in tree else dtype)
                    for k, v in tree.items()}
        return tree.to(device=device, dtype=dtype)

    got = moe_ffn(to(p, dev, torch.bfloat16), x.to(dev), K, capacity=C)
    ref = moe_ffn(to(p, "cpu", torch.float32), x.float(), K, capacity=C)
    torch.cuda.synchronize()
    err = (got.float().cpu() - ref).abs().max() / ref.abs().max()
    assert got.dtype == torch.bfloat16 and err.item() <= 2e-2


@pytest.mark.parametrize("S,real,H,fused", [
    (512, 500, 4, True),     # Fun-ASR's SANM blocks: (ac1)'s 512 bucket
    (256, 250, 8, False),    # its adaptor blocks: seg[::2] of that bucket
    (64, 50, 4, True),       # sample.wav's 3 s: the 64 bucket
])
def test_segment_flash_at_fun_asr_shapes(dev, S, real, H, fused):
    """Row 10 at Fun-ASR-Nano's D 128: the SANM blocks hand it q and k as
    strided thirds of the fused q|k|v product and v as the pad-zeroed copy;
    the adaptor three contiguous tensors.  Within 2e-2 of max |ref| of the
    f32 plain version on the real rows, pad rows 0, a repeat bit-equal,
    the kernel launched."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_attention_segmented, flash_attention_segmented_plain)

    D = 128
    seg = torch.full((S,), -1, dtype=torch.int32)
    seg[:real] = 0
    seg = seg.to(dev)
    g = torch.Generator(device=dev).manual_seed(S + H)
    if fused:
        qkv = torch.randn((1, S, 3 * H * D), generator=g, device=dev)
        qkv[..., :H * D] *= 4
        qkv = qkv.to(torch.bfloat16)
        q = qkv[..., :H * D].reshape(1, S, H, D)
        k = qkv[..., H * D:2 * H * D].reshape(1, S, H, D)
        v = torch.where((seg >= 0)[None, :, None], qkv[..., 2 * H * D:],
                        0.0).reshape(1, S, H, D)
        assert not q.is_contiguous() and v.is_contiguous()
    else:
        q, k, v = (_bf(g, 1, S, H, D) for _ in range(3))
        q = q * 4
    n0 = flash_attention_segmented.launches
    got = flash_attention_segmented(q, k, v, seg)
    again = flash_attention_segmented(q, k, v, seg)
    ref = flash_attention_segmented_plain(q.float(), k.float(), v.float(),
                                          seg)
    torch.cuda.synchronize()
    assert flash_attention_segmented.launches == n0 + 2
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2 * top
    assert torch.equal(got, again)
    assert torch.equal(got[:, seg < 0], torch.zeros_like(got[:, seg < 0]))


# -- row 8 over a float32 cache (VoxCPM's MiniCPM stacks) ---------------------

#: the float32 decode kernel against its plain version on the same float32
#: inputs, max abs error relative to max |ref|: both sum in f32, in another
#: order, with the kernel's fast exp; a live length off by one moves the
#: planted row's weight, most of max |ref|
TOL_DECODE_F32_REL = 1e-5


def _planted_f32(g, L, B, S, Hq, Hkv, D, lens):
    """q and a (L, B, S, Hkv, D) float32 cache: each slot's last live row
    planted along its query heads' summed direction, so the outputs are
    O(1) and lean on that row."""
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda")
    k = torch.randn((L, B, S, Hkv, D), generator=g, device="cuda")
    v = torch.randn((L, B, S, Hkv, D), generator=g, device="cuda")
    u = q.reshape(B, Hkv, Hq // Hkv, D).sum(2)
    u = u / u.norm(dim=-1, keepdim=True)
    for b, n in enumerate(lens):
        k[:, b, n - 1] = 12 * u[b]
    return q, k, v


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("L,valid", [(24, 1), (24, 49), (24, 74), (6, 74)])
def test_decode_f32_at_voxcpm_shapes(dev, L, valid):
    """flash_decode_at_layer on VoxCPM-0.5B's float32 caches: the base LM's
    24 layers and the residual LM's 6, 16 query heads over 2 of 64, S = a
    48-token prompt + the audio start + 25 patches + 8 (82 rows); within
    TOL_DECODE_F32_REL of max |ref|, one launch each, and a live length
    off by one outside that bound."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(L + valid)
    S, Hq, Hkv, D = 82, 16, 2, 64
    q, k, v = _planted_f32(g, L, 1, S, Hq, Hkv, D, (valid,))
    vl = torch.tensor([valid], dtype=torch.int32, device=dev)
    for li in (0, L - 1):
        layer = torch.tensor(li, dtype=torch.int32, device=dev)
        n0 = fa.flash_decode_at_layer.launches
        got = fa.flash_decode_at_layer(q, k, v, layer, vl)
        ref = fa.flash_decode_at_layer_plain(q, k, v, layer, vl)
        torch.cuda.synchronize()
        assert fa.flash_decode_at_layer.launches == n0 + 1
        assert got.dtype == torch.float32
        assert _rel(got, ref) <= TOL_DECODE_F32_REL
        if valid < S:
            bad = fa.flash_decode_at_layer(q, k, v, layer, vl + 1)
            assert _rel(bad, ref) > TOL_DECODE_F32_REL
        if valid > 1:
            bad = fa.flash_decode_at_layer(q, k, v, layer, vl - 1)
            assert _rel(bad, ref) > TOL_DECODE_F32_REL


def test_decode_f32_ragged_slots(dev):
    """B 2 slots of lengths 33 and 300 over a float32 (3, 2, 512, 2, 64)
    cache: each slot within TOL_DECODE_F32_REL of the plain version and
    bit-equal to a B = 1 launch on that slot alone."""
    from aha_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(21)
    L, S, Hq, Hkv, D, lens = 3, 512, 16, 2, 64, (33, 300)
    q, k, v = _planted_f32(g, L, 2, S, Hq, Hkv, D, lens)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    got = fa.flash_decode_at_layer(q, k, v, layer, vl)
    ref = fa.flash_decode_at_layer_plain(q, k, v, layer, vl)
    for b in range(2):
        one = fa.flash_decode_at_layer(
            q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
            v[:, b:b + 1].contiguous(), layer, vl[b:b + 1].contiguous())
        torch.cuda.synchronize()
        assert _rel(got[b], ref[b]) <= TOL_DECODE_F32_REL
        assert torch.equal(got[b:b + 1], one)


def test_decode_refuses_other_cache_dtypes(dev):
    """A float16 cache, or a float32 q over a bf16 cache, raises on the
    card: no plain version runs and nothing is counted."""
    from aha_tpu_torch.ops import flash_attention as fa

    layer = torch.zeros((), dtype=torch.int32, device=dev)
    vl = torch.ones(1, dtype=torch.int32, device=dev)
    n0 = fa.flash_decode_at_layer.launches
    for q_dt, kv_dt in ((torch.float16, torch.float16),
                        (torch.float32, torch.bfloat16),
                        (torch.bfloat16, torch.float32)):
        q = torch.zeros(1, 1, 4, 64, dtype=q_dt, device=dev)
        kv = torch.zeros(1, 1, 64, 2, 64, dtype=kv_dt, device=dev)
        with pytest.raises(ValueError):
            fa.flash_decode_at_layer(q, kv, kv, layer, vl)
    assert fa.flash_decode_at_layer.launches == n0
