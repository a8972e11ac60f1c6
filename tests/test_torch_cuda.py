"""Each CUDA kernel against its plain PyTorch version on the card, at small
shapes (bf16 inputs; attention tolerance 2e-2 abs against the f32 plain
version).  Marked `cuda`: skipped where torch sees no CUDA device.  Run on
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


@pytest.mark.parametrize("D,G,valid", [(128, 2, 300), (64, 4, 1), (128, 1, 512)])
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
    assert int(head_argmax(w, h)) == int(head_argmax_plain(w, h))
    wt = torch.zeros(5000, 256, dtype=torch.bfloat16, device=dev)
    wt[4000, 0] = wt[37, 0] = 1.0
    e0 = torch.zeros(1, 256, dtype=torch.bfloat16, device=dev)
    e0[0, 0] = 1.0
    assert int(head_argmax(wt, e0)) == 37
    nan = torch.full((1, 256), float("nan"), dtype=torch.bfloat16, device=dev)
    assert int(head_argmax(w, nan)) == 4999 == int(head_argmax_plain(w, nan))


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
                                   (64, 1, 8)])
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
