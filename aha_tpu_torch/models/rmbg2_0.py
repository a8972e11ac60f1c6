"""RMBG-2.0 (BiRefNet): a Swin-L backbone and a deformable-conv ASPP
decoder → a foreground matte (counterpart of aha_tpu/models/rmbg2_0.py,
the same names and parameter tree).

- Swin: patch embed, windows of 12 with the relative-position bias and
  the shifted-window mask (both numpy tables, built once per geometry),
  patch merging, the four stage outputs normalised, NCHW.  The window
  attention is an einsum in float32 with the bias added: the reference
  runs it in XLA, outside any Pallas kernel, and so does the port (plain
  PyTorch; its device time is read by the smoke as a design candidate).
- `deform_conv2d`: torchvision's modulated deformable conv (bilinear
  sampling, zeros outside), batched, in torch: the taps in chunks sized
  to a memory budget, each chunk's four bilinear corners row gathers of
  the channels-last input (`index_select`) and its products one einsum
  against the (K, C, O) weight slices (the card machine has no
  torchvision, and the reference's is a lax.scan of the same gathers).
- batch norm (running statistics), the ASPP with 1/1/3/7 deformable
  branches and a pooled one, the decoder blocks, the gdt gates, the
  source image split into patches stacked on channels; every resize
  bilinear with align_corners=True (utils/interpolate.py).
- `init_random`: seeded weights of the published shapes from a
  `torch.Generator` (the JAX package has no such function; its bench draws
  a checkpoint with numpy), through `random_state_dict` and
  `load_params`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.core import nn
from aha_tpu_torch.io.weights import take_linear, take_norm
from aha_tpu_torch.ops.conv import conv2d
from aha_tpu_torch.utils.interpolate import interpolate

# ---------------------------------------------------------------------------
# Swin transformer backbone
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 192
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    eps: float = 1e-5

    @property
    def num_features(self) -> tuple:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))


@functools.lru_cache(maxsize=8)
def _rel_bias_index(window: int) -> np.ndarray:
    """(N, N) index into the (2w − 1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + window - 1
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


@functools.lru_cache(maxsize=16)
def _shift_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask of the shifted windows."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in ((0, hp - window), (hp - window, hp - shift), (hp - shift, hp)):
        for ws in ((0, wp - window), (wp - window, wp - shift),
                   (wp - shift, wp)):
            img[hs[0]:hs[1], ws[0]:ws[1]] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask == 0, 0.0, -100.0).astype(np.float32)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def _window_reverse(win: torch.Tensor, window: int, hp: int,
                    wp: int) -> torch.Tensor:
    C = win.shape[-1]
    B = win.shape[0] // (hp * wp // window // window)
    x = win.reshape(B, hp // window, wp // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)


def _swin_attention(p: dict, x: torch.Tensor, num_heads: int,
                    mask: np.ndarray | None = None) -> torch.Tensor:
    """Windowed MSA with the relative-position bias; x (nW·B, N, C), mask
    (nW, N, N) additive or None."""
    nWB, N, C = x.shape
    hd = C // num_heads
    qkv = nn.linear(p["qkv"], x).reshape(nWB, N, 3, num_heads, hd)
    q = qkv[:, :, 0].transpose(1, 2) * (hd ** -0.5)
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float())
    idx = torch.from_numpy(_rel_bias_index(int(round(N ** 0.5))).reshape(-1))
    bias = p["rel_bias_table"].index_select(0, idx.to(x.device))
    bias = bias.reshape(N, N, num_heads).permute(2, 0, 1)
    scores = scores + bias[None].float()
    if mask is not None:
        nW = mask.shape[0]
        m = torch.from_numpy(mask).to(x.device)
        scores = (scores.reshape(nWB // nW, nW, num_heads, N, N)
                  + m[None, :, None]).reshape(nWB, num_heads, N, N)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bnkd->bnqd", probs, v)
    out = out.transpose(1, 2).reshape(nWB, N, C)
    return nn.linear(p["proj"], out)


def _swin_block(p: dict, x: torch.Tensor, H: int, W: int, window: int,
                shift: int, num_heads: int, eps: float) -> torch.Tensor:
    B, L, C = x.shape
    shortcut = x
    x = nn.ln(p["norm1"], x, eps=eps).reshape(B, H, W, C)
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = H + pad_h, W + pad_w
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _shift_mask(hp, wp, window, shift)
    win = _swin_attention(p["attn"], _window_partition(x, window), num_heads,
                          mask)
    x = _window_reverse(win, window, hp, wp)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x[:, :H, :W].reshape(B, L, C)
    h = nn.ln(p["norm2"], x, eps=eps)
    return x + nn.linear(p["fc2"], F.gelu(nn.linear(p["fc1"], h)))


def _patch_merging(p: dict, x: torch.Tensor, H: int, W: int,
                   eps: float) -> torch.Tensor:
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1).reshape(B, -1, 4 * C)
    return nn.linear(p["reduction"], nn.ln(p["norm"], x, eps=eps))


def swin_forward(p: dict, pixels: torch.Tensor, cfg: SwinConfig) -> list:
    """(B, 3, H, W) → the 4 normalised NCHW stage outputs."""
    ps = cfg.patch_size
    B, _, H, W = pixels.shape
    if H % ps or W % ps:
        pixels = F.pad(pixels, (0, (ps - W % ps) % ps, 0, (ps - H % ps) % ps))
    x = conv2d(p["patch"], pixels, stride=ps)
    _, E, wh, ww = x.shape
    x = nn.ln(p["patch_norm"], x.reshape(B, E, wh * ww).transpose(1, 2),
              eps=cfg.eps)
    outs = []
    for i, depth in enumerate(cfg.depths):
        lp = p["layers"][i]
        x_out = x
        for j in range(depth):
            shift = 0 if j % 2 == 0 else cfg.window_size // 2
            x_out = _swin_block(lp["blocks"][j], x_out, wh, ww,
                                cfg.window_size, shift, cfg.num_heads[i],
                                cfg.eps)
        normed = nn.ln(p["norms"][i], x_out, eps=cfg.eps)
        outs.append(normed.reshape(B, wh, ww, cfg.num_features[i])
                    .permute(0, 3, 1, 2))
        if "downsample" in lp:
            x = _patch_merging(lp["downsample"], x_out, wh, ww, cfg.eps)
            wh, ww = (wh + 1) // 2, (ww + 1) // 2
        else:
            x = x_out
    return outs


# ---------------------------------------------------------------------------
# Deformable convolution (torchvision deform_conv2d semantics)
# ---------------------------------------------------------------------------

#: elements of one chunk's gathered (B, taps, Ho·Wo, C) samples at most
DEFORM_CHUNK_ELEMS = 1 << 26


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, offset: torch.Tensor,
                  mask: torch.Tensor, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """x (B, C, H, W), weight (O, C, kh, kw), offset (B, 2K, Ho, Wo) with
    (Δy, Δx) interleaved per tap, mask (B, K, Ho, Wo): bilinear sampling
    with zeros outside, batched."""
    B, C, H, W = x.shape
    O, _, kh, kw = weight.shape
    K = kh * kw
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    dev = x.device
    off = offset.reshape(B, K, 2, Ho, Wo).float()
    base_y = torch.arange(Ho, device=dev, dtype=torch.float32) * stride \
        - padding
    base_x = torch.arange(Wo, device=dev, dtype=torch.float32) * stride \
        - padding
    ki = torch.arange(kh, device=dev).repeat_interleave(kw).float()
    kj = torch.arange(kw, device=dev).repeat(kh).float()
    ys = (base_y[None, :, None] + ki[:, None, None])[None] + off[:, :, 0]
    xs = (base_x[None, None, :] + kj[:, None, None])[None] + off[:, :, 1]
    m = mask.float().reshape(B, K, Ho * Wo, 1)
    # channels-last rows, so each bilinear corner is a row gather
    rows = x.float().permute(0, 2, 3, 1).reshape(B * H * W, C)
    w_k = weight.float().reshape(O, C, K).permute(2, 1, 0)        # (K, C, O)
    boff = (torch.arange(B, device=dev) * (H * W))[:, None, None, None]
    out = torch.zeros((B, Ho * Wo, O), dtype=torch.float32, device=dev)
    step = max(1, DEFORM_CHUNK_ELEMS // max(1, B * Ho * Wo * C))
    for t0 in range(0, K, step):
        y, xx = ys[:, t0:t0 + step], xs[:, t0:t0 + step]     # (B, k, Ho, Wo)
        k = y.shape[1]
        inside = (y > -1.0) & (y < H) & (xx > -1.0) & (xx < W)
        y0, x0 = torch.floor(y), torch.floor(xx)
        ly, lx = y - y0, xx - x0
        acc = None
        for dy, dx, wgt in ((0, 0, (1 - ly) * (1 - lx)),
                            (0, 1, (1 - ly) * lx),
                            (1, 0, ly * (1 - lx)),
                            (1, 1, ly * lx)):
            cy, cx = y0 + dy, x0 + dx
            ok = inside & (cy >= 0) & (cy <= H - 1) & (cx >= 0) & (cx <= W - 1)
            idx = (cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long() + boff
            v = rows.index_select(0, idx.reshape(-1)).reshape(
                B, k, Ho * Wo, C)
            v = v * torch.where(ok, wgt, 0.0).reshape(B, k, Ho * Wo, 1)
            acc = v if acc is None else acc + v
        sampled = acc * m[:, t0:t0 + step]
        out = out + torch.einsum("bknc,kco->bno", sampled,
                                 w_k[t0:t0 + step])
    out = out.transpose(1, 2).reshape(B, O, Ho, Wo)
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(x.dtype)


def _batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    inv = torch.rsqrt(p["var"] + eps)
    return ((x - p["mean"][None, :, None, None]) * inv[None, :, None, None]
            * p["w"][None, :, None, None] + p["b"][None, :, None, None])


def _deform_block(p: dict, x: torch.Tensor, padding: int) -> torch.Tensor:
    """DeformableConv2d: offset conv, 2·sigmoid modulator, deformable
    regular conv."""
    offset = conv2d(p["offset"], x, padding=padding)
    mask = 2.0 * torch.sigmoid(conv2d(p["modulator"], x, padding=padding))
    return deform_conv2d(x, p["conv"]["w"], p["conv"].get("b"), offset, mask,
                         stride=1, padding=padding)


def _aspp_module(p: dict, x: torch.Tensor, padding: int) -> torch.Tensor:
    return F.relu(_batch_norm(p["bn"], _deform_block(p, x, padding)))


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    return interpolate(x, tuple(hw), "bilinear", align_corners=True)


def _aspp_deformable(p: dict, x: torch.Tensor) -> torch.Tensor:
    """ASPPDeformable: 1/1/3/7 deformable branches and the global pool
    branch, fused by a 1×1 conv."""
    branches = [_aspp_module(p["aspp1"], x, 0)]
    for i, ks in enumerate((1, 3, 7)):
        branches.append(_aspp_module(p[f"deform{i}"], x, ks // 2))
    g = conv2d(p["pool_conv"], x.mean(dim=(2, 3), keepdim=True))
    g = F.relu(_batch_norm(p["pool_bn"], g))
    g = _resize(g, branches[0].shape[2:])
    x = conv2d(p["conv1"], torch.cat(branches + [g], dim=1))
    return F.relu(_batch_norm(p["bn1"], x))


def _basic_dec_blk(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(_batch_norm(p["bn_in"], conv2d(p["conv_in"], x, padding=1)))
    x = _aspp_deformable(p["dec_att"], x)
    return _batch_norm(p["bn_out"], conv2d(p["conv_out"], x, padding=1))


def _simple_convs(p: dict, x: torch.Tensor) -> torch.Tensor:
    return conv2d(p["conv_out"], conv2d(p["conv1"], x, padding=1), padding=1)


def _gdt(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The gdt conv and its sigmoid attention gate."""
    g = F.relu(_batch_norm(p["bn"], conv2d(p["conv"], x, padding=1)))
    return x * torch.sigmoid(conv2d(p["attn"], g))


def _patches_to_channels(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Split the source image into (ph, pw) patches stacked on channels,
    column-major (columns along W first, then each along H)."""
    B, C, H, W = x.shape
    gh, gw = H // ph, W // pw
    x = x.reshape(B, C, gh, ph, gw, pw).permute(0, 4, 2, 1, 3, 5)
    return x.reshape(B, gw * gh * C, ph, pw)


# ---------------------------------------------------------------------------
# BiRefNet
# ---------------------------------------------------------------------------

#: the decoder's inner widths (ic of the blocks, the ASPP's branches, the
#: gdt gates)
DEC_CHANNELS = 64
ASPP_CHANNELS = 256
GDT_CHANNELS = 16


class BiRefNet:
    def __init__(self, swin: SwinConfig | None = None,
                 device: torch.device | str = "cpu"):
        self.swin = swin or SwinConfig()
        nf = self.swin.num_features
        # the dual-scale concat doubles each stage, in reverse order
        self.channels = tuple(2 * f for f in reversed(nf))
        self.device = torch.device(device)

    def backbone(self, params: dict, pixels: torch.Tensor) -> list:
        """The four dual-scale features: the full image's and the half
        image's stage outputs concatenated."""
        f_full = swin_forward(params["bb"], pixels, self.swin)
        H, W = pixels.shape[2:]
        f_half = swin_forward(params["bb"], _resize(pixels, (H // 2, W // 2)),
                              self.swin)
        return [torch.cat([a, _resize(b, a.shape[2:])], dim=1)
                for a, b in zip(f_full, f_half)]

    def forward(self, params: dict, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalised → (B, 1, H, W) sigmoid matte."""
        H, W = pixels.shape[2:]
        x1, x2, x3, x4 = self.backbone(params, pixels)
        hw4 = x4.shape[2:]
        x4 = torch.cat([_resize(x1, hw4), _resize(x2, hw4), _resize(x3, hw4),
                        x4], dim=1)
        x4 = _basic_dec_blk(params["squeeze"], x4)

        d = params["decoder"]
        src = pixels
        pb = _resize(_patches_to_channels(src, *hw4), hw4)
        x4 = torch.cat([x4, _simple_convs(d["ipt_blk5"], pb)], dim=1)
        p4 = _gdt(d["gdt4"], _basic_dec_blk(d["block4"], x4))

        hw3 = x3.shape[2:]
        p3_ = _resize(p4, hw3) + conv2d(d["lateral4"], x3)
        pb = _resize(_patches_to_channels(src, *hw3), hw3)
        p3_ = torch.cat([p3_, _simple_convs(d["ipt_blk4"], pb)], dim=1)
        p3 = _gdt(d["gdt3"], _basic_dec_blk(d["block3"], p3_))

        hw2 = x2.shape[2:]
        p2_ = _resize(p3, hw2) + conv2d(d["lateral3"], x2)
        pb = _resize(_patches_to_channels(src, *hw2), hw2)
        p2_ = torch.cat([p2_, _simple_convs(d["ipt_blk3"], pb)], dim=1)
        p2 = _gdt(d["gdt2"], _basic_dec_blk(d["block2"], p2_))

        hw1 = x1.shape[2:]
        p1_ = _resize(p2, hw1) + conv2d(d["lateral2"], x1)
        pb = _resize(_patches_to_channels(src, *hw1), hw1)
        p1_ = torch.cat([p1_, _simple_convs(d["ipt_blk2"], pb)], dim=1)
        p1 = _resize(_basic_dec_blk(d["block1"], p1_), (H, W))
        p1 = torch.cat([p1, _simple_convs(d["ipt_blk1"], src)], dim=1)
        return torch.sigmoid(conv2d(d["conv_out1"], p1))

    # -- loading ---------------------------------------------------------------

    def load_params(self, src, dtype=torch.float32) -> dict:
        """The tree from the checkpoint's names (bb.*, squeeze_module.0.*,
        decoder.*)."""
        cfg = self.swin
        dev = self.device

        def get(n):
            return src[n].to(device=dev, dtype=dtype)

        def lin(n):
            return take_linear(src, n, dev, dtype)

        def norm(n):
            return take_norm(src, n, dev, dtype)

        def convp(n, bias=True):
            p = {"w": get(n + ".weight")}
            if bias and n + ".bias" in src:
                p["b"] = get(n + ".bias")
            return p

        def bn(n):
            return {"w": get(n + ".weight"), "b": get(n + ".bias"),
                    "mean": get(n + ".running_mean"),
                    "var": get(n + ".running_var")}

        bb = {"patch": convp("bb.patch_embed.proj"),
              "patch_norm": norm("bb.patch_embed.norm"),
              "layers": [], "norms": []}
        for i, depth in enumerate(cfg.depths):
            lp = {"blocks": []}
            for j in range(depth):
                b = f"bb.layers.{i}.blocks.{j}."
                lp["blocks"].append({
                    "norm1": norm(b + "norm1"), "norm2": norm(b + "norm2"),
                    "attn": {"qkv": lin(b + "attn.qkv"),
                             "proj": lin(b + "attn.proj"),
                             "rel_bias_table": get(
                                 b + "attn.relative_position_bias_table")},
                    "fc1": lin(b + "mlp.fc1"), "fc2": lin(b + "mlp.fc2"),
                })
            if i < len(cfg.depths) - 1:
                lp["downsample"] = {
                    "norm": norm(f"bb.layers.{i}.downsample.norm"),
                    "reduction": lin(f"bb.layers.{i}.downsample.reduction")}
            bb["layers"].append(lp)
            bb["norms"].append(norm(f"bb.norm{i}"))

        def aspp_mod(n):
            return {"offset": convp(n + ".atrous_conv.offset_conv"),
                    "modulator": convp(n + ".atrous_conv.modulator_conv"),
                    "conv": convp(n + ".atrous_conv.regular_conv"),
                    "bn": bn(n + ".bn")}

        def aspp(n):
            p = {"aspp1": aspp_mod(n + ".aspp1")}
            for i in range(3):
                p[f"deform{i}"] = aspp_mod(n + f".aspp_deforms.{i}")
            p["pool_conv"] = convp(n + ".global_avg_pool.1", bias=False)
            p["pool_bn"] = bn(n + ".global_avg_pool.2")
            p["conv1"] = convp(n + ".conv1", bias=False)
            p["bn1"] = bn(n + ".bn1")
            return p

        def dec_blk(n):
            return {"conv_in": convp(n + ".conv_in"), "bn_in": bn(n + ".bn_in"),
                    "dec_att": aspp(n + ".dec_att"),
                    "conv_out": convp(n + ".conv_out"),
                    "bn_out": bn(n + ".bn_out")}

        def simple(n):
            return {"conv1": convp(n + ".conv1"),
                    "conv_out": convp(n + ".conv_out")}

        def gdt(i):
            return {"conv": convp(f"decoder.gdt_convs_{i}.0"),
                    "bn": bn(f"decoder.gdt_convs_{i}.1"),
                    "attn": convp(f"decoder.gdt_convs_attn_{i}.0")}

        decoder = {f"ipt_blk{i}": simple(f"decoder.ipt_blk{i}")
                   for i in (5, 4, 3, 2, 1)}
        decoder.update({f"block{i}": dec_blk(f"decoder.decoder_block{i}")
                        for i in (4, 3, 2, 1)})
        decoder["conv_out1"] = convp("decoder.conv_out1.0")
        decoder.update({f"lateral{i}": convp(f"decoder.lateral_block{i}.conv")
                        for i in (4, 3, 2)})
        decoder.update({f"gdt{i}": gdt(i) for i in (4, 3, 2)})
        return {"bb": bb, "squeeze": dec_blk("squeeze_module.0"),
                "decoder": decoder}

    def init_random(self, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
        """Seeded weights at this Swin geometry (random_state_dict)."""
        return self.load_params(random_state_dict(self.swin, generator),
                                dtype)


def random_state_dict(cfg: SwinConfig,
                      generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A BiRefNet checkpoint's tensors under its names at any Swin
    geometry, drawn on the CPU from `generator`: weights N(0, 1 / fan_in)
    (fan_in the product of a weight's trailing dims), so the decoder's
    chain of convs keeps its activations O(1) and the matte off its 0 / 1
    saturation; the relative-position tables N(0, 0.02); unit norms and
    batch-norm variances, zero biases and means."""
    def w(*shape):
        return torch.randn(shape, generator=generator) / math.sqrt(
            math.prod(shape[1:]))

    t: dict[str, torch.Tensor] = {}

    def add_ln(n, d):
        t[n + ".weight"], t[n + ".bias"] = torch.ones(d), torch.zeros(d)

    def add_lin(n, i, o, bias=True):
        t[n + ".weight"] = w(o, i)
        if bias:
            t[n + ".bias"] = torch.zeros(o)

    def add_conv(n, i, o, k, bias=True):
        t[n + ".weight"] = w(o, i, k, k)
        if bias:
            t[n + ".bias"] = torch.zeros(o)

    def add_bn(n, d):
        add_ln(n, d)
        t[n + ".running_mean"], t[n + ".running_var"] = (torch.zeros(d),
                                                         torch.ones(d))

    E, win, feats = cfg.embed_dim, cfg.window_size, cfg.num_features
    add_conv("bb.patch_embed.proj", 3, E, cfg.patch_size)
    add_ln("bb.patch_embed.norm", E)
    for i, d_i in enumerate(feats):
        for j in range(cfg.depths[i]):
            b = f"bb.layers.{i}.blocks.{j}."
            add_ln(b + "norm1", d_i)
            add_ln(b + "norm2", d_i)
            add_lin(b + "attn.qkv", d_i, 3 * d_i)
            add_lin(b + "attn.proj", d_i, d_i)
            t[b + "attn.relative_position_bias_table"] = torch.randn(
                ((2 * win - 1) ** 2, cfg.num_heads[i]),
                generator=generator) * 0.02
            hidden = int(d_i * cfg.mlp_ratio)
            add_lin(b + "mlp.fc1", d_i, hidden)
            add_lin(b + "mlp.fc2", hidden, d_i)
        if i < len(feats) - 1:
            add_ln(f"bb.layers.{i}.downsample.norm", 4 * d_i)
            add_lin(f"bb.layers.{i}.downsample.reduction", 4 * d_i, 2 * d_i,
                    bias=False)
        add_ln(f"bb.norm{i}", d_i)

    ch = [2 * f for f in reversed(feats)]
    ic, inter = DEC_CHANNELS, ASPP_CHANNELS

    def add_deform(n, i, o, k):
        add_conv(n + ".offset_conv", i, 2 * k * k, k)
        add_conv(n + ".modulator_conv", i, k * k, k)
        add_conv(n + ".regular_conv", i, o, k, bias=False)

    def add_aspp(n, c):
        for sub, k in (("aspp1", 1), ("aspp_deforms.0", 1),
                       ("aspp_deforms.1", 3), ("aspp_deforms.2", 7)):
            add_deform(f"{n}.{sub}.atrous_conv", c, inter, k)
            add_bn(f"{n}.{sub}.bn", inter)
        add_conv(n + ".global_avg_pool.1", c, inter, 1, bias=False)
        add_bn(n + ".global_avg_pool.2", inter)
        add_conv(n + ".conv1", inter * 5, c, 1, bias=False)
        add_bn(n + ".bn1", c)

    def add_dec_blk(n, i, o):
        add_conv(n + ".conv_in", i, ic, 3)
        add_bn(n + ".bn_in", ic)
        add_aspp(n + ".dec_att", ic)
        add_conv(n + ".conv_out", ic, o, 3)
        add_bn(n + ".bn_out", o)

    def add_simple(n, i, o):
        add_conv(n + ".conv1", i, ic, 3)
        add_conv(n + ".conv_out", ic, o, 3)

    add_dec_blk("squeeze_module.0", sum(ch), ch[0])
    # the source patches stacked on channels: 3 · (grid cells) per level
    for n, cells, o in (("ipt_blk5", 1024, ch[0] // 8),
                        ("ipt_blk4", 256, ch[0] // 8),
                        ("ipt_blk3", 64, ch[1] // 8),
                        ("ipt_blk2", 16, ch[2] // 8),
                        ("ipt_blk1", 1, ch[3] // 8)):
        add_simple("decoder." + n, 3 * cells, o)
    add_dec_blk("decoder.decoder_block4", ch[0] + ch[0] // 8, ch[1])
    add_dec_blk("decoder.decoder_block3", ch[1] + ch[0] // 8, ch[2])
    add_dec_blk("decoder.decoder_block2", ch[2] + ch[1] // 8, ch[3])
    add_dec_blk("decoder.decoder_block1", ch[3] + ch[2] // 8, ch[3] // 2)
    add_conv("decoder.conv_out1.0", ch[3] // 2 + ch[3] // 8, 1, 1)
    for i, c in ((4, ch[1]), (3, ch[2]), (2, ch[3])):
        add_conv(f"decoder.lateral_block{i}.conv", c, c, 1)
        add_conv(f"decoder.gdt_convs_{i}.0", c, GDT_CHANNELS, 3)
        add_bn(f"decoder.gdt_convs_{i}.1", GDT_CHANNELS)
        add_conv(f"decoder.gdt_convs_attn_{i}.0", GDT_CHANNELS, 1, 1)
    return t
