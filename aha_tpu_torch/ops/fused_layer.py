"""The whole-stack fused decode step (batch 1, one token, dense Qwen3), over
bf16 weights or over the GGUF grids.

Replaces aha_tpu/ops/fused_layer.py:fused_decode_stack with the CUDA kernel
of csrc/fused_decode_stack.cu, and :fused_decode_stack_q8 with that of
csrc/fused_decode_stack_q8.cu: every layer's norms, fused q|k|v and gate|up
products, q/k head norms, RoPE, attention over the cache plus the fresh
row, o-proj, SwiGLU and residuals in ONE cooperative launch.  Bound: the
weight bytes (840 MB a step for Qwen3-0.6B in bf16, 433 MB on the int8
grid, 236 MB on the 4-bit one), read once; the per-op chain instead pays
~70 host dispatches and launches per layer.  The design — a persistent
block per SM, six grid barriers per layer, deterministic block- or
warp-level dot reductions — is described in the sources.

The quantized stack takes each of its four projections on either grid
(ops/quant_matmul.py layouts, K exactly the grid's Kp), as the JAX kernel
does, and quantizes every activation it feeds them per 128-group from f32,
as the Pallas kernel's _quant_acts does; the bf16 stack rounds them to bf16
instead, as its Pallas kernel's dots do.

Unlike the JAX functions, which return new cache arrays, the kernels write
the new K/V row of every layer IN PLACE at `pos` (the port's caches are
pooled and updated in place, core/cache.py), and return only the hidden
state.  The JAX kernels' static `window` is a VMEM bound; the CUDA kernels
read the live length from the device, so the port has no window argument.
`MAX_WINDOW` stays the gate of the model (models/qwen3.py): a fused step
runs while at most that many cache rows are live, as in the JAX package.

On the CPU the plain versions run; on the card the kernel runs or the
wrapper raises.  `fused_decode_stack.launches` and
`fused_decode_stack_q8.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.quant_matmul import (GRID_KEYS, GROUP, check_grid,
                                            grid_info, grid_k, qdot,
                                            quant_acts)
from aha_tpu_torch.ops.rope import rotate_half

#: the live-row bound of the JAX package's fused path (its VMEM window)
MAX_WINDOW = 2048


def _in_out(p: dict) -> tuple[int, int]:
    """(K, N) of a dense (L, K, N) "w" or a stacked quantized grid."""
    if "w" in p:
        return tuple(p["w"].shape[-2:])
    return grid_k(p), grid_info(p)[2]


def _dims(layers: dict, k_cache: torch.Tensor) -> dict:
    L, _, S, HD = k_cache.shape
    D = layers["q_norm"]["w"].shape[-1]
    NQ, H = _in_out(layers["o"])
    return dict(L=L, S=S, H=H, D=D, hkv=HD // D, hq=NQ // D, NQ=NQ, HD=HD,
                NI=_in_out(layers["mlp"]["down"])[0])


def _mats(layers: dict) -> list:
    mlp = layers.get("mlp", {})
    return [layers.get("qkv"), layers.get("o"), mlp.get("gateup"),
            mlp.get("down")]


def _norms(layers: dict) -> list:
    return [layers.get(k) for k in ("ln1", "ln2", "q_norm", "k_norm")]


def fused_stack_supported(layers: dict, hidden: int, n_heads: int,
                          n_kv_heads: int, head_dim: int,
                          intermediate: int) -> bool:
    """True when the kernel covers this geometry and parameter layout:
    fused bf16 qkv/gateup weights (fuse_decode_params), q/k head norms, no
    biases, D 64 or 128, whole GQA groups, widths in 8-column chunks."""
    parts = _mats(layers) + _norms(layers)
    if any(p is None or "w" not in p or "b" in p for p in parts):
        return False
    if any(p["w"].dtype != torch.bfloat16 for p in parts):
        return False
    return (head_dim in (64, 128) and n_kv_heads >= 1
            and n_heads % n_kv_heads == 0 and hidden % 8 == 0
            and intermediate % 8 == 0)


def fused_stack_q8_supported(layers: dict, hidden: int, n_heads: int,
                             n_kv_heads: int, head_dim: int,
                             intermediate: int) -> bool:
    """True when the quantized kernel covers this geometry and layout, as
    the JAX gate fused_layer_q8_supported: fused q|k|v and gate|up, every
    projection on a GGUF grid (either one each) with no bias and K exactly
    its grid's Kp, bf16 norms with q/k head norms, D 64 or 128, whole GQA
    groups.  (The JAX gate's 1024-row K chunks and D = 128 are TPU
    tiling.)"""
    mats, norms = _mats(layers), _norms(layers)
    if any(p is None or grid_info(p) is None or "b" in p for p in mats):
        return False
    if any(p is None or "w" not in p or p["w"].dtype != torch.bfloat16
           for p in norms):
        return False
    NQ, NKV = n_heads * head_dim, n_kv_heads * head_dim
    want = ((hidden, NQ + 2 * NKV), (NQ, hidden), (hidden, 2 * intermediate),
            (intermediate, hidden))
    return (all(_in_out(p) == kn and grid_k(p) % GROUP == 0
                for p, kn in zip(mats, want))
            and head_dim in (64, 128) and n_kv_heads >= 1
            and n_heads % n_kv_heads == 0)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _attend(qkv: torch.Tensor, lyr: dict, li: int, pos: torch.Tensor,
            cos: torch.Tensor, sin: torch.Tensor, k_cache: torch.Tensor,
            v_cache: torch.Tensor, eps: float, n: dict) -> torch.Tensor:
    """One layer's attention in the plain versions, as the Pallas
    _attention_rows: q/k head norms and RoPE, q and the fresh k/v rounded to
    bf16, f32 scores over rows [0, pos) plus the fresh row, probabilities
    rounded to bf16 for the value product as its dot does; writes the fresh
    k/v row at pos.  Returns the (NQ,) f32 output, unrounded."""
    S, D, hkv, hq, NQ, HD = (n[k] for k in ("S", "D", "hkv", "hq", "NQ",
                                            "HD"))
    G = hq // hkv
    bf = torch.bfloat16
    live = (torch.arange(S, device=qkv.device) < pos).reshape(1, 1, S)
    cosf, sinf = cos.reshape(1, D).float(), sin.reshape(1, D).float()
    scale = D ** -0.5
    q = _rms(qkv[:NQ].reshape(hq, D), lyr["q_norm"]["w"][li].float(), eps)
    k = _rms(qkv[NQ:NQ + HD].reshape(hkv, D), lyr["k_norm"]["w"][li].float(),
             eps)
    q = (q * cosf + rotate_half(q) * sinf).to(bf).float()
    k = (k * cosf + rotate_half(k) * sinf).to(bf).float()
    v = qkv[NQ + HD:].reshape(hkv, D).to(bf).float()
    kw = k_cache[li, 0].float().reshape(S, hkv, D)
    vw = v_cache[li, 0].float().reshape(S, hkv, D)
    qg = q.reshape(hkv, G, D)
    s = torch.einsum("hgd,shd->hgs", qg, kw) * scale
    s = torch.where(live, s, -1e30)
    s_cur = (qg * k[:, None, :]).sum(-1, keepdim=True) * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_cur)
    p = torch.exp(s - m)
    p_cur = torch.exp(s_cur - m)
    denom = p.sum(-1, keepdim=True) + p_cur
    o = torch.einsum("hgs,shd->hgd", p.to(bf).float(), vw)
    o = (o + p_cur * v[:, None, :]) / denom
    pidx = pos.reshape(1).long()
    k_cache[li, 0].index_copy_(0, pidx, k.reshape(1, HD).to(k_cache.dtype))
    v_cache[li, 0].index_copy_(0, pidx, v.reshape(1, HD).to(v_cache.dtype))
    return o.reshape(NQ)


def _silu_mul(gu: torch.Tensor, inter: int) -> torch.Tensor:
    g, u = gu[:inter], gu[inter:]
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def fused_decode_stack_plain(x, layers, pos, cos, sin, k_cache, v_cache, eps):
    """Plain version, with the JAX kernel's numerics: hidden state carried
    in f32 across layers, dot inputs rounded to bf16 where its dots take
    them, f32 products; attention as _attend."""
    n = _dims(layers, k_cache)
    bf = torch.bfloat16
    lyr = layers
    xf = x.reshape(n["H"]).float()
    for li in range(n["L"]):
        def w(p):
            return p["w"][li].float()

        h1 = _rms(xf, w(lyr["ln1"]), eps).to(bf).float()
        o = _attend(h1 @ w(lyr["qkv"]), lyr, li, pos, cos, sin, k_cache,
                    v_cache, eps, n)
        xf = xf + o.to(bf).float() @ w(lyr["o"])
        h2 = _rms(xf, w(lyr["ln2"]), eps).to(bf).float()
        act = _silu_mul(h2 @ w(lyr["mlp"]["gateup"]), n["NI"])
        xf = xf + act.to(bf).float() @ w(lyr["mlp"]["down"])
    return xf.to(x.dtype).reshape(1, 1, n["H"])


def fused_decode_stack_q8_plain(x, layers, pos, cos, sin, k_cache, v_cache,
                                eps):
    """Plain version of the quantized stack, with the JAX kernel's numerics:
    the f32 carry; every activation a projection takes (the normed hidden
    state, the attention output, SiLU(g)·u) quantized per 128-group from
    f32 and dotted as the quant-matmul kernels' plain versions do
    (ops/quant_matmul.qdot); attention as _attend."""
    n = _dims(layers, k_cache)
    lyr = layers
    xf = x.reshape(n["H"]).float()
    for li in range(n["L"]):
        def mm(p, v):
            p = {k: t[li] for k, t in p.items()}
            return qdot(p, *quant_acts(v[None], grid_k(p)))[0]

        h1 = _rms(xf, lyr["ln1"]["w"][li].float(), eps)
        o = _attend(mm(lyr["qkv"], h1), lyr, li, pos, cos, sin, k_cache,
                    v_cache, eps, n)
        xf = xf + mm(lyr["o"], o)
        h2 = _rms(xf, lyr["ln2"]["w"][li].float(), eps)
        act = _silu_mul(mm(lyr["mlp"]["gateup"], h2), n["NI"])
        xf = xf + mm(lyr["mlp"]["down"], act)
    return xf.to(x.dtype).reshape(1, 1, n["H"])


def _check_step(x, layers, pos, cos, sin, k_cache, v_cache) -> dict:
    """The checks both wrappers make of the step's tensors; returns _dims."""
    require(x.shape[:2] == (1, 1), "fused stack takes one token of batch 1")
    require(k_cache.ndim == 4 and k_cache.shape == v_cache.shape
            and k_cache.shape[1] == 1, "k/v must be (L, 1, S, Hkv*D)")
    n = _dims(layers, k_cache)
    require(x.shape[2] == n["H"], "hidden width does not match the weights")
    require(cos.numel() == sin.numel() == n["D"], "cos/sin are one (D,) row")
    return n


def _launch_args(x, layers, pos, cos, sin, k_cache, v_cache, n):
    """The card-side checks both kernels share, then (norm pointers, cos,
    sin, workspace, output, grid) for the launch."""
    L, H, D, hq, hkv, NI = (n[k] for k in ("L", "H", "D", "hq", "hkv", "NI"))
    norms = dict(ln1=(L, H), ln2=(L, H), q_norm=(L, D), k_norm=(L, D))
    for name, shape in norms.items():
        t = layers[name]["w"]
        require(tuple(t.shape) == shape and t.device == x.device
                and t.dtype == torch.bfloat16 and t.is_contiguous(),
                f"{name} must be a contiguous {shape} bf16 tensor on x's "
                "device")
    for t in (x, k_cache, v_cache):
        require(t.device == x.device and t.dtype == torch.bfloat16
                and t.is_contiguous() and t.data_ptr() % 16 == 0,
                "x and the caches must be contiguous aligned bf16 tensors")
    require(pos.device == x.device and pos.dtype == torch.int32
            and pos.numel() == 1, "pos must be an int32 device scalar")
    cos_r = cos.reshape(D).float().contiguous()
    sin_r = sin.reshape(D).float().contiguous()
    require(cos_r.device == x.device and sin_r.device == x.device,
            "cos/sin on x's device")
    require(D in (64, 128) and hq % hkv == 0 and H % 8 == 0
            and NI % 8 == 0, f"unsupported geometry D={D} Hq={hq} "
            f"Hkv={hkv} H={H} NI={NI}")
    grid = torch.cuda.get_device_properties(x.device).multi_processor_count
    ws = torch.empty(H + n["NQ"] + 2 * n["HD"] + n["NQ"] + NI
                     + hq * grid * (D + 2), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((1, 1, H), dtype=x.dtype, device=x.device)
    ptrs = [layers[name]["w"].data_ptr() for name in norms]
    return ptrs, cos_r, sin_r, ws, out, grid


def fused_decode_stack(x: torch.Tensor, layers: dict, pos: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """x (1, 1, H); layers: the fused bf16 (L, ...) stacks; pos: int32
    device scalar, the cache row of this token; cos/sin (1, D) f32: the rope
    row of this position over both halves; k/v caches (L, 1, S, Hkv·D),
    written in place at pos.  Returns the stack's output (1, 1, H) before
    the final norm."""
    n = _check_step(x, layers, pos, cos, sin, k_cache, v_cache)
    if not x.is_cuda:
        return fused_decode_stack_plain(x, layers, pos, cos, sin, k_cache,
                                        v_cache, eps)
    L, H, NI = n["L"], n["H"], n["NI"]
    shapes = dict(qkv=(L, H, n["NQ"] + 2 * n["HD"]), o=(L, n["NQ"], H),
                  gateup=(L, H, 2 * NI), down=(L, NI, H))
    w = dict(zip(shapes, (p["w"] for p in _mats(layers))))
    for name, shape in shapes.items():
        t = w[name]
        require(tuple(t.shape) == shape, f"{name} is {tuple(t.shape)}, "
                f"expected {shape}")
        require(t.device == x.device and t.dtype == torch.bfloat16
                and t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{name} must be a contiguous, 16-byte aligned bf16 tensor "
                f"on x's device")
    norms, cos_r, sin_r, ws, out, grid = _launch_args(
        x, layers, pos, cos, sin, k_cache, v_cache, n)
    rc = kernels.lib().aha_fused_decode_stack(
        x.data_ptr(), *(t.data_ptr() for t in w.values()), *norms,
        cos_r.data_ptr(), sin_r.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
        L, H, n["hq"], n["hkv"], n["D"], NI, n["S"], float(eps),
        float(n["D"] ** -0.5), grid, kernels.stream_handle(x))
    kernels.check(rc, "aha_fused_decode_stack")
    fused_decode_stack.launches += 1
    return out


def fused_decode_stack_q8(x: torch.Tensor, layers: dict, pos: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """fused_decode_stack over the GGUF grids: layers holds the fused
    (L, N, ...) grid dicts of q|k|v, o, gate|up and down (each on either
    grid, fused_stack_q8_supported) and bf16 norms; the rest as there."""
    n = _check_step(x, layers, pos, cos, sin, k_cache, v_cache)
    if not x.is_cuda:
        return fused_decode_stack_q8_plain(x, layers, pos, cos, sin,
                                           k_cache, v_cache, eps)
    L, H, NQ, NI = n["L"], n["H"], n["NQ"], n["NI"]
    want = ((H, NQ + 2 * n["HD"]), (NQ, H), (H, 2 * NI), (NI, H))
    w, s, b, q4 = [], [], [], []
    for name, p, (K, N) in zip(("qkv", "o", "gateup", "down"),
                               _mats(layers), want):
        require(grid_info(p) is not None and "b" not in p,
                f"{name} must be an unbiased grid dict")
        shape = check_grid(p, x.device, K, name, layers=L)
        require(shape == (N, K), f"{name} is {shape} (N, Kp), expected "
                f"{(N, K)}")
        tensors = [p[k] for k in GRID_KEYS["q4" if "q4" in p else "q8"]]
        w.append(tensors[0].data_ptr())
        s.append(tensors[1].data_ptr())
        b.append(tensors[2].data_ptr() if "q4" in p else None)
        q4.append(int("q4" in p))
    norms, cos_r, sin_r, ws, out, grid = _launch_args(
        x, layers, pos, cos, sin, k_cache, v_cache, n)
    ptrs = [(ctypes.c_void_p * 4)(*a) for a in (w, s, b)]
    flags = (ctypes.c_int * 4)(*q4)
    rc = kernels.lib().aha_fused_decode_stack_q8(
        x.data_ptr(), *(ctypes.addressof(a) for a in ptrs),
        ctypes.addressof(flags), *norms, cos_r.data_ptr(), sin_r.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), L, H, n["hq"], n["hkv"], n["D"], NI,
        n["S"], float(eps), float(n["D"] ** -0.5), grid,
        kernels.stream_handle(x))
    kernels.check(rc, "aha_fused_decode_stack_q8")
    fused_decode_stack_q8.launches += 1
    return out


fused_decode_stack.launches = 0
fused_decode_stack_q8.launches = 0
