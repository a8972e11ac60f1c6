"""The whole-stack fused decode step (batch 1, one token, bf16 dense Qwen3).

Replaces aha_tpu/ops/fused_layer.py:fused_decode_stack with the CUDA kernel
of csrc/fused_decode_stack.cu: every layer's norms, fused q|k|v and gate|up
products, q/k head norms, RoPE, attention over the cache plus the fresh
row, o-proj, SwiGLU and residuals in ONE cooperative launch.  Bound: the
weight bytes (840 MB a step for Qwen3-0.6B), read once; the per-op chain
instead pays ~70 host dispatches and launches per layer.  The design — a
persistent block per SM, six grid barriers per layer, deterministic
block-level GEMV reductions — is described in the source.

Unlike the JAX function, which returns new cache arrays, the kernel writes
the new K/V row of every layer IN PLACE at `pos` (the port's caches are
pooled and updated in place, core/cache.py), and returns only the hidden
state.  The JAX kernel's static `window` is a VMEM bound; the CUDA kernel
reads the live length from the device, so the port has no window argument.
`MAX_WINDOW` stays the gate of the model (models/qwen3.py): the fused step
runs while at most that many cache rows are live, as in the JAX package.

On the CPU the plain version runs; on the card the kernel runs or this
raises.  `fused_decode_stack.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.rope import rotate_half

#: the live-row bound of the JAX package's fused path (its VMEM window)
MAX_WINDOW = 2048


def _dims(layers: dict, k_cache: torch.Tensor) -> dict:
    L, _, S, HD = k_cache.shape
    D = layers["q_norm"]["w"].shape[-1]
    NQ = layers["o"]["w"].shape[1]
    return dict(L=L, S=S, H=layers["o"]["w"].shape[2], D=D, hkv=HD // D,
                hq=NQ // D, NQ=NQ, HD=HD, NI=layers["mlp"]["down"]["w"].shape[1])


def fused_stack_supported(layers: dict, hidden: int, n_heads: int,
                          n_kv_heads: int, head_dim: int,
                          intermediate: int) -> bool:
    """True when the kernel covers this geometry and parameter layout:
    fused bf16 qkv/gateup weights (fuse_decode_params), q/k head norms, no
    biases, D 64 or 128, whole GQA groups, widths in 8-column chunks."""
    mlp = layers.get("mlp", {})
    parts = [layers.get("qkv"), layers.get("o"), mlp.get("gateup"),
             mlp.get("down"), layers.get("ln1"), layers.get("ln2"),
             layers.get("q_norm"), layers.get("k_norm")]
    if any(p is None or "w" not in p or "b" in p for p in parts):
        return False
    if any(p["w"].dtype != torch.bfloat16 for p in parts):
        return False
    return (head_dim in (64, 128) and n_kv_heads >= 1
            and n_heads % n_kv_heads == 0 and hidden % 8 == 0
            and intermediate % 8 == 0)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def fused_decode_stack_plain(x, layers, pos, cos, sin, k_cache, v_cache, eps):
    """Plain version, with the JAX kernel's numerics: hidden state carried
    in f32 across layers, dot inputs rounded to bf16 where its dots take
    them, f32 products; attention over rows [0, pos) plus the fresh row,
    probabilities rounded to bf16 for the value product as its dot does."""
    n = _dims(layers, k_cache)
    L, S, H, D, hkv, hq, NQ, HD, NI = (n[k] for k in (
        "L", "S", "H", "D", "hkv", "hq", "NQ", "HD", "NI"))
    G = hq // hkv
    bf = torch.bfloat16
    lyr = layers
    pidx = pos.reshape(1).long()
    live = (torch.arange(S, device=x.device) < pos).reshape(1, 1, S)
    cosf, sinf = cos.reshape(1, D).float(), sin.reshape(1, D).float()
    scale = D ** -0.5
    xf = x.reshape(H).float()
    for li in range(L):
        def w(p):
            return p["w"][li].float()

        h1 = _rms(xf, w(lyr["ln1"]), eps).to(bf).float()
        qkv = h1 @ w(lyr["qkv"])
        q = _rms(qkv[:NQ].reshape(hq, D), w(lyr["q_norm"]), eps)
        k = _rms(qkv[NQ:NQ + HD].reshape(hkv, D), w(lyr["k_norm"]), eps)
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
        xf = xf + o.reshape(NQ).to(bf).float() @ w(lyr["o"])
        h2 = _rms(xf, w(lyr["ln2"]), eps).to(bf).float()
        gu = h2 @ w(lyr["mlp"]["gateup"])
        g, u = gu[:NI], gu[NI:]
        act = g * (1.0 / (1.0 + torch.exp(-g))) * u
        xf = xf + act.to(bf).float() @ w(lyr["mlp"]["down"])
        k_cache[li, 0].index_copy_(0, pidx, k.reshape(1, HD).to(k_cache.dtype))
        v_cache[li, 0].index_copy_(0, pidx, v.reshape(1, HD).to(v_cache.dtype))
    return xf.to(x.dtype).reshape(1, 1, H)


def fused_decode_stack(x: torch.Tensor, layers: dict, pos: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """x (1, 1, H); layers: the fused (L, ...) stacks; pos: int32 device
    scalar, the cache row of this token; cos/sin (1, D) f32: the rope row of
    this position over both halves; k/v caches (L, 1, S, Hkv·D), written in
    place at pos.  Returns the stack's output (1, 1, H) before the final
    norm."""
    require(x.shape[:2] == (1, 1), "fused stack takes one token of batch 1")
    require(k_cache.ndim == 4 and k_cache.shape == v_cache.shape
            and k_cache.shape[1] == 1, "k/v must be (L, 1, S, Hkv*D)")
    n = _dims(layers, k_cache)
    require(x.shape[2] == n["H"], "hidden width does not match the weights")
    require(cos.numel() == sin.numel() == n["D"], "cos/sin are one (D,) row")
    if not x.is_cuda:
        return fused_decode_stack_plain(x, layers, pos, cos, sin, k_cache,
                                        v_cache, eps)
    L, H, D, hq, hkv, NI = (n[k] for k in ("L", "H", "D", "hq", "hkv", "NI"))
    shapes = dict(qkv=(L, H, n["NQ"] + 2 * n["HD"]), o=(L, n["NQ"], H),
                  gateup=(L, H, 2 * NI), down=(L, NI, H), ln1=(L, H),
                  ln2=(L, H), q_norm=(L, D), k_norm=(L, D))
    mlp = layers["mlp"]
    w = {name: (mlp[name] if name in ("gateup", "down") else layers[name])["w"]
         for name in shapes}
    for name, shape in shapes.items():
        t = w[name]
        require(tuple(t.shape) == shape, f"{name} is {tuple(t.shape)}, "
                f"expected {shape}")
        require(t.device == x.device and t.dtype == torch.bfloat16
                and t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{name} must be a contiguous, 16-byte aligned bf16 tensor "
                f"on x's device")
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
    rc = kernels.lib().aha_fused_decode_stack(
        x.data_ptr(), w["qkv"].data_ptr(), w["o"].data_ptr(),
        w["gateup"].data_ptr(), w["down"].data_ptr(), w["ln1"].data_ptr(),
        w["ln2"].data_ptr(), w["q_norm"].data_ptr(), w["k_norm"].data_ptr(),
        cos_r.data_ptr(), sin_r.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
        L, H, hq, hkv, D, NI, k_cache.shape[2], float(eps), float(D ** -0.5),
        grid, kernels.stream_handle(x))
    kernels.check(rc, "aha_fused_decode_stack")
    fused_decode_stack.launches += 1
    return out


fused_decode_stack.launches = 0
