"""Matmuls over GGUF block-quantized weights (counterpart of
aha_tpu/ops/quant_matmul.py).

Two grids, with the JAX package's meaning:

- int8: one f32 scale per (128-row K group, column), w = q·s;
- 4-bit: unsigned nibbles n ∈ [0, 15] with an f32 scale s and min b per
  (group, column), w = n·s + b.

The byte order is the port's own, chosen for Hopper: **column-major
rows**.  `qt` is (N, Kp) int8, `q4` (N, Kp/2) uint8 with two adjacent K
values per byte (even k in the low nibble), the scales and mins (N, Kp/128)
f32; a stacked decoder carries a leading (L, ...) axis.  A column's K bytes
are contiguous, so a lane reads 16 of them in one load and `__dp4a` takes
four consecutive K values per 32-bit word; the quantized head is then
vocab-major like the bf16 head kernel's (V, K).  K is padded to a multiple
of 128 only (padded groups carry scale 0): the JAX package's 1024-row
chunks are VMEM tiling, and its folded high nibbles ((n − 8) & 15 with s/16
and b + 8s) a Mosaic workaround — `io/convert.quant_from_jax` unfolds them.

Kernels (csrc/quant_matmul.cu, csrc/quant_swiglu.cu, both on the
tensor-core dot of csrc/quant_mma.cuh), each with a plain version that
repeats its arithmetic — activations quantized per (row, 128-group) to int8
(sx = max|x|/127, round half to even of x/sx, the exact f32 group sum for
the 4-bit grid's min term), an integer dot per group, scales applied after
the dot — and a `.launches` count:

- `quant_matmul` / `quant_matmul_q4`: x (M, K) @ W → (M, N);
- `quant_swiglu`: down(SiLU(gate(x))·up(x)) in one cooperative launch.

Each launch runs on a plan (`matmul_plan`, `swiglu_plan`) that depends on
the grid's Kp, its columns and the SM count, never on M, so a row's output
is bit-equal whatever rows share its launch.

`quant_linear` routes as the JAX package does: on a CUDA tensor M ≤
MAX_KERNEL_M goes to the kernel and larger M to dequantize + matmul; on a
CPU tensor the dequantize path always runs, as the JAX package's non-TPU
branch does.  `dequant_matmul` / `dequant_matmul_q4` (quant_matmul_xla /
quant_matmul_q4_xla there) run outside any kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from aha_tpu_torch.ops import kernels
from aha_tpu_torch.ops.kernels import require
from aha_tpu_torch.ops.launches import count
from aha_tpu_torch.utils.device import sm_count

GROUP = 128          # weight / activation quantization group (rows of K)
#: above this many rows the dequantize-then-matmul path takes over (the
#: JAX package's MAX_KERNEL_M)
MAX_KERNEL_M = 64
#: sub-5-bit GGML types packed onto the 4-bit grid; 5 bits and up go to
#: int8 (ids per io/gguf.py): Q4_0/Q4_1/Q2_K/Q3_K/Q4_K/IQ4_NL/IQ4_XS
Q4_TYPES = {2, 3, 10, 11, 12, 20, 23}
#: the tensors of each grid's dict, in the kernels' argument order; the
#: column axis of every one of them is -2
GRID_KEYS = {"q8": ("qt", "st"), "q4": ("q4", "s4", "b4")}
#: rows per pass each kernel is built for (csrc/quant_matmul.cu,
#: csrc/quant_swiglu.cu)
MATMUL_PASS_ROWS = (1, 2, 4, 8, 16)
SWIGLU_PASS_ROWS = (1, 4, 8, 16)
#: the kernels' plan constants (csrc/quant_mma.cuh and the two kernels):
#: output columns a unit (one mma n-tile), staged row padding, groups ×
#: tiles a warp holds in registers, warps a block
UNIT_COLS = 8
ROW_PAD = 16
SPAN_TILES = 4
MATMUL_WARPS = 8
SWIGLU_WARPS = 8

def supports_kernel_layout(Kp: int) -> bool:
    return Kp % GROUP == 0


def is_quantized(p: dict) -> bool:
    return "qt" in p or "q4" in p


# -- packers ------------------------------------------------------------------


def _true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, as the kernels and numpy divide.  On a CUDA
    tensor PyTorch multiplies by the reciprocal of a Python-scalar divisor,
    which can land one ulp off max|x|/127 and flip a value that sits at a
    .5 boundary by a whole quantization step; a tensor divisor keeps the
    true division."""
    return a / torch.full_like(a, b)


def _groups(w) -> torch.Tensor:
    """(..., N, K) float (numpy or torch) → f32 (..., N, Kp/128, 128), K
    zero-padded to a multiple of 128."""
    w = (w.float() if isinstance(w, torch.Tensor)
         else torch.from_numpy(np.array(w, dtype=np.float32)))
    pad = (-w.shape[-1]) % GROUP
    if pad:
        w = F.pad(w, (0, pad))
    return w.reshape(*w.shape[:-1], w.shape[-1] // GROUP, GROUP)


def pack_q8_rows(w) -> dict:
    """(..., N, K) float → {"qt": int8 (..., N, Kp), "st": f32 (..., N,
    Kp/128)}: symmetric int8 per 128-group, as aha_tpu's pack_q8_rows."""
    xb = _groups(w)
    d = _true_div(xb.abs().amax(-1), 127.0)
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    q = torch.round(xb / d_safe[..., None]).clamp(-127, 127).to(torch.int8)
    return {"qt": q.flatten(-2).contiguous(), "st": d.contiguous()}


def pack_q4_rows(w) -> dict:
    """(..., N, K) float → {"q4": uint8 (..., N, Kp/2), "s4", "b4": f32
    (..., N, Kp/128)}: the affine grid w ≈ n·s + b per 128-group, s =
    (max − min)/15, b = min, as aha_tpu's pack_q4_rows before its fold."""
    xb = _groups(w)
    mn, mx = xb.amin(-1), xb.amax(-1)
    d = _true_div(mx - mn, 15.0)
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    n = torch.round((xb - mn[..., None]) / d_safe[..., None]).clamp(0, 15)
    n = n.to(torch.uint8).flatten(-2)
    return {"q4": (n[..., 0::2] | (n[..., 1::2] << 4)).contiguous(),
            "s4": d.contiguous(), "b4": mn.contiguous()}


def pack_rows(w, q4: bool) -> dict:
    return pack_q4_rows(w) if q4 else pack_q8_rows(w)


def from_gguf_tensor(gguf, name: str,
                     device: torch.device | str = "cpu") -> dict:
    """GGUF tensor → the port's grid on `device`: sub-5-bit formats on the
    4-bit grid (its min row keeps the mins Q4_1/Q4_K/Q2_K encode), 5 bits
    and up on the int8 grid (Q8_0's per-32 scales regroup per 128 with ≤
    0.5 ulp of extra rounding)."""
    info = gguf.tensors[name]
    w = torch.from_numpy(gguf.dequantize(name).reshape(info.shape)).to(device)
    return pack_rows(w, info.ggml_type in Q4_TYPES)


# -- plain versions -----------------------------------------------------------


def quant_acts(x: torch.Tensor, Kp: int):
    """(M, K) float → (xq (M, G, 128) f32 holding integers, sx (M, G),
    xsum (M, G)): per-(row, group) symmetric int8 with a true division and
    round half to even, the exact f32 group sums; K zero-padded to Kp."""
    x = x.float()
    if Kp > x.shape[-1]:
        x = F.pad(x, (0, Kp - x.shape[-1]))
    x3 = x.reshape(x.shape[0], Kp // GROUP, GROUP)
    sx = _true_div(x3.abs().amax(-1), 127.0)
    d = torch.where(sx == 0, torch.ones_like(sx), sx)
    return torch.round(x3 / d[..., None]), sx, x3.sum(-1)


def _unpack_q4(q4: torch.Tensor) -> torch.Tensor:
    """(..., N, Kp/2) packed → (..., N, Kp) uint8 nibbles in K order."""
    return torch.stack([q4 & 15, q4 >> 4], -1).flatten(-2)


def qdot(p: dict, xq: torch.Tensor, sx: torch.Tensor,
          xsum: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic after activation quantization: an integer
    dot per (row, column, group) — exact in f32, every partial sum < 2^24 —
    times sx·s, summed over groups, plus Σ_g xsum·b on the 4-bit grid.
    Returns (M, N) f32."""
    M, G, _ = xq.shape
    if "qt" in p:
        w, s = p["qt"], p["st"]
    else:
        w, s = _unpack_q4(p["q4"]), p["s4"]
    N = w.shape[0]
    idot = torch.einsum("mgk,ngk->mng", xq, w.float().reshape(N, G, GROUP))
    y = (idot * (sx[:, None, :] * s[None])).sum(-1)
    if "q4" in p:
        y = y + xsum @ p["b4"].t()
    return y


def grid_k(p: dict) -> int:
    return p["qt"].shape[-1] if "qt" in p else p["q4"].shape[-1] * 2


def quant_matmul_plain(x, qt, st):
    """Plain version of the int8 kernel: (M, K) → (M, N) in x's dtype."""
    p = {"qt": qt, "st": st}
    return qdot(p, *quant_acts(x, grid_k(p))).to(x.dtype)


def quant_matmul_q4_plain(x, q4, s4, b4):
    """Plain version of the 4-bit kernel: (M, K) → (M, N) in x's dtype."""
    p = {"q4": q4, "s4": s4, "b4": b4}
    return qdot(p, *quant_acts(x, grid_k(p))).to(x.dtype)


def _silu_mul(h: torch.Tensor, inter: int) -> torch.Tensor:
    g, u = h[:, :inter], h[:, inter:]
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def quant_swiglu_plain(gu: dict, dn: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel: (M, H) → (M, H_out) in x's
    dtype; the SiLU·mul activation stays f32 and is requantized for the
    down product, as the JAX kernel does in VMEM."""
    h = qdot(gu, *quant_acts(x, grid_k(gu)))
    a = _silu_mul(h, h.shape[1] // 2)
    return qdot(dn, *quant_acts(a, grid_k(dn))).to(x.dtype)


# -- dequantize + matmul ------------------------------------------------------


def dequant(p: dict) -> torch.Tensor:
    """A quantized dict → its (..., N, Kp) f32 weights."""
    if "qt" in p:
        return p["qt"].float() * p["st"].repeat_interleave(GROUP, -1)
    return (_unpack_q4(p["q4"]).float() * p["s4"].repeat_interleave(GROUP, -1)
            + p["b4"].repeat_interleave(GROUP, -1))


def _dequant_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    w = dequant(p)
    xf = x.float()
    if w.shape[-1] > xf.shape[-1]:
        xf = F.pad(xf, (0, w.shape[-1] - xf.shape[-1]))
    return (xf @ w.t()).to(x.dtype)


def dequant_matmul(x, qt, st):
    """Exact per-group dequantize then an f32 matmul (no activation
    quantization): aha_tpu's quant_matmul_xla, the large-M path."""
    return _dequant_matmul(x, {"qt": qt, "st": st})


def dequant_matmul_q4(x, q4, s4, b4):
    """The 4-bit grid's dequantize-then-matmul (quant_matmul_q4_xla)."""
    return _dequant_matmul(x, {"q4": q4, "s4": s4, "b4": b4})


# -- kernel wrappers ----------------------------------------------------------


def staged_bytes(rows: int, Kp: int) -> int:
    """Shared memory of `rows` staged activation rows of width Kp: the int8
    values at row stride Kp + 16 and an f32 scale and sum per 128-group
    (csrc/quant_mma.cuh staged_mma_bytes)."""
    return rows * (Kp + ROW_PAD) + 8 * rows * (Kp // GROUP)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MatmulPlan:
    """csrc/quant_matmul.cu's launch: `wk` of a block's `warps` share a
    unit of UNIT_COLS columns, so a block step takes warps / wk units, and
    block b takes steps b, b + grid, ...; a unit's K runs in `chunks`
    chunks of `wk · span` groups, warp part p taking chunk groups
    [p·span, (p+1)·span); `fixed` bytes of shared memory besides the
    staged rows (two buffers of the warps' partials where they share a
    unit)."""
    warps: int
    wk: int
    span: int
    chunks: int
    grid: int
    fixed: int


def matmul_plan(Kp: int, N: int, sms: int) -> MatmulPlan:
    """The plan of an (N, Kp) grid on a card of `sms` SMs.  Every block
    quantizes all of x, so where the units fit one step of at most one
    block an SM, that is the plan: the way of sharing a unit among wk of
    the block's warps that gives the most blocks, then the fewest warps a
    unit (Qwen3-0.6B's q|k|v: 2 warps a unit, 128 blocks; gate|up: 1, 96;
    o and down: all 8, 128).  Otherwise (the head) units stream through
    two blocks an SM, two warps a unit, which read fastest on the card.
    A warp holds at most SPAN_TILES groups at once."""
    W, G, U = MATMUL_WARPS, Kp // GROUP, _cdiv(N, UNIT_COLS)
    one_step = [w for w in (1, 2, 4, 8) if _cdiv(U, W // w) <= sms]
    if one_step:
        wk = max(one_step, key=lambda w: (_cdiv(U, W // w), -w))
        grid = _cdiv(U, W // wk)
    else:
        wk, grid = 2, 2 * sms
    chunks = _cdiv(G, wk * SPAN_TILES)
    span = _cdiv(G, wk * chunks)
    return MatmulPlan(W, wk, span, chunks, grid,
                      2 * W * 128 * 4 if wk > 1 else 0)


@dataclass(frozen=True)
class SwigluPlan:
    """csrc/quant_swiglu.cu's launch: `grid` blocks (one an SM), block b
    taking the units b, b + grid, ... of each phase — phase 1's of 8 gate
    and the same 8 up columns, phase 3's of 8 down columns — all its warps
    on each unit, whose K runs in chunks1 / chunks3 chunks of
    `warps · span1` / `warps · span3` groups; `fixed` bytes of shared
    memory besides the staged rows (two buffers of the warps' partials)."""
    warps: int
    span1: int
    chunks1: int
    span3: int
    chunks3: int
    grid: int
    fixed: int


def swiglu_plan(gKp: int, inter: int, sms: int) -> SwigluPlan:
    """The fused MLP's plan (a gate|up unit's two tiles share the
    registers of SPAN_TILES groups)."""
    W, G1, G3 = SWIGLU_WARPS, gKp // GROUP, inter // GROUP
    chunks1 = _cdiv(G1, W * SPAN_TILES // 2)
    chunks3 = _cdiv(G3, W * SPAN_TILES)
    return SwigluPlan(W, _cdiv(G1, W * chunks1), chunks1, _cdiv(G3, W * chunks3),
                      chunks3, sms, 2 * W * 2 * 128 * 4)


def matmul_launch(M: int, Kp: int, N: int, sms: int,
                  smem_limit: int) -> tuple[MatmulPlan, int]:
    """The int8 / 4-bit kernel's plan and rows per pass for M rows."""
    plan = matmul_plan(Kp, N, sms)
    return plan, pass_rows(M, Kp, smem_limit - plan.fixed)


def swiglu_launch(M: int, gKp: int, inter: int, sms: int,
                  smem_limit: int) -> tuple[SwigluPlan, int]:
    """The fused MLP's plan and rows per pass for M rows."""
    plan = swiglu_plan(gKp, inter, sms)
    return plan, pass_rows(M, max(gKp, inter), smem_limit - plan.fixed,
                           SWIGLU_PASS_ROWS)


def pass_rows(m: int, Kp: int, smem_limit: int,
              sizes: tuple[int, ...] = MATMUL_PASS_ROWS) -> int:
    """Rows a kernel stages per pass: the fewest of `sizes` that take all m
    rows (at most the largest), stepped down to the most whose staged rows
    of width Kp fit `smem_limit` bytes of shared memory.  Raises if not one
    row fits."""
    fits = [r for r in sizes if staged_bytes(r, Kp) <= smem_limit]
    require(bool(fits), f"one staged row of {Kp} columns needs "
            f"{staged_bytes(1, Kp)} B of shared memory, over {smem_limit}")
    want = min(r for r in sizes if r >= min(m, sizes[-1]))
    return max(r for r in fits if r <= want)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_grid(p: dict, device: torch.device, K: int, what: str,
               layers: int | None = None) -> tuple[int, int]:
    """(N, Kp) of a quantized dict the kernels take, on `device`, for
    inputs of width K; with `layers`, of a stacked (layers, N, ...) one."""
    q4 = "q4" in p
    w = p["q4"] if q4 else p["qt"]
    s = p["s4"] if q4 else p["st"]
    lead = () if layers is None else (layers,)
    N, Kp = w.shape[-2], grid_k(p)
    require(w.shape[:-2] == lead and w.ndim == len(lead) + 2
            and w.dtype == (torch.uint8 if q4 else torch.int8),
            f"{what}: weights must be {lead + ('N', 'Kp/2' if q4 else 'Kp')}"
            f" {'uint8' if q4 else 'int8'}")
    require(supports_kernel_layout(Kp) and K <= Kp,
            f"{what}: Kp {Kp} must be a multiple of {GROUP} and ≥ K {K}")
    mins = (p["b4"],) if q4 else ()
    for t in (s, *mins):
        require(tuple(t.shape) == (*lead, N, Kp // GROUP)
                and t.dtype == torch.float32,
                f"{what}: scales must be {lead + ('N', f'Kp/{GROUP}')} f32")
    for t in (w, s, *mins):
        require(t.device == device and t.is_contiguous(),
                f"{what}: weights must be contiguous on x's device")
    require(w.data_ptr() % 16 == 0, f"{what}: weights 16-byte aligned")
    return N, Kp


def _launch_matmul(x: torch.Tensor, p: dict, what: str) -> torch.Tensor:
    require(x.ndim == 2 and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"{what} kernel takes a contiguous (M, K) bf16 x")
    M, K = x.shape
    N, Kp = check_grid(p, x.device, K, what)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    q4 = "q4" in p
    plan, rows = matmul_launch(M, Kp, N, sm_count(x.device),
                               kernels.smem_optin(x.device))
    rc = kernels.lib().aha_quant_matmul(
        x.data_ptr(), (p["q4"] if q4 else p["qt"]).data_ptr(),
        (p["s4"] if q4 else p["st"]).data_ptr(), _ptr(p.get("b4")),
        out.data_ptr(), M, K, N, Kp, int(q4), rows, plan.wk, plan.span,
        plan.chunks, plan.grid, kernels.stream_handle(x))
    kernels.check(rc, what)
    return out


def quant_matmul(x: torch.Tensor, qt: torch.Tensor,
                 st: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(qt, st) → (M, N): the int8 kernel on the card
    (bf16 x, M any; callers send M ≤ MAX_KERNEL_M), the plain version on
    the CPU."""
    if not x.is_cuda:
        return quant_matmul_plain(x, qt, st)
    out = _launch_matmul(x, {"qt": qt, "st": st}, "quant_matmul")
    count(quant_matmul)
    return out


def quant_matmul_q4(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                    b4: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant4(q4, s4, b4) → (M, N), the 4-bit kernel."""
    if not x.is_cuda:
        return quant_matmul_q4_plain(x, q4, s4, b4)
    out = _launch_matmul(x, {"q4": q4, "s4": s4, "b4": b4},
                         "quant_matmul_q4")
    count(quant_matmul_q4)
    return out


quant_matmul.launches = 0
quant_matmul_q4.launches = 0


def quant_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Linear over a quantized dict ({"qt", "st"} or {"q4", "s4", "b4"},
    optional dense bias "b"): x (..., K) → (..., N)."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    kernel = x2.is_cuda and x2.shape[0] <= MAX_KERNEL_M
    if "q4" in p:
        args = (p["q4"], p["s4"], p["b4"])
        y = (quant_matmul_q4 if kernel else dequant_matmul_q4)(x2, *args)
    else:
        args = (p["qt"], p["st"])
        y = (quant_matmul if kernel else dequant_matmul)(x2, *args)
    if "b" in p:
        y = y + p["b"]
    return y.reshape(*lead, y.shape[-1])


# -- fused quantized SwiGLU ---------------------------------------------------


def grid_info(p: dict) -> tuple[bool, int, int] | None:
    """(is_q4, Kp, N) of a quantized dict, or None."""
    if "qt" in p:
        return False, p["qt"].shape[-1], p["qt"].shape[-2]
    if "q4" in p:
        return True, p["q4"].shape[-1] * 2, p["q4"].shape[-2]
    return None


def concat_columns(parts: list[dict]) -> dict | None:
    """Quantized dicts concatenated on their column axis (one grid, equal
    Kp, no biases), or None.  Column blocks of a product are independent and
    every grid scales per column, so the result's products are bit-identical
    to the parts'."""
    infos = [grid_info(p) for p in parts]
    if any(i is None for i in infos) or any("b" in p for p in parts) \
            or len({i[:2] for i in infos}) != 1:
        return None
    keys = GRID_KEYS["q4" if infos[0][0] else "q8"]
    return {k: torch.cat([p[k] for p in parts], dim=-2) for k in keys}


def pad_quant_cols(p: dict, mult: int = 128) -> dict:
    """A quantized dict's columns zero-padded to a multiple of `mult` (the
    JAX package's pad_quant_cols, on the port's column axis −2): pad
    columns carry zero integers, scales and mins, so they dequantize to
    exact zeros and their products are 0; callers slice them off.  Dense
    dicts, and grids already on the multiple, pass through."""
    info = grid_info(p)
    if info is None or info[2] % mult == 0:
        return p
    pad = mult - info[2] % mult
    return {k: F.pad(v, (0, 0, 0, pad)) for k, v in p.items()}


def swiglu_fusable(gu: dict, dn: dict, m: int) -> bool:
    """True when the fused kernel covers this MLP: both weights on a
    quantized grid, no biases, the gate|up split clean on 128-column
    halves, the down projection's K exactly the intermediate size,
    128-multiple output columns, and decode-sized M.  The JAX gate's VMEM
    budget (_SWIGLU_VMEM_BYTES) is a TPU limit: the Hopper kernel streams
    its weights, and stages the activations in passes of as many rows as
    its shared memory holds (pass_rows)."""
    gi, di = grid_info(gu), grid_info(dn)
    if gi is None or di is None or "b" in gu or "b" in dn:
        return False
    _, gKp, gN = gi
    _, dKp, dN = di
    return (m <= MAX_KERNEL_M and gN % 256 == 0
            and supports_kernel_layout(gKp) and supports_kernel_layout(dKp)
            and dKp == gN // 2 and dN % 128 == 0)


def quant_swiglu(gu: dict, dn: dict, x: torch.Tensor) -> torch.Tensor:
    """down(SiLU(gate(x))·up(x)) over the fused [gate | up] dict `gu` and
    the `dn` dict, q8 or q4 either side; x (..., H) → (..., H_out).  One
    cooperative launch on the card (callers gate on swiglu_fusable), the
    plain version on the CPU."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not x.is_cuda:
        return quant_swiglu_plain(gu, dn, x2).reshape(*lead, -1)
    M, H = x2.shape
    require(swiglu_fusable(gu, dn, M), "quant_swiglu: layout the fused "
            "kernel does not take (swiglu_fusable is False)")
    require(x2.dtype == torch.bfloat16, "quant_swiglu kernel takes bf16 x")
    x2 = x2.contiguous()
    gN, _ = check_grid(gu, x.device, H, "quant_swiglu gate|up")
    inter = gN // 2
    dN, _ = check_grid(dn, x.device, inter, "quant_swiglu down")
    g4, d4 = "q4" in gu, "q4" in dn
    act = torch.empty((M, inter), dtype=torch.float32, device=x.device)
    out = torch.empty((M, dN), dtype=x.dtype, device=x.device)
    plan, rows = swiglu_launch(M, grid_k(gu), inter, sm_count(x.device),
                               kernels.smem_optin(x.device))
    rc = kernels.lib().aha_quant_swiglu(
        x2.data_ptr(), (gu["q4"] if g4 else gu["qt"]).data_ptr(),
        (gu["s4"] if g4 else gu["st"]).data_ptr(), _ptr(gu.get("b4")),
        (dn["q4"] if d4 else dn["qt"]).data_ptr(),
        (dn["s4"] if d4 else dn["st"]).data_ptr(), _ptr(dn.get("b4")),
        act.data_ptr(), out.data_ptr(), M, H, grid_k(gu), inter, dN, int(g4),
        int(d4), rows, plan.span1, plan.chunks1, plan.span3, plan.chunks3,
        plan.grid, kernels.stream_handle(x))
    kernels.check(rc, "aha_quant_swiglu")
    count(quant_swiglu)
    return out.reshape(*lead, dN)


quant_swiglu.launches = 0
