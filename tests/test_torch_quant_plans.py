"""The launch plans of the tensor-core GGUF kernels (csrc/quant_matmul.cu,
csrc/quant_swiglu.cu), checked on the CPU: `ops/quant_matmul.matmul_plan`
and `swiglu_plan` are pure functions of the grid's Kp, its columns and the
SM count.  Each test walks the plan's index map as the kernels walk it —
block → steps → units, chunk → warp → groups — and holds it to what the
kernels need: every output column and every 128-group taken exactly once,
the same plan whatever M, the shared memory within an H100 block's opt-in
232,448 bytes at each pass size, and enough weight loads in flight a
lane."""

import itertools

import numpy as np
import pytest

from aha_tpu_torch.ops import quant_matmul as qm

SMS = 132            # H100 SXM
LIMIT = 232_448      # its opt-in shared memory a block
NS = (1001, 4096, 1024, 151936)
KPS = (128, 1024, 3072, 17408)


def _cdiv(a, b):
    return -(-a // b)


def _groups_taken(G, chunks, parts, span):
    """How many times each of G groups is multiplied for one unit: chunk c,
    warp part p takes groups c·parts·span + p·span + [0, span), those past
    G skipped (quant_mma.cuh load_frags / mma_frags)."""
    taken = np.zeros(G, np.int64)
    for c, p, i in itertools.product(range(chunks), range(parts), range(span)):
        gg = c * parts * span + p * span + i
        if gg < G:
            taken[gg] += 1
    return taken


def _units_taken(U, grid, upb):
    """How many (block, step, slot) triples take each of U units: block b's
    step k takes units (b + k·grid)·upb + [0, upb), those past U masked."""
    taken = np.zeros(U, np.int64)
    steps_all = _cdiv(U, upb)
    for b in range(grid):
        for step in range(b, steps_all, grid):
            for us in range(upb):
                u = step * upb + us
                if u < U:
                    taken[u] += 1
    return taken


@pytest.mark.parametrize("N,Kp", list(itertools.product(NS, KPS)))
def test_matmul_plan_covers_every_column_and_group_once(N, Kp):
    plan = qm.matmul_plan(Kp, N, SMS)
    G, U = Kp // qm.GROUP, _cdiv(N, qm.UNIT_COLS)
    assert plan.warps % plan.wk == 0 and 1 <= plan.span <= qm.SPAN_TILES
    assert (_units_taken(U, plan.grid, plan.warps // plan.wk) == 1).all()
    assert (_groups_taken(G, plan.chunks, plan.wk, plan.span) == 1).all()
    # unit u is columns [8u, 8u + 8), those past N masked: every column of
    # [0, N) lies in one of the U units
    assert U * qm.UNIT_COLS - N < qm.UNIT_COLS


@pytest.mark.parametrize("H,inter", [(1024, 3072), (384, 512), (256, 17408),
                                     (5120, 17408), (128, 128)])
def test_swiglu_plan_covers_every_column_and_group_once(H, inter):
    plan = qm.swiglu_plan(H, inter, SMS)
    assert plan.grid == SMS
    assert plan.span1 <= qm.SPAN_TILES // 2 and plan.span3 <= qm.SPAN_TILES
    # phase 1: unit j is gate columns 8j..8j+7 and up columns I+8j..
    u1 = _units_taken(inter // qm.UNIT_COLS, plan.grid, 1)
    gate_up = np.zeros(2 * inter, np.int64)
    for j, n in enumerate(u1):
        gate_up[8 * j:8 * j + 8] += n
        gate_up[inter + 8 * j:inter + 8 * j + 8] += n
    assert (gate_up == 1).all()
    assert (_groups_taken(H // qm.GROUP, plan.chunks1, plan.warps,
                          plan.span1) == 1).all()
    # phase 3: unit n is down columns 8n..8n+7
    assert (_units_taken(H // qm.UNIT_COLS, plan.grid, 1) == 1).all()
    assert (_groups_taken(inter // qm.GROUP, plan.chunks3, plan.warps,
                          plan.span3) == 1).all()


@pytest.mark.parametrize("N,Kp", list(itertools.product(NS, KPS)))
def test_matmul_plan_does_not_depend_on_m_and_fits(N, Kp):
    """One plan for M = 1..64; the partials beside the staged rows of
    every pass size it picks fit the block."""
    plans, rows = set(), set()
    for M in range(1, qm.MAX_KERNEL_M + 1):
        plan, R = qm.matmul_launch(M, Kp, N, SMS, LIMIT)
        plans.add(plan)
        rows.add(R)
        assert plan.fixed + qm.staged_bytes(R, Kp) <= LIMIT
        assert plan.fixed == (2 * plan.warps * 512 if plan.wk > 1 else 0)
    assert len(plans) == 1
    assert rows <= set(qm.MATMUL_PASS_ROWS)


@pytest.mark.parametrize("H,inter", [(1024, 3072), (256, 17408),
                                     (5120, 17408), (5120, 25600)])
def test_swiglu_plan_does_not_depend_on_m_and_fits(H, inter):
    plans = set()
    for M in range(1, qm.MAX_KERNEL_M + 1):
        plan, R = qm.swiglu_launch(M, H, inter, SMS, LIMIT)
        plans.add(plan)
        assert R in qm.SWIGLU_PASS_ROWS
        assert plan.fixed + qm.staged_bytes(R, max(H, inter)) <= LIMIT
    assert len(plans) == 1


@pytest.mark.parametrize("N,Kp,wk", [(4096, 1024, 2), (1024, 2048, 8),
                                     (6144, 1024, 1), (1024, 3072, 8)])
def test_decode_projections_take_one_step_a_block(N, Kp, wk):
    """Qwen3-0.6B's projections each run as one step of at most one block
    an SM: q|k|v's 512 units of 8 columns four to a block (two warps a
    unit), gate|up's 768 eight to a block, o's and down's 128 one to a
    block with all 8 warps on its K."""
    plan = qm.matmul_plan(Kp, N, SMS)
    U = _cdiv(N, qm.UNIT_COLS)
    assert plan.wk == wk and plan.grid <= SMS
    assert _cdiv(U, plan.warps // plan.wk) == plan.grid


def test_head_streams_through_two_blocks_an_sm():
    """The head's 18992 units are more than one step of 132 blocks can
    take: they stream through 264 blocks, two warps a unit."""
    plan = qm.matmul_plan(1024, 151936, SMS)
    assert plan.wk == 2 and plan.grid == 2 * SMS and plan.chunks == 1
    # two blocks of it fit an SM's 228 KB, staged rows of 16 included
    assert 2 * (plan.fixed + qm.staged_bytes(16, 1024) + 1024) <= LIMIT + 1024


@pytest.mark.parametrize("N,Kp", [(4096, 1024), (1024, 2048), (6144, 1024),
                                  (1024, 3072), (151936, 1024)])
def test_each_lane_has_four_weight_loads_in_flight(N, Kp):
    """At Qwen3-0.6B's projections and head every lane of the int8 matmul
    issues at least four 16-byte weight loads (two a group) before its first
    mma; the fused MLP's gate|up (two tiles) and down likewise."""
    assert 2 * qm.matmul_plan(Kp, N, SMS).span >= 4
    sw = qm.swiglu_plan(1024, 3072, SMS)
    assert 2 * 2 * sw.span1 >= 4 and 2 * sw.span3 >= 4


def test_wide_intermediate_takes_eight_rows_a_pass():
    """Qwen3-14B's intermediate (17408) at M = 37: beside the partials, both
    kernels still stage 8 rows a pass (tests/test_torch_cuda.py runs it)."""
    assert qm.matmul_launch(37, 17408, 256, SMS, LIMIT)[1] == 8
    assert qm.swiglu_launch(37, 256, 17408, SMS, LIMIT)[1] == 8


def test_staged_rows_keep_lanes_off_each_others_banks():
    """Lanes read 32 bytes at 32t of a staged row; the row stride Kp + 16
    (≡ 16 mod 128) puts rows g and g + 1 of a quarter warp's reads on
    different banks."""
    for kp in KPS + (256, 5120, 25600):
        assert (kp + qm.ROW_PAD) % 128 == 16
        assert qm.staged_bytes(1, kp) == kp + qm.ROW_PAD + 8 * (kp // qm.GROUP)
