"""The launch plans of the H100 studies' persistent kernels, checked on the
CPU.  `studies/exp_gemv.gemv_plan(N, sms)` is a pure function of the
column count and the SM count, the plan of the decode-GEMV kernels
(csrc/study_gemv.cu); `studies/exp_int4.packed_k_plan` is its form for the
int4 kernels on TMA rings (csrc/study_int4.cu `i4_packed_k` and
`i4_upcast`), whose tiles are whole 128-column boxes.  Each test walks the plan as the kernel walks it —
block b takes tiles b, b + grid, ..., each tile 64·C columns, those past N
masked — and holds it to what the kernel needs: every column of [0, N)
taken exactly once, a tile the kernel has, a grid no larger than the
tiles, a short last round, the argmax's fold, and a launch that the
script's block width bn does not reach.
`studies/exp_fused_layer.fused_layer_plan(sms)` splits the one-launch
layer's units (csrc/study_fused_layer.cu) over the SMs, and the kernel
reads each block's units from its table: every unit of both phases once,
the blocks' shares within a unit.  The card tests (tests/test_torch_cuda.py)
run both kernels on these plans at several SM counts against their plain
versions."""

import inspect

import numpy as np
import pytest
import torch

from aha_tpu_torch.studies import exp_fused_layer as efl
from aha_tpu_torch.studies import exp_gemv as eg

SMS = 132            # H100 SXM
NS = (151936, 2 * 2048 + 384, 2 * 2048 + 40, 1000, 4096, 8, 64 * 132 + 8)


def _cdiv(a, b):
    return -(-a // b)


def _walks(N, tile, grid):
    """Block b's tiles, in the order it takes them."""
    return [list(range(b, _cdiv(N, tile), grid)) for b in range(grid)]


@pytest.mark.parametrize("sms", [SMS, 114, 1])
@pytest.mark.parametrize("N", NS)
def test_gemv_plan_covers_every_column_once(N, sms):
    tile, grid = eg.gemv_plan(N, sms)
    taken = np.zeros(_cdiv(N, tile) * tile, np.int64)
    for walk in _walks(N, tile, grid):
        for t in walk:
            taken[t * tile:(t + 1) * tile] += 1
    assert (taken[:N] == 1).all()
    # what lies past N is the last tile's TMA zero fill, less than a tile
    assert len(taken) - N < tile


@pytest.mark.parametrize("sms", [SMS, 114, 1])
@pytest.mark.parametrize("N", NS)
def test_gemv_plan_tile_and_grid(N, sms):
    tile, grid = eg.gemv_plan(N, sms)
    assert tile in (64, 128, 256)
    assert 1 <= grid <= min(_cdiv(N, tile), sms)
    # every block has a tile, so every block posts an argmax partial
    assert all(_walks(N, tile, grid))


def test_gemv_plan_last_round_at_the_qwen3_head():
    """At N 151936 on 132 SMs the plan's last round leaves fewer block
    slots idle than 256-column tiles would (594 tiles: 4.5 rounds)."""
    tile, grid = eg.gemv_plan(151936, SMS)

    def idle(tile, grid):
        tiles = _cdiv(151936, tile)
        return _cdiv(tiles, grid) * grid - tiles

    assert idle(tile, grid) < idle(256, min(_cdiv(151936, 256), SMS)) == 66
    assert (tile, grid) == (128, 132) and idle(tile, grid) == 1


def test_gemv_plan_does_not_take_bn():
    """The launch is the plan's: neither the plan nor the launch it feeds
    has a block-width argument; the wrappers keep bn for the script's sweep
    only."""
    assert list(inspect.signature(eg.gemv_plan).parameters) == ["n", "sms"]
    assert "bn" not in inspect.signature(eg._launch).parameters


def _kernel_argmax(logits, N, tile, grid):
    """The argmax kernel's fold order over logits (the last tile's columns
    past N are zero fill): per block, a running (max, first index) over its
    tiles in walk order, columns past N masked by index; then the blocks'
    partials in a scrambled order."""
    def better(v, i, bv, bi):
        return v > bv or (v == bv and i < bi)

    padded = np.zeros(_cdiv(N, tile) * tile, np.float32)
    padded[:N] = logits
    parts = []
    for walk in _walks(N, tile, grid):
        best = (-np.inf, 2**31 - 1)
        for t in walk:
            for c in range(t * tile, (t + 1) * tile):
                if c < N and better(float(padded[c]), c, *best):
                    best = (float(padded[c]), c)
        parts.append(best)
    out = (-np.inf, 2**31 - 1)
    for p in np.random.default_rng(0).permutation(len(parts)):
        if better(*parts[p], *out):
            out = parts[p]
    return out


@pytest.mark.parametrize("N", [2 * 2048 + 384, 1000, 64 * 132 + 8])
def test_gemv_plan_argmax_is_the_same_at_every_bn(N):
    """All logits negative with the maximum planted in the last column (the
    zero fill past N must not win), and ties across a tile boundary and
    across blocks: the kernel's fold gives np.argmax's first index.  Its
    launch is gemv_plan's, which takes no bn, so that index is the one of
    every bn of the sweep."""
    rng = np.random.default_rng(N)
    logits = -rng.random(N).astype(np.float32) - 1.0
    logits[N - 1] = -0.5
    tile, grid = eg.gemv_plan(N, SMS)
    assert len(_walks(N, tile, grid)) > 1
    assert _kernel_argmax(logits, N, tile, grid) == (-0.5, N - 1)
    tied = logits.copy()
    for c in (tile - 1, tile, 3 * tile + 5):      # tile 0 | 1, another block
        tied[c] = -0.5
    assert _kernel_argmax(tied, N, tile, grid) == (-0.5, tile - 1)
    assert int(np.argmax(tied)) == tile - 1


# -- the one-launch layer's plan (csrc/study_fused_layer.cu) -------------------


@pytest.mark.parametrize("sms", [SMS, 114, 1])
def test_fused_layer_plan_covers_every_unit_once(sms):
    """fused_layer_plan(sms): one block an SM; block b's phase-1 units b,
    b + grid, ... and a contiguous range of phase-2 units; together they
    take every unit of both phases exactly once, and a block's share of
    each phase (phase 2's: the units it streams after the grid barrier) is
    within one unit of the mean."""
    plan = efl.fused_layer_plan(sms)
    grid = len(plan)
    assert grid == min(sms, efl.P2_UNITS)
    for phase, units in ((0, efl.P1_UNITS), (1, efl.P2_UNITS)):
        taken = np.zeros(units, np.int64)
        for b, block in enumerate(plan):
            r = block[phase]
            assert (r.start, r.step) == ((b, grid) if phase == 0 else
                                         (r.start, 1))
            taken[list(r)] += 1
        assert (taken == 1).all()
        mean = units / len(plan)
        assert all(abs(len(block[phase]) - mean) < 1 for block in plan)


def test_fused_layer_plan_units_are_the_layer():
    """The units tile the layer: phase 1 the 10,240 columns of [Wqkv | Wgu]
    in 64-column tiles by four 256-row K quarters, phase 2 the 1,024
    columns of [Wo ; Wdn] by twenty 256-row tiles (four a 1024-row chunk,
    none straddling o and down); at 132 SMs each block has units of both
    phases (no block skips the barrier's work), its phase-2 units span at
    most two row tiles (the activations it stages), and the blocks' first
    phase-1 units are neighbouring column tiles of one K quarter."""
    cols1 = efl.NQKV + 2 * efl.NI
    assert efl.P1_UNITS * efl.UNIT_COLS * efl.P1_ROWS == cols1 * efl.H
    assert efl.P2_UNITS * efl.UNIT_COLS * efl.P2_ROWS == \
        efl.H * (efl.NO + efl.NI)
    assert efl.NO % efl.P2_ROWS == 0 and efl.H % efl.P2_ROWS == 0
    for b, (p1, p2) in enumerate(efl.fused_layer_plan(SMS)):
        assert len(p1) and len(p2), b
        tiles = {u // efl.P2_COLUMN_TILES for u in p2}
        assert len(tiles) <= 2 and max(tiles) - min(tiles) == len(tiles) - 1
    firsts = [p1[0] for p1, _ in efl.fused_layer_plan(SMS)]
    assert firsts == list(range(SMS)) and SMS <= efl.P1_UNITS // efl.P1_SLICES


@pytest.mark.parametrize("sms", [SMS, 114, 1])
def test_fused_layer_plan_table_is_the_plan(sms):
    """The table the kernel reads from its parameters, a row a block (its
    rows the launch's grid): (phase-1 start, step, count, phase-2 first,
    count), each row giving back exactly the block's ranges of
    fused_layer_plan, every value at most the 640 phase-1 units (the
    kernel holds them as int16), and block b's phase-1 walk starting at b
    with step grid (the launch refuses a plan that walks otherwise)."""
    plan = efl.fused_layer_plan(sms)
    table = efl.fused_layer_plan_table(sms)
    assert len(table) == len(plan)
    for b, ((start1, step1, n1, first2, n2), (r1, r2)) in enumerate(
            zip(table, plan)):
        assert (start1, step1) == (b, len(table))
        assert range(start1, start1 + step1 * n1, step1) == r1
        assert range(first2, first2 + n2) == r2
    assert np.array(table).min() >= 0
    assert np.array(table).max() <= efl.P1_UNITS == 640


# -- the packed-int4 kernel's plan (csrc/study_int4.cu) -------------------------


@pytest.mark.parametrize("sms", [SMS, 114, 1])
@pytest.mark.parametrize("N", [8, 24, 2088, 151936])
def test_packed_k_plan_covers_every_column_once(N, sms):
    """packed_k_plan: tiles of whole 128-column boxes (one or two), a grid
    no larger than the tiles, and every column of [0, N) in exactly one
    block's walk; the (K/4, 2N) view the kernel's TMA reads has a row
    stride of 2N bytes, a multiple of 16 for any N a multiple of 8."""
    from aha_tpu_torch.studies import exp_int4 as e4

    tile, grid = e4.packed_k_plan(N, sms)
    assert tile in (128, 256)
    assert 1 <= grid <= min(_cdiv(N, tile), sms)
    taken = np.zeros(_cdiv(N, tile) * tile, np.int64)
    for walk in _walks(N, tile, grid):
        for t in walk:
            taken[t * tile:(t + 1) * tile] += 1
    assert (taken[:N] == 1).all()
    assert (2 * N) % 16 == 0


@pytest.mark.parametrize("N", NS)
def test_packed_k_plan_is_the_gemv_plan_in_whole_boxes(N):
    """Where gemv_plan's tile is a whole box or two, packed_k_plan is
    gemv_plan; its 64-column tiles become 128-column ones (the kernel would
    read each box for two tiles).  At N 151936 on 132 SMs: 1,187 tiles of
    128 columns on 132 blocks."""
    from aha_tpu_torch.studies import exp_int4 as e4

    tile, grid = eg.gemv_plan(N, SMS)
    if tile >= 128:
        assert e4.packed_k_plan(N, SMS) == (tile, grid)
    else:
        assert e4.packed_k_plan(N, SMS) == (128, min(_cdiv(N, 128), SMS))
    tile, grid = e4.packed_k_plan(151936, SMS)
    assert (tile, grid, _cdiv(151936, tile)) == (128, 132, 1187)


# -- the int4 upcast kernel's plan (csrc/study_int4.cu `i4_upcast`) -------------
#
# i4_upcast reuses packed_k_plan: its tiles of 128 or 256 columns are four
# or eight of its 32-word TMA boxes.

UPCAST_BOX_WORDS = 32      # a box row: 32 k8 words, 128 bytes


@pytest.mark.parametrize("sms", [SMS, 114, 1])
@pytest.mark.parametrize("N", [8, 24, 2088, 151936])
def test_upcast_plan_covers_every_column_once(N, sms):
    """i4_upcast runs on packed_k_plan (reused, not a plan of its own):
    every column of [0, N) lies in exactly one block's walk, a tile is
    whole 32-word boxes, the grid is no larger than the tiles, and the k8
    words' tensor map has a row stride of 4N bytes, a multiple of 16; a box
    starts at a column that is a multiple of 32, 128 bytes into a row."""
    from aha_tpu_torch.studies import exp_int4 as e4

    tile, grid = e4.packed_k_plan(N, sms)
    assert tile in (128, 256) and tile % UPCAST_BOX_WORDS == 0
    assert 1 <= grid <= min(_cdiv(N, tile), sms)
    taken = np.zeros(_cdiv(N, tile) * tile, np.int64)
    for walk in _walks(N, tile, grid):
        assert walk, "every block has a tile"
        for t in walk:
            taken[t * tile:(t + 1) * tile] += 1
    assert (taken[:N] == 1).all()
    assert (4 * N) % 16 == 0
    assert all((4 * b) % 128 == 0
               for b in range(0, _cdiv(N, tile) * tile, UPCAST_BOX_WORDS))


def test_upcast_word_rows_stride_is_whole_16_bytes_for_every_n():
    """The TMA map over the (K/8, N) int32 words needs a row stride that is
    a multiple of 16 bytes: 4N is, for every N % 8 == 0 the wrapper admits
    (up to past the Qwen3 head's 151936)."""
    assert all((4 * n) % 16 == 0 for n in range(8, 160_001, 8))


def _fake_lib(monkeypatch, calls):
    from aha_tpu_torch.ops import kernels

    class Lib:
        def aha_study_int4(self, x, w, out, K, N, variant, tile, grid,
                           stream):
            calls.append(dict(K=K, N=N, variant=variant, tile=tile,
                              grid=grid))
            return 0

    monkeypatch.setattr(kernels, "lib", lambda: Lib())
    monkeypatch.setattr(kernels, "stream_handle", lambda t: 0)


@pytest.mark.parametrize("sms", [SMS, 114, 1])
@pytest.mark.parametrize("N", [8, 2088, 132 * 256, 151936])
def test_upcast_wrapper_launches_on_packed_k_plan(monkeypatch, N, sms):
    """The launch i4_upcast's wrapper makes takes packed_k_plan(N, sms)
    for the card's SM count (faked here, the C entry recorded instead of
    called): the same (tile, grid) as i4_packed_k's; i4_tensorcore's grid
    stays its own (no plan passed)."""
    from aha_tpu_torch.studies import exp_int4 as e4

    calls = []
    _fake_lib(monkeypatch, calls)
    monkeypatch.setattr(e4, "sm_count", lambda device: sms)
    K = 64
    x = torch.zeros((8, K), dtype=torch.bfloat16)
    words = torch.zeros((K // 8, N), dtype=torch.int32)
    packed = torch.zeros((K // 2, N), dtype=torch.int8)
    e4._launch(x, words, "i4_upcast")
    e4._launch(x, packed, "i4_packed_k")
    e4._launch(x, words, "i4_tensorcore")
    tile, grid = e4.packed_k_plan(N, sms)
    assert calls[0] == dict(K=K, N=N, variant=e4.VARIANTS["i4_upcast"],
                            tile=tile, grid=grid)
    assert (calls[1]["tile"], calls[1]["grid"]) == (tile, grid)
    assert (calls[2]["tile"], calls[2]["grid"]) == (0, 0)


def test_upcast_wrapper_refuses_past_its_k(monkeypatch):
    """i4_upcast's K limit is checked by the wrapper: K = UPCAST_K_MAX
    launches, one step of 32 past it raises ValueError before any launch."""
    from aha_tpu_torch.studies import exp_int4 as e4

    calls = []
    _fake_lib(monkeypatch, calls)
    monkeypatch.setattr(e4, "sm_count", lambda device: SMS)
    for K in (e4.UPCAST_K_MAX, e4.UPCAST_K_MAX + 32):
        x = torch.zeros((8, K), dtype=torch.bfloat16)
        words = torch.zeros((K // 8, 64), dtype=torch.int32)
        if K > e4.UPCAST_K_MAX:
            with pytest.raises(ValueError):
                e4._launch(x, words, "i4_upcast")
        else:
            e4._launch(x, words, "i4_upcast")
    assert len(calls) == 1 and calls[0]["K"] == e4.UPCAST_K_MAX


def test_upcast_k_limit_is_the_shared_memory_budget():
    """UPCAST_K_MAX is the longest K (a multiple of 32) whose B fragments
    (512 bytes a 64 k values, in whole 512-k ring steps) fit beside two
    256-column ring stages (64 KB each, two mbarriers), the warps' row
    maxima and the 1 KB alignment in the H100's 227 KB of opt-in shared
    memory — csrc/study_int4.cu's launch_upcast<2> budget; and below it
    the sums stay exact (|sum| ≤ K·127·8 < 2^24, and 16x that < 2^31)."""
    from aha_tpu_torch.studies import exp_int4 as e4

    def smem(K, tile=256):
        ksteps = _cdiv(K // 8, 64)
        stage = tile // 32 * 64 * 128
        return 1024 + ksteps * 8 * 32 * 16 + tile // 32 * 8 * 4 \
            + 2 * (stage + 16)

    optin = 232448
    assert smem(e4.UPCAST_K_MAX) <= optin < smem(e4.UPCAST_K_MAX + 32)
    assert e4.UPCAST_K_MAX % 32 == 0 and e4.UPCAST_K_MAX >= e4.PACKED_K_MAX
    assert e4.UPCAST_K_MAX * 127 * 8 < 2 ** 24
    assert 16 * e4.UPCAST_K_MAX * 127 * 8 < 2 ** 31
