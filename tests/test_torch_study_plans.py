"""The launch plan of the decode-GEMV study's kernels (csrc/study_gemv.cu),
checked on the CPU: `studies/exp_gemv.gemv_plan(N, sms)` is a pure
function of the column count and the SM count.  Each test walks the plan
as the kernel walks it — block b takes tiles b, b + grid, ..., each tile
64·C columns, those past N masked — and holds it to what the kernel needs:
every column of [0, N) taken exactly once, a tile the kernel has, a grid
no larger than the tiles, a short last round, the argmax's fold, and a
launch that the script's block width bn does not reach."""

import inspect

import numpy as np
import pytest

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
