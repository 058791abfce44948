"""The corrections kernel's launch geometry (``inner_geometry``) and tile
walk (``inner_tiles``), on the CPU: the CUDA kernel itself runs only on
the GPU, where ``chip_smoke.py`` holds it against its plain version.

The layout these tests rebuild is the kernel's (``csrc/sstep_inner.cu``):
u and v, each s·b floats rounded up to 4, then a ring of ``stages`` slots
at a 128-byte boundary, each slot b·cols floats rounded up to 128 bytes,
then two 8-byte barriers a slot."""

import pytest

from repro_torch.kernels.ell_gram import SMEM_LIMIT
from repro_torch.kernels.sstep_inner import (
    LANES,
    MAX_COLS,
    MAX_CONSUMERS,
    MAX_SB,
    MAX_STAGES,
    inner_geometry,
    inner_tiles,
)


def _ceil(n, to):
    return -(-n // to) * to


def _layout_bytes(s, b, geo):
    ring = 4 * _ceil(2 * _ceil(s * b, 4), 32)
    return ring + geo.stages * 4 * _ceil(b * geo.cols, 32) + 16 * geo.stages


GRID = [(1, 8), (2, 1), (3, 7), (4, 32), (8, 16), (8, 32), (16, 32), (5, 12), (64, 32), (12, 5),
        (2, 300), (96, 128), (2, 6144), (3, 4096), (1, MAX_SB), (6144, 2), (MAX_SB, 1), (48, 256)]


@pytest.mark.parametrize("s,b", GRID)
def test_inner_tiles_cover_every_step_once_in_order(s, b):
    """The tiles walk the steps in order, and within step j cover the
    columns [0, j·b) exactly once, left to right, each at most ``cols``
    wide; their number is the geometry's ``tiles``."""
    geo = inner_geometry(s, b)
    count, step, end = 0, 1, 0  # the next tile must start step `step` at column `end`
    for j, c0, width in inner_tiles(s, b, geo.cols):
        if end == step * b:  # the step is covered: the next one starts at column 0
            step, end = step + 1, 0
        assert (j, c0) == (step, end) and 0 < width <= geo.cols and c0 + width <= j * b
        end += width
        count += 1
    assert count == geo.tiles
    assert (step, end) == ((s - 1, (s - 1) * b) if s > 1 else (1, 0))


@pytest.mark.parametrize("s,b", GRID)
def test_inner_geometry_fits_a_block(s, b):
    """Shared memory is the kernel's layout and fits an sm_90 block; the
    tile is a multiple of 4 columns (16-byte vectors) no wider than a TMA
    box; the ring has at most MAX_STAGES slots, none for s = 1; the block
    has enough consumer threads for one row a group of LANES lanes, up to
    MAX_CONSUMERS."""
    geo = inner_geometry(s, b)
    assert geo.smem_bytes == _layout_bytes(s, b, geo) <= SMEM_LIMIT
    assert geo.cols % 4 == 0 and 4 <= geo.cols <= MAX_COLS
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= MAX_CONSUMERS
    assert geo.threads == min(MAX_CONSUMERS, max(32, _ceil(b * LANES, 32)))
    if s == 1:
        assert geo.stages == geo.tiles == 0
    else:
        assert 1 <= geo.stages <= MAX_STAGES
        full = _ceil((s - 1) * b, 4)
        if geo.stages == s - 1 and geo.cols == full:  # the whole triangle in flight
            assert geo.tiles == s - 1
        else:  # a ring: tiles at least 4·LANES wide, unless the panel is narrower
            assert geo.cols >= min(full, 4 * LANES) or geo.stages == 1


def test_inner_geometry_main_path():
    """The main path's bundle (s = 4, b = 32) has its whole triangle in
    flight: three tiles, one a step; s = 16 walks a ring of 8 slots."""
    geo = inner_geometry(4, 32)
    assert (geo.threads, geo.cols, geo.stages, geo.tiles) == (256, 96, 3, 3)
    ring = inner_geometry(16, 32)
    assert ring.stages == MAX_STAGES and ring.tiles > ring.stages
    assert [w for _, _, w in inner_tiles(4, 32, geo.cols)] == [32, 64, 96]


def test_inner_geometry_accepts_every_sb_up_to_max():
    """Every s·b ≤ MAX_SB has a geometry that fits: each b with s = 1, 2
    and the largest s (the most shared memory for u and v)."""
    for b in range(1, MAX_SB + 1):
        for s in {1, 2, MAX_SB // b} - {0}:
            if s * b > MAX_SB:
                continue
            geo = inner_geometry(s, b)
            assert geo.smem_bytes <= SMEM_LIMIT and geo.cols >= 4


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, MAX_CONSUMERS])
def test_inner_geometry_takes_a_swept_block_size(threads):
    """A sweep's consumer count is kept as given, with the same tiles."""
    geo, default = inner_geometry(16, 32, threads=threads), inner_geometry(16, 32)
    assert geo.threads == threads
    assert (geo.cols, geo.stages, geo.tiles) == (default.cols, default.stages, default.tiles)
