"""The s-bundle primitive (G, v) = (tril(Y·Yᵀ, −1), Y·x) straight from
ELL rows — paper Algorithm 3 lines 5–8 (the sparse syrk + SpMV hot
spot) — without ever materializing the dense (sb × n) bundle.

Two versions of the same function live here:

* ``ell_gram_and_v`` — the wrapper. For CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/ell_gram.cu`` (built at first use)
  or raises; it never falls back. For CPU tensors it runs the plain
  version below.
* ``ell_gram_and_v_blocked`` — the plain PyTorch version, which walks
  ⌈n/bk⌉ column panels: it scatters the bundle's entries that fall in
  panel k into a dense (sb, bk) tile (``bm`` rows at a time; duplicate
  column ids add), accumulates ``G += P·Pᵀ`` and ``v += P·x_k``, and
  masks to the strict lower triangle after the last panel. It repeats
  the kernel's arithmetic panel by panel and is the oracle for it; it
  is not a yardstick of speed.

The CUDA kernel does not walk panels: each block of it owns a square
tile of G, hashes its j-rows' entries into open-addressing tables in
shared memory and looks its i-rows' entries up in them (see its header
note). ``bk`` and ``bm`` have no effect on it; they only define the
plain version's walk. Any ``bk``/``bm`` gives the same result up to
summation order. ``gram_geometry`` computes the kernel's launch
geometry — tile, threads a pair, chunk of a row's entries, table
capacity and dynamic shared memory — from (sb, w), on the host, where
the CPU tests reach it.

Pads are (idx 0, val 0) and contribute nothing. Accumulation is
float32 (float64 inputs stay float64 in the plain version; the kernel
takes float32 only).

Precision. ``precision="bf16"`` is the reference's
``compute_dtype=bfloat16``: each row's per-column value (the dense panel
entry) and x are rounded to bf16, the products are accumulated in
float32, and G and v stay float32. The plain version builds each panel
in float32, rounds it to bf16 and rounds x to bf16, then takes float32
dots — a product of two bf16 values is exact in float32, so on rows
with distinct ids it differs from the reference only in the order of
the sums. (Where a row repeats an id, the reference rounds each entry
and then their sum, the plain version the sum alone.) The CUDA kernel
rounds each j-row's table value once after the row's repeated ids are
merged into it (as the plain version rounds its panel entry) and each
i-row entry on its own as it is staged: where an i-row repeats an id
(or a j-row repeats one across two chunks of a row wider than one
chunk), the plain version rounds the sum once and the kernel the
parts, a difference of up to one bf16 rounding (relative 2⁻⁸) of that
entry. No registered dataset and no generator row repeats an id.

Meta tensors (the comm ledger's structural capture) get outputs of the
right shape and dtype and no arithmetic.

Oracle: ``repro_torch.kernels.ref.ell_gram_and_v_ref`` (dense scatter).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load_library("ell_gram")
        lib.ell_gram_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.ell_gram_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


MAX_CHUNK = 512  # entries of a row hashed into one table (j) or staged at once (i)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on sm_90
# Below this many blocks (two on each of an H100's 132 SMs) a bundle is cut
# into 8 × 8 tiles with 8 threads a pair, for more blocks and more threads to
# hide shared-memory latency; from it on into 16 × 16 tiles with 2 threads a
# pair, which build each j-row's table half as often.
FILL_BLOCKS = 264
# A table has at least twice a chunk's slots (load factor ≤ ½), and four
# times up to this many: most lookups then end in their home bucket.
TABLE_SLOTS = 1024


@dataclasses.dataclass(frozen=True)
class GramGeometry:
    """The CUDA kernel's launch: one block of ``threads`` = tile²·ks
    threads for each of the tiles·(tiles + 1)/2 tiles of G on or below
    the diagonal; each row is walked in ⌈w/chunk⌉ chunks of at most
    ``chunk`` entries, a j-chunk hashed into a table of ``cap`` slots;
    ``smem_bytes`` of dynamic shared memory a block."""

    tile: int
    ks: int
    chunk: int
    cap: int
    tiles: int
    threads: int
    smem_bytes: int

    @property
    def cap_log2(self) -> int:
        return self.cap.bit_length() - 1


# The (tile, ks) pairs the kernel can run: whole warps (the warp ballot
# that compacts an i-row and the shuffle that sums v take full masks, and
# the staging loops hand rows to warps), at most MAX_THREADS threads, and a
# tile of 4, 8 or 16 rows. With a tile of 8 or 16 the 8 lanes of a quarter
# warp read 8 different tables (the bank layout); a tile of 4 is right but
# puts two lanes on one table.
TILES = (4, 8, 16)
MAX_THREADS = 512


def check_tile_ks(tile: int, ks: int) -> None:
    """Raise ``ValueError`` unless the kernel supports ``tile`` × ``tile``
    tiles with ``ks`` threads a pair (see ``TILES``)."""
    if tile not in TILES or ks < 1:
        raise ValueError(f"tile={tile} (one of {TILES}), ks={ks} (≥ 1): not a geometry of the kernel")
    threads = tile * tile * ks
    if threads % 32 or threads > MAX_THREADS:
        raise ValueError(
            f"tile={tile}, ks={ks} gives {threads} threads a block: the kernel needs a "
            f"multiple of 32 up to {MAX_THREADS}"
        )


def supported_tile_ks() -> tuple[tuple[int, int], ...]:
    """Every (tile, ks) the kernel supports with ks a power of two: the
    autotuner's candidates on the card."""
    pairs = []
    for tile in TILES:
        ks = 1
        while tile * tile * ks <= MAX_THREADS:
            if (tile * tile * ks) % 32 == 0:
                pairs.append((tile, ks))
            ks *= 2
    return tuple(pairs)


def default_tile_ks(sb: int) -> tuple[int, int]:
    """The (tile, ks) the kernel takes for ``sb`` rows without a tuned
    geometry: the ``FILL_BLOCKS`` rule."""
    tiles16 = -(-sb // 16)
    return (16, 2) if tiles16 * (tiles16 + 1) // 2 >= FILL_BLOCKS else (8, 8)


def gram_geometry(sb: int, w: int, tile: int | None = None, ks: int | None = None) -> GramGeometry:
    """Launch geometry of the CUDA kernel for an (sb, w) bundle. Without
    ``tile``/``ks`` the tile and the threads a pair follow from the number
    of blocks (``default_tile_ks``); given both (a tuned geometry) they
    must be a pair the kernel supports (``check_tile_ks``), else
    ``ValueError``. Either way the chunk, the table capacity and the
    shared memory follow from the actual ``w``, so one tuned (tile, ks)
    holds for every width a build produces. The row is cut into the
    fewest chunks of at most ``MAX_CHUNK`` entries, of equal size but the
    last, whose tables fit; a table has a power of two of slots, at least
    twice a chunk and four times up to ``TABLE_SLOTS``. Shared memory
    holds, per block, ``tile`` tables of cap + 4 keys and values, ``tile``
    staged i-rows and ``tile`` staged j-rows of ``chunk`` ids and values,
    the i-rows' counts and v sums, and the ks partial sums of each pair —
    the layout the kernel carves."""
    if sb < 1 or w < 1:
        raise ValueError(f"empty bundle (sb={sb}, w={w})")
    if (tile is None) != (ks is None):
        raise ValueError(f"give both tile and ks or neither, got tile={tile}, ks={ks}")
    if tile is None:
        tile, ks = default_tile_ks(sb)
    else:
        check_tile_ks(tile, ks)

    def layout(n_chunks: int) -> tuple[int, int, int]:
        chunk = -(-w // n_chunks)
        cap = max(8, 1 << (2 * chunk - 1).bit_length(),
                  min(TABLE_SLOTS, 1 << (4 * chunk - 1).bit_length()))
        return chunk, cap, 4 * (2 * tile * (cap + 4) + 4 * tile * chunk + 2 * tile + ks * tile * tile)

    n_chunks = -(-w // MAX_CHUNK)
    while layout(n_chunks)[2] > SMEM_LIMIT:  # a chunk of one entry always fits
        n_chunks += 1
    chunk, cap, smem = layout(n_chunks)
    return GramGeometry(tile=tile, ks=ks, chunk=chunk, cap=cap, tiles=-(-sb // tile),
                        threads=tile * tile * ks, smem_bytes=smem)


PRECISIONS = ("fp32", "bf16")


def check_precision(precision: str) -> None:
    """The kernels' ``precision`` knob: "fp32" or "bf16"."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and back to its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _prep_panels(values: torch.Tensor, x: torch.Tensor, n: int, bk: int):
    """Accumulation dtype + x zero-padded to whole panels."""
    acc = torch.float64 if values.dtype == torch.float64 else torch.float32
    n_pad = -(-n // bk) * bk
    x = x.to(acc)
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    return acc, x, n_pad // bk


def _panel_rows(indices, values, k: int, bk: int, dtype) -> torch.Tensor:
    """Scatter one row chunk's entries of panel k: (rows, bk) in
    ``dtype``. Entries outside [k·bk, (k+1)·bk) are added as zeros at a
    clamped lane, so no data-dependent shape arises."""
    local = indices.long() - k * bk  # (rows, w)
    inside = (local >= 0) & (local < bk)
    vals = torch.where(inside, values.to(dtype), torch.zeros((), dtype=dtype, device=values.device))
    panel = torch.zeros((indices.shape[0], bk), dtype=dtype, device=values.device)
    return panel.scatter_add_(1, local.clamp(0, bk - 1), vals)


def panel_from_ell(indices, values, k: int, bk: int, acc_dtype, bm: int | None = None):
    """Expand the ELL bundle's column panel k into a dense (sb, bk)
    tile, ``bm`` rows at a time (None = all rows at once; rows are
    independent, so any ``bm`` gives the same tile)."""
    sb = indices.shape[0]
    if bm is None or bm >= sb:
        return _panel_rows(indices, values, k, bk, acc_dtype)
    return torch.cat(
        [
            _panel_rows(indices[r : r + bm], values[r : r + bm], k, bk, acc_dtype)
            for r in range(0, sb, bm)
        ],
        dim=0,
    )


def ell_gram_and_v_blocked(
    indices: torch.Tensor,
    values: torch.Tensor,
    x: torch.Tensor,
    *,
    n: int,
    bk: int = 512,
    bm: int | None = None,
    precision: str = "fp32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch panel streaming — the kernel's plain version (see
    the module note). Runs on whatever device the tensors are on."""
    check_precision(precision)
    sb, _ = values.shape
    acc, x, n_panels = _prep_panels(values, x, n, bk)
    if values.is_meta:  # shapes only: no panel walk
        return (torch.empty((sb, sb), dtype=acc, device="meta"),
                torch.empty((sb,), dtype=acc, device="meta"))
    if precision == "bf16":
        x = bf16_round(x)
    g = torch.zeros((sb, sb), dtype=acc, device=values.device)
    v = torch.zeros((sb,), dtype=acc, device=values.device)
    for k in range(n_panels):
        panel = panel_from_ell(indices, values, k, bk, acc, bm)
        if precision == "bf16":
            panel = bf16_round(panel)
        xblk = x[k * bk : (k + 1) * bk]
        g = g + panel @ panel.T
        v = v + panel @ xblk
    return torch.tril(g, diagonal=-1), v


def ell_gram_and_v(
    indices: torch.Tensor,  # (sb, w) int32
    values: torch.Tensor,  # (sb, w) float32
    x: torch.Tensor,  # (n,) float32
    *,
    n: int,
    bk: int = 512,
    bm: int | None = None,
    precision: str = "fp32",
    geometry: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, v) = (tril(Y Yᵀ, -1), Y·x) for the ELL bundle Y.

    CUDA tensors: one launch of the Hopper kernel on the current
    stream, no synchronisation; ``bk``/``bm`` are ignored (the kernel's
    result does not depend on them), ``geometry`` is a tuned (tile, ks)
    (None: ``gram_geometry``'s default), and every column id must lie in
    [0, n) — that is not checked on the device. A failed build or
    launch raises. CPU (and meta) tensors: the plain
    ``ell_gram_and_v_blocked`` (``geometry`` does not apply). Each kernel launch adds one to
    ``ell_gram_and_v.launches[precision]``."""
    check_precision(precision)
    if not (indices.device == values.device == x.device):
        raise ValueError(
            f"indices, values, x must share a device, got {indices.device}, "
            f"{values.device}, {x.device}"
        )
    if not values.is_cuda:
        return ell_gram_and_v_blocked(indices, values, x, n=n, bk=bk, bm=bm, precision=precision)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if values.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernel takes float32 values and x, got {values.dtype}, {x.dtype}"
        )
    if values.dim() != 2 or indices.shape != values.shape:
        raise ValueError(
            f"indices {tuple(indices.shape)} and values {tuple(values.shape)} must "
            f"be the same (sb, w)"
        )
    if x.shape != (n,):
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    sb, w = values.shape
    if sb < 1 or w < 1:
        raise ValueError(f"empty bundle (sb={sb}, w={w})")
    if not (indices.is_contiguous() and values.is_contiguous() and x.is_contiguous()):
        raise ValueError("indices, values and x must be contiguous")

    geo = gram_geometry(sb, w, *(geometry or (None, None)))
    g = torch.empty((sb, sb), dtype=torch.float32, device=values.device)
    v = torch.empty((sb,), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        rc = _lib().ell_gram_launch(
            indices.data_ptr(), values.data_ptr(), x.data_ptr(), g.data_ptr(),
            v.data_ptr(), sb, w, int(precision == "bf16"), geo.tile, geo.ks, geo.chunk,
            geo.cap_log2, geo.smem_bytes, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ell_gram kernel launch failed: CUDA error {rc} (sb={sb}, w={w}, {precision}, {geo})"
        )
    ell_gram_and_v.launches[precision] += 1
    return g, v


ell_gram_and_v.launches = dict.fromkeys(PRECISIONS, 0)
