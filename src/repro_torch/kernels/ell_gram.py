"""The s-bundle primitive (G, v) = (tril(Y·Yᵀ, −1), Y·x) straight from
ELL rows — paper Algorithm 3 lines 5–8 (the sparse syrk + SpMV hot
spot) — without ever materializing the dense (sb × n) bundle in memory
that outlives a call.

Three versions of the same function live here:

* ``ell_gram_and_v`` — the wrapper. For CUDA tensors it launches one of
  two hand-written Hopper routes (built at first use) or raises; it never
  falls back. For CPU tensors it runs the plain panel walk below.
* ``ell_gram_and_v_blocked`` — the plain PyTorch version, which walks
  ⌈n/bk⌉ column panels: it scatters the bundle's entries that fall in
  panel k into a dense (sb, bk) tile (``bm`` rows at a time; duplicate
  column ids add), accumulates ``G += P·Pᵀ`` and ``v += P·x_k``, and
  masks to the strict lower triangle after the last panel. It repeats
  the reference kernel's arithmetic panel by panel and is the oracle for
  both routes; it is not a yardstick of speed.
* ``ell_gram_dense_plain`` — the dense route's plain version: the whole
  row densified (an accumulating ``index_put_``), rounded once in bf16,
  the product taken as the kernel's column splits in their order, masked
  with ``tril``. The CPU tests and the smoke run hold the dense route
  against it; no path runs it.

The two routes (``gram_route`` picks one from the bundle's shape alone,
on the host, so a CUDA-graph capture and the mesh's column shards take
the same route every call):

* **hash** (``csrc/ell_gram.cu``): the CUDA kernel does not walk panels:
  each block owns a square tile of G, hashes its j-rows' entries into
  open-addressing tables in shared memory and looks its i-rows' entries
  up in them (see its header note). Its work is Σ_{i>j} nnz_i lookups,
  whatever n is. ``gram_geometry`` computes its launch — tile, threads a
  pair, chunk of a row's entries, table capacity and dynamic shared
  memory — from (sb, w); a tuned (tile, ks) applies to it alone.
* **dense** (``csrc/ell_gram_dense.cu``): where n ≤ ``DENSE_RATIO``·w —
  rows that cover most of their columns, epsilon's — every lookup would
  hit, and the product is a tensor-core one: pass A densifies each row
  into a workspace image (and takes v), pass B multiplies the 64 × 64
  tiles on or below the diagonal with mma.sync (split-TF32 in fp32, bf16
  × bf16 → fp32 in bf16), the columns split across blocks and the
  partials added in split order. Its work grows with sb²·n.
  ``dense_geometry`` computes its launch and workspace from (sb, n).

``bk`` and ``bm`` have no effect on either route; they only define the
plain walk. Any ``bk``/``bm`` gives the same result up to summation
order.

Pads are (idx 0, val 0) and contribute nothing. Accumulation is
float32 (float64 inputs stay float64 in the plain versions; the kernels
take float32 only).

Precision. ``precision="bf16"`` is the reference's
``compute_dtype=bfloat16``: each row's per-column value (the dense panel
entry) and x are rounded to bf16, the products are accumulated in
float32, and G and v stay float32. The plain version builds each panel
in float32, rounds it to bf16 and rounds x to bf16, then takes float32
dots — a product of two bf16 values is exact in float32, so on rows
with distinct ids it differs from the reference only in the order of
the sums. (Where a row repeats an id, the reference rounds each entry
and then their sum, the plain version the sum alone.) The dense route
rounds as the plain version does: each image entry once, after a
repeated id is merged. The hash route rounds each j-row's table value
once after the row's repeated ids are merged into it (as the plain
version rounds its panel entry) and each i-row entry on its own as it
is staged: where an i-row repeats an id (or a j-row repeats one across
two chunks of a row wider than one chunk), the plain version rounds the
sum once and the kernel the parts, a difference of up to one bf16
rounding (relative 2⁻⁸) of that entry. No registered dataset and no
generator row repeats an id.

Meta tensors (the comm ledger's structural capture) get outputs of the
right shape and dtype and no arithmetic.

Oracle: ``repro_torch.kernels.ref.ell_gram_and_v_ref`` (dense scatter).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build

_LIBS = {}


def _lib(name: str = "ell_gram"):
    """The route's shared library (``csrc/<name>.cu``), built at first use."""
    if name not in _LIBS:
        lib = _build.load_library(name)
        if name == "ell_gram":
            lib.ell_gram_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            lib.ell_gram_launch.restype = ctypes.c_int
        else:
            lib.ell_gram_dense_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            lib.ell_gram_dense_launch.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


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


# ---- the dense-row route (csrc/ell_gram_dense.cu) ----

ROUTES = ("hash", "dense")
# w ≥ DENSE_MIN_WIDTH and n ≤ DENSE_RATIO·w send a bundle to the dense
# route: the crossover that chip_smoke.py's phase 5 sweeps (sb = 128, w from
# 128 to 2,000, n = w to 64·w, both modes; `crossover` there), read on an
# NVIDIA H100 80GB HBM3 (700 W; PERF.md). Below the width the hash route's
# few lookups beat the dense route's two launches; above the ratio its work,
# which does not grow with n, beats the dense route's sb²·n.
DENSE_MIN_WIDTH = 500
DENSE_RATIO = 32
DENSE_TILE = 64  # rows and columns of a tile of G in pass B
DENSE_KT = 32  # columns a chunk (a stage of pass B's ring); n is padded to chunks
DENSE_SMS = 132  # an H100's SMs: pass B's blocks fill them before a split grows
# pass B's four-stage ring: an i-panel and a j-panel of 64 rows × 32
# columns a stage, rows padded by 4 words (the kernel's pitch_words)
DENSE_STAGES = 4
DENSE_RING_BYTES = {"fp32": DENSE_STAGES * 2 * DENSE_TILE * (DENSE_KT + 4) * 4,
                    "bf16": DENSE_STAGES * 2 * DENSE_TILE * (DENSE_KT // 2 + 4) * 4}
_ALIGN = 256  # the workspace's parts start at this many bytes


@dataclasses.dataclass(frozen=True)
class DenseGeometry:
    """The dense route's launch for an (sb, ·) bundle over n columns:
    pass A one block of 256 threads for each of the ``sb_pad`` image rows
    with ``densify_smem`` = 4·n_pad bytes of dynamic shared memory; pass B
    one block of 128 threads for each of the ``tile_count`` 64 × 64 tiles
    on or below the diagonal times ``splits`` column ranges of ``per``
    32-column chunks (the last range may be shorter), ``ring_bytes`` of
    dynamic shared memory. The workspace is one buffer of
    ``workspace_bytes``: the image (sb_pad × n_pad, float32 or bf16) at 0,
    the partial tiles at ``ws_offset``, the tickets at ``ticket_offset``."""

    sb: int
    n: int
    n_pad: int
    sb_pad: int
    tiles: int
    tile_count: int
    chunks: int
    splits: int
    per: int
    densify_smem: int
    ring_bytes: int
    image_bytes: int
    ws_offset: int
    ticket_offset: int
    workspace_bytes: int


def dense_geometry(sb: int, n: int, precision: str = "fp32", splits: int | None = None) -> DenseGeometry:
    """Launch plan and workspace of the dense route for sb rows over n
    columns (``ValueError`` if the bundle is empty). Without ``splits`` the
    column ranges a tile are ≈ √(2·chunks) — the range's product against
    the last block's sum of the partials — but no more than fill the SMs
    (⌈DENSE_SMS / tiles⌉). Either way the chunks are cut into ranges of
    ``per`` = ⌈chunks / splits⌉, which may make fewer ranges."""
    check_precision(precision)
    if sb < 1 or n < 1:
        raise ValueError(f"empty bundle (sb={sb}, n={n})")
    tiles = -(-sb // DENSE_TILE)
    tile_count = tiles * (tiles + 1) // 2
    chunks = -(-n // DENSE_KT)
    if splits is None:
        splits = max(1, min(math.isqrt(2 * chunks), -(-DENSE_SMS // tile_count)))
    per = -(-chunks // max(1, min(splits, chunks)))
    splits = -(-chunks // per)
    n_pad = chunks * DENSE_KT
    sb_pad = tiles * DENSE_TILE
    image = sb_pad * n_pad * (2 if precision == "bf16" else 4)
    ws_offset = -(-image // _ALIGN) * _ALIGN
    partial = tile_count * splits * DENSE_TILE * DENSE_TILE * 4 if splits > 1 else 0
    ticket_offset = ws_offset + -(-partial // _ALIGN) * _ALIGN
    return DenseGeometry(sb=sb, n=n, n_pad=n_pad, sb_pad=sb_pad, tiles=tiles, tile_count=tile_count,
                         chunks=chunks, splits=splits, per=per, densify_smem=4 * n_pad,
                         ring_bytes=DENSE_RING_BYTES[precision], image_bytes=image, ws_offset=ws_offset,
                         ticket_offset=ticket_offset, workspace_bytes=ticket_offset + 4 * tile_count)


def dense_fits(n: int) -> bool:
    """Whether a densified row of n columns fits pass A's shared memory."""
    return 4 * -(-n // DENSE_KT) * DENSE_KT <= SMEM_LIMIT


def gram_route(sb: int, w: int, n: int) -> str:
    """The route of an (sb, w) ELL bundle over n columns, from its shape
    alone: "dense" where w ≥ DENSE_MIN_WIDTH, n ≤ DENSE_RATIO·w and a
    densified row fits pass A's shared memory, else "hash"."""
    if sb < 1 or w < 1:
        raise ValueError(f"empty bundle (sb={sb}, w={w})")
    return "dense" if w >= DENSE_MIN_WIDTH and n <= DENSE_RATIO * w and dense_fits(n) else "hash"


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


def ell_gram_dense_plain(
    indices: torch.Tensor,
    values: torch.Tensor,
    x: torch.Tensor,
    *,
    n: int,
    precision: str = "fp32",
    splits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense route's plain version (see the module note): the rows
    densified with an accumulating ``index_put_`` (repeated ids add), in
    bf16 rounded once, G summed over the kernel's column ranges
    (``dense_geometry(sb, n, precision, splits)``) in their order and
    masked to the strict lower triangle, v the image times x. Runs on
    whatever device the tensors are on."""
    check_precision(precision)
    sb, w = values.shape
    acc = torch.float64 if values.dtype == torch.float64 else torch.float32
    if values.is_meta:
        return (torch.empty((sb, sb), dtype=acc, device="meta"),
                torch.empty((sb,), dtype=acc, device="meta"))
    geo = dense_geometry(sb, n, precision, splits)
    rows = torch.arange(sb, device=values.device).repeat_interleave(w)
    dense = torch.zeros((sb, n), dtype=acc, device=values.device)
    dense.index_put_((rows, indices.reshape(-1).long()), values.reshape(-1).to(acc), accumulate=True)
    x = x.to(acc)
    if precision == "bf16":
        dense, x = bf16_round(dense), bf16_round(x)
    g = torch.zeros((sb, sb), dtype=acc, device=values.device)
    cols = geo.per * DENSE_KT
    for k in range(geo.splits):
        part = dense[:, k * cols : (k + 1) * cols]
        g = g + part @ part.T
    return torch.tril(g, diagonal=-1), dense @ x


def _check_cuda_inputs(indices, values, x, n: int) -> tuple[int, int]:
    """The kernels' argument checks; (sb, w)."""
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
    return sb, w


def _counted(route: str, precision: str) -> None:
    ell_gram_and_v.launches[precision] += 1
    ell_gram_and_v.route_launches[route][precision] += 1


def ell_gram_hash(indices, values, x, *, n: int, precision: str = "fp32",
                  geometry: tuple[int, int] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the hash route (``csrc/ell_gram.cu``) on CUDA tensors,
    whatever ``gram_route`` says: ``geometry`` is a tuned (tile, ks) (None:
    ``gram_geometry``'s default). Checks as ``ell_gram_and_v``; a failed
    build or launch raises. Counts one launch of the route."""
    check_precision(precision)
    sb, w = _check_cuda_inputs(indices, values, x, n)
    geo = gram_geometry(sb, w, *(geometry or (None, None)))
    g = torch.empty((sb, sb), dtype=torch.float32, device=values.device)
    v = torch.empty((sb,), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        rc = _lib("ell_gram").ell_gram_launch(
            indices.data_ptr(), values.data_ptr(), x.data_ptr(), g.data_ptr(),
            v.data_ptr(), sb, w, int(precision == "bf16"), geo.tile, geo.ks, geo.chunk,
            geo.cap_log2, geo.smem_bytes, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ell_gram kernel launch failed: CUDA error {rc} (sb={sb}, w={w}, {precision}, {geo})"
        )
    _counted("hash", precision)
    return g, v


def ell_gram_dense(indices, values, x, *, n: int, precision: str = "fp32"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the dense route (``csrc/ell_gram_dense.cu``, two
    launches) on CUDA tensors, whatever ``gram_route`` says. The
    workspace is one ``torch.empty`` buffer of ``dense_geometry``'s size.
    Checks as ``ell_gram_and_v``, and a densified row must fit pass A's
    shared memory (``dense_fits``); a failed build or launch raises.
    Counts one launch of the route."""
    check_precision(precision)
    sb, w = _check_cuda_inputs(indices, values, x, n)
    if not dense_fits(n):
        raise ValueError(f"n={n}: a densified row does not fit {SMEM_LIMIT} bytes of shared memory")
    geo = dense_geometry(sb, n, precision)
    g = torch.empty((sb, sb), dtype=torch.float32, device=values.device)
    v = torch.empty((sb,), dtype=torch.float32, device=values.device)
    work = torch.empty((geo.workspace_bytes,), dtype=torch.uint8, device=values.device)
    base = work.data_ptr()
    with torch.cuda.device(values.device):
        rc = _lib("ell_gram_dense").ell_gram_dense_launch(
            indices.data_ptr(), values.data_ptr(), x.data_ptr(), g.data_ptr(), v.data_ptr(),
            base, base + geo.ws_offset, base + geo.ticket_offset, sb, w, n, geo.n_pad, geo.tiles,
            geo.splits, geo.per, int(precision == "bf16"), geo.densify_smem,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ell_gram dense kernel launch failed: CUDA error {rc} (sb={sb}, w={w}, n={n}, {precision}, {geo})"
        )
    _counted("dense", precision)
    return g, v


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

    CUDA tensors: the route ``gram_route(sb, w, n)`` names, launched on
    the current stream with no synchronisation — ``ell_gram_hash`` (with
    ``geometry``, a tuned (tile, ks); None: ``gram_geometry``'s default) or
    ``ell_gram_dense`` (``geometry`` does not apply). ``bk``/``bm`` are
    ignored (neither route's result depends on them), and every column id
    must lie in [0, n) — that is not checked on the device. A failed build
    or launch raises. CPU (and meta) tensors: the plain
    ``ell_gram_and_v_blocked`` (no route applies). Each kernel call adds one
    to ``ell_gram_and_v.launches[precision]`` and to
    ``ell_gram_and_v.route_launches[route][precision]``."""
    check_precision(precision)
    if not (indices.device == values.device == x.device):
        raise ValueError(
            f"indices, values, x must share a device, got {indices.device}, "
            f"{values.device}, {x.device}"
        )
    if not values.is_cuda:
        return ell_gram_and_v_blocked(indices, values, x, n=n, bk=bk, bm=bm, precision=precision)
    if values.dim() == 2 and gram_route(*values.shape, n) == "dense":  # each route checks the rest
        return ell_gram_dense(indices, values, x, n=n, precision=precision)
    return ell_gram_hash(indices, values, x, n=n, precision=precision, geometry=geometry)


ell_gram_and_v.launches = dict.fromkeys(PRECISIONS, 0)
ell_gram_and_v.route_launches = {route: dict.fromkeys(PRECISIONS, 0) for route in ROUTES}
