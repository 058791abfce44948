"""The s-step inner correction loop (paper Algorithm 3, lines 9–14).

After the Gram Allreduce, every rank runs s sequential corrections:

    z_j = v_j + (η/b) · G[j·b:(j+1)b, :] · u
    u_j = 1 / (1 + exp(z_j))        (u accumulates block by block)

The loop is a chain of s dependent b-row mat-vecs: expressed as tensor
ops it is s round trips through device memory and several launches
each. Two versions of the same function live here:

* ``sstep_inner`` — the wrapper. For CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/sstep_inner.cu`` (one launch for
  the whole bundle; built at first use) or raises; it never falls
  back. For CPU tensors it runs the plain version below.
* ``sstep_inner_ref`` — the plain PyTorch loop, the oracle.

Both hardcode the logistic residual and have no L2 decay; the engine's
``inner_corrections`` covers the other objectives and λ > 0.

The kernel's producer warp copies G's strict lower block triangle by
TMA into a ring of tiles in shared memory ahead of the chain of steps,
and the chain reads only shared memory (see its header note).
``inner_geometry`` computes its launch geometry — consumer threads,
tile width, ring slots, tile count and dynamic shared memory — from
(s, b), on the host, where the CPU tests reach it; ``inner_tiles`` is
the order in which the kernel walks the tiles.

``precision="bf16"`` is the reference's ``compute_dtype=bfloat16``: the
G row panel and u are rounded to bf16 for the dot only, the products
are summed in float32, and z, the residual and the stored u stay
float32. The plain version rounds its operands with
``.to(torch.bfloat16).float()`` and takes a float32 mat-vec (a product
of two bf16 values is exact in float32), so the kernel and its plain
version differ only in the order of the sums. The engine never runs
this mode: under its bf16 schedule it unwires (G, v) to float32 and
runs the float32 corrections, as the reference does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_gram import PRECISIONS, SMEM_LIMIT, bf16_round, check_precision

# the largest s·b the kernel takes: u and v (8·sb bytes) and a ring of at
# least one tile of b rows × 4 columns fit a block's shared memory up to here
MAX_SB = 48 * 1024 // 4
MAX_STAGES = 8  # tiles in the ring at most
MAX_COLS = 256  # columns of a tile at most: one TMA box is at most 256 wide
MAX_CONSUMERS = 992  # a block has at most 1,024 threads, one warp of them the producer
LANES = 8  # consumer lanes a row of a panel, fixed in the kernel (a sweep's choice at b = 32)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load_library("sstep_inner")
        lib.sstep_inner_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sstep_inner_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@dataclasses.dataclass(frozen=True)
class InnerGeometry:
    """The CUDA kernel's launch: one block of ``threads`` consumer threads
    and a producer warp, a row of a panel to each group of ``LANES``
    consumer lanes; G's strict lower block triangle walked in ``tiles``
    tiles of b rows × ``cols`` columns (``inner_tiles``) through a ring of
    ``stages`` slots; ``smem_bytes`` of dynamic shared memory (u, v, the
    ring and two 8-byte barriers a slot)."""

    threads: int
    cols: int
    stages: int
    tiles: int
    smem_bytes: int


def _ceil(n: int, to: int) -> int:
    return -(-n // to) * to


@functools.lru_cache(maxsize=256)
def inner_geometry(s: int, b: int, *, threads: int | None = None) -> InnerGeometry:
    """Launch geometry of the CUDA kernel for s steps of b rows.

    ``threads`` (the consumers) is enough groups of ``LANES`` lanes for
    one row each, within 32..``MAX_CONSUMERS``, unless given (sweeps).
    The tiles: where all s − 1 panels fit in shared memory beside u and
    v, one tile a step, as wide as the widest panel (at most
    ``MAX_COLS``), all in flight at once; else a ring of the most slots
    (≤ ``MAX_STAGES``) whose tiles are at least 4·LANES columns wide (or
    the whole panel), as wide as shared memory allows.
    The layout is the kernel's: u and v (s·b rounded up to 4 floats
    each), then the ring at a 128-byte boundary, slots of b·cols floats
    rounded up to 128 bytes, then the barriers."""
    s, b = int(s), int(b)
    if s < 1 or b < 1:
        raise ValueError(f"s={s} and b={b} must be positive")
    if s * b > MAX_SB:
        raise ValueError(f"s·b={s * b} exceeds the kernel's shared-memory bound {MAX_SB}")
    if threads is None:
        threads = min(MAX_CONSUMERS, max(32, _ceil(b * LANES, 32)))
    if threads % 32 or not 32 <= threads <= MAX_CONSUMERS:
        raise ValueError(f"threads={threads} must be a multiple of 32 ≤ {MAX_CONSUMERS}")
    ring = 4 * _ceil(2 * _ceil(s * b, 4), 32)  # bytes before the ring: u and v
    if s == 1:  # no panel: step 0 is z = v
        return InnerGeometry(threads=threads, cols=4, stages=0, tiles=0, smem_bytes=ring)

    def fits(stages: int, cols: int) -> bool:
        return ring + stages * 4 * _ceil(b * cols, 32) + 16 * stages <= SMEM_LIMIT

    def widest(stages: int) -> int:  # the widest tile (a multiple of 4) with which `stages` slots fit
        cols = min(MAX_COLS, ((SMEM_LIMIT - ring - 16 * stages) // (4 * b * stages)) // 4 * 4)
        while cols >= 4 and not fits(stages, cols):
            cols -= 4
        return cols

    full = _ceil((s - 1) * b, 4)
    if s - 1 <= MAX_STAGES and full <= MAX_COLS and fits(s - 1, full):
        stages, cols = s - 1, full
    else:
        for stages in range(MAX_STAGES, 0, -1):
            cols = min(full, widest(stages))
            if cols >= min(full, 4 * LANES):
                break
    if cols < 4:
        raise ValueError(f"no ring fits shared memory at s={s}, b={b}")
    tiles = sum(1 for _ in inner_tiles(s, b, cols))
    return InnerGeometry(threads=threads, cols=cols, stages=stages, tiles=tiles,
                         smem_bytes=ring + stages * 4 * _ceil(b * cols, 32) + 16 * stages)


def inner_tiles(s: int, b: int, cols: int):
    """The tiles in the kernel's order: (step j, first column, width) for
    step j's columns [0, j·b) cut every ``cols`` columns, j = 1 .. s − 1."""
    for j in range(1, s):
        for c0 in range(0, j * b, cols):
            yield j, c0, min(cols, j * b - c0)


def eta_over_b(eta, b: int) -> float:
    """η/b formed in float32, as the engine forms it."""
    return float(np.float32(eta) / np.float32(b))


def sstep_inner_ref(g: torch.Tensor, v: torch.Tensor, s: int, b: int, eta: float,
                    *, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch oracle — the same loop the engine runs at the
    logistic default; under "bf16" the dot's operands are rounded to
    bf16 (see the module note)."""
    from repro_torch.core.objective import LOGISTIC

    check_precision(precision)
    operand = bf16_round if precision == "bf16" else (lambda t: t)
    scale = eta_over_b(eta, b)
    u = torch.zeros(s * b, dtype=v.dtype, device=v.device)
    for j in range(s):
        zj = v[j * b : (j + 1) * b] + scale * (operand(g[j * b : (j + 1) * b]) @ operand(u))
        u[j * b : (j + 1) * b] = LOGISTIC.residual(zj)
    return u


def sstep_inner(
    g: torch.Tensor,  # (sb, sb) strictly-lower Gram
    v: torch.Tensor,  # (sb,)
    s: int,
    b: int,
    eta: float,
    *,
    precision: str = "fp32",
) -> torch.Tensor:
    """u (sb,) such that u_j = residual(v_j + (η/b) Σ_{l<j} G_{jl} u_l),
    logistic residual.

    CUDA tensors: one launch of the Hopper kernel on the current
    stream, no synchronisation; a failed build or launch raises. CPU
    tensors: the plain ``sstep_inner_ref``. s, b and η are runtime
    arguments of the kernel. Each kernel launch adds one to
    ``sstep_inner.launches[precision]``."""
    check_precision(precision)
    s, b = int(s), int(b)
    sb = s * b
    if s < 1 or b < 1:
        raise ValueError(f"s={s} and b={b} must be positive")
    if g.shape != (sb, sb) or v.shape != (sb,):
        raise ValueError(
            f"expected G ({sb}, {sb}) and v ({sb},), got {tuple(g.shape)} and {tuple(v.shape)}"
        )
    if g.device != v.device:
        raise ValueError(f"G and v must share a device, got {g.device} and {v.device}")
    if not g.is_cuda:
        return sstep_inner_ref(g.to(torch.float32), v.to(torch.float32), s, b, eta,
                               precision=precision)
    if g.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 G and v, got {g.dtype}, {v.dtype}")
    if not (g.is_contiguous() and v.is_contiguous()):
        raise ValueError("G and v must be contiguous")
    return sstep_inner_launch(g, v, s, b, eta, precision, inner_geometry(s, b))


def sstep_inner_launch(g: torch.Tensor, v: torch.Tensor, s: int, b: int, eta: float,
                       precision: str, geo: InnerGeometry) -> torch.Tensor:
    """One launch of the kernel at the geometry ``geo`` on contiguous
    float32 CUDA tensors that ``sstep_inner`` has checked (sweeps call
    it with other geometries); adds one to
    ``sstep_inner.launches[precision]``."""
    u = torch.empty((s * b,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = _lib().sstep_inner_launch(
            g.data_ptr(), v.data_ptr(), u.data_ptr(), s, b, eta_over_b(eta, b),
            int(precision == "bf16"), geo.threads, geo.cols, geo.stages, geo.tiles,
            geo.smem_bytes, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sstep_inner kernel launch failed: CUDA error {rc} (s={s}, b={b}, {precision}, {geo})"
        )
    sstep_inner.launches[precision] += 1
    return u


sstep_inner.launches = dict.fromkeys(PRECISIONS, 0)
