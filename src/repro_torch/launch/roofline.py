"""Bounds of the bundle (G, v) build on an NVIDIA H100 — the panel half of
the reference's roofline module.

Two models live here:

* the **panel model** (``panel_vmem_bytes``, ``panel_flops``,
  ``panel_hbm_bytes``, ``PanelRoofline``, ``panel_roofline``): the
  reference's count of a (bk, bm) panel walk — the plain
  ``ell_gram_and_v_blocked`` walks exactly these panels. The counts do not
  depend on the chip and equal the reference's for equal arguments; the
  rates and the fit check are the H100's. The CPU autotuner prices its
  (bk, bm) candidates with it.
* the **probe bound** (``probe_bound``): the least time the card could
  take for the function the CUDA kernel computes, whatever its design —
  the bytes it must move (the ELL bundle's ids and values, each distinct
  gathered x entry, G and v, each once) over the memory rate, against
  the operations it must do (a multiply-add per pair of nonzeros of rows
  i > j that share a column id, one per nonzero for v) over the fp32
  rate. The card's autotuner cross-checks its (tile, ks) timings with it,
  and ``chip_smoke.py`` reports it as each Gram row's ``bound_ms``.

Rates: the H100 SXM's published peaks — 3.35 TB/s HBM3, 67 TFLOP/s fp32
outside the tensor cores (the kernel is fp32 FMA in both modes: a bf16
product is exact in fp32), 989 TFLOP/s bf16 dense on the tensor cores
(the bf16 panel of the plain walk is a matmul). The fit check is the
kernel's dynamic shared memory a block, ``SMEM_LIMIT``.

The model half of the reference's module (HLO collective parsing, the
dry-run roofline terms, model FLOPs, depth extrapolation) reads XLA's
compiled text and waits for the language-model dry run (ROADMAP.md Queue 1
item 13d).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.ell_gram import SMEM_LIMIT

# NVIDIA H100 SXM, published peaks (one card)
HBM_BW = 3.35e12  # B/s
PEAK_FLOPS_FP32 = 67e12  # FMA units, no tensor cores
PEAK_FLOPS_BF16 = 989e12  # tensor cores, dense
SMEM_BYTES = SMEM_LIMIT  # dynamic shared memory a block may use (sm_90)


# ---- the panel model (the plain walk's count) ----
#
# The plain walk takes ⌈n/bk⌉ column panels; per panel it expands the
# (sb, w) ELL block into a (sb, bk) dense panel (one-hot contraction,
# 2·sb·w·bk FLOPs), accumulates G += P·Pᵀ (2·sb²·bk) and v += P·x_blk
# (2·sb·bk). The ELL block is re-read once per panel.


def panel_vmem_bytes(
    rows: int, width: int, bk: int, bm: int | None = None, compute_bytes: int = 4
) -> int:
    """On-chip working set of one panel step: the (bm, bk) expanded panel
    tile at compute precision plus the resident ELL block (indices +
    values), G, v, and x panel (all f32/i32). (The reference's name: the
    count is the same, the fit check is against shared memory.)"""
    bm = rows if bm is None or bm > rows else bm
    panel = bm * bk * compute_bytes
    resident = rows * width * (4 + 4) + rows * rows * 4 + rows * 4 + bk * 4
    return panel + resident


def panel_flops(rows: int, width: int, n: int, bk: int) -> float:
    """Total FLOPs of one (G, v) bundle build at panel width bk."""
    n_panels = -(-n // bk)
    per_panel = 2 * rows * width * bk + 2 * rows * rows * bk + 2 * rows * bk
    return float(n_panels * per_panel)


def panel_hbm_bytes(
    rows: int, width: int, n: int, bk: int, compute_bytes: int = 4
) -> float:
    """Memory traffic of one bundle build: the ELL block re-streamed once
    per panel, x streamed once, G and v written once."""
    n_panels = -(-n // bk)
    ell = n_panels * rows * width * (4 + 4)  # int32 indices + f32 values
    x = n_panels * bk * 4
    out = rows * rows * 4 + rows * 4
    return float(ell + x + out)


@dataclasses.dataclass(frozen=True)
class PanelRoofline:
    """Attainable-time bound for one (rows, width, n, bk, bm) panel
    configuration — what the CPU autotuner cross-checks measured time
    against (a measurement below the bound is a timer glitch)."""

    rows: int
    width: int
    n: int
    bk: int
    bm: int | None
    flops: float
    hbm_bytes: float
    vmem_bytes: int
    peak_flops: float = PEAK_FLOPS_FP32
    hbm_bw: float = HBM_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def attainable_s(self) -> float:
        """Roofline lower bound on the bundle build (max of the terms)."""
        return max(self.compute_s, self.memory_s)

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def fits_vmem(self) -> bool:
        """The working set fits one block's shared memory on the card."""
        return self.vmem_bytes <= SMEM_BYTES


def panel_roofline(
    rows: int,
    width: int,
    n: int,
    bk: int,
    bm: int | None = None,
    precision: str = "fp32",
) -> PanelRoofline:
    """The attainable-time justification for one (bk, bm) candidate:
    bf16 panels at the tensor cores' bf16 peak with 2-byte tiles, fp32
    at the fp32 peak with 4-byte tiles."""
    cb = 2 if precision == "bf16" else 4
    peak = PEAK_FLOPS_BF16 if precision == "bf16" else PEAK_FLOPS_FP32
    return PanelRoofline(
        rows=rows,
        width=width,
        n=n,
        bk=bk,
        bm=bm,
        flops=panel_flops(rows, width, n, bk),
        hbm_bytes=panel_hbm_bytes(rows, width, n, bk, cb),
        vmem_bytes=panel_vmem_bytes(rows, width, bk, bm, cb),
        peak_flops=peak,
    )


# ---- the probe bound (the function's own count) ----


@dataclasses.dataclass(frozen=True)
class ProbeBound:
    """The least time of one (G, v) build of a given bundle on the card:
    ``bytes`` moved once over ``HBM_BW`` against ``operations`` (a
    multiply-add counts two) over ``PEAK_FLOPS_FP32``."""

    bytes: float
    operations: float
    pairs: float  # multiply-adds G needs: shared column ids of rows i > j

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def compute_s(self) -> float:
        return self.operations / PEAK_FLOPS_FP32

    @property
    def attainable_s(self) -> float:
        return max(self.memory_s, self.compute_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.compute_s > self.memory_s else "bytes"


def matching_pairs(indices, values) -> float:
    """Σ_{i>j} of the nonzero entries of rows i and j that share a column
    id: the multiply-adds G needs on this bundle (numpy arrays)."""
    indices, values = np.asarray(indices), np.asarray(values)
    nz = values != 0
    rows = np.broadcast_to(np.arange(indices.shape[0])[:, None], indices.shape)[nz].astype(np.int64)
    cols = indices[nz].astype(np.int64)
    per_col = np.unique(cols, return_counts=True)[1].astype(np.float64)
    per_cell = np.unique(rows * (int(cols.max(initial=0)) + 1) + cols, return_counts=True)[1].astype(np.float64)
    return float(((per_col ** 2).sum() - (per_cell ** 2).sum()) / 2)


def probe_bound(indices, values) -> ProbeBound:
    """The bound of one (G, v) build of the (sb, w) ELL bundle
    (``indices``, ``values``; numpy arrays or tensors, read on the host):
    bytes = ids + values + each distinct gathered x entry + G + v, 4 bytes
    each; operations = 2 per matching pair + 2 per nonzero."""
    indices = indices.cpu().numpy() if hasattr(indices, "cpu") else np.asarray(indices)
    values = values.cpu().numpy() if hasattr(values, "cpu") else np.asarray(values)
    sb = indices.shape[0]
    nbytes = indices.size * 8 + np.unique(indices).size * 4 + sb * sb * 4 + sb * 4
    pairs = matching_pairs(indices, values)
    ops = 2.0 * pairs + 2.0 * float(np.count_nonzero(values))
    return ProbeBound(bytes=float(nbytes), operations=ops, pairs=pairs)
