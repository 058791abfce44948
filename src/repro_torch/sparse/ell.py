"""Padded ELL device format and plain-torch sparse matvec/rmatvec.

ELL pads every row to the same nonzero count so shapes are uniform.
Padding uses column 0 with value 0. The padded width is the *global
max* across row teams so all teams share one shape; this is where the
paper's κ imbalance turns into padded compute.

The transpose products ``ell_rmatvec`` / ``ell_rmatmat`` are scatter-adds
through ``Tensor.index_add_``. On the CPU it accumulates serially: the
same inputs give the same bits on every run, and chunked ≡ monolithic
is exact. On CUDA it accumulates with float32 atomics, so the order in
which one column's contributions are summed, and with it the last bits
of that sum, can change from run to run. The stated tolerance: two runs
of the same schedule on a GPU agree to 5e-6 of the largest entry of the
iterate (``chip_smoke.py`` measures the gap); they are not bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.csr import CSRMatrix


@dataclasses.dataclass
class EllBlock:
    """One local sparse block in padded-ELL layout.

    indices: (rows, width) int32 column ids (0 where padded)
    values:  (rows, width) float (0 where padded)
    n:       local column count (for rmatvec output length)
    """

    indices: torch.Tensor
    values: torch.Tensor
    n: int

    @property
    def rows(self) -> int:
        return int(self.indices.shape[0])

    @property
    def width(self) -> int:
        return int(self.indices.shape[1])


def ell_from_csr(
    a: CSRMatrix, width: int | None = None, dtype: torch.dtype = torch.float32,
    device=None,
) -> EllBlock:
    """Pad the CSR rows to one width. Values are assembled in float64
    on the host and cast to ``dtype`` (float32) explicitly."""
    device = resolve_device(device)
    counts = a.nnz_per_row
    w = int(counts.max()) if counts.size and width is None else int(width or 0)
    w = max(w, 1)
    idx = np.zeros((a.m, w), dtype=np.int32)
    val = np.zeros((a.m, w), dtype=np.float64)
    for i in range(a.m):
        lo, hi = int(a.indptr[i]), int(a.indptr[i + 1])
        k = hi - lo
        if k > w:
            raise ValueError(f"row {i} has {k} nnz > ELL width {w}")
        idx[i, :k] = a.indices[lo:hi]
        val[i, :k] = a.data[lo:hi]
    return EllBlock(
        indices=torch.from_numpy(idx).to(device),
        values=torch.from_numpy(val).to(dtype).to(device),
        n=a.n,
    )


def _gather(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x[indices] along dim 0 for an int32 index tensor of any shape."""
    flat = x.index_select(0, indices.reshape(-1))
    return flat.reshape(*indices.shape, *x.shape[1:])


def ell_matvec(ell: EllBlock, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, y: (rows,). Gather + row-sum; pads contribute 0."""
    return torch.sum(ell.values * _gather(x, ell.indices), dim=1)


def ell_matmat(ell: EllBlock, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X: (n, k) — used by the s-step bundle."""
    gathered = _gather(x, ell.indices)  # (rows, width, k)
    return torch.einsum("rw,rwk->rk", ell.values, gathered)


def ell_rmatvec(ell: EllBlock, u: torch.Tensor) -> torch.Tensor:
    """g = A.T @ u, g: (n,). Scatter-add of u-weighted values; pads add
    0 to column 0. Atomic on CUDA — see the module note."""
    contrib = (ell.values * u[:, None]).reshape(-1)
    out = torch.zeros(ell.n, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, ell.indices.reshape(-1), contrib)


def ell_rmatmat(ell: EllBlock, u: torch.Tensor) -> torch.Tensor:
    """G = A.T @ U for U: (rows, k); accumulates like ``ell_rmatvec``."""
    contrib = ell.values[:, :, None] * u[:, None, :]  # (rows, width, k)
    out = torch.zeros((ell.n, u.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, ell.indices.reshape(-1), contrib.reshape(-1, u.shape[1]))


def ell_row_slice(ell: EllBlock, r0: int, r1: int) -> EllBlock:
    return EllBlock(indices=ell.indices[r0:r1], values=ell.values[r0:r1], n=ell.n)
