"""Host-side CSR matrices (numpy).

This is the ingest format: the paper stores A in three-array CSR and all
partitioners operate on column/row index structure. The device format
(padded ELL, ``repro_torch.sparse.ell``) is derived from CSR blocks.

Numpy only, and arithmetic-for-arithmetic the same as the JAX package's
``repro.sparse.csr`` so that the same inputs give identical arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Three-array CSR. ``indptr`` has length m+1; column indices sorted
    within each row is NOT required (partition permutations may unsort)."""

    indptr: np.ndarray  # (m+1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray  # (nnz,) float
    shape: tuple[int, int]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nnz_per_row(self) -> np.ndarray:
        return np.diff(self.indptr)

    def nnz_per_col(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n)

    @property
    def zbar(self) -> float:
        """Mean nonzeros per row (the paper's z̄)."""
        return self.nnz / max(self.m, 1)

    def row_block(self, r0: int, r1: int) -> "CSRMatrix":
        """Rows [r0, r1) as a new CSR (row dimension r1-r0)."""
        lo, hi = int(self.indptr[r0]), int(self.indptr[r1])
        return CSRMatrix(
            indptr=(self.indptr[r0 : r1 + 1] - lo).astype(np.int64),
            indices=self.indices[lo:hi],
            data=self.data[lo:hi],
            shape=(r1 - r0, self.n),
        )

    def select_columns(self, cols: np.ndarray, relabel: bool = True) -> "CSRMatrix":
        """Keep only ``cols`` (any order). With ``relabel`` the kept
        columns are renumbered 0..len(cols)-1 in the order given — this
        is the column permutation a partitioner induces locally."""
        mask = np.zeros(self.n, dtype=bool)
        mask[cols] = True
        keep = mask[self.indices]
        new_indices = self.indices[keep]
        if relabel:
            remap = np.full(self.n, -1, dtype=np.int64)
            remap[cols] = np.arange(len(cols))
            new_indices = remap[new_indices].astype(np.int32)
            new_n = len(cols)
        else:
            new_n = self.n
        row_counts = np.add.reduceat(keep.astype(np.int64), self.indptr[:-1]) if self.nnz else np.zeros(self.m, np.int64)
        # reduceat misbehaves for empty rows; recompute robustly
        row_ids = np.repeat(np.arange(self.m), self.nnz_per_row)
        row_counts = np.bincount(row_ids[keep], minlength=self.m)
        indptr = np.zeros(self.m + 1, dtype=np.int64)
        np.cumsum(row_counts, out=indptr[1:])
        return CSRMatrix(indptr=indptr, indices=new_indices, data=self.data[keep], shape=(self.m, new_n))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype if self.nnz else np.float64)
        row_ids = np.repeat(np.arange(self.m), self.nnz_per_row)
        out[row_ids, self.indices] = self.data
        return out

    def scale_rows(self, y: np.ndarray) -> "CSRMatrix":
        """Return diag(y) @ A — the paper precomputes this once."""
        row_ids = np.repeat(np.arange(self.m), self.nnz_per_row)
        return dataclasses.replace(self, data=self.data * y[row_ids])


def csr_transpose(a: CSRMatrix) -> CSRMatrix:
    """Aᵀ as CSR (host-side)."""
    row_ids = np.repeat(np.arange(a.m), a.nnz_per_row)
    order = np.argsort(a.indices, kind="stable")
    new_indices = row_ids[order].astype(np.int32)
    new_data = a.data[order]
    counts = np.bincount(a.indices, minlength=a.n)
    indptr = np.zeros(a.n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix(indptr=indptr, indices=new_indices, data=new_data, shape=(a.n, a.m))


def csr_from_dense(a: np.ndarray) -> CSRMatrix:
    m, n = a.shape
    indptr = np.zeros(m + 1, dtype=np.int64)
    idx_list, val_list = [], []
    for i in range(m):
        (cols,) = np.nonzero(a[i])
        idx_list.append(cols.astype(np.int32))
        val_list.append(a[i, cols])
        indptr[i + 1] = indptr[i] + len(cols)
    return CSRMatrix(
        indptr=indptr,
        indices=np.concatenate(idx_list) if idx_list else np.zeros(0, np.int32),
        data=np.concatenate(val_list) if val_list else np.zeros(0),
        shape=(m, n),
    )


def csr_matvec(a: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """y = A @ x (host oracle)."""
    row_ids = np.repeat(np.arange(a.m), a.nnz_per_row)
    contrib = a.data * x[a.indices]
    return np.bincount(row_ids, weights=contrib, minlength=a.m).astype(x.dtype, copy=False)


def csr_rmatvec(a: CSRMatrix, u: np.ndarray) -> np.ndarray:
    """g = A.T @ u (host oracle)."""
    row_ids = np.repeat(np.arange(a.m), a.nnz_per_row)
    contrib = a.data * u[row_ids]
    return np.bincount(a.indices, weights=contrib, minlength=a.n).astype(u.dtype, copy=False)


def row_chunks(indptr: np.ndarray, max_nnz: int):
    """(r0, r1) row ranges that cover the rows in order, each holding at
    most ``max_nnz`` nonzeros (or one row, where a row alone holds more):
    how the host build bounds its temporaries on datasets of any size."""
    m = len(indptr) - 1
    r0 = 0
    while r0 < m:
        r1 = max(int(np.searchsorted(indptr, indptr[r0] + max_nnz, side="right")) - 1, r0 + 1)
        yield r0, r1
        r0 = r1
