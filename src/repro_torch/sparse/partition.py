"""Column/row partitioners and irregularity statistics.

The paper frames partitioner choice as the two-objective constrained
problem  min_P κ(P)  s.t.  max_rank n_local(P)·w ≤ L_cap  (§6.5) and
implements three column partitioners (§7.3):

  rows    contiguous uniform n/p_c columns per rank — cache-friendly,
          nnz-imbalanced on skewed data;
  nnz     contiguous greedy — walk columns, advance rank when cumulative
          nnz reaches m·z̄/p_c — κ≈1 but may concentrate huge n_local;
  cyclic  round-robin c → c mod p_c — n_local exact AND κ≈1 in
          expectation, at the cost of a column permutation in the reader.

κ = max_rank(nnz)/mean_rank(nnz). On SPMD hardware every shard is padded
to the max, so κ multiplies compute directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSRMatrix

PARTITIONERS = ("rows", "nnz", "cyclic")


@dataclasses.dataclass(frozen=True)
class ColumnPartition:
    """Assignment of the n columns to p_c ranks.

    ``order`` lists column ids grouped by rank (rank r owns
    order[starts[r]:starts[r+1]], renumbered locally in that order).
    """

    kind: str
    p: int
    order: np.ndarray  # (n,) int64 — permutation of column ids
    starts: np.ndarray  # (p+1,) int64

    def rank_cols(self, r: int) -> np.ndarray:
        return self.order[self.starts[r] : self.starts[r + 1]]

    @property
    def n_local(self) -> np.ndarray:
        return np.diff(self.starts)


def partition_columns(a: CSRMatrix, p: int, kind: str) -> ColumnPartition:
    n = a.n
    if kind == "rows":  # contiguous uniform
        bounds = np.linspace(0, n, p + 1).astype(np.int64)
        order = np.arange(n, dtype=np.int64)
        return ColumnPartition("rows", p, order, bounds)
    if kind == "nnz":  # contiguous greedy on cumulative nnz
        col_nnz = a.nnz_per_col()
        target = a.nnz / p
        csum = np.cumsum(col_nnz)
        starts = [0]
        for r in range(1, p):
            # first column index where cumulative nnz reaches r*target
            idx = int(np.searchsorted(csum, r * target, side="left")) + 1
            idx = max(idx, starts[-1])  # never move backwards
            idx = min(idx, n - (p - r))  # leave ≥1 col per remaining rank
            starts.append(idx)
        starts.append(n)
        order = np.arange(n, dtype=np.int64)
        return ColumnPartition("nnz", p, order, np.asarray(starts, np.int64))
    if kind == "cyclic":  # round robin
        order = np.concatenate([np.arange(r, n, p, dtype=np.int64) for r in range(p)])
        sizes = np.array([len(range(r, n, p)) for r in range(p)], np.int64)
        starts = np.zeros(p + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        return ColumnPartition("cyclic", p, order, starts)
    raise ValueError(f"unknown partitioner {kind!r}; expected one of {PARTITIONERS}")


def partition_rows(m: int, p: int) -> np.ndarray:
    """Contiguous row bounds (p+1,) — all algorithms row-partition
    uniformly (the paper pads m to a multiple of s_max·b)."""
    return np.linspace(0, m, p + 1).astype(np.int64)


def partition_2d(
    a: CSRMatrix, p_r: int, p_c: int, kind: str
) -> tuple[list[list[CSRMatrix]], ColumnPartition, np.ndarray]:
    """Split A into p_r × p_c local CSR blocks.

    Returns (blocks[i][j], column partition, row bounds). Block (i, j)
    holds rows [rb[i], rb[i+1]) and the j-th rank's columns, locally
    renumbered in partition order.
    """
    cp = partition_columns(a, p_c, kind)
    rb = partition_rows(a.m, p_r)
    blocks: list[list[CSRMatrix]] = []
    for i in range(p_r):
        row_blk = a.row_block(int(rb[i]), int(rb[i + 1]))
        blocks.append([row_blk.select_columns(cp.rank_cols(j)) for j in range(p_c)])
    return blocks, cp, rb


@dataclasses.dataclass(frozen=True)
class PartitionStats:
    kind: str
    p: int
    kappa: float  # max/mean per-rank nnz
    nnz_per_rank: np.ndarray
    n_local: np.ndarray
    max_n_local: int
    weight_slab_bytes: int  # max_rank n_local · word
    fits_cache: bool


def partition_stats(
    a: CSRMatrix, cp: ColumnPartition, word_bytes: int = 8, l_cap_bytes: int = 1 << 20
) -> PartitionStats:
    col_nnz = a.nnz_per_col()
    nnz_per_rank = np.array(
        [int(col_nnz[cp.rank_cols(r)].sum()) for r in range(cp.p)], np.int64
    )
    mean = float(nnz_per_rank.mean()) if cp.p else 0.0
    kappa = float(nnz_per_rank.max() / mean) if mean > 0 else 1.0
    n_local = cp.n_local
    slab = int(n_local.max()) * word_bytes
    return PartitionStats(
        kind=cp.kind,
        p=cp.p,
        kappa=kappa,
        nnz_per_rank=nnz_per_rank,
        n_local=n_local,
        max_n_local=int(n_local.max()),
        weight_slab_bytes=slab,
        fits_cache=slab <= l_cap_bytes,
    )
