"""Skew-controlled synthetic sparse datasets + LIBSVM stat analogues.

LIBSVM files (url, news20, rcv1, epsilon) are not available offline, so
we reproduce the paper's experiments on synthetic datasets matched to
each dataset's published statistics (m, n, z̄, column skew). Column ids are drawn from p(c) ∝ (c+1)^(-alpha)
(alpha=0 uniform, alpha=1 Zipf), the same family as the paper's Figure 3
skew sweep. Both the paper's full-size statistics and the scaled "-sm"
variants are registered; ``make_dataset`` materializes either.

Numpy only; the same seed gives bit-identical arrays to the JAX
package's ``repro.sparse.synthetic`` (both draw from ``default_rng``
in the same order).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_matvec, row_chunks


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    """Published statistics used by the cost model (paper Table 6)."""

    name: str
    m: int
    n: int
    zbar: int
    skew_alpha: float  # column-skew exponent matched qualitatively
    dense: bool = False


# Paper Table 6 (+ the synthetic uniform matrix of Table 4 / Fig 7).
DATASET_STATS: dict[str, DatasetStats] = {
    "rcv1": DatasetStats("rcv1", 20_242, 47_236, 74, 0.6),
    "news20": DatasetStats("news20", 19_996, 1_355_191, 455, 0.9),
    "url": DatasetStats("url", 2_396_130, 3_231_961, 116, 1.0),
    "epsilon": DatasetStats("epsilon", 400_000, 2_000, 2_000, 0.0, dense=True),
    "synthetic_uniform": DatasetStats("synthetic_uniform", 2**21, 3_145_728, 12_582, 0.0),
}

# Scaled variants that we actually materialize on CPU. Scaling keeps the
# qualitative structure: n >> m for news20/url (high-dimensional), the
# column-skew exponent, and dense epsilon.
SM_STATS: dict[str, DatasetStats] = {
    "rcv1-sm": DatasetStats("rcv1-sm", 2_048, 4_736, 74, 0.6),
    "news20-sm": DatasetStats("news20-sm", 2_000, 66_560, 200, 0.9),
    "url-sm": DatasetStats("url-sm", 8_192, 131_072, 116, 1.0),
    "epsilon-sm": DatasetStats("epsilon-sm", 4_096, 512, 512, 0.0, dense=True),
    "uniform-sm": DatasetStats("uniform-sm", 4_096, 16_384, 64, 0.0),
}


def dataset_stats(name: str) -> DatasetStats:
    """Registered statistics for ``name`` — materializable -sm variants
    first, then the paper's full-size stat entries."""
    stats = SM_STATS.get(name) or DATASET_STATS.get(name)
    if stats is None:
        known = sorted(SM_STATS) + sorted(DATASET_STATS)
        raise KeyError(f"unknown dataset {name!r}; known: {known}")
    return stats


@dataclasses.dataclass
class SyntheticDataset:
    name: str
    A: CSRMatrix  # already includes NO label scaling; solvers apply diag(y)
    y: np.ndarray  # (m,) ±1
    x_true: np.ndarray  # (n,) generating weights
    stats: DatasetStats


def _column_probs(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    # p(c) ∝ (c+1)^(-α): heavy columns are *clustered at low ids*, the
    # structure real LIBSVM data exhibits (features sorted by frequency).
    # This is what makes contiguous partitioners κ-pathological (paper
    # Table 9: rows κ=33.8 on url) while cyclic stays near-optimal.
    del rng
    p = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    return p / p.sum()


def make_skewed_csr(
    m: int, n: int, zbar: int, alpha: float, seed: int = 0, dense: bool = False
) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    if dense:
        data = rng.standard_normal((m, n)) / np.sqrt(n)
        indptr = np.arange(m + 1, dtype=np.int64) * n
        indices = np.tile(np.arange(n, dtype=np.int32), m)
        return CSRMatrix(indptr=indptr, indices=indices, data=data.reshape(-1), shape=(m, n))
    probs = _column_probs(n, alpha, rng)
    # Per-row nnz ~ Poisson(zbar) clipped to [1, 4*zbar] — heavy-tailed
    # rows like real data.
    counts = np.clip(rng.poisson(zbar, size=m), 1, min(4 * zbar, n)).astype(np.int64)
    total = int(counts.sum())
    # Sample with replacement then dedupe per row (cheap, preserves skew).
    cols = rng.choice(n, size=total, p=probs).astype(np.int32)
    vals = rng.standard_normal(total) / np.sqrt(zbar)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    idx, val, kept = _dedupe_rows(cols, vals, indptr, n)
    out_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(kept, out=out_ptr[1:])
    return CSRMatrix(indptr=out_ptr, indices=idx, data=val, shape=(m, n))


# entries a pass of ``_dedupe_rows`` sorts at once: its int64 temporaries
# stay near 0.5 GB whatever the dataset's size
DEDUPE_CHUNK = 1 << 24


def _dedupe_rows(cols: np.ndarray, vals: np.ndarray, indptr: np.ndarray, n: int):
    """Each row's distinct column ids in ascending order, each with the
    value of its first occurrence, and the kept count of every row: what
    ``np.unique(row_cols, return_index=True)`` keeps, for all rows at
    once. A stable sort by (row, column) puts a repeated id's first
    occurrence first in its run; the runs' heads are kept. Rows go in
    chunks of about ``DEDUPE_CHUNK`` entries."""
    idx_parts, val_parts, kept = [], [], np.zeros(len(indptr) - 1, dtype=np.int64)
    for r0, r1 in row_chunks(indptr, DEDUPE_CHUNK):
        lo, hi = int(indptr[r0]), int(indptr[r1])
        rows = np.repeat(np.arange(r1 - r0, dtype=np.int64), np.diff(indptr[r0 : r1 + 1]))
        key = rows * n + cols[lo:hi]
        order = np.argsort(key, kind="stable")
        key = key[order]
        head = np.empty(hi - lo, dtype=bool)
        head[:1] = True
        np.not_equal(key[1:], key[:-1], out=head[1:])
        take = order[head]
        idx_parts.append(cols[lo:hi][take])
        val_parts.append(vals[lo:hi][take])
        kept[r0:r1] = np.bincount(rows[take], minlength=r1 - r0)
    return np.concatenate(idx_parts), np.concatenate(val_parts), kept


def make_dataset(name: str, seed: int = 0) -> SyntheticDataset:
    stats = dataset_stats(name)
    a = make_skewed_csr(stats.m, stats.n, stats.zbar, stats.skew_alpha, seed=seed, dense=stats.dense)
    rng = np.random.default_rng(seed + 1)
    # sparse ground truth for a learnable logistic problem
    x_true = np.zeros(stats.n)
    support = rng.choice(stats.n, size=max(stats.n // 100, 10), replace=False)
    x_true[support] = rng.standard_normal(len(support)) * 3.0
    logits = csr_matvec(a, x_true)
    # normalize the generating margins to std ≈ 2.5 so the labels carry
    # real signal (unnormalized sparse margins were ≈0.2 std → 53%
    # predictable → every solver plateaued at log 2)
    scale = 2.5 / max(float(logits.std()), 1e-9)
    x_true *= scale
    logits *= scale
    p = 1.0 / (1.0 + np.exp(-logits))
    y = np.where(rng.random(stats.m) < p, 1.0, -1.0)
    return SyntheticDataset(name=name, A=a, y=y, x_true=x_true, stats=stats)
