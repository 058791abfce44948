"""Row-team stacking: partition (A, y) into p row blocks with uniform
padded shapes and stack them along a leading axis.

The unified engine (repro_torch.core.engine) loops its per-team inner
iterations over this axis — exact SPMD semantics on one device. All
teams share one ELL width and one padded row count (SPMD uniformity;
this is where nnz imbalance κ becomes padded compute).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.objective import LOGISTIC, Objective, get_objective
from repro_torch.core.problem import Problem
from repro_torch.sparse.csr import CSRMatrix, row_chunks
from repro_torch.sparse.ell import EllBlock
from repro_torch.sparse.partition import partition_rows


@dataclasses.dataclass
class TeamProblem:
    """p stacked local problems. indices/values: (p, rows_local, width).
    ``objective`` is the shared convex loss every team runs."""

    indices: torch.Tensor
    values: torch.Tensor
    rows_valid: torch.Tensor  # (p, rows_local) bool
    p: int
    m: int  # global true samples
    n: int
    objective: Objective = LOGISTIC

    @property
    def rows_local(self) -> int:
        return int(self.indices.shape[1])

    def team_ell(self, i: int) -> EllBlock:
        return EllBlock(indices=self.indices[i], values=self.values[i], n=self.n)


def stack_row_teams(
    a: CSRMatrix, y: np.ndarray, p: int, row_multiple: int = 1,
    dtype: torch.dtype = torch.float32, objective: str | Objective = LOGISTIC,
    device=None,
) -> TeamProblem:
    device = resolve_device(device)
    obj = get_objective(objective)
    y = np.asarray(y, dtype=np.float64)
    rb = partition_rows(a.m, p)
    blocks = [a.row_block(int(rb[i]), int(rb[i + 1])) for i in range(p)]
    width = max(max((int(blk.nnz_per_row.max()) if blk.m and blk.nnz else 1) for blk in blocks), 1)
    rows_local = max(int(rb[i + 1] - rb[i]) for i in range(p))
    rows_local = -(-rows_local // row_multiple) * row_multiple

    idx = np.zeros((p, rows_local, width), dtype=np.int32)
    # the values straight in float32; another dtype is cast from float64 at
    # the end, one rounding as before
    val = np.zeros((p, rows_local, width), dtype=np.float32 if dtype == torch.float32 else np.float64)
    valid = np.zeros((p, rows_local), dtype=bool)
    for i, blk in enumerate(blocks):
        _pad_rows(idx[i], val[i], blk, y[rb[i] : rb[i + 1]])
        valid[i, : blk.m] = True
    return TeamProblem(
        indices=torch.from_numpy(idx).to(device),
        values=torch.from_numpy(val).to(dtype).to(device),
        rows_valid=torch.from_numpy(valid).to(device),
        p=p,
        m=a.m,
        n=a.n,
        objective=obj,
    )


# nonzeros ``_pad_rows`` places at once: its int64 temporaries stay near
# 0.5 GB whatever the block's size
PAD_CHUNK = 1 << 24


def _pad_rows(idx: np.ndarray, val: np.ndarray, blk: CSRMatrix, y: np.ndarray) -> None:
    """Row r of ``blk`` into ``idx[r, :k]`` and ``diag(y)·blk``'s row into
    ``val[r, :k]`` (k its length; the rest stays zero). Each value is the
    float64 product ``data·y`` cast once to ``val``'s dtype, as a float64
    array cast afterwards would give. Rows go in chunks of about
    ``PAD_CHUNK`` nonzeros; a chunk of full-width rows is a reshape."""
    width = idx.shape[1]
    for r0, r1 in row_chunks(blk.indptr, PAD_CHUNK):
        lo, hi = int(blk.indptr[r0]), int(blk.indptr[r1])
        counts = np.diff(blk.indptr[r0 : r1 + 1])
        if hi - lo == (r1 - r0) * width:  # every row full: rows of the ELL block as they are
            idx[r0:r1] = blk.indices[lo:hi].reshape(r1 - r0, width)
            val[r0:r1] = blk.data[lo:hi].reshape(r1 - r0, width) * y[r0:r1, None]
        else:
            rows = np.repeat(np.arange(r0, r1, dtype=np.int64), counts)
            slots = np.arange(lo, hi, dtype=np.int64) - np.repeat(blk.indptr[r0:r1], counts)
            idx[rows, slots] = blk.indices[lo:hi]
            val[rows, slots] = blk.data[lo:hi] * y[rows]


def team_problem_from_numpy(
    indices: np.ndarray, values: np.ndarray, rows_valid: np.ndarray, *,
    p: int, m: int, n: int, objective: str | Objective = "logistic",
    l2: float = 0.0, device=None,
) -> TeamProblem:
    """Carry stacked row teams across as numpy arrays: the fields of a
    ``TeamProblem`` built elsewhere plus the objective's registry name
    and λ. Values become ``torch.float32``, indices ``torch.int32``."""
    device = resolve_device(device)
    indices = np.array(indices, dtype=np.int32)
    if indices.ndim != 3 or indices.shape[0] != p:
        raise ValueError(f"indices shape {indices.shape} is not (p={p}, rows_local, width)")
    return TeamProblem(
        indices=torch.from_numpy(indices).to(device),
        values=torch.from_numpy(np.array(values, dtype=np.float32)).to(device),
        rows_valid=torch.from_numpy(np.array(rows_valid, dtype=bool)).to(device),
        p=int(p),
        m=int(m),
        n=int(n),
        objective=get_objective(objective, l2),
    )


def global_problem(tp: TeamProblem) -> Problem:
    """Flatten the stacked teams back into one Problem (for the
    full-objective trace); the objective rides along."""
    flat_idx = tp.indices.reshape(-1, tp.indices.shape[-1])
    flat_val = tp.values.reshape(-1, tp.values.shape[-1])
    return Problem(
        ya=EllBlock(indices=flat_idx, values=flat_val, n=tp.n),
        m=tp.m,
        n=tp.n,
        rows_valid=tp.rows_valid.reshape(-1),
        objective=tp.objective,
    )
