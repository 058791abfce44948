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
from repro_torch.sparse.csr import CSRMatrix
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
    ya = a.scale_rows(np.asarray(y, dtype=np.float64))
    rb = partition_rows(a.m, p)
    blocks = [ya.row_block(int(rb[i]), int(rb[i + 1])) for i in range(p)]
    width = max(max((int(blk.nnz_per_row.max()) if blk.m and blk.nnz else 1) for blk in blocks), 1)
    rows_local = max(int(rb[i + 1] - rb[i]) for i in range(p))
    rows_local = -(-rows_local // row_multiple) * row_multiple

    idx = np.zeros((p, rows_local, width), dtype=np.int32)
    val = np.zeros((p, rows_local, width), dtype=np.float64)
    valid = np.zeros((p, rows_local), dtype=bool)
    for i, blk in enumerate(blocks):
        for r in range(blk.m):
            lo, hi = int(blk.indptr[r]), int(blk.indptr[r + 1])
            k = hi - lo
            idx[i, r, :k] = blk.indices[lo:hi]
            val[i, r, :k] = blk.data[lo:hi]
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
