"""The optimization problem (paper §3), generalized to any registered
convex objective (repro_torch.core.objective):

    min_x f(x) = (1/m) Σ_i ℓ(y_i · a_i x) + (λ/2)‖x‖²

diag(y)·A is precomputed once (the paper does the same), so the sampled
mini-batch gradient is  g = -(1/b) (S·diag(y)A)ᵀ u + λx  with
u = objective.residual(S·diag(y)A·x).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.objective import LOGISTIC, Objective, get_objective
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.ell import EllBlock, ell_from_csr, ell_matvec


@dataclasses.dataclass
class Problem:
    """diag(y)·A in padded-ELL layout + metadata + the objective.

    ``rows_valid`` masks padded (all-zero) rows out of the loss; padded
    rows contribute zero gradient automatically (zero A-row).
    """

    ya: EllBlock  # diag(y)·A, possibly row-padded
    rows_valid: torch.Tensor  # (padded_m,) bool
    m: int  # true sample count
    n: int
    objective: Objective = LOGISTIC

    @property
    def padded_m(self) -> int:
        return self.ya.rows


def pad_rows_to(a: CSRMatrix, multiple: int) -> int:
    return -(-a.m // multiple) * multiple


def make_problem(
    a: CSRMatrix, y: np.ndarray, row_multiple: int = 1,
    dtype: torch.dtype = torch.float32, ell_width: int | None = None,
    objective: str | Objective = LOGISTIC, device=None,
) -> Problem:
    """Build the device problem. Rows are padded to ``row_multiple`` (the
    paper pads m ≡ 0 mod s_max·b so cyclic batches never wrap).
    ``objective`` is a registry name or an ``Objective`` instance."""
    device = resolve_device(device)
    obj = get_objective(objective)
    ya_csr = a.scale_rows(y)
    padded_m = pad_rows_to(a, row_multiple)
    ell = ell_from_csr(ya_csr, width=ell_width, dtype=dtype, device=device)
    if padded_m > a.m:
        pad = padded_m - a.m
        ell = EllBlock(
            indices=torch.cat(
                [ell.indices, torch.zeros((pad, ell.width), dtype=torch.int32, device=device)]
            ),
            values=torch.cat(
                [ell.values, torch.zeros((pad, ell.width), dtype=ell.values.dtype, device=device)]
            ),
            n=ell.n,
        )
    valid = torch.arange(padded_m, device=device) < a.m
    return Problem(ya=ell, m=a.m, n=a.n, rows_valid=valid, objective=obj)


def problem_from_numpy(
    indices: np.ndarray, values: np.ndarray, rows_valid: np.ndarray, *,
    m: int, n: int, objective: str | Objective = "logistic", l2: float = 0.0,
    device=None,
) -> Problem:
    """Carry a problem across as numpy arrays: the fields of a
    ``Problem`` built elsewhere (``ya.indices``, ``ya.values``,
    ``rows_valid``) plus the objective's registry name and λ. Values
    become ``torch.float32``, indices ``torch.int32``."""
    device = resolve_device(device)
    return Problem(
        ya=EllBlock(
            indices=torch.from_numpy(np.array(indices, dtype=np.int32)).to(device),
            values=torch.from_numpy(np.array(values, dtype=np.float32)).to(device),
            n=int(n),
        ),
        rows_valid=torch.from_numpy(np.array(rows_valid, dtype=bool)).to(device),
        m=int(m),
        n=int(n),
        objective=get_objective(objective, l2),
    )


def problem_loss(problem: Problem, x: torch.Tensor) -> torch.Tensor:
    """f(x) over all m samples under the problem's objective:
    (1/m) Σ ℓ(margin) + (l2/2)‖x‖², with margin = (ya·x) — the label
    sign is folded into ya = diag(y)A. A 0-dim tensor on x's device."""
    margin = ell_matvec(problem.ya, x)
    losses = problem.objective.pointwise_loss(margin)
    losses = torch.where(problem.rows_valid, losses, torch.zeros_like(losses))
    f = torch.sum(losses) / problem.m
    if problem.objective.l2:
        f = f + 0.5 * problem.objective.l2 * torch.sum(x * x)
    return f
