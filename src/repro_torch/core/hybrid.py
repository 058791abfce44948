"""HybridSGD — the paper's 2D-parallel SGD (§4.1).

``run_hybrid_sgd`` is a thin wrapper over the unified engine
(repro_torch.core.engine), which implements the general (p_r, s, τ)
point directly.

Processors form a p = p_r × p_c mesh. Each of the p_r row teams runs
1D s-step SGD (Algorithm 3) on its local row block for τ inner
iterations (τ/s bundles, one row-team Allreduce of (G, v) per bundle
across its p_c column ranks); every τ iterations the weight vector is
averaged across row teams (one column Allreduce of n/p_c words per
rank). Constraint: s ≤ τ and τ ≡ 0 (mod s).

The *numerics* depend only on (p_r, s, b, τ): p_c changes where columns
live (communication), not what is computed — s-step is an algebraic
identity.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import ParallelSGDSchedule, run_parallel_sgd
from repro_torch.core.teams import TeamProblem


def run_hybrid_sgd(
    tp: TeamProblem,
    x0: torch.Tensor,
    s: int,
    b: int,
    eta: float,
    tau: int,
    rounds: int,
    loss_every: int = 0,
    gram: str = "kernel",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``rounds`` outer rounds; each = τ inner s-step iterations per row
    team + one averaging step across the p_r teams. ``gram`` selects
    the bundle backend (engine.GRAM_METHODS)."""
    if tau % s:
        raise ValueError(f"tau={tau} must be divisible by s={s} (paper requires s ≤ τ)")
    if tp.rows_local % (s * b):
        raise ValueError(f"local rows {tp.rows_local} must be divisible by s·b={s * b}")
    sched = ParallelSGDSchedule.hybrid(
        tp.p, s, b, eta, tau, rounds, loss_every=loss_every, gram=gram
    )
    return run_parallel_sgd(tp, x0, sched)
