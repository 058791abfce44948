"""Algorithm 1 — mini-batch SGD (the sequential baseline).

``run_sgd`` is a thin wrapper over the unified engine
(repro_torch.core.engine) at the corner p_r = 1, s = 1, τ = 1.
``sgd_step``/``batch_rows`` are the standalone single-step helpers.

Row sub-sampling is cyclic, i = (i + b) mod m, exactly as the paper
(§5): it makes the sample sequence reproducible across solvers so the
s-step ≡ SGD identity can be tested to floating-point error.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import ParallelSGDSchedule, run_parallel_sgd, single_team
from repro_torch.core.objective import LOGISTIC
from repro_torch.core.problem import Problem
from repro_torch.kernels.sstep_inner import eta_over_b
from repro_torch.sparse.ell import EllBlock, ell_matvec, ell_rmatvec


def batch_rows(ell: EllBlock, k: int, b: int) -> EllBlock:
    """Rows [k·b mod m, +b) — size b, start from the host integer k."""
    m = ell.rows
    start = min((int(k) * b) % m, max(m - b, 0))
    return EllBlock(
        indices=ell.indices[start : start + b], values=ell.values[start : start + b], n=ell.n
    )


def sgd_step(ell: EllBlock, x: torch.Tensor, k: int, b: int, eta: float) -> torch.Tensor:
    """One mini-batch SGD step (Algorithm 1 lines 3-6)."""
    batch = batch_rows(ell, k, b)
    z = ell_matvec(batch, x)  # S·diag(y)·A·x
    u = LOGISTIC.residual(z)  # 1/(1+exp(z))
    # g = -(1/b) (S diag(y) A)^T u  ⇒  x ← x + (η/b) Yᵀu
    return x + eta_over_b(eta, b) * ell_rmatvec(batch, u)


def run_sgd(
    problem: Problem,
    x0: torch.Tensor,
    b: int,
    eta: float,
    K: int,
    loss_every: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Engine corner (p_r=1, s=1, τ=1). Returns (x_K, losses) where
    losses is the full objective sampled every ``loss_every``
    iterations (empty if 0)."""
    if problem.ya.rows % b:
        raise ValueError(f"padded m={problem.ya.rows} must be divisible by b={b}")
    if loss_every and K % loss_every:
        raise ValueError(f"K={K} must be divisible by loss_every={loss_every}")
    sched = ParallelSGDSchedule.mb_sgd(b, eta, K, loss_every=loss_every)
    return run_parallel_sgd(single_team(problem), x0, sched)
