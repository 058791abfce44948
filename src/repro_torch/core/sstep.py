"""Algorithm 3 — s-step (communication-avoiding) SGD.

``run_sstep_sgd`` is a thin wrapper over the unified engine
(repro_torch.core.engine) at the corner p_r = 1, τ = s.
``sstep_bundle`` is the standalone single-bundle helper.

Recurrence unrolling: a bundle of s consecutive mini-batch steps is
regrouped so that all matrix work happens up front —

    Y = [S_1; ...; S_s]·diag(y)·A          (sb × n)
    G = tril(Y Yᵀ)                         (sb × sb Gram, strictly-lower
                                            blocks correct the deferred
                                            updates)
    v = Y·x_sk                             (sb)

then the inner loop runs on s b-vectors only:

    z_j = v_j + (η/b) Σ_{l<j} G_{jl} u_l   (apply deferred updates)
    u_j = residual(z_j)
    x_{sk+s} = x_sk + (η/b) Yᵀ [u_1; ...; u_s]

This is an algebraic identity of Algorithm 1 (same sample sequence ⇒
identical iterates up to FP error) — validated in tests. In the 1D
distributed form the only communication is one Allreduce of (G, v) per s
steps; Yᵀu is local under column partitioning.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import (
    ParallelSGDSchedule,
    bundle_gram_v,
    inner_corrections,
    run_parallel_sgd,
    single_team,
)
from repro_torch.core.problem import Problem
from repro_torch.kernels.sstep_inner import eta_over_b
from repro_torch.core.sgd import batch_rows
from repro_torch.sparse.ell import EllBlock, ell_rmatvec


def sstep_bundle(
    ell: EllBlock,
    x: torch.Tensor,
    k: int,
    s: int,
    b: int,
    eta: float,
) -> torch.Tensor:
    """One outer iteration of Algorithm 3 (s fused steps), starting at
    global step index k·s (cyclic sampling)."""
    bundle = batch_rows(ell, k, s * b)  # rows [k·sb, k·sb + sb)
    g, v = bundle_gram_v(bundle.indices, bundle.values, x, ell.n)
    u = inner_corrections(g, v, s, b, eta)
    return x + eta_over_b(eta, b) * ell_rmatvec(bundle, u).to(x.dtype)


def run_sstep_sgd(
    problem: Problem,
    x0: torch.Tensor,
    s: int,
    b: int,
    eta: float,
    K: int,
    loss_every: int = 0,
    gram: str = "kernel",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Engine corner (p_r=1, τ=s): K total SGD-equivalent iterations =
    K/s bundles. ``gram`` selects the bundle backend (engine.GRAM_METHODS)."""
    if K % s:
        raise ValueError(f"K={K} must be divisible by s={s}")
    if problem.ya.rows % (s * b):
        raise ValueError(f"padded m={problem.ya.rows} must be divisible by s·b={s * b}")
    sched = ParallelSGDSchedule.sstep(s, b, eta, K, loss_every=loss_every, gram=gram)
    return run_parallel_sgd(single_team(problem), x0, sched)
