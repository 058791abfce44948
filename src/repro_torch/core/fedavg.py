"""Algorithm 2 — Federated SGD with Averaging (FedAvg / local SGD).

``run_fedavg`` is a thin wrapper over the unified engine
(repro_torch.core.engine) at the corner s = 1 (the bundle degenerates
to one mini-batch step, so no Gram work is done and no kernel runs).

Row-partition (A, y) across p ranks; each rank runs τ sequential local
SGD iterations from the shared iterate; the local solutions are averaged
(one length-n Allreduce) every round. τ=1 degenerates to synchronous
mini-batch SGD on an effective batch of p·b; p=1 is sequential SGD.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import ParallelSGDSchedule, run_parallel_sgd
from repro_torch.core.teams import TeamProblem


def run_fedavg(
    tp: TeamProblem,
    x0: torch.Tensor,
    b: int,
    eta: float,
    tau: int,
    rounds: int,
    loss_every: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Engine corner (s=1): ``rounds`` outer iterations (K̃); each is τ
    local steps + average. Returns (x, losses) with the full global
    objective sampled every ``loss_every`` rounds."""
    if tp.rows_local % b:
        raise ValueError(f"local rows {tp.rows_local} must be divisible by b={b}")
    sched = ParallelSGDSchedule.fedavg(tp.p, b, eta, tau, rounds, loss_every=loss_every)
    return run_parallel_sgd(tp, x0, sched)
