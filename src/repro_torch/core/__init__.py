"""The paper's contribution: one 2D-parallel SGD family, in PyTorch.

The unified engine (repro_torch.core.engine) implements the whole
(p_r, p_c, s, τ) family with one inner loop on the ELL-Gram kernel path:

  run_parallel_sgd     the engine — any point of the family
  run_engine_chunk     the same rounds, k at a time from a carried x
  ParallelSGDSchedule  the knob object (corners by name: mb_sgd,
                       sstep, fedavg, hybrid)
  bundle_gram_v        the shared s-bundle primitive (G, v)

Configured corners, kept as thin wrappers:

  run_sgd              Algorithm 1 — sequential mini-batch SGD
  run_sstep_sgd        Algorithm 3 — s-step (communication-avoiding) SGD
  run_fedavg           Algorithm 2 — FedAvg / local SGD
  run_hybrid_sgd       HybridSGD, exact simulated-rank semantics
"""

from repro_torch.core.comm import COUNTING, Collectives
from repro_torch.core.engine import (
    GRAM_METHODS,
    ParallelSGDSchedule,
    bundle_gram_v,
    check_delay,
    engine_loss,
    inner_corrections,
    run_engine_chunk,
    run_parallel_sgd,
    single_team,
)
from repro_torch.core.fedavg import run_fedavg
from repro_torch.core.hybrid import run_hybrid_sgd
from repro_torch.core.objective import (
    LOGISTIC,
    OBJECTIVES,
    LeastSquaresObjective,
    LogisticObjective,
    Objective,
    SquaredHingeObjective,
    get_objective,
)
from repro_torch.core.problem import (
    Problem,
    make_problem,
    pad_rows_to,
    problem_from_numpy,
    problem_loss,
)
from repro_torch.core.sgd import batch_rows, run_sgd, sgd_step
from repro_torch.core.sstep import run_sstep_sgd, sstep_bundle
from repro_torch.core.teams import (
    TeamProblem,
    global_problem,
    stack_row_teams,
    team_problem_from_numpy,
)

__all__ = [
    "COUNTING",
    "Collectives",
    "GRAM_METHODS",
    "ParallelSGDSchedule",
    "bundle_gram_v",
    "check_delay",
    "engine_loss",
    "inner_corrections",
    "run_engine_chunk",
    "run_parallel_sgd",
    "single_team",
    "run_fedavg",
    "run_hybrid_sgd",
    "LOGISTIC",
    "OBJECTIVES",
    "LeastSquaresObjective",
    "LogisticObjective",
    "Objective",
    "SquaredHingeObjective",
    "get_objective",
    "Problem",
    "make_problem",
    "pad_rows_to",
    "problem_from_numpy",
    "problem_loss",
    "batch_rows",
    "run_sgd",
    "sgd_step",
    "TeamProblem",
    "global_problem",
    "stack_row_teams",
    "team_problem_from_numpy",
    "run_sstep_sgd",
    "sstep_bundle",
]
