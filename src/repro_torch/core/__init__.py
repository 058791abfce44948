"""The paper's contribution: one 2D-parallel SGD family, in PyTorch.

The unified engine (repro_torch.core.engine) implements the whole
(p_r, p_c, s, τ) family with one inner loop on the ELL-Gram kernel path:

  run_parallel_sgd     the engine — any point of the family
  run_engine_chunk     the same rounds, k at a time from a carried x
  ParallelSGDSchedule  the knob object (corners by name: mb_sgd,
                       sstep, fedavg, hybrid)
  bundle_gram_v        the shared s-bundle primitive (G, v)
  engine_comm_ledger   what a schedule's rounds communicate (CommLedger
                       of CommRates, captured from the round body)

On the card both run a resident problem's rounds as CUDA graphs, one a
round residue (repro_torch.core.round_graph).

The 2D-mesh backend (repro_torch.core.distributed), one process per
mesh device over ``torch.distributed``:

  run_hybrid_distributed  HybridSGD on a p_r × p_c process mesh
                          (consumes the same ParallelSGDSchedule and
                          shares the engine's bundle primitive)
  HybridDriver         the round-incremental form of the same executor
                       (device-resident shard; advance k rounds at a
                       time — what repro_torch.api.Session drives)

Configured corners, kept as thin wrappers:

  run_sgd              Algorithm 1 — sequential mini-batch SGD
  run_sstep_sgd        Algorithm 3 — s-step (communication-avoiding) SGD
  run_fedavg           Algorithm 2 — FedAvg / local SGD
  run_hybrid_sgd       HybridSGD, exact simulated-rank semantics
"""

from repro_torch.core.comm import COUNTING, MESH, TIMED, Collectives, CommLedger, CommRate
from repro_torch.core.distributed import (
    Hybrid2DProblem,
    HybridDriver,
    ProcessMesh,
    build_2d_problem,
    gather_x,
    hybrid_comm_ledger,
    make_hybrid_step,
    make_process_mesh,
    run_hybrid_distributed,
    scatter_x,
)
from repro_torch.core.engine import (
    GRAM_METHODS,
    ParallelSGDSchedule,
    bundle_gram_v,
    check_delay,
    engine_comm_ledger,
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
    "MESH",
    "TIMED",
    "Collectives",
    "CommLedger",
    "CommRate",
    "engine_comm_ledger",
    "hybrid_comm_ledger",
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
    "Hybrid2DProblem",
    "HybridDriver",
    "ProcessMesh",
    "build_2d_problem",
    "gather_x",
    "make_hybrid_step",
    "make_process_mesh",
    "run_hybrid_distributed",
    "scatter_x",
]
