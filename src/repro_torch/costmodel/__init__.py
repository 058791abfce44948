"""α-β-γ cost model, refinements, topology rule, and selection API."""

from repro_torch.costmodel.machines import MACHINES, PERLMUTTER, TPU_V5E, Machine
from repro_torch.costmodel.hockney import (
    CommVolume,
    CostBreakdown,
    HybridConfig,
    fedavg_epoch_cost,
    hybrid_epoch_cost,
    mbsgd_epoch_cost,
    per_sample_costs,
    schedule_comm_volume,
    sstep_epoch_cost,
)
from repro_torch.costmodel.calibrate import CalPoint, Calibration, calibrate
from repro_torch.costmodel.optimum import (
    Regime,
    b_star,
    bandwidth_balance,
    classify_regime,
    grid_search_config,
    joint_sb_star,
    s_star,
)
from repro_torch.costmodel.topology import cache_term_binding, topology_rule
from repro_torch.costmodel.refine import (
    IterBreakdown,
    PartitionerProfile,
    predict_fedavg_iter,
    predict_hybrid_iter,
    rank_partitioners,
)

__all__ = [
    "MACHINES",
    "PERLMUTTER",
    "TPU_V5E",
    "Machine",
    "CalPoint",
    "Calibration",
    "calibrate",
    "CommVolume",
    "schedule_comm_volume",
    "CostBreakdown",
    "HybridConfig",
    "fedavg_epoch_cost",
    "hybrid_epoch_cost",
    "mbsgd_epoch_cost",
    "per_sample_costs",
    "sstep_epoch_cost",
    "Regime",
    "b_star",
    "bandwidth_balance",
    "classify_regime",
    "grid_search_config",
    "joint_sb_star",
    "s_star",
    "cache_term_binding",
    "topology_rule",
    "IterBreakdown",
    "PartitionerProfile",
    "predict_fedavg_iter",
    "predict_hybrid_iter",
    "rank_partitioners",
]
