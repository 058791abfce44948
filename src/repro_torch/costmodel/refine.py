"""Empirical refinements of the leading-order model (paper §6.5).

  * cache-aware compute: γ evaluated at the per-rank weight-slab working
    set (max n_local·w) — cache spill (nnz-greedy on url) lands in a
    slower tier;
  * rank-aware β: each Allreduce uses β(q) for its span (in Machine);
  * load imbalance: κ multiplies the sparse-compute term;
  * sync-skew: T ≈ (κ-1)·T_compute,avg charged to the row-team
    Allreduce — wait-for-slowest, not payload cost (paper Table 10);
  * per-call column-proportional floor: MKL sparse_syrkd's inspector and
    the transpose-SpMV scatter scale with n_local, not flops. The TPU
    analogue is index streaming + kernel launch; coefficient is a
    calibration knob (0 disables).

The refined predictor's validated property is *ranking fidelity* across
partitioners and meshes (paper: correct on all 9 dataset×partitioner
cells), not absolute seconds.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.costmodel.machines import Machine


@dataclasses.dataclass(frozen=True)
class PartitionerProfile:
    """What the refined model needs from a (dataset, partitioner, p_c)
    combination. Obtainable from repro_torch.sparse.partition.partition_stats
    or taken from the paper's measured Table 9."""

    name: str
    kappa: float
    max_n_local: int


@dataclasses.dataclass(frozen=True)
class IterBreakdown:
    """Per-inner-iteration seconds (cf. paper Table 10 phases)."""

    compute: float  # SpMV + Gram + correction flops on the avg rank
    sync_skew: float  # (κ-1)·compute — waits inside the row Allreduce
    row_comm: float  # Gram/residual Allreduce payload+latency (per iter)
    col_comm: float  # weight-averaging Allreduce (amortized over τ)
    weights: float  # τ-amortized weight-vector access
    per_call: float  # column-proportional per-call floor

    @property
    def total(self) -> float:
        return self.compute + self.sync_skew + self.row_comm + self.col_comm + self.weights + self.per_call


def predict_hybrid_iter(
    n: int,
    zbar: float,
    prof: PartitionerProfile,
    p_r: int,
    p_c: int,
    s: int,
    b: int,
    tau: int,
    machine: Machine,
    percall_col_coeff: float = 4.0e-10,
) -> IterBreakdown:
    """Refined per-inner-iteration prediction for HybridSGD."""
    w = machine.word_bytes
    slab = prof.max_n_local * w  # per-rank weight working set
    gamma = machine.gamma_flop(slab)

    # average-rank compute per iteration: b rows, z̄/p_c nnz each after
    # column split, with the s-step extra 2sb correction flops
    compute = b * (6 * zbar / p_c + 2 * s * b) * gamma
    sync_skew = max(prof.kappa - 1.0, 0.0) * compute

    # row-team Allreduce, amortized per iteration: one (G, v) per bundle
    gram_words = (s - 1) * b * b / 2 + b  # tril Gram blocks + residual
    row_comm = machine.allreduce_time(p_c, int(gram_words)) / s if p_c > 1 else 0.0

    # column Allreduce of the n_local weight slab every τ iterations
    col_comm = machine.allreduce_time(p_r, prof.max_n_local) / tau if p_r > 1 else 0.0

    # cache-aware weight access: first touch at DRAM tier, the remaining
    # τ-1 inner iterations at the slab's cache tier (§6.5)
    gamma_dram = machine.gamma_tiers[-1][1]
    weights = slab * (gamma_dram + (tau - 1) * machine.gamma_bytes(slab)) / tau

    per_call = percall_col_coeff * prof.max_n_local
    return IterBreakdown(
        compute=compute,
        sync_skew=sync_skew,
        row_comm=row_comm,
        col_comm=col_comm,
        weights=weights,
        per_call=per_call,
    )


def predict_fedavg_iter(
    n: int,
    zbar: float,
    b: int,
    tau: int,
    p: int,
    machine: Machine,
    kappa: float = 1.0,
) -> float:
    """Refined per-inner-iteration prediction for FedAvg (1D-row)."""
    w = machine.word_bytes
    slab = n * w  # FedAvg keeps the full weight vector per rank
    gamma = machine.gamma_flop(slab)
    compute = b * 4 * zbar * gamma * kappa
    gamma_dram = machine.gamma_tiers[-1][1]
    weights = slab * (gamma_dram + (tau - 1) * machine.gamma_bytes(slab)) / tau
    col_comm = machine.allreduce_time(p, n) / tau if p > 1 else 0.0
    return compute + weights + col_comm


def rank_partitioners(
    n: int,
    zbar: float,
    profiles: list[PartitionerProfile],
    p_r: int,
    p_c: int,
    s: int,
    b: int,
    tau: int,
    machine: Machine,
    percall_col_coeff: float = 4.0e-10,
) -> list[tuple[str, IterBreakdown]]:
    """Order partitioners by predicted per-iteration time (ascending) —
    the selection decision the model drives (§6.5 Validation)."""
    preds = [
        (
            prof.name,
            predict_hybrid_iter(
                n, zbar, prof, p_r, p_c, s, b, tau, machine, percall_col_coeff
            ),
        )
        for prof in profiles
    ]
    return sorted(preds, key=lambda kv: kv[1].total)
