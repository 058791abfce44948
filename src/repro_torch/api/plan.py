"""plan(spec) — the cost-model stage of the front door.

Runs the paper's closed-form α-β-γ machinery (Eq. 4 via
``repro_torch.costmodel.hockney.hybrid_epoch_cost``; regime classification
per Table 5) on the spec's registered dataset statistics, and — when
``spec.autotune`` — rewrites the schedule's (s, b) to the Eq. 5–6
optima before anything is built or run. ``run`` calls ``plan`` first,
so every run carries its predicted cost breakdown in the report.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.api.spec import ExperimentSpec, dataset_stats
from repro_torch.costmodel.calibrate import Calibration
from repro_torch.costmodel.hockney import (
    CostBreakdown,
    HybridConfig,
    hybrid_epoch_cost,
    recommend_delay,
)
from repro_torch.costmodel.machines import MACHINES, Machine
from repro_torch.costmodel.optimum import classify_regime, joint_sb_star


@dataclasses.dataclass(frozen=True)
class Plan:
    """The planned experiment: the (possibly retuned) spec plus the
    model's predictions for it.

    spec      the spec that ``run`` will execute — if autotune rewrote
              (s, b), this is the rewritten spec (``autotuned`` True).
    cost      Eq. 4 per-epoch CostBreakdown at the spec's operating
              point on ``spec.machine``.
    regime    dominant cost term (Table 5): compute | latency |
              gram_bw | sync_bw.
    balance   bandwidth-balance ratio (s-1)·s·b²·τ·p_c / 2n.
    s_star, b_star   raw Eq. 5–6 optima (before integer snapping);
              None when autotune is off.
    recommended_delay   the model's suggested DaSGD staleness D — the
              smallest D whose overlap window covers the Gram-phase
              comm (0 when the mesh has no column shards to reduce
              over). Advisory: ``plan`` never rewrites the schedule's
              ``delay`` (staleness changes the iterates, so opting in
              is the user's call — unlike the loss-neutral (s, b)
              autotune).
    """

    spec: ExperimentSpec
    cost: CostBreakdown
    regime: str
    balance: float
    autotuned: bool = False
    s_star: float | None = None
    b_star: float | None = None
    calibrated: bool = False
    recommended_delay: int = 0
    # (bk, bm) from the kernel tuner's disk cache when schedule.bk=None
    # opted in and a cached winner exists for the run's device; None =
    # tune (or fall back to the static 512) at build time. plan() only
    # *reads* the cache — planning stays pure.
    tuned_panel: tuple | None = None

    def summary(self) -> str:
        sched, mesh = self.spec.schedule, self.spec.mesh
        tag = f" [autotuned s*={self.s_star:.2f} b*={self.b_star:.2f}]" if self.autotuned else ""
        if sched.delay or self.recommended_delay:
            tag += (
                f" [delay D={sched.delay}, hides {self.cost.overlap_saved:.3g} s/epoch; "
                f"model recommends D={self.recommended_delay}]"
            )
        if sched.bk is None:
            if self.tuned_panel is not None:
                bk, bm = self.tuned_panel
                tag += f" [panel bk=auto→{bk} bm={bm} (tuner cache)]"
            else:
                tag += " [panel bk=auto (tuned at build)]"
        if sched.precision != "fp32":
            tag += f" [precision={sched.precision}: 2-byte Gram wire words]"
        machine = self.spec.machine + ("+calibrated" if self.calibrated else "")
        return (
            f"{self.spec.name or self.spec.dataset}: mesh {mesh.p_r}×{mesh.p_c} "
            f"({mesh.backend}), s={sched.s} b={sched.b} τ={sched.tau} → predicted "
            f"{self.cost.total:.3g} s/epoch on {machine} "
            f"(dominant: {self.regime}, balance {self.balance:.2f}){tag}"
        )


def _autotune_schedule(spec: ExperimentSpec, machine: Machine) -> tuple[ExperimentSpec, float, float]:
    """Rewrite (s, b) to the Eq. 5–6 joint optimum, snapped to a valid
    schedule (s ≥ 1, s | τ, b ≥ 1)."""
    sched, mesh = spec.schedule, spec.mesh
    st = dataset_stats(spec.dataset)
    s_raw, b_raw = joint_sb_star(
        sched.tau, mesh.p_r, mesh.p_c, st.n, machine, s0=sched.s, b0=sched.b
    )
    s_new = sched.s if not math.isfinite(s_raw) else max(1, min(int(round(s_raw)), sched.tau))
    while sched.tau % s_new:  # snap down to a divisor of τ (s | τ)
        s_new -= 1
    b_new = sched.b if not math.isfinite(b_raw) else max(1, int(round(b_raw)))
    new_sched = dataclasses.replace(sched, s=s_new, b=b_new)
    return dataclasses.replace(spec, schedule=new_sched), s_raw, b_raw


def replan_mesh(
    spec: ExperimentSpec,
    devices: int,
    calibration: Calibration | None = None,
    backend: str | None = None,
) -> Plan:
    """Elastic re-planning: the mesh changed size (a preemption lost
    workers, or capacity arrived) — price every (p_r, p_c) factorization
    of ``devices`` under the (optionally §6.5-calibrated) Eq. 4 model
    and return the cheapest point's Plan.

    The winning geometry is written into both the mesh and the schedule
    (``schedule.p_r`` follows ``mesh.p_r``: row teams are a numerical
    knob, so an elastic resume at a different p_r continues the
    *optimization*, not the bitwise trajectory — the Session layer
    guarantees bitwise resumption only at an unchanged mesh). Pure
    planning: nothing is built or run — ``Session.restore_elastic``
    does the rebuild/remap."""
    devices = int(devices)
    if devices < 1:
        raise ValueError(f"replan_mesh needs ≥ 1 device, got {devices}")
    best: Plan | None = None
    for p_r in range(1, devices + 1):
        if devices % p_r:
            continue
        p_c = devices // p_r
        cand = dataclasses.replace(
            spec,
            schedule=dataclasses.replace(spec.schedule, p_r=p_r, p_c=p_c),
            mesh=dataclasses.replace(
                spec.mesh, p_r=p_r, p_c=p_c,
                backend=backend if backend is not None else spec.mesh.backend,
            ),
        )
        pl = plan(cand, calibration=calibration)
        if best is None or pl.cost.total < best.cost.total:
            best = pl
    return best


def _tuner_device(device) -> str | None:
    """The tuner cache's device kind for a plan: the given device's, or
    with none given the CUDA device's; None (the probe misses) when there
    is no card. Never raises, never initializes anything but the query."""
    import torch

    from repro_torch.kernels.tune import device_kind

    if device is not None:
        return device_kind(device)
    if torch.cuda.is_available():
        return device_kind("cuda")
    return None


def plan(spec: ExperimentSpec, calibration: Calibration | None = None, device=None) -> Plan:
    """Cost-model the spec (and auto-tune it when asked). Pure planning:
    nothing is built, placed, or run — safe as a CI dry-run.

    ``calibration`` (repro_torch.costmodel.calibrate — fitted from a timed
    run's CommLedger) re-targets the spec's machine with measured α/β/γ
    before anything is predicted, so planned sweeps rank configurations
    with machine-fitted constants instead of the static presets; the
    Eq. 5–6 autotune then also optimizes against the fitted machine.

    ``device`` is where the run will compute (``Session`` passes its own):
    with ``schedule.bk=None`` the kernel tuner's cache is probed for that
    device's record. Without one the CUDA device's is probed, or — on a
    box without a card — nothing (the summary says "tuned at build")."""
    machine = MACHINES[spec.machine]
    if calibration is not None:
        machine = calibration.machine(machine)
    s_raw = b_raw = None
    autotuned = False
    if spec.autotune:
        spec, s_raw, b_raw = _autotune_schedule(spec, machine)
        autotuned = True
    st = dataset_stats(spec.dataset)
    sched, mesh = spec.schedule, spec.mesh
    cfg = HybridConfig(p_r=mesh.p_r, p_c=mesh.p_c, s=sched.s, b=sched.b, tau=sched.tau)
    cost = hybrid_epoch_cost(
        st.m, st.n, st.zbar, cfg, machine, delay=sched.delay,
        # bf16 schedules ship 2-byte Gram words: the β·bytes Gram term
        # halves, the fp32 weight sync is unchanged (Tables 2–3 word
        # counts are precision-invariant — only the byte pricing moves).
        gram_word_bytes=2 if sched.precision == "bf16" else None,
    )
    regime = classify_regime(st.m, st.n, st.zbar, cfg, machine)
    tuned_panel = None
    if sched.bk is None:
        # read-only probe of the kernel tuner's cache (never tunes here)
        from repro_torch.kernels.tune import PanelProfile, lookup_panel

        kind = _tuner_device(device)
        rec = None if kind is None else lookup_panel(
            PanelProfile.from_stats(st, sched, mesh.p_c), device=kind)
        if rec is not None:
            tuned_panel = (rec["bk"], rec["bm"])
    return Plan(
        spec=spec,
        cost=cost,
        regime=regime.name,
        balance=regime.balance,
        autotuned=autotuned,
        s_star=s_raw,
        b_star=b_raw,
        calibrated=calibration is not None,
        recommended_delay=recommend_delay(st.m, st.n, st.zbar, cfg, machine),
        tuned_panel=tuned_panel,
    )
