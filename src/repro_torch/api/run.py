"""run(spec) — build once, execute through a Session, report uniformly.

``build_problem`` makes the stacked row teams (and the global problem
for the loss) from the spec, on the device the caller names; ``run`` is
a thin loop over the round-incremental ``repro_torch.api.Session``,
which drives the ``ParallelSGDSchedule`` through the simulated engine
(``repro_torch.core.engine.run_engine_chunk`` — exact simulated-rank
semantics on one device; p_c is communication-only there).

``backend="shard_map"`` (the 2D device mesh) is a valid spec, and is
refused here until the mesh backend is ported. Chunked session
execution is bitwise-identical to the monolithic engine path on the CPU
(on CUDA the Yᵀu scatter-add is atomic, so two runs agree to a stated
tolerance, not to the bit).

Device rule: ``device=None`` means the CUDA device and raises when there
is none; ``device="cpu"`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.api.report import RunReport
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.objective import get_objective
from repro_torch.core.problem import Problem, make_problem
from repro_torch.core.teams import TeamProblem, stack_row_teams
from repro_torch.sparse.synthetic import SyntheticDataset, make_dataset


@dataclasses.dataclass
class ProblemBundle:
    """Everything ``run`` needs, built once from the spec: the stacked
    row teams the engine runs, and the global problem for loss traces
    and the final objective, both on ``team``'s device."""

    spec: ExperimentSpec
    dataset: SyntheticDataset
    global_problem: Problem
    row_multiple: int
    team: TeamProblem


# Dataset materialization is deterministic in (name, seed) and is the
# dominant build cost for repeated run(spec) calls (benchmark repeats,
# sweeps over schedules on one dataset) — memoize it. The cached
# dataset is *enforced* read-only: every consumer sees the same numpy
# buffers, so an in-place write anywhere would silently corrupt every
# later run on the same (name, seed). Frozen flags turn that aliasing
# hazard into an immediate ValueError at the write site.


@functools.lru_cache(maxsize=8)
def _cached_dataset(name: str, seed: int = 0) -> SyntheticDataset:
    ds = make_dataset(name, seed=seed)
    for arr in (ds.A.indptr, ds.A.indices, ds.A.data, ds.y, ds.x_true):
        arr.flags.writeable = False
    return ds


def build_problem(spec: ExperimentSpec, device=None) -> ProblemBundle:
    """Materialize the dataset and stack its row teams on ``device``.
    Row padding is ``spec.row_multiple`` (default s·b); the spec's
    objective (+ l2) rides on every problem object, so the engine and
    the loss probes read the same convex loss."""
    sched, mesh = spec.schedule, spec.mesh
    if mesh.backend != "simulated":
        raise NotImplementedError(
            f"backend={mesh.backend!r} needs the 2D-mesh backend (core/distributed.py, "
            f"ROADMAP.md Queue 1 item 8), which the port does not have yet; use "
            f"backend='simulated'"
        )
    device = resolve_device(device)
    ds = _cached_dataset(spec.dataset, seed=spec.seed)
    rm = spec.row_multiple or sched.s * sched.b
    obj = get_objective(spec.objective, l2=spec.l2)
    gp = make_problem(ds.A, ds.y, row_multiple=rm, objective=obj, device=device)
    team = stack_row_teams(ds.A, ds.y, mesh.p_r, row_multiple=rm, objective=obj, device=device)
    return ProblemBundle(spec=spec, dataset=ds, global_problem=gp, row_multiple=rm, team=team)


def run(spec: ExperimentSpec, x0: np.ndarray | None = None, device=None) -> RunReport:
    """The front door: plan (auto-tuning if asked), build, execute,
    report — a thin loop over the round-incremental ``Session``
    (``Session(spec, x0, device=device).run()``), honoring the spec's
    ``StopPolicy``. ``wall_time_s`` covers the solver only and splits
    into ``compile_time_s`` (the first chunk) + ``solve_time_s``."""
    from repro_torch.api.session import Session

    return Session(spec, x0=x0, device=device).run()


def run_decaying_tau(
    spec: ExperimentSpec,
    x0: np.ndarray | None = None,
    stages: int = 3,
    growth: int = 2,
    device=None,
) -> list[RunReport]:
    """The decaying-communication-frequency schedule of *Local SGD to
    One-Shot Averaging* (arXiv:2106.04759), as a compensation knob for
    delayed averaging: run ``stages`` consecutive segments of the spec,
    multiplying τ by ``growth`` each stage — synchronize often while
    the iterates move fast, then progressively less as they settle.
    The spec's round budget is split across the stages (earlier stages
    get the remainder) and the weights chain stage to stage, so the
    list of per-stage reports is one continuous optimization; the last
    report holds the final iterate. A ``delay`` on the schedule rides
    along unchanged — growing τ only widens its legal range (D ≤ τ/s).
    """
    if stages < 1:
        raise ValueError(f"stages={stages} must be ≥ 1")
    if growth < 1:
        raise ValueError(f"growth={growth} must be ≥ 1")
    sched = spec.schedule
    total = sched.rounds
    per = [total // stages + (1 if i < total % stages else 0) for i in range(stages)]
    if per[-1] < 1:
        raise ValueError(
            f"rounds={total} cannot cover {stages} stages with ≥ 1 round each"
        )
    base = spec.name or spec.dataset
    reports: list[RunReport] = []
    x = x0
    for k, r in enumerate(per):
        st = dataclasses.replace(
            spec,
            name=f"{base}/stage{k}-tau{sched.tau * growth**k}",
            schedule=dataclasses.replace(
                sched, tau=sched.tau * growth**k, rounds=r
            ),
        )
        rep = run(st, x0=x, device=device)
        reports.append(rep)
        x = rep.x
    return reports
