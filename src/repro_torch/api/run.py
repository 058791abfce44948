"""run(spec) — build once, execute through a Session, report uniformly.

``build_problem`` makes what the spec's backend runs, on the device the
caller names; ``run`` is a thin loop over the round-incremental
``repro_torch.api.Session``, which dispatches the same
``ParallelSGDSchedule`` to either executor:

  backend="simulated"  repro_torch.core.engine.run_engine_chunk — exact
                       simulated-rank semantics on one device (the
                       oracle; p_c is communication-only there).
  backend="shard_map"  repro_torch.core.distributed.HybridDriver — the
                       2D mesh, one process per mesh device: every rank
                       of an initialized default process group of p_r·p_c
                       ranks calls ``run(spec)`` (``torchrun``, or
                       ``torch.distributed.init_process_group`` in each
                       process), and each holds its own (i, j) block.

Both return the same ``RunReport`` (on the mesh, every rank returns the
same weights and loss trace). Chunked session execution is
bitwise-identical to the monolithic engine path on the CPU (on CUDA the
Yᵀu scatter-add is atomic, so two runs agree to a stated tolerance, not to
the bit).

Device rule: ``device=None`` means the CUDA device (``cuda:(rank %
device_count)`` on a mesh rank) and raises when there is none;
``device="cpu"`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.api.report import RunReport
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.distributed import Hybrid2DProblem, build_2d_problem
# the reference's name for "this process's place on the mesh": raises, saying
# how to start one, without a default process group of p_r·p_c ranks
from repro_torch.core.distributed import make_process_mesh as _make_device_mesh  # noqa: F401
from repro_torch.core.objective import get_objective
from repro_torch.core.teams import TeamProblem, stack_row_teams
from repro_torch.sparse.partition import ColumnPartition
from repro_torch.sparse.synthetic import SyntheticDataset, make_dataset


@dataclasses.dataclass
class ProblemBundle:
    """Everything ``run`` needs, built once from the spec.

    Exactly one of (team, prob2d) is populated, per the backend: the
    stacked row teams the engine runs (on the device), or the mesh's
    column partition and host layout — on a mesh rank its own block
    alone, which it moves to its device. Each executor computes the loss
    from what it holds."""

    spec: ExperimentSpec
    dataset: SyntheticDataset
    row_multiple: int
    team: TeamProblem | None = None
    prob2d: Hybrid2DProblem | None = None
    cp: ColumnPartition | None = None


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


def _rank_block(p_r: int, p_c: int) -> tuple[int, int] | None:
    """This process's mesh device (i, j) in an initialized default process
    group of p_r·p_c ranks, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == p_r * p_c:
        rank = dist.get_rank()
        return rank // p_c, rank % p_c
    return None


def build_problem(spec: ExperimentSpec, device=None) -> ProblemBundle:
    """Materialize the dataset and partition it for the spec's backend,
    on ``device`` (the mesh's layout stays on the host). Row padding is ``spec.row_multiple`` (default s·b) on
    both paths so simulated and distributed sample sequences agree; the
    spec's objective (+ l2) rides on every problem object, so both
    executors and the loss probes read the same convex loss.

    On the mesh, in a default process group of p_r·p_c ranks, the layout
    holds this rank's (i, j) ELL block alone; outside one (a host-side look:
    there is no rank to build for) every block."""
    sched, mesh = spec.schedule, spec.mesh
    device = resolve_device(device)
    ds = _cached_dataset(spec.dataset, seed=spec.seed)
    rm = spec.row_multiple or sched.s * sched.b
    obj = get_objective(spec.objective, l2=spec.l2)
    bundle = ProblemBundle(spec=spec, dataset=ds, row_multiple=rm)
    if mesh.backend == "simulated":
        bundle.team = stack_row_teams(
            ds.A, ds.y, mesh.p_r, row_multiple=rm, objective=obj, device=device
        )
    else:
        bundle.prob2d, bundle.cp = build_2d_problem(
            ds.A, ds.y, mesh.p_r, mesh.p_c, mesh.partitioner, row_multiple=rm,
            objective=obj, block=_rank_block(mesh.p_r, mesh.p_c),
        )
    return bundle


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
