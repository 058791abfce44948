"""repro_torch.api — one front door for the whole (p_r, p_c, s, τ) family.

    spec  = ExperimentSpec(dataset="rcv1-sm",
                           schedule=ParallelSGDSchedule.hybrid(...),
                           mesh=MeshSpec(p_r=4, p_c=2, backend="simulated"))
    plan  = repro_torch.api.plan(spec)   # Eq. 4 cost + regime (+ Eq. 5–6 autotune)
    report = repro_torch.api.run(spec)   # build → session loop → RunReport

The execution lifecycle is round-incremental underneath: ``Session``
exposes it (step_rounds / save / restore / report), ``run`` is a thin
loop over it honoring the spec's ``StopPolicy`` (target_loss /
max_seconds / max_rounds), and ``sweep`` drives many specs with a
shared dataset cache, retry/quarantine and interrupt/resume. Specs,
reports and session checkpoints are the reference package's, on the
wire and on disk: a spec file hashes the same in both packages, and a
checkpoint written by either resumes in the other.

Every entry point that runs takes ``device=None`` — the CUDA device, or
an error when there is none; ``device="cpu"`` runs the plain PyTorch
versions. ``backend="shard_map"`` runs on the 2D process mesh: every rank
of an initialized default process group of p_r·p_c ranks makes the same
call. A spec with a stream (``StreamSpec``) trains through
``Session.step_stream`` on micro-batches from ``repro_torch.serve``. A
spec with ``bk=None`` asks the Gram autotuner (``kernels/tune.py``) for
its device's geometry: on the card the kernel's (tile, ks) by device
time, on the CPU the plain walk's (bk, bm), tuned once and cached.
"""

from repro_torch.api.spec import (
    BACKENDS,
    ExperimentSpec,
    FaultPolicy,
    MeshSpec,
    StopPolicy,
    StreamSpec,
    dataset_stats,
)
from repro_torch.api.plan import Plan, plan, replan_mesh
from repro_torch.api.report import RunReport, modeled_comm_words
from repro_torch.api.run import ProblemBundle, build_problem, run, run_decaying_tau
from repro_torch.api.session import RoundEvent, Session, autosave_base
from repro_torch.api.sweep import QuarantineRecord, SweepReport, sweep
from repro_torch.core.comm import CommLedger
from repro_torch.costmodel.calibrate import CalPoint, Calibration, calibrate

__all__ = [
    "BACKENDS",
    "ExperimentSpec",
    "FaultPolicy",
    "MeshSpec",
    "StopPolicy",
    "StreamSpec",
    "dataset_stats",
    "Plan",
    "plan",
    "replan_mesh",
    "RunReport",
    "modeled_comm_words",
    "CommLedger",
    "CalPoint",
    "Calibration",
    "calibrate",
    "ProblemBundle",
    "build_problem",
    "run",
    "run_decaying_tau",
    "RoundEvent",
    "Session",
    "autosave_base",
    "QuarantineRecord",
    "SweepReport",
    "sweep",
]
