"""sweep(specs) — the processor-scale sweep as one resumable call.

The paper's headline artifacts are sweeps over the (p_r, p_c, s, τ)
family — Table 11 / Figure 6 time-to-loss rows, Figure 5 mesh sweeps.
This module makes that a first-class operation instead of a for-loop
around ``run()``:

* points run sequentially in one process, on one device, so the
  dataset cache (``repro_torch.api.run._cached_dataset``) is shared
  across every point on the same (dataset, seed) — the dominant build
  cost is paid once;
* with ``resume_dir``, every finished point persists its report as
  ``<spec content hash>.report.json`` (the reference package's record
  format and key); re-invoking the same sweep after an interruption
  rehydrates finished points from disk and only runs the rest;
* a *failing* point no longer kills the sweep: each point is retried
  per its spec's ``FaultPolicy`` (``max_retries`` with exponential
  ``backoff_s``; every retry resumes from the point's last autosave in
  ``resume_dir`` when the policy autosaves), and a point that exhausts
  its retries is **quarantined** — recorded in
  ``SweepReport.quarantined`` (hash, attempts, error, rounds of
  progress) while the remaining points complete;
* the result knows how to print the paper-style time-to-loss table
  (§7.5 protocol: seconds/rounds to the first crossing of a target).

``max_points`` bounds how many *unfinished* points one invocation runs
— the building block for budgeted/interruptible sweeps.

A ``backend="shard_map"`` point runs on the process mesh: every rank of
the default process group calls ``sweep`` with the same specs and runs
the point through its ``Session``; rank 0 alone writes the resume record
and discards the spent autosave, and the other ranks wait at a barrier.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.api.report import RunReport
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import faults
from repro_torch.core.distributed import on_rank0
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train.checkpoint import (
    CheckpointCorruptError,
    SpecMismatchError,
    discard_session_checkpoint,
)

__all__ = ["QuarantineRecord", "SweepReport", "sweep"]


@dataclasses.dataclass
class QuarantineRecord:
    """One sweep point that exhausted its retry budget.

    spec_hash    the point's content hash (the resume-dir key).
    name         the spec's label (or dataset) for human output.
    attempts     how many times it was tried (1 + max_retries).
    error        repr of the last failure.
    rounds_done  progress at the final failure (what an autosave holds —
                 a later re-invocation resumes there, it is not lost).
    """

    spec_hash: str
    name: str
    attempts: int
    error: str
    rounds_done: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "QuarantineRecord":
        return cls(**d)


@dataclasses.dataclass
class SweepReport:
    """All points of one sweep, finished or rehydrated.

    reports      one ``RunReport`` per *completed* spec, in spec order
                 (rehydrated reports have ``x=None`` — weights live in
                 checkpoints).
    resumed      per completed point: True when the report was loaded
                 from ``resume_dir`` instead of being run here.
    attempts     per completed point: how many tries it took (1 = clean;
                 0 = rehydrated, never run in this invocation).
    skipped      specs beyond ``max_points`` that this invocation did
                 not reach (their hashes; rerun with ``resume_dir``).
    quarantined  points that exhausted their retry budget — the sweep
                 completed *around* them (``QuarantineRecord`` each).
    """

    reports: list[RunReport]
    resumed: list[bool]
    skipped: list[str] = dataclasses.field(default_factory=list)
    quarantined: list[QuarantineRecord] = dataclasses.field(default_factory=list)
    attempts: list[int] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        ran = sum(1 for r in self.resumed if not r)
        quar = (
            f", {len(self.quarantined)} quarantined" if self.quarantined else ""
        )
        return (
            f"sweep: {len(self.reports)} point(s) ({ran} run, "
            f"{len(self.reports) - ran} resumed, {len(self.skipped)} skipped"
            f"{quar})"
        )

    def time_to_loss_table(self, target: float | None = None) -> str:
        """The paper-style table: per point, wall seconds and rounds to
        the first crossing of the target loss.

        The target is per-point ``spec.stop.target_loss`` when set
        (runs that stopped on it report their measured wall directly);
        ``target`` is the fallback for points without one, applied
        post-hoc to their loss trace via ``RunReport.time_to_target``.
        """
        rows = [
            f"{'point':24s} {'backend':9s} {'mesh':7s} {'s':>3s} {'b':>4s} "
            f"{'τ':>4s} {'target':>8s} {'sec-to-target':>13s} {'rounds':>6s} "
            f"{'loss':>8s} hit"
        ]
        for rep in self.reports:
            spec = rep.spec
            tgt = spec.stop.target_loss if spec.stop.target_loss is not None else target
            if tgt is not None and rep.stop_reason != "target_loss" and not len(rep.losses):
                tgt = None  # no trace to cross (loss_every=0) — report the full run
            if tgt is None:
                sec, rounds, loss, hit = rep.wall_time_s, len(rep.losses), rep.final_loss, False
                tgt_s = "-"
            elif rep.stop_reason == "target_loss":
                # the run *stopped* at the crossing — the wall time is
                # the measured time-to-target, not a scaled estimate
                sec, rounds, loss, hit = (
                    rep.wall_time_s, rep.rounds_completed, float(rep.losses[-1]), True,
                )
                tgt_s = f"{tgt:.4f}"
            else:
                sec, rounds, loss, hit = rep.time_to_target(tgt)
                tgt_s = f"{tgt:.4f}"
            sched = spec.schedule
            rows.append(
                f"{(spec.name or spec.dataset)[:24]:24s} {rep.backend:9s} "
                f"{spec.mesh.p_r}×{spec.mesh.p_c:<5d} {sched.s:>3d} {sched.b:>4d} "
                f"{sched.tau:>4d} {tgt_s:>8s} {sec:>13.4f} {rounds:>6d} "
                f"{loss:>8.4f} {'yes' if hit else 'no'}"
            )
        for q in self.quarantined:
            rows.append(
                f"{q.name[:24]:24s} QUARANTINED after {q.attempts} attempt(s) "
                f"at round {q.rounds_done}: {q.error}"
            )
        return "\n".join(rows)

    def to_dict(self) -> dict:
        return {
            "reports": [r.to_dict() for r in self.reports],
            "resumed": list(self.resumed),
            "attempts": list(self.attempts),
            "skipped": list(self.skipped),
            "quarantined": [q.to_dict() for q in self.quarantined],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _record_path(resume_dir: Path, spec: ExperimentSpec) -> Path:
    return resume_dir / f"{spec.content_hash()}.report.json"


def _write(spec: ExperimentSpec, device, write) -> None:
    """Write a point's file: on the mesh rank 0 alone, the others wait."""
    if spec.mesh.backend == "shard_map":
        on_rank0(write, device)
    else:
        write()


def _open_session(spec, autosave_dir: Path | None, x0, device):
    """A session for one sweep attempt: resume from the point's
    autosave when a loadable one exists; a torn or foreign autosave is
    discarded (the integrity layer flags it), never trusted."""
    from repro_torch.api.session import Session, autosave_base

    if autosave_dir is not None:
        base = autosave_base(autosave_dir, spec)
        try:
            return Session.restore(base, spec=spec, autosave_dir=autosave_dir, device=device)
        except FileNotFoundError:
            pass
        except (CheckpointCorruptError, SpecMismatchError):
            _write(spec, device, lambda: discard_session_checkpoint(base))
    return Session(spec, x0=x0, autosave_dir=autosave_dir, device=device)


def _run_point(spec, index: int, autosave_dir: Path | None, x0, device):
    """Run one sweep point under its FaultPolicy: retry with backoff,
    resuming from autosave; returns (report | None, attempts, error) —
    report None means the point is quarantined."""
    policy = spec.faults
    attempts = 0
    rounds_done = 0
    reg = obs_metrics.registry()
    while True:
        attempts += 1
        if attempts > 1:
            reg.counter("sweep.retries_total").inc()
        sess = None
        try:
            faults.poke("point", at=index)
            sess = _open_session(spec, autosave_dir, x0, device)
            report = sess.run()
            return report, attempts, None
        except (KeyboardInterrupt, SystemExit):
            raise  # the *user* interrupting a sweep is not a point fault
        except Exception as err:
            if sess is not None:
                rounds_done = max(rounds_done, sess.rounds_done)
            if attempts > policy.max_retries:
                return None, attempts, (err, rounds_done)
            if policy.backoff_s:
                time.sleep(policy.backoff_s * 2 ** (attempts - 1))


def sweep(
    specs: Sequence[ExperimentSpec] | Iterable[ExperimentSpec],
    resume_dir: str | Path | None = None,
    max_points: int | None = None,
    x0: np.ndarray | None = None,
    device=None,
) -> SweepReport:
    """Run every spec (sequentially on ``device``, shared dataset cache)
    and collect the reports. ``device=None`` means the CUDA device and
    raises when there is none; the device never enters a spec or a
    resume record.

    With ``resume_dir``, finished points are persisted there keyed by
    spec content hash and never re-run — interrupt the sweep anywhere
    and re-invoke to continue; autosaves (``FaultPolicy.autosave_every``)
    land there too, so a retried or re-invoked point resumes mid-run
    instead of from round 0. A point that keeps failing is quarantined
    after its retry budget (``FaultPolicy.max_retries``) and the sweep
    completes the remaining points. ``max_points`` caps how many
    unfinished points this invocation executes (the rest are reported in
    ``skipped``).
    """
    from repro_torch.api.session import autosave_base

    # resolved before any point runs: a missing CUDA device is the
    # caller's error, not a point failure to retry and quarantine
    device = resolve_device(device)
    specs = list(specs)
    resume_dir = Path(resume_dir) if resume_dir is not None else None
    if resume_dir is not None:
        resume_dir.mkdir(parents=True, exist_ok=True)

    reports: list[RunReport] = []
    resumed: list[bool] = []
    attempts_log: list[int] = []
    skipped: list[str] = []
    quarantined: list[QuarantineRecord] = []
    reg = obs_metrics.registry()
    ran = 0
    for index, spec in enumerate(specs):
        if resume_dir is not None:
            rec = _record_path(resume_dir, spec)
            if rec.exists():
                reports.append(RunReport.from_json(rec.read_text()))
                resumed.append(True)
                attempts_log.append(0)
                reg.counter("sweep.points_resumed_total").inc()
                continue
        if max_points is not None and ran >= max_points:
            skipped.append(spec.content_hash())
            reg.counter("sweep.points_skipped_total").inc()
            continue
        reg.counter("sweep.points_total").inc()
        report, attempts, failure = _run_point(spec, index, resume_dir, x0, device)
        ran += 1
        if report is None:
            err, rounds_done = failure
            reg.counter("sweep.quarantined_total").inc()
            quarantined.append(
                QuarantineRecord(
                    spec_hash=spec.content_hash(),
                    name=spec.name or spec.dataset,
                    attempts=attempts,
                    error=repr(err),
                    rounds_done=int(rounds_done),
                )
            )
            continue
        if resume_dir is not None:
            def finish(rec=_record_path(resume_dir, spec), report=report):
                tmp = rec.with_suffix(".tmp")
                tmp.write_text(report.to_json())
                tmp.replace(rec)
                # the point is durably finished — its autosave is spent
                discard_session_checkpoint(autosave_base(resume_dir, spec))

            _write(spec, device, finish)
        reports.append(report)
        resumed.append(False)
        attempts_log.append(attempts)
    return SweepReport(
        reports=reports,
        resumed=resumed,
        skipped=skipped,
        quarantined=quarantined,
        attempts=attempts_log,
    )
