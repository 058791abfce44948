"""Session — the round-incremental execution lifecycle.

A ``Session`` opens the run loop up at round granularity without
changing a single iterate:

    sess = Session(spec)                 # plan + build once (device=None: CUDA)
    while not sess.done:
        ev = sess.step_rounds(4)         # advance 4 rounds
        print(ev.rounds_done, ev.loss)   # weights-so-far, loss sample
        sess.save("ckpt/run1")           # resumable at any boundary
    report = sess.report()

    sess2 = Session.restore("ckpt/run1") # later / elsewhere
    report2 = sess2.run()                # finish under the StopPolicy

The simulated engine advances through
``repro_torch.core.engine.run_engine_chunk``: the carry is the weight
vector on the device, and the round offset is a host integer, so the
bundle rows a round reads depend only on the global round index.
Chunked execution runs the same per-round body over the same global
round indices as the monolithic ``run_parallel_sgd`` — bitwise equal on
the CPU; on CUDA the Yᵀu scatter-add is atomic, so two runs agree to a
stated tolerance, not to the bit. That is what makes save/restore and
early stopping safe to use in time-to-loss experiments.

``run()`` is a thin loop over ``step_rounds`` that honors the spec's
``StopPolicy`` (``target_loss`` / ``max_seconds`` / ``max_rounds``) —
the paper's §7.5 time-to-loss protocol as a first-class stop condition
instead of post-hoc arithmetic on a finished trace.

The device is runtime state, like ``autosave_dir``: never part of the
spec, never part of a hash. ``device=None`` means the CUDA device and
raises when there is none. The session and checkpoint format is the
reference package's, so a checkpoint written by either resumes in the
other. Not in the port yet, and refused with ``NotImplementedError``:
the mesh backend (``backend="shard_map"``), the panel autotuner
(``bk=None``) and the streaming door (``step_stream``, a spec with
``stream.enabled``).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.api.plan import Plan, plan, replan_mesh
from repro_torch.api.report import RunReport, modeled_comm_words
from repro_torch.api.spec import ExperimentSpec, MeshSpec
from repro_torch.core import faults
from repro_torch.core.comm import CommLedger, time_dispatch, time_phase
from repro_torch.core.engine import (
    engine_comm_ledger,
    engine_loss,
    engine_phase_probes,
    run_engine_chunk,
)
from repro_torch.core.problem import problem_loss
from repro_torch.core.teams import global_problem
from repro_torch.obs import trace as obs_trace
from repro_torch.train.checkpoint import (
    SessionCheckpoint,
    load_session_checkpoint,
    save_session_checkpoint,
)

__all__ = ["RoundEvent", "Session", "autosave_base"]


def autosave_base(directory: str | Path, spec: ExperimentSpec) -> Path:
    """Where a session autosaves inside ``directory`` — keyed by the
    spec's content hash (dot-free stem: the checkpoint layer appends
    .npz/.json via with_suffix)."""
    return Path(directory) / f"autosave-{spec.content_hash()}"


@dataclasses.dataclass
class RoundEvent:
    """What one ``step_rounds`` call observed.

    rounds_done     total rounds completed so far (cumulative).
    x               weights after those rounds (global (n,) on host).
    loss            the most recent full-objective sample taken during
                    this step, or None if no sampling boundary was
                    crossed (``schedule.loss_every`` semantics).
    wall_time_s     cumulative solver wall time.
    compile_time_s  wall accrued to first chunks (kernel build at first
                    use, CUDA warm-up and one chunk; summed across
                    restores — each process starts cold) — the split
                    ``RunReport`` carries.
    comm_words      cumulative modeled per-rank comm volume for the
                    rounds completed (Table 3 payloads).
    ledger          snapshot of the run's CommLedger at this boundary:
                    the *counted* collectives (and, timed runs, the
                    measured per-round seconds) for the rounds done.
    stop            StopPolicy verdict at this boundary: None, or one of
                    "target_loss" / "max_seconds" / "max_rounds" /
                    "rounds" (schedule budget exhausted).
    """

    rounds_done: int
    x: np.ndarray
    loss: float | None
    wall_time_s: float
    compile_time_s: float
    comm_words: dict[str, float]
    ledger: CommLedger | None = None
    stop: str | None = None


class Session:
    """An open, resumable run of one ``ExperimentSpec`` on one device.

    Construction plans the spec (autotune included — ``self.spec`` is
    the spec as executed) and builds the problem once on ``device``;
    every ``step_rounds`` call after that advances the same
    device-resident carry. The session is the single source of truth for
    run state: rounds done, loss trace, wall/compile time — ``report()``
    is a pure read of it.
    """

    def __init__(
        self,
        spec: ExperimentSpec,
        x0: np.ndarray | None = None,
        autosave_dir: str | Path | None = None,
        device=None,
    ):
        # imported here: repro_torch.api.run imports Session for its thin
        # run() wrapper, so the build machinery import must be lazy.
        from repro_torch.api.run import build_problem

        if spec.stream.enabled:
            raise NotImplementedError(
                f"stream.source={spec.stream.source!r} needs the streaming and serving "
                f"plane (serve/*, ROADMAP.md Queue 1 item 11), which the port does not "
                f"have yet"
            )
        self.device = resolve_device(device)
        self.autosave_dir = Path(autosave_dir) if autosave_dir is not None else None
        self.input_spec = spec          # pre-plan (what checkpoints key on)
        self._plan: Plan = plan(spec)
        self.spec = self._plan.spec     # post-autotune (what executes)
        self.bundle = build_problem(self.spec, device=self.device)
        n = self.bundle.dataset.A.n
        x0 = np.zeros(n, np.float32) if x0 is None else np.asarray(x0, np.float32)

        self.rounds_done = 0
        self.losses: list[float] = []
        self.wall_time_s = 0.0
        self.compile_time_s = 0.0
        self.stop_reason: str | None = None
        # the next chunk's wall is accrued to compile_time_s (set again
        # on restore: a fresh process builds and warms up again, and that
        # wall must not masquerade as steady-state solve time)
        self._first_chunk_pending = True

        self._x = torch.from_numpy(x0.copy()).to(self.device)
        self._gp = global_problem(self.bundle.team)
        # the counted-comm ledger: the round body's collectives,
        # captured on meta tensors from the problem actually built
        self.ledger = engine_comm_ledger(self.spec.schedule, n, tp=self.bundle.team)

    # ---- state probes ----

    @property
    def total_rounds(self) -> int:
        """The schedule's round budget (the StopPolicy may end sooner)."""
        return self.spec.schedule.rounds

    @property
    def done(self) -> bool:
        return self.rounds_done >= self.total_rounds or self.stop_reason is not None

    def current_x(self) -> np.ndarray:
        """Current global weights (a host copy, never a view of the
        carry; waits for pending work)."""
        return self._x.to("cpu", copy=True).numpy()

    # ---- the incremental core ----

    def _advance(self, k: int) -> None:
        """Run k rounds on the carry (no loss sampling)."""
        if self.spec.comm_timing:
            # timed: advance one round at a time, waiting for the device
            # each round, so the ledger gets a per-round wall — the
            # iterate sequence is unchanged (chunk size never changes it).
            for i in range(int(k)):
                t0 = time.perf_counter()
                self._x = run_engine_chunk(
                    self.bundle.team, self._x, self.rounds_done + i, 1,
                    self.spec.schedule,
                )
                self._sync()
                self.ledger.add_round_seconds(time.perf_counter() - t0)
        else:
            self._x = run_engine_chunk(
                self.bundle.team, self._x, self.rounds_done, k, self.spec.schedule
            )
        self.ledger.add_rounds(k)
        self.rounds_done += k

    def _sync(self) -> None:
        """Wait for the carry without a host copy."""
        if self._x.is_cuda:
            torch.cuda.synchronize(self._x.device)

    def _traced_advance(self, sub: int, first: bool) -> None:
        """One sub-chunk through the tracing seam: untraced, exactly the
        bare advance; traced, the same advance wrapped in a host-side
        span that waits for the device before it closes, so the recorded
        wall covers the dispatched work (an observer effect on timing
        only — the numerics are untouched)."""
        rec = obs_trace.active()
        if rec is None:
            self._advance(sub)
            return
        with rec.span(
            "compile" if first else "round",
            name=f"rounds[{self.rounds_done}+{sub}]",
            start_round=self.rounds_done,
            rounds=sub,
        ):
            self._advance(sub)
            self._sync()

    def _measure_phases(self) -> None:
        """Populate ``ledger.phase_seconds`` (→ ``exposed_comm_s``) once
        per timed run: the §6.5 phase split, measured by separate probes
        over the round's real payload shapes — the training step itself
        is never split. Runs outside the wall/compile accounting
        windows; each probed phase also lands as a trace span when a
        recorder is installed."""
        probes = engine_phase_probes(self.bundle.team, self.spec.schedule)
        rec = obs_trace.active()
        delay = self.spec.schedule.delay
        phases = {}
        for name, (fn, args, calls) in probes.items():
            per_call = time_phase(fn, *args)
            phases[name] = per_call * calls
            if rec is None:
                continue
            if name == "allreduce_gv" and delay >= 1:
                # delay-D split: the issue half is the async dispatch
                # cost (measured — what the critical path pays while
                # the reduction is in flight); the await half is the
                # exposed remainder after D bundle-computes of overlap
                # (the ledger's closed form, so trace and ledger agree).
                issue_call = time_dispatch(fn, *args)
                issue = min(issue_call, per_call) * calls
                compute = phases.get("bundle_compute", 0.0)
                await_s = max(phases[name] - issue - delay * compute, 0.0)
                rec.add_span("allreduce_gv_issue", f"probe:{name}:issue",
                             dur=issue, per_call_s=issue_call,
                             calls_per_round=calls)
                rec.add_span("allreduce_gv_await", f"probe:{name}:await",
                             dur=await_s, delay=delay,
                             calls_per_round=calls)
            else:
                rec.add_span(name, f"probe:{name}", dur=phases[name],
                             per_call_s=per_call, calls_per_round=calls)
        self.ledger.set_phase_seconds(phases)

    def _sample_loss(self) -> float:
        return float(engine_loss(self._gp, self._x))

    def step_rounds(self, k: int | None = None) -> RoundEvent:
        """Advance up to ``k`` rounds (default: to the next loss-sampling
        boundary, or all remaining rounds when ``loss_every`` is 0) and
        return what happened.

        Internally the advance is split at every ``loss_every`` boundary
        so the full objective is sampled exactly where the monolithic
        loop sampled it — arbitrary ``k`` never changes the trace, only
        how often control returns to the caller. The StopPolicy is
        evaluated at every boundary, so a step spanning several may end
        early (``RoundEvent.stop`` says why).
        """
        if self.done:
            raise RuntimeError(
                f"session is finished ({self.stop_reason or 'rounds'} at round "
                f"{self.rounds_done}); nothing to step"
            )
        sched = self.spec.schedule
        budget = self.total_rounds
        if self.spec.stop.max_rounds is not None:
            budget = min(budget, self.spec.stop.max_rounds)
        remaining = budget - self.rounds_done
        if k is None:
            k = (
                sched.loss_every - self.rounds_done % sched.loss_every
                if sched.loss_every
                else remaining
            )
        k = min(int(k), remaining)
        if k < 1:
            raise ValueError(f"step_rounds needs k ≥ 1, got {k}")

        loss = None
        synced = False
        autosave_every = self.input_spec.faults.autosave_every
        autosaving = self.autosave_dir is not None and autosave_every > 0
        t0 = time.perf_counter()
        while k > 0 and self.stop_reason is None:
            if sched.loss_every:
                sub = min(k, sched.loss_every - self.rounds_done % sched.loss_every)
            else:
                sub = k
            if autosaving:
                # split at autosave boundaries too, so a cadence finer
                # than loss_every still checkpoints on time (chunk size
                # never changes the iterates).
                sub = min(sub, autosave_every - self.rounds_done % autosave_every)
            if faults.active() is not None:
                # under an installed fault plan every round is a
                # boundary, so planned events fire exactly at their
                # round index.
                sub = 1
            first = self._first_chunk_pending
            tc = time.perf_counter()
            self._traced_advance(sub, first)
            sampled = None
            if sched.loss_every and self.rounds_done % sched.loss_every == 0:
                sampled = self._sample_loss()  # waits (device → float)
                self.losses.append(sampled)
                loss, synced = sampled, True
            else:
                synced = False
            if first:
                if sampled is None:
                    self._sync()  # the first chunk's wall must be real
                    synced = True
                self.compile_time_s += time.perf_counter() - tc
                self._first_chunk_pending = False
            k -= sub
            # the policy is checked at every boundary, not once per
            # call: a target crossed mid-step stops the step there.
            self._check_stop(
                sampled, wall=self.wall_time_s + (time.perf_counter() - t0)
            )
            if autosaving and self.rounds_done % autosave_every == 0:
                # preemption-safe: the carry is durable at this boundary
                # *before* the seam below may kill/stall/fail the worker.
                self.save(self.autosave_path)
            faults.poke("round", at=self.rounds_done)
        if not synced:
            self._sync()  # wall covers all dispatched work
        self.wall_time_s += time.perf_counter() - t0
        if self.spec.comm_timing and not self.ledger.phase_seconds:
            # after the wall accrual so probe time never masquerades as
            # solve/compile time.
            self._measure_phases()

        return RoundEvent(
            rounds_done=self.rounds_done,
            x=self.current_x(),  # after the wait: a copy, not a timed stall
            loss=loss,
            wall_time_s=self.wall_time_s,
            compile_time_s=self.compile_time_s,
            comm_words=modeled_comm_words(self.spec, rounds=self.rounds_done),
            ledger=self.ledger.snapshot(),
            stop=self.stop_reason,
        )

    def step_stream(self, source, k: int | None = None) -> RoundEvent:
        """The streaming twin of ``step_rounds`` (one fresh micro-batch a
        round) — not in the port yet."""
        raise NotImplementedError(
            "Session.step_stream needs the streaming and serving plane (serve/*, "
            "ROADMAP.md Queue 1 item 11), which the port does not have yet"
        )

    def _check_stop(self, loss: float | None, wall: float | None = None) -> None:
        # target_loss is checked first: a crossing on the final budgeted
        # round is still a hit (the §7.5 verdict the benchmarks persist),
        # not a budget exhaustion.
        stop = self.spec.stop
        wall = self.wall_time_s if wall is None else wall
        if (
            stop.target_loss is not None
            and loss is not None
            and loss <= stop.target_loss
        ):
            self.stop_reason = "target_loss"
        elif self.rounds_done >= self.total_rounds:
            self.stop_reason = "rounds"
        elif stop.max_rounds is not None and self.rounds_done >= stop.max_rounds:
            self.stop_reason = "max_rounds"
        elif stop.max_seconds is not None and wall >= stop.max_seconds:
            self.stop_reason = "max_seconds"

    def run(self) -> RunReport:
        """Drive the session to its stop condition and report."""
        while not self.done:
            self.step_rounds()
        return self.report()

    def report(self) -> RunReport:
        """The uniform ``RunReport`` for the rounds completed so far."""
        final_loss = float(problem_loss(self.bundle.global_problem, self._x))
        return RunReport(
            spec=self.spec,
            plan=self._plan,
            backend=self.spec.mesh.backend,
            x=self.current_x(),
            losses=np.asarray(self.losses, np.float32),
            final_loss=final_loss,
            wall_time_s=self.wall_time_s,
            comm_words=modeled_comm_words(self.spec, rounds=self.rounds_done),
            compile_time_s=self.compile_time_s,
            solve_time_s=max(self.wall_time_s - self.compile_time_s, 0.0),
            rounds_completed=self.rounds_done,
            stop_reason=self.stop_reason,
            ledger=self.ledger.snapshot(),
        )

    # ---- checkpoint / resume ----

    @property
    def autosave_path(self) -> Path:
        """Where this session autosaves (``autosave_dir`` keyed by the
        input spec's content hash); raises when no dir was given."""
        if self.autosave_dir is None:
            raise ValueError(
                "session has no autosave_dir — pass Session(spec, autosave_dir=...)"
            )
        return autosave_base(self.autosave_dir, self.input_spec)

    def save(self, path) -> None:
        """Checkpoint the session carry at the current round boundary
        (atomic; keyed by the input spec's content hash)."""
        save_session_checkpoint(
            path,
            spec_dict=self.input_spec.to_dict(),
            spec_hash=self.input_spec.content_hash(),
            rounds_done=self.rounds_done,
            x=self.current_x(),
            losses=np.asarray(self.losses, np.float32),
            wall_time_s=self.wall_time_s,
            compile_time_s=self.compile_time_s,
        )

    @classmethod
    def restore(
        cls,
        path,
        spec: ExperimentSpec | None = None,
        autosave_dir: str | Path | None = None,
        device=None,
    ) -> "Session":
        """Reopen a saved session on ``device`` and fast-forward to its
        round.

        With ``spec`` given, its ``content_hash()`` must equal the hash
        the checkpoint was written under (``SpecMismatchError``
        otherwise — the message names both hashes and the first
        differing spec field) — resuming under a different experiment is
        always a hard error. With ``spec`` omitted, the spec is rebuilt
        from the checkpoint itself.

        The restored session continues the identical round sequence:
        the round counter is part of the carry, so rounds r, r+1, …
        read exactly the bundle rows the uninterrupted run would have.
        """
        ck = load_session_checkpoint(
            path,
            expect_spec_hash=spec.content_hash() if spec is not None else None,
            expect_spec_dict=spec.to_dict() if spec is not None else None,
        )
        restored_spec = (
            spec if spec is not None else ExperimentSpec.from_dict(ck.spec_dict)
        )
        sess = cls(restored_spec, x0=ck.x, autosave_dir=autosave_dir, device=device)
        return cls._fast_forward(sess, ck)

    @classmethod
    def restore_elastic(
        cls,
        path,
        devices: int | None = None,
        mesh: MeshSpec | None = None,
        calibration=None,
        autosave_dir: str | Path | None = None,
        device=None,
    ) -> "Session":
        """Reopen a saved session on a *different* mesh — the elastic
        door for shrink/grow after a preemption.

        Exactly one of ``devices`` / ``mesh`` picks the new geometry:
        with ``devices``, ``replan_mesh`` prices every (p_r, p_c)
        factorization under the (optionally §6.5-``calibration``-fitted)
        cost model and the cheapest wins; with ``mesh``, that geometry
        is used as given. The checkpoint's weights seed a session built
        for the new geometry, the loss trace and round counter carry
        over, and the run continues from the last round boundary.
        ``device`` is where this process runs the simulated mesh.

        At an *unchanged* mesh this is exactly ``restore`` (bitwise-
        identical continuation on the CPU). At a changed p_c the
        numerics are unchanged by construction (p_c is
        communication-only); a changed p_r re-teams the rows, so the
        resumed trajectory is a different — equally valid — member of
        the (p_r, p_c, s, τ) family that converges to the same
        objective, not a replay.
        """
        if (devices is None) == (mesh is None):
            raise ValueError("restore_elastic needs exactly one of devices= / mesh=")
        ck = load_session_checkpoint(path)  # deliberately un-keyed: elastic
        old_spec = ExperimentSpec.from_dict(ck.spec_dict)
        if mesh is None:
            new_spec = replan_mesh(old_spec, devices, calibration=calibration).spec
        else:
            new_spec = dataclasses.replace(
                old_spec,
                schedule=dataclasses.replace(
                    old_spec.schedule, p_r=mesh.p_r, p_c=mesh.p_c
                ),
                mesh=mesh,
            )
        sess = cls(new_spec, x0=ck.x, autosave_dir=autosave_dir, device=device)
        return cls._fast_forward(sess, ck)

    @staticmethod
    def _fast_forward(sess: "Session", ck: SessionCheckpoint) -> "Session":
        """Advance a freshly built session's counters to the checkpoint:
        round counter (part of the carry — the bundle row offsets
        continue exactly), loss-trace prefix, and accumulated wall. The
        counted-comm side of the ledger fast-forwards too (the run, as
        opposed to this process, has communicated ck.rounds_done rounds'
        worth); measured per-round seconds stay per-process — a fresh
        process starts cold and re-times."""
        sess.rounds_done = ck.rounds_done
        sess.ledger.rounds = ck.rounds_done
        sess.losses = [float(v) for v in ck.losses]
        sess.wall_time_s = ck.wall_time_s
        sess.compile_time_s = ck.compile_time_s
        sess._first_chunk_pending = True  # this process starts cold
        sess._check_stop(sess.losses[-1] if sess.losses else None)
        return sess
