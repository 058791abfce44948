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

Both backends are chunkable underneath: the simulated engine advances
through ``repro_torch.core.engine.run_engine_chunk`` (the carry is the
weight vector on the device) and the 2D mesh through
``repro_torch.core.distributed.HybridDriver`` (each rank's carry is its
weight shard on its device). The round offset is a host integer, so the
bundle rows a round reads depend only on the global round index.
Chunked execution runs the same per-round body over the same global
round indices as the monolithic path — bitwise equal on the CPU; on
CUDA the Yᵀu scatter-add is atomic, so two runs agree to a stated
tolerance, not to the bit. That is what makes save/restore and early
stopping safe to use in time-to-loss experiments.

On the mesh (``backend="shard_map"``) every rank of the default process
group builds the same ``Session`` and makes the same calls: the loss
probe, ``current_x`` and ``save`` gather the weights with a collective.
Only rank 0 writes a checkpoint (``save``, autosave) while the other
ranks wait at a barrier; every rank reads one on restore.

``run()`` is a thin loop over ``step_rounds`` that honors the spec's
``StopPolicy`` (``target_loss`` / ``max_seconds`` / ``max_rounds``) —
the paper's §7.5 time-to-loss protocol as a first-class stop condition
instead of post-hoc arithmetic on a finished trace.

The device is runtime state, like ``autosave_dir``: never part of the
spec, never part of a hash. ``device=None`` means the CUDA device and
raises when there is none. The session and checkpoint format is the
reference package's, so a checkpoint written by either resumes in the
other. ``step_stream`` is the streaming door: each round trains on one
fresh micro-batch (``repro_torch.serve``) instead of the resident rows.

``schedule.bk=None`` opts into the Gram kernel's autotuner
(``repro_torch.kernels.tune``): the session resolves it from the tuner's
cache for its device, or tunes once on a miss, before it builds. On the
CPU that gives the plain walk's (bk, bm), as the reference's session does;
on the card the kernel's (tile, ks) (``self.gram_geometry``), carried to
every launch of the Gram kernel, with ``bk``/``bm`` the static
(512, None). The same opt-in owns the heavy-tail choice of the dense
oracle (``select_gram_path``, device-keyed). Checkpoints key on the input
spec, so tuning never moves a content hash.
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
from repro_torch.core.comm import MESH, TIMED, CommLedger, time_dispatch, time_phase
from repro_torch.core.distributed import HybridDriver
from repro_torch.core.engine import (
    ParallelSGDSchedule,
    engine_comm_ledger,
    engine_loss,
    engine_phase_probes,
    run_engine_chunk,
)
from repro_torch.core.teams import TeamProblem, global_problem
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.ingest import stream_team_problem
from repro_torch.serve.stream import StreamDesyncError
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


class _EngineDriver:
    """The simulated engine behind ``HybridDriver``'s interface, so the
    ``Session`` drives either executor through the same calls: the carry
    is the global weight vector on the stacked teams' device, each round
    ``run_engine_chunk``. With ``timed`` the rounds run one at a time,
    waiting for the device each round, so the ledger gets a per-round
    wall — the iterate sequence is unchanged (chunk size never changes
    it)."""

    def __init__(self, tp: TeamProblem, x0: np.ndarray, sched: ParallelSGDSchedule,
                 timed: bool = False, geometry: tuple[int, int] | None = None):
        self.tp, self.sched, self.timed, self.geometry = tp, sched, timed, geometry
        self.rounds_done = 0
        self._x = torch.from_numpy(x0.copy()).to(tp.values.device)
        self._gp = global_problem(tp)
        # the counted-comm ledger: the round body's collectives, captured
        # on meta tensors from the problem actually built
        self.ledger = engine_comm_ledger(sched, tp.n, tp=tp)

    def _run(self, tp: TeamProblem, k: int) -> None:
        if self.timed:
            for _ in range(int(k)):
                t0 = time.perf_counter()
                self._x = run_engine_chunk(tp, self._x, self.rounds_done, 1, self.sched,
                                           self.geometry)
                self.sync()
                self.ledger.add_round_seconds(time.perf_counter() - t0)
                self.rounds_done += 1
        else:
            self._x = run_engine_chunk(tp, self._x, self.rounds_done, k, self.sched,
                                       self.geometry)
            self.rounds_done += int(k)
        self.ledger.rounds = self.rounds_done

    def advance(self, k: int) -> None:
        self._run(self.tp, k)

    def advance_batch(self, batch) -> None:
        """Run ONE round over a micro-batch instead of the resident rows,
        as a team problem on the carry's device: with ``rows_local = τ·b``
        the engine's cyclic bundle slicing walks the fresh rows exactly
        once at any round index."""
        tp = self.tp
        self._run(stream_team_problem(batch, tp.p, tp.n, tp.objective, device=tp.values.device), 1)

    def sync(self) -> None:
        if self._x.is_cuda:
            torch.cuda.synchronize(self._x.device)

    def gather(self) -> np.ndarray:
        return self._x.to("cpu", copy=True).numpy()

    def loss(self) -> float:
        return float(engine_loss(self._gp, self._x))

    def phase_probes(self) -> dict:
        return engine_phase_probes(self.tp, self.sched, self.geometry)

    def write(self, fn) -> None:
        fn()

    def agreed_max(self, value: float) -> float:
        return value


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
    """An open, resumable run of one ``ExperimentSpec`` on one device
    (on the mesh: this rank's part of it, on this rank's device).

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
        from repro_torch.api.run import _make_device_mesh, build_problem

        self.device = resolve_device(device)
        self.autosave_dir = Path(autosave_dir) if autosave_dir is not None else None
        self.input_spec = spec          # pre-plan (what checkpoints key on)
        self._plan: Plan = plan(spec, device=self.device)
        self.spec = self._plan.spec     # post-autotune (what executes)
        # the Gram kernel's tuned (tile, ks) on the card, else None
        self.gram_geometry: tuple[int, int] | None = None
        autotuned_panels = self.spec.schedule.bk is None
        if autotuned_panels:
            # bk=None opted into the kernel autotuner: resolve to the
            # cached (or freshly tuned) shape for this device before
            # anything is built. Checkpoints still key on input_spec, so
            # the tuned value never moves a content hash.
            from repro_torch.api.spec import dataset_stats
            from repro_torch.kernels import tune

            profile = tune.PanelProfile.from_stats(
                dataset_stats(self.spec.dataset), self.spec.schedule, self.spec.mesh.p_c,
            )
            bk, bm = tune.resolve_panel(profile, run_on=self.device)
            self.gram_geometry = tune.tuned_geometry(
                tune.lookup_panel(profile, device=tune.device_kind(self.device)))
            sched = dataclasses.replace(
                self.spec.schedule,
                bk=bk,
                bm=self.spec.schedule.bm if self.spec.schedule.bm is not None else bm,
            )
            self.spec = dataclasses.replace(self.spec, schedule=sched)
        # on the mesh the rank's place first: a missing or mis-sized process
        # group is refused before anything is built, and in one the rank
        # builds its own block alone
        mesh = None
        if self.spec.mesh.backend != "simulated":
            mesh = _make_device_mesh(self.spec.mesh.p_r, self.spec.mesh.p_c)
        self.bundle = build_problem(self.spec, device=self.device)
        if autotuned_panels:
            # the opt-in also owns the gram-path choice: a heavy-tailed ELL
            # width flips the bundle build to the dense oracle where the
            # device's rule says so (logged once in tune)
            sched = self.spec.schedule
            built = self.bundle.team if self.bundle.team is not None else self.bundle.prob2d
            width = int(built.indices.shape[-1])
            gram = tune.select_gram_path(width, sched.s * sched.b, sched.gram,
                                         device=tune.device_kind(self.device))
            if gram != sched.gram:
                self.spec = dataclasses.replace(
                    self.spec, schedule=dataclasses.replace(sched, gram=gram)
                )
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

        if self.spec.mesh.backend == "simulated":
            self._driver = _EngineDriver(self.bundle.team, x0, self.spec.schedule,
                                         timed=self.spec.comm_timing,
                                         geometry=self.gram_geometry)
        else:
            self._driver = HybridDriver(
                mesh,
                self.bundle.prob2d,
                self.bundle.cp,
                x0,
                self.spec.schedule,
                comm=TIMED if self.spec.comm_timing else MESH,
                device=self.device,
                geometry=self.gram_geometry,
            )
        # the driver commits rounds (and, timed, measures them) into it
        self.ledger = self._driver.ledger

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
        carry; waits for pending work). On the mesh a collective: every
        rank gathers the same bits."""
        return self._driver.gather()

    # ---- the incremental core ----

    def _advance(self, k: int) -> None:
        """Run k rounds on the carry (no loss sampling)."""
        self._driver.advance(k)
        self.rounds_done += k

    def _sync(self) -> None:
        """Wait for the carry without a host copy."""
        self._driver.sync()

    def _traced_advance(self, sub: int, first: bool, stream_batch=None) -> None:
        """One sub-chunk (or, with ``stream_batch``, one streamed round)
        through the tracing seam: untraced, exactly the bare advance;
        traced, the same advance wrapped in a host-side span that waits
        for the device before it closes, so the recorded wall covers the
        dispatched work (an observer effect on timing only — the numerics
        are untouched)."""
        rec = obs_trace.active()
        if rec is None:
            if stream_batch is not None:
                self._advance_stream(stream_batch)
            else:
                self._advance(sub)
            return
        with rec.span(
            "compile" if first else "round",
            name=f"rounds[{self.rounds_done}+{sub}]",
            start_round=self.rounds_done,
            rounds=sub,
        ):
            if stream_batch is not None:
                self._advance_stream(stream_batch)
            else:
                self._advance(sub)
            self._sync()

    def _measure_phases(self) -> None:
        """Populate ``ledger.phase_seconds`` (→ ``exposed_comm_s``) once
        per timed run: the §6.5 phase split, measured by separate probes
        over the round's real payload shapes — the training step itself
        is never split. Runs outside the wall/compile accounting
        windows; each probed phase also lands as a trace span when a
        recorder is installed."""
        probes = self._driver.phase_probes()
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
        return self._driver.loss()

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
        return self._step(k, "step_rounds")

    # ---- the streaming door ----

    def _next_stream_batch(self, source):
        """One micro-batch from ``source`` — a ``StreamFeed`` (bounded
        ingest queue; preferred) or a bare ``StreamSource`` (iterated
        lazily from the current round, re-anchored if swapped)."""
        if hasattr(source, "get"):  # StreamFeed
            return source.get()
        if getattr(self, "_stream_src", None) is not source:
            self._stream_src = source
            self._stream_iter = source.micro_batches(self.rounds_done)
        return next(self._stream_iter)

    def _advance_stream(self, batch) -> None:
        """Run ONE round over a fresh micro-batch (no loss sampling).

        The batch replaces the resident data for exactly this round: with
        ``m_local = τ·b`` rows per team, the cyclic bundle slicing walks
        the fresh rows exactly once at any round index, so streaming
        reuses the offline round body verbatim. The executor puts the
        batch in its own layout and commits the round."""
        want = self.spec.stream_rows_per_round()
        if batch.rows != want:
            raise ValueError(
                f"micro-batch has {batch.rows} rows; one round of this schedule "
                f"consumes p_r·τ·b = {want}"
            )
        self._driver.advance_batch(batch)
        self.rounds_done += 1

    def step_stream(self, source, k: int | None = None) -> RoundEvent:
        """Advance up to ``k`` rounds (default: to the next loss-sampling
        boundary, or all remaining budget), each round consuming one
        fresh micro-batch from ``source``, and return what happened.

        The streaming twin of ``step_rounds`` — same loss-sampling
        boundaries (the full objective is probed on the spec's resident
        dataset, which serves as the stream session's holdout — so
        ``stop.target_loss`` keeps working), same autosave cadence, same
        StopPolicy and fault seam. What changes is the data: round r
        trains on micro-batch r instead of the resident rows.

        Exactly-once is structural: ``MicroBatch.index`` must equal the
        session's round counter (``StreamDesyncError`` otherwise), and a
        session restored from a round-r autosave re-attaches at batch r
        — sources replay deterministically, so resume continues the
        identical sequence with no duplicated or dropped batch.
        """
        return self._step(k, "step_stream", source)

    def _step(self, k: int | None, what: str, source=None) -> RoundEvent:
        """``step_rounds`` (``source`` None: chunks over the resident rows)
        and ``step_stream`` (one round a micro-batch of ``source``)."""
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
            raise ValueError(f"{what} needs k ≥ 1, got {k}")

        loss = None
        synced = False
        autosave_every = self.input_spec.faults.autosave_every
        autosaving = self.autosave_dir is not None and autosave_every > 0
        t0 = time.perf_counter()
        while k > 0 and self.stop_reason is None:
            batch = None
            if source is not None:
                sub = 1
                # the span measures consumer-side stall: how long the
                # trainer waited on the feed for this round's batch.
                with obs_trace.span("ingest", name=f"batch[{self.rounds_done}]",
                                    index=self.rounds_done):
                    batch = self._next_stream_batch(source)
                if batch.index != self.rounds_done:
                    raise StreamDesyncError(
                        f"micro-batch index {batch.index} != session round "
                        f"{self.rounds_done}: a batch was duplicated, dropped, or "
                        f"reordered (resume must re-attach the source at "
                        f"start={self.rounds_done})"
                    )
            else:
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
            self._traced_advance(sub, first, stream_batch=batch)
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
                sampled, wall=self._agreed_wall(self.wall_time_s + (time.perf_counter() - t0))
            )
            if autosaving and self.rounds_done % autosave_every == 0:
                # preemption-safe: the carry (and the stream position,
                # rounds_done: resume re-attaches at this batch index) is
                # durable at this boundary *before* the seam below may
                # kill/stall/fail the worker.
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

    def _agreed_wall(self, wall: float) -> float:
        """The wall the ``max_seconds`` verdict reads. On the mesh every
        rank must reach the same verdict at the same boundary (a rank that
        stops alone would leave the others in a collective), so the ranks
        agree on the largest of their walls — one all-reduce, only when
        ``max_seconds`` is set."""
        if self.spec.stop.max_seconds is None:
            return wall
        return self._driver.agreed_max(wall)

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
        x = self.current_x()
        final_loss = self._driver.loss()
        return RunReport(
            spec=self.spec,
            plan=self._plan,
            backend=self.spec.mesh.backend,
            x=x,
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
        (atomic; keyed by the input spec's content hash). On the mesh
        every rank gathers x, rank 0 alone writes, and every rank waits
        at a barrier until the files are in place."""
        x = self.current_x()

        def write():
            save_session_checkpoint(
                path,
                spec_dict=self.input_spec.to_dict(),
                spec_hash=self.input_spec.content_hash(),
                rounds_done=self.rounds_done,
                x=x,
                losses=np.asarray(self.losses, np.float32),
                wall_time_s=self.wall_time_s,
                compile_time_s=self.compile_time_s,
            )

        self._driver.write(write)

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
        ``device`` is where this process runs (the simulated mesh, or this
        rank's block of a ``shard_map`` mesh, whose ELL shards are rebuilt
        for the new partition).

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
        sess._driver.rounds_done = ck.rounds_done
        sess.ledger.rounds = ck.rounds_done
        sess.losses = [float(v) for v in ck.losses]
        sess.wall_time_s = ck.wall_time_s
        sess.compile_time_s = ck.compile_time_s
        sess._first_chunk_pending = True  # this process starts cold
        sess._check_stop(sess.losses[-1] if sess.losses else None)
        return sess
