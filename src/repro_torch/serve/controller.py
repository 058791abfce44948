"""OnlineController — serve and train on one process, one Session.

The interleave loop of the serving plane: a ``StreamFeed`` ingests
micro-batches, ``Session.step_stream`` trains one round per batch, and
on freshness boundaries the controller publishes the current weights to
the ``ModelStore`` the prediction service reads from. Ingest never
pauses for a swap — the swap path is checkpoint-shaped
(``session.save`` → ``store.swap_from_checkpoint``), so every served
model went through the integrity-hashed durable format and a torn or
corrupt model can never install.

Freshness policy (when the served model refreshes):

* ``swap_every`` — every k training rounds (the steady-state cadence;
  defaults to the spec's ``stream.swap_every``);
* ``swap_at_loss`` — additionally as soon as a sampled holdout loss
  crosses this target (publish the recovered model immediately after a
  drift instead of waiting out the cadence);
* a final swap when the run ends, so the store never lags the trainer
  at rest.

``metrics()`` reports the per-stage health: ingest
lag and queue depth (stream), rounds/sec (train), predictions/sec
(serve), and staleness (rounds the served model trails the trainer).

Swap checkpoints are written by ``Session.save`` — on a mesh, rank 0
alone writes while every rank waits for the write — and every process
loads them into its own store.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path

__all__ = ["StageMetrics", "OnlineController"]

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.stream import StreamFeed


@dataclasses.dataclass(frozen=True)
class StageMetrics:
    """One snapshot of the three stages (ingest / train / serve).

    Based on the ``repro_torch.obs`` metrics registry: every field is also a
    registry gauge (``serve.stage.<field>``), published whenever the
    controller takes a snapshot, so the serving stages share the one
    process-wide telemetry home with train/sweep. ``to_dict()`` keys are
    the reference's (the serve CLI writes them)."""

    rounds_done: int
    rounds_per_sec: float
    last_loss: float | None
    ingest_lag: int
    queue_depth: int
    predictions_per_sec: float | None
    predictions_served: int | None
    staleness_rounds: int
    model_version: int
    swaps: int
    failed_swaps: int

    def publish(self, registry: obs_metrics.MetricsRegistry | None = None) -> None:
        """Mirror every (non-None) field into ``serve.stage.*`` gauges."""
        reg = obs_metrics.registry() if registry is None else registry
        for field, value in dataclasses.asdict(self).items():
            if value is not None:
                reg.gauge(f"serve.stage.{field}").set(value)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class OnlineController:
    """Drive one ``Session`` from a stream while a ``ModelStore`` (and
    optionally a started ``PredictionService``) serves beside it.

    session     the (streaming-spec) Session to train.
    source      a ``StreamSource``; wrapped in a ``StreamFeed`` anchored
                at ``session.rounds_done`` (resume-safe by construction).
    store       the ``ModelStore`` predictions read from; seeded with
                the session's current weights so serving starts at
                round 0 (version 1 = the unswapped initial model).
    service     optional ``PredictionService`` (only read for metrics —
                the controller never blocks on the serve side).
    swap_every  override the spec's ``stream.swap_every`` cadence.
    swap_dir    where swap checkpoints land (a tempdir when omitted).
    swap_at_loss  also swap immediately when a sampled loss ≤ this.
    """

    def __init__(
        self,
        session,
        source,
        store,
        service=None,
        swap_every: int | None = None,
        swap_dir=None,
        swap_at_loss: float | None = None,
    ):
        self.session = session
        self.store = store
        self.service = service
        st = session.spec.stream
        self.swap_every = st.swap_every if swap_every is None else int(swap_every)
        self.swap_at_loss = swap_at_loss
        self.swap_dir = Path(
            tempfile.mkdtemp(prefix="repro-swap-") if swap_dir is None else swap_dir
        )
        self.source = source
        self.feed = StreamFeed(
            source, start=session.rounds_done, capacity=st.queue_capacity
        )
        self.events: list = []
        self.swap_rounds: list[int] = []
        self._train_seconds = 0.0
        self._rounds_run = 0
        self._feed_started = False
        # serve from round 0: the initial weights are a valid (if
        # untrained) model, and a target-loss swap may never fire.
        self.store.publish(
            session.current_x(),
            rounds_done=session.rounds_done,
            spec_hash=session.input_spec.content_hash(),
        )

    # ---- the interleave loop ----

    def _swap(self) -> None:
        path = self.swap_dir / f"swap-{self.session.rounds_done}"
        self.session.save(path)
        self.store.swap_from_checkpoint(path)
        self.swap_rounds.append(self.session.rounds_done)

    def _ensure_feed(self) -> None:
        if self._feed_started:
            return
        if self.feed._thread is not None:
            # a closed feed's producer is gone — re-anchor a fresh one
            # at the current round (sources replay, so the sequence
            # continues exactly where the previous feed left off).
            self.feed = StreamFeed(
                self.source,
                start=self.session.rounds_done,
                capacity=self.session.spec.stream.queue_capacity,
            )
        self.feed.start()
        self._feed_started = True

    def step(self):
        """One stream round + the freshness policy. Returns the
        session's ``RoundEvent`` (callers interleave probes/logging
        between steps; ``run`` is the no-frills loop over this)."""
        self._ensure_feed()
        t0 = time.perf_counter()
        ev = self.session.step_stream(self.feed, 1)
        self._train_seconds += time.perf_counter() - t0
        self.events.append(ev)
        self._rounds_run += 1
        if self.swap_every and self.session.rounds_done % self.swap_every == 0:
            self._swap()
        elif (
            self.swap_at_loss is not None
            and ev.loss is not None
            and ev.loss <= self.swap_at_loss
            and self.store.snapshot().rounds_done < self.session.rounds_done
        ):
            self._swap()
        return ev

    def finish(self) -> StageMetrics:
        """Final swap (the store never lags the trainer at rest) + feed
        shutdown. Idempotent; returns the end-of-run metrics."""
        if self.store.snapshot().rounds_done < self.session.rounds_done:
            self._swap()
        if self._feed_started:
            self.feed.close()
            self._feed_started = False
        return self.metrics()

    def run(self, rounds: int | None = None) -> StageMetrics:
        """Train up to ``rounds`` stream rounds (default: the session's
        remaining budget), hot-swapping per the freshness policy, and
        finish with a final swap. Returns the end-of-run metrics."""
        remaining = self.session.total_rounds - self.session.rounds_done
        rounds = remaining if rounds is None else min(int(rounds), remaining)
        done = 0
        while done < rounds and not self.session.done:
            ev = self.step()
            done += 1
            if ev.stop:
                break
        return self.finish()

    # ---- per-stage metrics ----

    def metrics(self) -> StageMetrics:
        svc = self.service.stats() if self.service is not None else None
        snap = self.store.snapshot()
        m = StageMetrics(
            rounds_done=self.session.rounds_done,
            rounds_per_sec=(
                self._rounds_run / self._train_seconds if self._train_seconds else 0.0
            ),
            last_loss=self.session.losses[-1] if self.session.losses else None,
            ingest_lag=self.feed.ingest_lag,
            queue_depth=self.feed.queue_depth,
            predictions_per_sec=svc["predictions_per_sec"] if svc else None,
            predictions_served=svc["rows_served"] if svc else None,
            staleness_rounds=self.session.rounds_done - snap.rounds_done,
            model_version=snap.version,
            swaps=self.store.swaps,
            failed_swaps=self.store.failed_swaps,
        )
        m.publish()
        return m
