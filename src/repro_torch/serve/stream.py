"""The streaming data plane: deterministic, replayable micro-batches.

The engine is round-incremental (``Session``), so streaming training is
purely an *input* plane. One round of the (p_r, p_c, s, τ)
schedule consumes exactly ``p_r · τ · b`` sample rows, so a live stream
plugs in by micro-batching arrivals into fixed-shape ELL row-shards of
that size and handing each batch to ``Session.step_stream`` as one
round.

Determinism contract (what makes streaming fault-tolerant): micro-batch
``k`` is a pure function of ``(source config, seed, k)`` — never of
thread timing, queue depth, or how many batches were already drawn.
``micro_batches(start=k)`` therefore *replays* the identical suffix, so
a session resumed from a round-``k`` autosave re-attaches at batch ``k``
and continues the exact sequence: no duplicated and no dropped
micro-batch, enforced structurally (``MicroBatch.index`` must equal the
session's round counter — ``StreamDesyncError`` otherwise).

Sources:

* ``DriftStream``  — synthetic labeled examples from a hidden weight
  vector that flips at ``drift_at`` (concept shift); the time-to-adapt
  benchmark's generator.
* ``ReplayStream`` — cycles a registered synthetic dataset's rows; the
  bridge that feeds the *offline* matrices through the online path.

``StreamFeed`` is the ingest half of the serving plane: a producer
thread pulls a source into a bounded queue, so training backpressure
(queue full) and ingest lag are observable per-stage metrics instead of
hidden in iterator pull order.

This module is numpy and threading only: the producer thread makes host
batches and never touches a device. Batch ``k`` of a source is bitwise
the reference package's (``repro.serve.stream``) for the same
configuration, seed and ``k``, so a stream resumed in either package
continues the same sequence.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Protocol, runtime_checkable

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "MicroBatch",
    "StreamSource",
    "StreamDesyncError",
    "DriftStream",
    "ReplayStream",
    "StreamFeed",
    "make_stream_source",
]


class StreamDesyncError(RuntimeError):
    """A consumer received a micro-batch whose ``index`` does not match
    its position — a duplicated, dropped, or reordered batch. Raised
    instead of silently training on the wrong data."""


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One fixed-shape micro-batch of labeled sparse examples.

    index    position in the stream (the replay key; equals the round
             that will consume it).
    indices  (rows, width) int32 global feature ids (ELL layout; id 0 +
             value 0 where padded — duplicates are legal, contributions
             sum).
    values   (rows, width) float32 feature values (labels NOT folded —
             ``ya_values`` gives the diag(y)·A form the solver wants).
    y        (rows,) float32 labels in {−1, +1}.
    """

    index: int
    indices: np.ndarray
    values: np.ndarray
    y: np.ndarray

    @property
    def rows(self) -> int:
        return int(self.indices.shape[0])

    @property
    def width(self) -> int:
        return int(self.indices.shape[1])

    def ya_values(self) -> np.ndarray:
        """Label-folded values: row i scaled by y_i (diag(y)·A), the
        layout both executors train on."""
        return (self.values * self.y[:, None]).astype(np.float32)


@runtime_checkable
class StreamSource(Protocol):
    """Anything that yields a deterministic, replayable batch sequence.

    ``micro_batches(start)`` must yield batch ``start``, ``start+1``, …
    with each batch a pure function of the source's configuration and
    its index — two iterators from equal sources are elementwise
    identical, regardless of interleaving.
    """

    def micro_batches(self, start: int = 0) -> Iterator:
        ...


@dataclasses.dataclass(frozen=True)
class DriftStream:
    """Synthetic labeled stream with one concept shift.

    Examples are sparse rows with exactly ``width`` active features
    (ids Zipf-skewed like the offline synthetic datasets when
    ``alpha > 0``); labels are sampled from a logistic model on a hidden
    weight vector ``w`` that *flips sign* at batch ``drift_at``
    (``drift_mode="flip"`` — every learned margin inverts, the hardest
    useful shift) or is redrawn independently (``"rotate"``).

    Batch ``k`` derives every array from ``default_rng([seed, k])`` —
    pure in (config, seed, k), so replay-from-k is exact.
    """

    n: int
    rows: int
    width: int = 16
    seed: int = 0
    drift_at: int = 0  # batch index of the shift; 0 = never drifts
    drift_mode: str = "flip"
    alpha: float = 0.6  # column-skew exponent (0 = uniform)
    margin_scale: float = 2.5

    def __post_init__(self):
        if self.n < 1 or self.rows < 1 or self.width < 1:
            raise ValueError(
                f"DriftStream needs n, rows, width ≥ 1, got "
                f"n={self.n} rows={self.rows} width={self.width}"
            )
        if self.drift_mode not in ("flip", "rotate"):
            raise ValueError(f"drift_mode={self.drift_mode!r} not in ('flip', 'rotate')")

    def truth(self, batch_index: int) -> np.ndarray:
        """The hidden concept at ``batch_index`` (pre/post drift)."""
        w0 = self._base_truth(0)
        if not self.drift_at or batch_index < self.drift_at:
            return w0
        return -w0 if self.drift_mode == "flip" else self._base_truth(1)

    def _col_p(self) -> np.ndarray | None:
        if not self.alpha:
            return None
        p = np.arange(1, self.n + 1, dtype=np.float64) ** (-self.alpha)
        return p / p.sum()

    def _base_truth(self, which: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 0x7A57E, which])
        w = np.zeros(self.n, np.float64)
        # support drawn from the *feature frequency* distribution, so
        # typical rows actually touch signal-carrying features (a
        # uniform support on a Zipf-skewed stream leaves most rows with
        # zero margin — unlearnable coin flips).
        size = min(max(self.n // 50, 8), self.n)
        support = rng.choice(self.n, size=size, replace=False, p=self._col_p())
        w[support] = rng.standard_normal(len(support)) * 3.0
        return w

    def batch(self, k: int) -> MicroBatch:
        """Micro-batch ``k`` — pure in (self, k)."""
        rng = np.random.default_rng([self.seed, int(k)])
        p = self._col_p()
        if p is not None:
            idx = rng.choice(self.n, size=(self.rows, self.width), p=p)
        else:
            idx = rng.integers(0, self.n, size=(self.rows, self.width))
        idx = idx.astype(np.int32)
        val = (rng.standard_normal((self.rows, self.width)) / np.sqrt(self.width)).astype(
            np.float32
        )
        w = self.truth(k)
        margins = np.einsum("rw,rw->r", val.astype(np.float64), w[idx])
        std = max(float(np.abs(margins).mean()), 1e-9)
        logits = self.margin_scale * margins / std
        prob = 1.0 / (1.0 + np.exp(-logits))
        y = np.where(rng.random(self.rows) < prob, 1.0, -1.0).astype(np.float32)
        return MicroBatch(index=int(k), indices=idx, values=val, y=y)

    def micro_batches(self, start: int = 0) -> Iterator[MicroBatch]:
        k = int(start)
        while True:
            yield self.batch(k)
            k += 1


@dataclasses.dataclass(frozen=True)
class ReplayStream:
    """Cycle a registered synthetic dataset's rows as micro-batches —
    the offline matrices fed through the online path (batch k = rows
    ``[k·rows, (k+1)·rows)`` of diag-less A, cyclically; deterministic
    trivially, since the dataset is deterministic in (name, seed))."""

    dataset: str
    rows: int
    seed: int = 0
    width: int | None = None  # None → the dataset's max nnz/row

    def _materialize(self):
        # lazy so the serving plane imports without the dataset machinery;
        # the dataset cache is shared with the offline path.
        from repro_torch.api.run import _cached_dataset

        return _cached_dataset(self.dataset, seed=self.seed)

    def batch(self, k: int) -> MicroBatch:
        ds = self._materialize()
        a, y = ds.A, ds.y
        w = self.width or max(int(a.nnz_per_row.max()), 1)
        # row r of the batch is dataset row (k·rows + r) mod m, its first
        # min(nnz, w) entries left-aligned, the rest pads (id 0, value 0)
        src = (int(k) * self.rows + np.arange(self.rows, dtype=np.int64)) % a.m
        lo = a.indptr[src].astype(np.int64)
        cnt = np.minimum(a.indptr[src + 1].astype(np.int64) - lo, w)
        slot = np.arange(w, dtype=np.int64)
        take = slot[None, :] < cnt[:, None]
        at = np.where(take, lo[:, None] + slot[None, :], 0)
        idx = np.where(take, a.indices[at], 0).astype(np.int32)
        val = np.where(take, a.data[at], 0).astype(np.float32)
        return MicroBatch(index=int(k), indices=idx, values=val, y=y[src].astype(np.float32))

    def micro_batches(self, start: int = 0) -> Iterator[MicroBatch]:
        k = int(start)
        while True:
            yield self.batch(k)
            k += 1


class StreamFeed:
    """Bounded-queue ingest: a producer thread pulls a ``StreamSource``
    into a ``queue.Queue(capacity)``; the trainer consumes with
    ``get()``. Determinism is the *source's* job (batch k is pure in k),
    so the queue adds observability — ingest lag, depth, backpressure —
    without touching the replay contract.

    Use as a context manager, or call ``start()`` / ``close()``.
    """

    def __init__(self, source: StreamSource, start: int = 0, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be ≥ 1")
        self.source = source
        self.start_index = int(start)
        self.capacity = int(capacity)
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.produced = 0
        self.consumed = 0

    # ---- lifecycle ----

    def start(self) -> "StreamFeed":
        if self._thread is not None:
            raise RuntimeError("StreamFeed already started")
        self._thread = threading.Thread(
            target=self._produce, name="stream-feed", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        # unblock a producer stuck on a full queue
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "StreamFeed":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- the two ends ----

    def _produce(self) -> None:
        # runs on the producer thread: the trace seam's module-level
        # fallback makes an install()-ed recorder visible here, and the
        # queue-depth gauge is the serving plane's backpressure signal.
        depth = obs_metrics.registry().gauge("stream.queue_depth")
        try:
            it = self.source.micro_batches(self.start_index)
            while not self._stop.is_set():
                with obs_trace.span("ingest", name="produce",
                                    index=self.start_index + self.produced):
                    batch = next(it)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.05)
                        self.produced += 1
                        depth.set(self._q.qsize())
                        break
                    except queue.Full:
                        continue  # backpressure: trainer is behind
        except StopIteration:
            return  # a finite source ran dry — a clean end of stream
        except BaseException as e:  # surfaced to the consumer on get()
            self._error = e

    def get(self, timeout: float | None = 30.0) -> MicroBatch:
        """Next micro-batch (blocks up to ``timeout``); re-raises a
        producer-side error here, on the consumer thread."""
        try:
            batch = self._q.get(timeout=timeout)
        except queue.Empty:
            if self._error is not None:
                raise RuntimeError("stream producer failed") from self._error
            raise TimeoutError(
                f"no micro-batch arrived within {timeout}s (queue empty, "
                f"produced={self.produced})"
            ) from None
        self.consumed += 1
        obs_metrics.registry().gauge("stream.queue_depth").set(self._q.qsize())
        return batch

    # ---- per-stage metrics ----

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    @property
    def ingest_lag(self) -> int:
        """Batches produced but not yet consumed (bounded by capacity)."""
        return self.produced - self.consumed

    def stats(self) -> dict:
        return {
            "produced": self.produced,
            "consumed": self.consumed,
            "queue_depth": self.queue_depth,
            "ingest_lag": self.ingest_lag,
            "capacity": self.capacity,
        }


def make_stream_source(spec) -> StreamSource:
    """Build the spec's declared stream source (``spec.stream``): the
    feature dimension comes from the spec's dataset registry entry, the
    rows-per-round from the schedule (one round's consumption)."""
    from repro_torch.sparse.synthetic import dataset_stats

    st = spec.stream
    if not st.enabled:
        raise ValueError(
            "spec has no stream attached (stream.source='') — set "
            "stream=StreamSpec(source='drift'|'replay')"
        )
    rows = spec.stream_rows_per_round()
    if st.source == "drift":
        return DriftStream(
            n=dataset_stats(spec.dataset).n,
            rows=rows,
            width=st.width,
            seed=st.seed,
            drift_at=st.drift_at,
        )
    if st.source == "replay":
        return ReplayStream(dataset=spec.dataset, rows=rows, seed=spec.seed)
    raise ValueError(f"unknown stream source {st.source!r}")
