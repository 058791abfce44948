"""Structured span tracing — the repo's observability seam.

The paper's empirical claims rest on a *time breakdown*: computation
vs. the two communication phases of Eq. 4, calibrated per machine in
§6.5. Before this module the repo could only measure whole rounds
(``CommLedger.round_seconds``) and whole runs (``RunReport``'s
compile/solve walls) — nothing could attribute wall time to a phase
*inside* a round, which is exactly what the overlap/asynchrony work
(exposed vs. total comm time) needs.

This is the tracing half of ``repro_torch.obs``: a ``TraceRecorder`` collects
``Span``s — named, categorized, nested wall-clock intervals — from
instrumented sites across train/sweep/serve. The seam follows
``repro_torch.core.faults`` exactly:

* a recorder is ``install``-ed for a scope (contextmanager + ContextVar;
  a module-level fallback makes it visible to worker threads, which
  do not inherit ContextVars — the serve plane's feed producer and
  prediction batcher record through it);
* instrumented code calls the module-level ``span(category, ...)``;
* with nothing installed, ``span`` returns one shared reusable no-op
  context — no allocation, no lock, one ContextVar read. Spans are
  host-side wall intervals only: nothing is recorded on the device, the
  numerics are untouched and the default path is bitwise-identical (the
  same discipline as the faults seam). A span that must cover device
  work waits for it (``torch.cuda.synchronize``) before it closes.

Span categories are a closed set (``SPAN_CATEGORIES``); an unknown
category is a programming error and raises immediately. The mapping to
the paper: ``bundle_compute`` is Eq. 4's γ (compute) term,
``allreduce_gv`` the per-bundle (G, v) Allreduce (α/β over p_c),
``param_avg`` the per-τ weight averaging (α/β over p_r) — the three
phases §6.5 calibrates. Under a delay-D schedule ``allreduce_gv``
splits into ``allreduce_gv_issue`` (the host-side dispatch cost that
stays on the critical path) and ``allreduce_gv_await`` (the exposed
remainder after D bundle-computes of overlap) — Perfetto shows the
bubble closing as D grows. ``round``/``compile`` wrap the session chunk
loop; ``ckpt_save``/``ckpt_verify``/``swap`` the durability plane;
``ingest``/``predict_batch`` the serve plane.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from contextvars import ContextVar

__all__ = [
    "SPAN_CATEGORIES",
    "Span",
    "TraceRecorder",
    "active",
    "install",
    "span",
]

SPAN_CATEGORIES = (
    "round",
    "bundle_compute",
    "allreduce_gv",
    "allreduce_gv_issue",
    "allreduce_gv_await",
    "param_avg",
    "ckpt_save",
    "ckpt_verify",
    "swap",
    "ingest",
    "predict_batch",
    "compile",
)


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded wall-clock interval.

    category  one of ``SPAN_CATEGORIES``.
    name      instance label ("rounds[8+4]", "swap-12", ...).
    t0        start, seconds since the recorder's epoch (perf_counter
              clock — monotonic; the recorder also stamps a unix epoch
              so exports can place spans in absolute time).
    dur       duration in seconds.
    tid       recording thread id (spans from the feed producer and the
              prediction batcher land on their own tracks).
    depth     nesting depth within the recording thread (0 = top).
    args      small JSON-safe payload (round counts, paths, row counts).
    """

    category: str
    name: str
    t0: float
    dur: float
    tid: int
    depth: int
    args: dict = dataclasses.field(default_factory=dict)


class TraceRecorder:
    """Collects spans from every instrumented seam while installed.

    Thread-safe: instrumented sites run on the session thread, the
    stream feed's producer thread, and the prediction service's batcher
    thread; each appends under one lock and nests against its own
    per-thread depth stack.
    """

    def __init__(self):
        self.epoch_perf = time.perf_counter()
        self.epoch_unix = time.time()
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # ---- recording ----

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def span(self, category: str, name: str | None = None, **args):
        """Record the with-block as one span. ``args`` must be
        JSON-safe (they land verbatim in the exported trace)."""
        if category not in SPAN_CATEGORIES:
            raise ValueError(f"category={category!r} not in {SPAN_CATEGORIES}")
        depth = self._depth()
        self._local.depth = depth + 1
        t0 = time.perf_counter() - self.epoch_perf
        try:
            yield self
        finally:
            dur = (time.perf_counter() - self.epoch_perf) - t0
            self._local.depth = depth
            self._append(Span(
                category=category,
                name=name if name is not None else category,
                t0=t0,
                dur=dur,
                tid=threading.get_ident(),
                depth=depth,
                args=args,
            ))

    def add_span(self, category: str, name: str, *, t0: float | None = None,
                 dur: float, **args) -> Span:
        """Record an externally-measured interval (phase probes, compile
        walls) post hoc. ``t0`` defaults to now-minus-``dur``."""
        if category not in SPAN_CATEGORIES:
            raise ValueError(f"category={category!r} not in {SPAN_CATEGORIES}")
        now = time.perf_counter() - self.epoch_perf
        s = Span(
            category=category,
            name=name,
            t0=(now - dur) if t0 is None else t0,
            dur=float(dur),
            tid=threading.get_ident(),
            depth=self._depth(),
            args=args,
        )
        self._append(s)
        return s

    def _append(self, s: Span) -> None:
        with self._lock:
            self.spans.append(s)

    # ---- inspection ----

    def by_category(self) -> dict[str, list[Span]]:
        out: dict[str, list[Span]] = {}
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            out.setdefault(s.category, []).append(s)
        return out

    def total_seconds(self, category: str) -> float:
        return sum(s.dur for s in self.by_category().get(category, ()))

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)


# ---- the seam ----------------------------------------------------------
#
# ContextVar for the common single-threaded case, plus a module-level
# fallback: ContextVars do NOT propagate into threading.Thread, and the
# serve plane's producer/batcher threads are exactly where queue-depth
# and batch spans come from. install() sets both; active() prefers the
# ContextVar (correct nesting of scoped installs on one thread) and
# falls back to the global for threads started inside the scope.

_ACTIVE: ContextVar[TraceRecorder | None] = ContextVar("trace_recorder", default=None)
_GLOBAL: TraceRecorder | None = None

# one shared, reusable no-op context: the uninstalled fast path must not
# allocate per call (the round loop crosses it every sub-chunk).
_NULLCTX = contextlib.nullcontext()


def active() -> TraceRecorder | None:
    """The installed recorder, or None (the normal, untraced case)."""
    rec = _ACTIVE.get()
    if rec is not None:
        return rec
    return _GLOBAL


@contextlib.contextmanager
def install(recorder: TraceRecorder | None = None):
    """Install a recorder for the dynamic extent of the with-block and
    yield it (make one when not given). Worker threads started inside
    the scope see it too, via the module-level fallback."""
    global _GLOBAL
    rec = TraceRecorder() if recorder is None else recorder
    token = _ACTIVE.set(rec)
    prev_global = _GLOBAL
    _GLOBAL = rec
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)
        _GLOBAL = prev_global


def span(category: str, name: str | None = None, **args):
    """Record a span at an instrumented site — the shared no-op context
    when no recorder is installed."""
    rec = active()
    if rec is None:
        return _NULLCTX
    return rec.span(category, name, **args)
