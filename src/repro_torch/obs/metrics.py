"""A unified metrics registry — typed counters, gauges, histograms.

Before this module the repo's telemetry lived in three ad-hoc silos:
``CommLedger`` (comm plane), the serve-only ``StageMetrics``, and chaos
forensics in log lines. This is the one process-wide home: every plane
registers typed instruments here, and snapshots/deltas give sweeps,
CLIs, and benchmarks a single labeled view.

Three instrument kinds, Prometheus-shaped:

  Counter    monotonically increasing count (points run, retries,
             predictions served). ``inc(n)``.
  Gauge      a level that goes up and down (queue depth, staleness,
             rounds/sec). ``set(v)``.
  Histogram  a running summary of observations — count/sum/min/max
             (per-module benchmark walls, batch sizes). ``observe(v)``.

Instruments are keyed by (kind, name, sorted labels); asking for the
same name with a different kind is a programming error and raises.
``registry()`` returns the process-default ``MetricsRegistry``
(tests use ``reset()`` or a private instance). Instruments are plain
Python on the host — nothing here touches the device or its tensors.
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
]


def _key(name: str, labels: dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


@dataclasses.dataclass
class Counter:
    """Monotonic count. ``inc`` by a non-negative amount."""

    name: str
    labels: dict = dataclasses.field(default_factory=dict)
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": "counter", "value": self.value}


@dataclasses.dataclass
class Gauge:
    """A level — last value written wins."""

    name: str
    labels: dict = dataclasses.field(default_factory=dict)
    value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"kind": "gauge", "value": self.value}


@dataclasses.dataclass
class Histogram:
    """Running summary of observations: count / sum / min / max."""

    name: str
    labels: dict = dataclasses.field(default_factory=dict)
    count: int = 0
    sum: float = 0.0
    min: float | None = None
    max: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> dict:
        return {
            "kind": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Process-wide home of typed instruments, keyed by name + labels.

    Thread-safe at the registration layer (instrument writes are plain
    float/int stores — atomic enough for telemetry under the GIL; this
    mirrors the big clients' approach, not a consistency guarantee).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._kinds: dict[str, str] = {}  # name -> kind (conflict check)

    def _get(self, kind: str, name: str, labels: dict[str, str] | None):
        labels = dict(labels or {})
        key = _key(name, labels)
        with self._lock:
            prev_kind = self._kinds.get(name)
            if prev_kind is not None and prev_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev_kind}, "
                    f"requested as {kind}"
                )
            self._kinds[name] = kind
            inst = self._instruments.get(key)
            if inst is None:
                inst = _KINDS[kind](name=name, labels=labels)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # ---- views ----

    def snapshot(self) -> dict[str, dict]:
        """All instruments as ``{"name{k=v}": {kind, value...}}`` —
        JSON-safe, stable keys (labels sorted)."""
        with self._lock:
            items = list(self._instruments.items())
        return {k: inst.snapshot() for k, inst in sorted(items)}

    def delta(self, prev: dict[str, dict]) -> dict[str, dict]:
        """What changed since a previous ``snapshot()``: counters and
        histograms report the increment, gauges their current level.
        Instruments absent from ``prev`` report their full value."""
        now = self.snapshot()
        out: dict[str, dict] = {}
        for key, snap in now.items():
            before = prev.get(key)
            if snap["kind"] == "gauge" or before is None:
                if before != snap:
                    out[key] = snap
                continue
            if snap["kind"] == "counter":
                d = snap["value"] - before.get("value", 0.0)
                if d:
                    out[key] = {"kind": "counter", "value": d}
            else:  # histogram
                d = snap["count"] - before.get("count", 0)
                if d:
                    out[key] = {
                        "kind": "histogram",
                        "count": d,
                        "sum": snap["sum"] - before.get("sum", 0.0),
                        "min": snap["min"],
                        "max": snap["max"],
                    }
        return out

    def reset(self) -> None:
        """Drop every instrument (tests; a fresh CLI run)."""
        with self._lock:
            self._instruments.clear()
            self._kinds.clear()


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry every plane publishes into."""
    return _DEFAULT
