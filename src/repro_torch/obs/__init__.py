"""repro_torch.obs — the observability plane.

``trace``    Span/TraceRecorder seam (contextmanager + ContextVar,
             inert when uninstalled) with the closed span-category set.
``metrics``  process-wide registry of typed Counter/Gauge/Histogram
             instruments with labeled snapshots and deltas.

Both are host-side Python, the same modules as the reference package's.
The trace exporters (Chrome trace-event JSON, JSONL event log) are not
in the port yet.
"""

from repro_torch.obs.metrics import MetricsRegistry, registry
from repro_torch.obs.trace import SPAN_CATEGORIES, Span, TraceRecorder, active, install, span

__all__ = [
    "MetricsRegistry",
    "SPAN_CATEGORIES",
    "Span",
    "TraceRecorder",
    "active",
    "install",
    "registry",
    "span",
]
