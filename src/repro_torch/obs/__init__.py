"""repro_torch.obs — the observability plane.

``trace``    Span/TraceRecorder seam (contextmanager + ContextVar,
             inert when uninstalled) with the closed span-category set.
``metrics``  process-wide registry of typed Counter/Gauge/Histogram
             instruments with labeled snapshots and deltas.

``export``   Chrome trace-event JSON and a JSONL event log of a
             recorder, their loader and the per-category table
             (``python -m repro_torch.launch.trace summarize PATH``).

All three are host-side Python, the same modules as the reference
package's; the trace files are the reference's format.
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
