"""Trace export — Chrome trace-event JSON and a JSONL event log.

Two schema-versioned formats from one ``TraceRecorder``:

* ``write_chrome_trace`` — the Chrome trace-event "JSON Object Format":
  a top-level dict with ``traceEvents`` of ``ph: "X"`` complete events
  (ts/dur in microseconds, pid/tid tracks, span args attached). The
  file loads directly in Perfetto (ui.perfetto.dev) and
  chrome://tracing; each recording thread is its own named track, so a
  serve-plane trace shows the session, the feed producer, and the
  prediction batcher side by side.
* ``write_jsonl`` — one JSON object per line: a header line carrying
  the schema version and epochs, then one line per span in recording
  order. Greppable and streamable (the shape log scrapers want).

``summarize``/``category_table`` aggregate per category — total wall,
span count, wall share — which is also what the launch CLIs print as
the ``[trace]`` summary line.

Every key and JSON form is the reference package's, so each package
loads the other's trace files and prints the same table for them.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.obs.trace import SPAN_CATEGORIES, TraceRecorder

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "category_table",
    "chrome_trace_dict",
    "load_trace",
    "summary_line",
    "summarize_text",
    "write_chrome_trace",
    "write_jsonl",
]

TRACE_SCHEMA_VERSION = 1


def chrome_trace_dict(rec: TraceRecorder, metrics: dict | None = None) -> dict:
    """The recorder as a Chrome trace-event JSON object (loads in
    Perfetto / chrome://tracing). ``metrics`` (a registry ``snapshot()``)
    rides along under ``otherData`` when given."""
    pid = os.getpid()
    tids = []
    events = [{
        "name": "process_name",
        "ph": "M",
        "pid": pid,
        "tid": 0,
        "args": {"name": "repro_torch"},
    }]
    for s in rec.spans:
        if s.tid not in tids:
            tids.append(s.tid)
        events.append({
            "name": s.name,
            "cat": s.category,
            "ph": "X",
            "ts": s.t0 * 1e6,        # trace-event timestamps are µs
            "dur": s.dur * 1e6,
            "pid": pid,
            "tid": tids.index(s.tid),
            "args": dict(s.args),
        })
    for i, _tid in enumerate(tids):
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": i,
            "args": {"name": "session" if i == 0 else f"worker-{i}"},
        })
    other = {
        "schemaVersion": TRACE_SCHEMA_VERSION,
        "epochUnix": rec.epoch_unix,
        "categories": list(SPAN_CATEGORIES),
    }
    if metrics is not None:
        other["metrics"] = metrics
    return {
        "schemaVersion": TRACE_SCHEMA_VERSION,
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": other,
    }


def write_chrome_trace(rec: TraceRecorder, path, metrics: dict | None = None) -> Path:
    path = Path(path)
    path.write_text(json.dumps(chrome_trace_dict(rec, metrics)))
    return path


def write_jsonl(rec: TraceRecorder, path) -> Path:
    """Header line (schema + epochs + span count), then one span per
    line in recording order."""
    path = Path(path)
    with path.open("w") as f:
        f.write(json.dumps({
            "schemaVersion": TRACE_SCHEMA_VERSION,
            "epochUnix": rec.epoch_unix,
            "spans": len(rec.spans),
        }) + "\n")
        for s in rec.spans:
            f.write(json.dumps({
                "cat": s.category,
                "name": s.name,
                "t0": s.t0,
                "dur": s.dur,
                "tid": s.tid,
                "depth": s.depth,
                "args": dict(s.args),
            }) + "\n")
    return path


def load_trace(path) -> dict:
    """Load either export back to one normalized shape:
    ``{"schemaVersion": int, "spans": [{cat, name, t0, dur}, ...]}``
    (seconds, like the recorder)."""
    path = Path(path)
    text = path.read_text()
    if path.suffix == ".jsonl" or "\n{" in text.strip():
        lines = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
        header, spans = lines[0], lines[1:]
        return {"schemaVersion": header.get("schemaVersion"), "spans": spans}
    blob = json.loads(text)
    spans = [
        {
            "cat": ev.get("cat"),
            "name": ev.get("name"),
            "t0": ev.get("ts", 0.0) / 1e6,
            "dur": ev.get("dur", 0.0) / 1e6,
            "tid": ev.get("tid"),
            "args": ev.get("args", {}),
        }
        for ev in blob.get("traceEvents", ())
        if ev.get("ph") == "X"
    ]
    return {"schemaVersion": blob.get("schemaVersion"), "spans": spans}


# ---- aggregation -------------------------------------------------------


def category_table(spans) -> list[dict]:
    """Per-category rows — count, total wall seconds, wall share —
    sorted by wall descending. ``spans`` is ``load_trace()["spans"]``
    or a recorder's span list."""
    agg: dict[str, list[float]] = {}
    for s in spans:
        cat = s["cat"] if isinstance(s, dict) else s.category
        dur = s["dur"] if isinstance(s, dict) else s.dur
        row = agg.setdefault(cat, [0, 0.0])
        row[0] += 1
        row[1] += dur
    total = sum(v[1] for v in agg.values()) or 1.0
    return sorted(
        (
            {"category": c, "count": n, "seconds": sec, "share": sec / total}
            for c, (n, sec) in agg.items()
        ),
        key=lambda r: -r["seconds"],
    )


def summary_line(rec: TraceRecorder) -> str:
    """The greppable one-liner the launch CLIs print:
    ``[trace] N spans over S.SSSs; top: cat 61%, cat 20%, cat 10%``."""
    rows = category_table(rec.spans)
    total = sum(r["seconds"] for r in rows)
    top = ", ".join(f"{r['category']} {r['share'] * 100:.0f}%" for r in rows[:3])
    return f"[trace] {len(rec.spans)} spans over {total:.3f}s; top: {top or 'none'}"


def summarize_text(path) -> str:
    """The ``repro_torch.launch.trace summarize`` table for one trace file."""
    blob = load_trace(path)
    rows = category_table(blob["spans"])
    out = [f"# trace {Path(path).name} (schema v{blob['schemaVersion']}, "
           f"{len(blob['spans'])} spans)"]
    out.append(f"{'category':<16} {'count':>6} {'seconds':>10} {'share':>7}")
    for r in rows:
        out.append(
            f"{r['category']:<16} {r['count']:>6} {r['seconds']:>10.4f} "
            f"{r['share'] * 100:>6.1f}%"
        )
    return "\n".join(out)
