"""PredictionService — batched predict() with request micro-batching.

Requests (from any thread, or from the HTTP front below) enqueue their
rows; one batcher thread drains the queue, coalescing everything that
arrives within ``max_wait_s`` of the first pending request (up to
``max_batch_rows``) into a *single* ``ModelStore.predict`` over one
pinned model snapshot. Heavy concurrent traffic therefore amortizes to
one matvec batch per tick, and every row in a coalesced batch is served
by the same model version — a hot swap lands between batches, never
inside one.

Two fronts, one batcher:

* in-process — ``service.predict(indices, values)`` (what the
  controller, tests, and benchmarks use; no sockets);
* HTTP — ``serve_http(service, port=0)``: a stdlib
  ``ThreadingHTTPServer`` with ``POST /predict``, ``GET /healthz``,
  ``GET /stats`` (no external deps).

The batcher thread does the device work (the store's gather-dot on the
store's device) while the caller's thread may be training on the same
device; requests and answers stay host numpy arrays.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["PredictResult", "PredictionService", "serve_http"]


@dataclasses.dataclass(frozen=True)
class PredictResult:
    """One request's answer: margins ``x·a`` per row, hard labels
    (sign, 0 → +1), and the model version that computed them."""

    margins: np.ndarray
    labels: np.ndarray
    model_version: int


@dataclasses.dataclass
class _Pending:
    indices: np.ndarray
    values: np.ndarray
    done: threading.Event
    result: PredictResult | None = None
    error: BaseException | None = None


class PredictionService:
    """The request micro-batcher over a ``ModelStore``.

    max_batch_rows  coalesce at most this many rows into one predict.
    max_wait_s      after the first pending request arrives, wait up to
                    this long for more before computing (the batching
                    window; latency floor under light load).
    """

    def __init__(self, store, max_batch_rows: int = 256, max_wait_s: float = 0.002):
        if max_batch_rows < 1:
            raise ValueError(f"max_batch_rows={max_batch_rows} must be ≥ 1")
        self.store = store
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = float(max_wait_s)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started_at = 0.0
        # counters (read by stats(); single-writer from the batcher)
        self.rows_served = 0
        self.batches = 0
        self.errors = 0

    # ---- lifecycle ----

    def start(self) -> "PredictionService":
        if self._thread is not None:
            raise RuntimeError("PredictionService already started")
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._batch_loop, name="predict-batcher", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "PredictionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- the request door ----

    def predict(
        self, indices, values, timeout: float | None = 10.0
    ) -> PredictResult:
        """Enqueue (B, width) ELL rows and wait for the coalesced
        answer. Thread-safe; rows from concurrent callers share one
        model application."""
        if self._thread is None:
            raise RuntimeError("PredictionService not started — use it as a context manager")
        indices = np.atleast_2d(np.asarray(indices, np.int32))
        values = np.atleast_2d(np.asarray(values, np.float32))
        if indices.shape != values.shape:
            raise ValueError(f"indices {indices.shape} != values {values.shape}")
        # a bad request fails alone, not the coalesced batch it would join
        self.store.check_ids(indices)
        pending = _Pending(indices=indices, values=values, done=threading.Event())
        self._q.put(pending)
        if not pending.done.wait(timeout):
            raise TimeoutError(f"prediction not answered within {timeout}s")
        if pending.error is not None:
            raise pending.error
        return pending.result

    # ---- the batcher ----

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            rows = first.indices.shape[0]
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(nxt)
                rows += nxt.indices.shape[0]
            self._answer(batch)

    def _answer(self, batch: list[_Pending]) -> None:
        # runs on the batcher thread: spans land via the trace seam's
        # module-level fallback; counters feed the serve gauges too.
        reg = obs_metrics.registry()
        total_rows = sum(p.indices.shape[0] for p in batch)
        try:
            with obs_trace.span("predict_batch", name=f"batch[{self.batches}]",
                                rows=int(total_rows), requests=len(batch)):
                width = max(p.indices.shape[1] for p in batch)
                idx = np.zeros((total_rows, width), np.int32)
                val = np.zeros_like(idx, dtype=np.float32)
                r = 0
                for p in batch:
                    b, w = p.indices.shape
                    idx[r : r + b, :w] = p.indices
                    val[r : r + b, :w] = p.values
                    r += b
                margins, version = self.store.predict(idx, val)
                labels = np.where(margins >= 0.0, 1.0, -1.0).astype(np.float32)
            r = 0
            for p in batch:
                b = p.indices.shape[0]
                p.result = PredictResult(
                    margins=margins[r : r + b],
                    labels=labels[r : r + b],
                    model_version=version,
                )
                r += b
            self.rows_served += r
            self.batches += 1
            reg.counter("serve.rows_served_total").inc(r)
            reg.counter("serve.batches_total").inc()
            reg.histogram("serve.batch_rows").observe(r)
        except BaseException as e:
            self.errors += 1
            reg.counter("serve.errors_total").inc()
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.done.set()

    # ---- per-stage metrics ----

    def stats(self) -> dict:
        elapsed = max(time.monotonic() - self._started_at, 1e-9)
        return {
            "rows_served": self.rows_served,
            "batches": self.batches,
            "errors": self.errors,
            "mean_batch_rows": self.rows_served / max(self.batches, 1),
            "predictions_per_sec": self.rows_served / elapsed,
            "model_version": self.store.version,
        }


# ---------------- stdlib HTTP front ----------------


def _rows_to_arrays(rows: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """JSON rows [{"idx": [...], "val": [...]}, ...] → padded ELL."""
    if not rows:
        raise ValueError("empty rows")
    width = max(max(len(r.get("idx", [])), 1) for r in rows)
    idx = np.zeros((len(rows), width), np.int32)
    val = np.zeros((len(rows), width), np.float32)
    for i, r in enumerate(rows):
        ri, rv = r.get("idx", []), r.get("val", [])
        if len(ri) != len(rv):
            raise ValueError(f"row {i}: idx/val length mismatch")
        idx[i, : len(ri)] = ri
        val[i, : len(rv)] = rv
    return idx, val


def serve_http(
    service: PredictionService, host: str = "127.0.0.1", port: int = 0
) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Expose a started ``PredictionService`` over HTTP. Returns the
    server (``server.server_address`` carries the bound port — pass
    ``port=0`` for an ephemeral one) and its daemon thread; call
    ``server.shutdown()`` to stop."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "model_version": service.store.version})
            elif self.path == "/stats":
                self._send(
                    200, {"service": service.stats(), "store": service.store.stats()}
                )
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                idx, val = _rows_to_arrays(payload.get("rows", []))
                res = service.predict(idx, val)
                self._send(
                    200,
                    {
                        "labels": res.labels.tolist(),
                        "margins": res.margins.tolist(),
                        "model_version": res.model_version,
                    },
                )
            except (ValueError, KeyError, TypeError, OverflowError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
            except RuntimeError as e:  # e.g. empty store
                self._send(503, {"error": str(e)})

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="predict-http", daemon=True
    )
    thread.start()
    return server, thread
