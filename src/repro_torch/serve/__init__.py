"""repro_torch.serve — the online serving plane.

The offline stack (spec → Session → rounds over a resident dataset)
gains its live half here:

* ``repro_torch.serve.stream``      — the streaming data plane: a
  ``StreamSource`` protocol (deterministic, replayable micro-batches),
  a drifting synthetic generator for concept-shift runs, and the
  bounded-queue ``StreamFeed`` that decouples ingest from training.
* ``repro_torch.serve.ingest``      — micro-batch → the executors'
  layouts (a team problem on the device, or column-local mesh shards).
* ``repro_torch.serve.store``       — ``ModelStore``: the serving-side
  model holder on a device; hot-swaps weights from integrity-hashed
  session checkpoints without ever exposing a torn model.
* ``repro_torch.serve.server``      — ``PredictionService``: batched
  ``predict()`` with request micro-batching, plus a stdlib-HTTP
  front (``serve_http``) for out-of-process clients.
* ``repro_torch.serve.controller``  — ``OnlineController``: interleaves
  serve and train on one ``Session`` (train-on-arrival, freshness
  policy for hot swaps, per-stage metrics).

Entry point: ``python -m repro_torch.launch.serve --spec spec.json``.
"""

from repro_torch.serve.stream import (
    DriftStream,
    MicroBatch,
    ReplayStream,
    StreamDesyncError,
    StreamFeed,
    StreamSource,
    make_stream_source,
)
from repro_torch.serve.store import ModelSnapshot, ModelStore
from repro_torch.serve.server import PredictionService, PredictResult, serve_http
from repro_torch.serve.controller import OnlineController, StageMetrics

__all__ = [
    "DriftStream",
    "MicroBatch",
    "ReplayStream",
    "StreamDesyncError",
    "StreamFeed",
    "StreamSource",
    "make_stream_source",
    "ModelSnapshot",
    "ModelStore",
    "PredictionService",
    "PredictResult",
    "serve_http",
    "OnlineController",
    "StageMetrics",
]
