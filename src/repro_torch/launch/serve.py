"""Serving-plane launcher: stream, train, and serve in one process.

``python -m repro_torch.launch.serve --spec examples/specs/serve_drift.json``
builds the spec's ``Session`` on ``--device`` (default: the CUDA device;
``--device cpu`` runs the plain PyTorch versions on the CPU), attaches its
declared stream source (``spec.stream``), starts the batched prediction
service over a ``ModelStore`` on the same device (plus the stdlib HTTP
front when ``--port`` is given), and runs the ``OnlineController``
interleave loop: one training round per micro-batch, hot-swapping the
served model per the freshness policy, probing held-out accuracy against
the stream's current concept as it goes. The probe lines make drift
recovery visible:

    [probe] round=12 acc=0.91 model_version=4 ...
    [swap ] round=16 version=5 ...

The flags, the printed lines and the ``--out`` payload keys are the
reference CLI's (``repro.launch.serve``), plus ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.api import ExperimentSpec, Session
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import (
    DriftStream,
    ModelStore,
    OnlineController,
    PredictionService,
    make_stream_source,
    serve_http,
)


def probe_accuracy(service: PredictionService, source, batch_index: int) -> float:
    """Held-out accuracy against the stream's *current* concept: draw a
    fresh micro-batch (an index the trainer never consumes) and compare
    the service's labels to the generator's."""
    batch = source.batch(batch_index)
    res = service.predict(batch.indices, batch.values)
    return float(np.mean(res.labels == batch.y))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="stream → train → hot-swap → predict, one process"
    )
    ap.add_argument("--spec", required=True, help="ExperimentSpec JSON (with stream)")
    ap.add_argument("--rounds", type=int, default=None, help="stream rounds to train")
    ap.add_argument("--port", type=int, default=None,
                    help="also serve HTTP on this port (0 = ephemeral)")
    ap.add_argument("--swap-every", type=int, default=None,
                    help="override the spec's freshness cadence")
    ap.add_argument("--probe-every", type=int, default=4,
                    help="probe served accuracy every N rounds (0 = off)")
    ap.add_argument("--swap-dir", default=None, help="where swap checkpoints land")
    ap.add_argument("--out", default=None, help="write final metrics JSON here")
    ap.add_argument("--device", default=None,
                    help="where the session and the served model run "
                         "(default: the CUDA device; 'cpu' for the CPU)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the run through the repro_torch.obs tracing seam "
                         "and write a Chrome trace-event JSON here (loads in "
                         "Perfetto; a .jsonl event log lands beside it)")
    args = ap.parse_args(argv)

    spec = ExperimentSpec.from_json(Path(args.spec).read_text())
    if not spec.stream.enabled:
        ap.error("spec has no stream attached (stream.source='')")
    source = make_stream_source(spec)

    session = Session(spec, device=args.device)
    store = ModelStore(device=args.device)
    http_server = None
    # the recorder installs as the module-global fallback too, so spans
    # from the feed producer and predict-batcher threads land in it.
    recorder = obs_trace.TraceRecorder() if args.trace else None
    with contextlib.ExitStack() as stack:
        if recorder is not None:
            stack.enter_context(obs_trace.install(recorder))
        service = stack.enter_context(PredictionService(store))
        if args.port is not None:
            http_server, _ = serve_http(service, port=args.port)
            host, port = http_server.server_address[:2]
            print(f"[serve] http://{host}:{port}  (POST /predict, GET /healthz /stats)")

        ctrl = OnlineController(
            session, source, store, service=service,
            swap_every=args.swap_every, swap_dir=args.swap_dir,
        )
        rounds = args.rounds if args.rounds is not None else session.total_rounds
        print(
            f"[start] dataset={spec.dataset} stream={spec.stream.source} "
            f"rows/round={spec.stream_rows_per_round()} rounds={rounds} "
            f"swap_every={ctrl.swap_every}"
        )

        # drive round-by-round so probes and swap lines interleave live
        t0 = time.perf_counter()
        done = 0
        probing = args.probe_every > 0 and isinstance(source, DriftStream)
        while done < rounds and not session.done:
            before = store.swaps
            ev = ctrl.step()
            done += 1
            if store.swaps > before:
                print(f"[swap ] round={session.rounds_done} version={store.version}")
            if probing and session.rounds_done % args.probe_every == 0:
                acc = probe_accuracy(service, source, session.rounds_done)
                loss = session.losses[-1] if session.losses else float("nan")
                print(
                    f"[probe] round={session.rounds_done} acc={acc:.3f} "
                    f"holdout_loss={loss:.4f} model_version={store.version}"
                )
            if ev.stop:
                break

        m = ctrl.finish()
        elapsed = time.perf_counter() - t0
        print(
            f"[done ] rounds={m.rounds_done} swaps={m.swaps} "
            f"failed_swaps={m.failed_swaps} staleness={m.staleness_rounds} "
            f"rounds/s={m.rounds_per_sec:.2f} "
            f"predictions={m.predictions_served} wall={elapsed:.1f}s"
        )
        if args.out:
            payload = {"metrics": m.to_dict(), "feed": ctrl.feed.stats(),
                       "service": service.stats(), "store": store.stats()}
            Path(args.out).write_text(json.dumps(payload, indent=2))
            print(f"[out  ] {args.out}")
        if http_server is not None:
            http_server.shutdown()
    if recorder is not None:
        out = Path(args.trace)
        obs_export.write_chrome_trace(
            recorder, out, metrics=obs_metrics.registry().snapshot()
        )
        obs_export.write_jsonl(recorder, out.with_suffix(".jsonl"))
        print(obs_export.summary_line(recorder), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
