"""Declarative experiment launcher: ``python -m repro_torch.launch.sweep``.

Drives the repro_torch.api front door from JSON spec files:

    PYTHONPATH=src python -m repro_torch.launch.sweep --spec spec.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec sweep.json --out results.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec spec.json --plan-only
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec sweep.json --resume ckpt/ --table
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec spec.json --objective squared_hinge --l2 1e-3
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec sweep.json --timed --out measured.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec sweep.json --calibrate measured.json --plan-only
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec spec.json --device cpu

The flags, printed lines and records are the reference CLI's
(``repro.launch.sweep``), plus ``--device``: where the points run
(default: the CUDA device; ``cpu`` runs the plain PyTorch versions).

The spec file holds one ``ExperimentSpec`` dict or a list of them (a
sweep). Each spec is cost-model planned (Eq. 4 breakdown + regime;
Eq. 5–6 autotune when the spec asks) and then run on its declared
backend through ``repro_torch.api.sweep`` — one process, shared dataset
cache across points.

``--plan-only`` stops after planning, which needs no device and no
dataset materialization. ``--resume DIR`` persists
each finished point's report under DIR keyed by spec content hash:
interrupt the sweep anywhere (Ctrl-C, preemption, ``--max-points``)
and re-invoke with the same ``--resume`` to continue — finished points
are rehydrated, never re-run. A point that keeps failing is retried per
its spec's ``FaultPolicy`` and then quarantined (``[quar ]`` line; the
record lands in the ``--out`` dump) while the rest of the sweep
completes. ``--table`` prints the paper-style time-to-loss table (§7.5)
over the collected reports.

The communication loop closes here too: ``--timed`` runs every spec
with the timed collectives (per-round wall seconds land in each
report's CommLedger — persist with ``--out``), and ``--calibrate
report.json`` fits Hockney constants from such a prior run
(repro_torch.costmodel.calibrate) and re-plans against the fitted
machine, printing the re-ranked prediction table. ``--calibrate``
requires ``--plan-only``: calibration re-ranks predictions, it never
changes what runs.

``--trace out.json`` records the whole run through the ``repro_torch.obs``
span seam and writes a Perfetto-loadable Chrome trace (plus a
``out.jsonl`` event log), printing a greppable ``[trace]`` summary
line — the observability twin of ``--timed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.api import ExperimentSpec, RunReport, calibrate, plan, sweep
from repro_torch.core.objective import OBJECTIVES
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def load_specs(path: Path) -> list[ExperimentSpec]:
    """One spec dict or a list of them → ExperimentSpecs (validated)."""
    raw = json.loads(path.read_text())
    if isinstance(raw, dict):
        raw = [raw]
    if not isinstance(raw, list):
        raise ValueError(f"{path}: expected a spec object or a list of them")
    return [ExperimentSpec.from_dict(d) for d in raw]


def _report_dicts(raw) -> list[dict]:
    """Report dicts from any shape this CLI emits: one report, a list
    of them (--out), or a SweepReport dump ({"reports": [...]})."""
    if isinstance(raw, dict):
        if "reports" in raw:
            return list(raw["reports"])
        return [raw]
    if isinstance(raw, list):
        return list(raw)
    raise ValueError("expected a report object, a list of them, or a sweep dump")


def load_calibration(path: Path):
    """Fit machine constants from a prior run's persisted report(s):
    every report with a timed CommLedger becomes one calibration point
    (``RunReport.calibration_point``)."""
    points = []
    for d in _report_dicts(json.loads(path.read_text())):
        if "spec" not in d or "backend" not in d:
            continue  # plan-only records are not reports
        pt = RunReport.from_dict(d).calibration_point()
        if pt is not None:
            points.append(pt)
    if not points:
        raise SystemExit(
            f"--calibrate {path}: no timed ledgers found — produce one with "
            f"`repro_torch.launch.sweep --spec ... --timed --out {path}`"
        )
    return calibrate(points)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.sweep", description="plan/run ExperimentSpecs from JSON"
    )
    ap.add_argument("--spec", required=True, type=Path, help="spec JSON (object or list)")
    ap.add_argument("--plan-only", action="store_true",
                    help="cost-model only — no build, no devices, no training")
    ap.add_argument("--out", type=Path, default=None,
                    help="write results here (plan-only: a JSON list of plan "
                         "records; run: the full SweepReport dump, quarantine "
                         "records included)")
    ap.add_argument("--resume", type=Path, default=None, metavar="DIR",
                    help="persist finished points here (keyed by spec content "
                         "hash) and skip them on re-invocation")
    ap.add_argument("--max-points", type=int, default=None, metavar="N",
                    help="run at most N unfinished points this invocation "
                         "(continue later with --resume)")
    ap.add_argument("--table", action="store_true",
                    help="print the paper-style time-to-loss table (§7.5)")
    ap.add_argument("--target-loss", type=float, default=None,
                    help="fallback target for --table points without a "
                         "stop.target_loss of their own")
    ap.add_argument("--objective", default=None, choices=sorted(OBJECTIVES),
                    help="override every loaded spec's convex objective "
                         "(repro_torch.core.objective registry)")
    ap.add_argument("--l2", type=float, default=None, metavar="LAMBDA",
                    help="override every loaded spec's L2 coefficient")
    ap.add_argument("--delay", type=int, default=None, metavar="D",
                    help="override every loaded spec's schedule.delay: the "
                         "DaSGD staleness D — (G, v) Allreduces issued at "
                         "bundle k are consumed at bundle k+D, overlapping "
                         "the collective with D bundles of Gram compute "
                         "(0 = synchronous; changes the iterates at D ≥ 1)")
    ap.add_argument("--timed", action="store_true",
                    help="run every spec with the timed collectives "
                         "(per-round wall into the report's CommLedger — "
                         "the --calibrate input)")
    ap.add_argument("--calibrate", type=Path, default=None, metavar="REPORT",
                    help="fit Hockney constants (α/β/γ) from a prior run's "
                         "report JSON (a --timed --out file) and plan "
                         "against the fitted machine instead of the preset "
                         "(requires --plan-only: calibration re-ranks "
                         "predictions, it does not change what runs)")
    ap.add_argument("--device", default=None,
                    help="where the points run (default: the CUDA device; "
                         "'cpu' for the CPU)")
    ap.add_argument("--trace", type=Path, default=None, metavar="OUT.json",
                    help="record the run through the repro_torch.obs tracing seam "
                         "and write a Chrome trace-event JSON here (loads in "
                         "Perfetto / chrome://tracing; a .jsonl event log "
                         "lands beside it)")
    args = ap.parse_args(argv)
    if args.calibrate is not None and not args.plan_only:
        # without this, the printed calibrated plans (incl. autotuned
        # schedules) would diverge from what the sweep then executes —
        # the run path plans with the preset machine.
        ap.error("--calibrate requires --plan-only")
    if args.trace is not None and args.plan_only:
        ap.error("--trace records a run — drop --plan-only")

    specs = load_specs(args.spec)
    override = {}
    if args.objective is not None:
        override["objective"] = args.objective
    if args.l2 is not None:
        override["l2"] = args.l2
    if args.timed:
        override["comm_timing"] = True
    if override:
        # replace() re-validates through __post_init__; the override
        # also moves each spec's content hash, so --resume dirs never
        # mix objectives (or timed with untimed runs).
        specs = [dataclasses.replace(s, **override) for s in specs]
    if args.delay is not None:
        # schedule-level override (same hash-moving property: a D ≥ 1
        # run never collides with a synchronous resume dir).
        specs = [
            dataclasses.replace(
                s, schedule=dataclasses.replace(s.schedule, delay=args.delay)
            )
            for s in specs
        ]

    calibration = None
    if args.calibrate is not None:
        calibration = load_calibration(args.calibrate)
        print(f"[cal  ] {calibration.summary()}", flush=True)

    records = []
    planned = []
    preset = [plan(s) for s in specs] if calibration is not None else None
    for i, spec in enumerate(specs):
        pl = plan(spec, calibration=calibration)
        planned.append(pl)
        print(f"[plan ] {pl.summary()}", flush=True)
        rec = {"spec": pl.spec.to_dict(),
               "predicted_total_s": pl.cost.total, "regime": pl.regime}
        if calibration is not None:
            rec["preset_total_s"] = preset[i].cost.total
            rec["calibration"] = calibration.to_dict()
        records.append(rec)
    if calibration is not None and len(planned) > 1:
        _print_reranked(planned, preset)
    if args.plan_only:
        _finish(args, records, f"{len(records)} spec(s) planned")
        return

    if args.trace is not None:
        with obs_trace.install() as rec:
            result = sweep(specs, resume_dir=args.resume, max_points=args.max_points,
                           device=args.device)
        obs_export.write_chrome_trace(
            rec, args.trace, metrics=obs_metrics.registry().snapshot()
        )
        obs_export.write_jsonl(rec, args.trace.with_suffix(".jsonl"))
        print(obs_export.summary_line(rec), flush=True)
    else:
        result = sweep(specs, resume_dir=args.resume, max_points=args.max_points,
                       device=args.device)
    for rep, was_resumed in zip(result.reports, result.resumed):
        tag = "skip " if was_resumed else "run  "
        print(f"[{tag}] {rep.summary()}", flush=True)
    for q in result.quarantined:
        print(f"[quar ] {q.name} ({q.spec_hash}) quarantined after "
              f"{q.attempts} attempt(s) at round {q.rounds_done}: {q.error}",
              flush=True)
    for h in result.skipped:
        print(f"[defer] point {h} not reached (--max-points); re-invoke with "
              f"--resume to finish", flush=True)
    if args.table and result.reports:
        print(result.time_to_loss_table(target=args.target_loss))
    # the full SweepReport dict (reports + quarantine records) is the
    # artifact CI uploads; _report_dicts/--calibrate accept this shape.
    _finish(args, result.to_dict(), result.summary())


def _print_reranked(planned, preset) -> None:
    """The calibrated ranking next to the preset one: which config the
    model now says to run, and whether the fitted constants moved it."""
    order_cal = sorted(range(len(planned)), key=lambda i: planned[i].cost.total)
    order_pre = sorted(range(len(preset)), key=lambda i: preset[i].cost.total)
    print(f"{'rank':>4s} {'point':24s} {'calibrated s/ep':>15s} "
          f"{'preset s/ep':>12s} {'preset rank':>11s}")
    for rank, i in enumerate(order_cal, 1):
        name = (planned[i].spec.name or planned[i].spec.dataset)[:24]
        moved = "" if order_pre[rank - 1] == i else "  ↕"
        print(f"{rank:>4d} {name:24s} {planned[i].cost.total:>15.4g} "
              f"{preset[i].cost.total:>12.4g} {order_pre.index(i) + 1:>11d}{moved}")


def _finish(args, records, summary: str) -> None:
    if args.out:
        args.out.write_text(json.dumps(records, indent=2))
        print(f"[done ] {summary} → {args.out}")
    else:
        print(f"[done ] {summary}")


if __name__ == "__main__":
    main()
