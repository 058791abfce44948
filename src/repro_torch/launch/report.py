"""The roofline markdown table of the port's dry run, from
results/dryrun_torch/*.json (``launch/dryrun.py``): the reference's
``repro.launch.report`` with the same columns. The terms are predictions
against the NVIDIA H100 SXM's published peaks (``launch/roofline.py``), not
measurements.

    PYTHONPATH=src python -m repro_torch.launch.report > results/roofline_table_torch.md
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import roofline as rl

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}µs"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None, help=f"the records' directory (default {RESULTS})")
    args = ap.parse_args(argv)
    results = Path(args.results) if args.results else RESULTS
    recs = [json.loads(f.read_text()) for f in sorted(results.glob("*.json"))]
    singles = {
        (r["arch"], r["shape"]): r for r in recs if r["mesh"].startswith(("16x16", "single"))
    }
    multis = {
        (r["arch"], r["shape"]): r for r in recs if r["mesh"].startswith(("2x16x16", "multi"))
    }

    print(f"Predictions against the H100 SXM's published peaks: {rl.PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s bf16, "
          f"{rl.HBM_BW / 1e12:g} TB/s HBM, {rl.LINK_BW / 1e9:g} GB/s a GPU between nodes; "
          f"{rl.HBM_BYTES / 1e9:g} GB HBM a card.\n")
    print("| arch | shape | compute | memory | collective | dominant | useful | peak GB (1-pod) | multi-pod |")
    print("|------|-------|--------:|-------:|-----------:|----------|-------:|----------------:|-----------|")
    archs = sorted({a for a, _ in singles})
    n_ok = n_skip = 0
    for arch in archs:
        for shape in SHAPE_ORDER:
            r = singles.get((arch, shape))
            if r is None:
                continue
            m = multis.get((arch, shape), {})
            mstat = m.get("status", "—")
            if mstat == "ok":
                mpk = m.get("memory", {}).get("peak_bytes", 0) / 1e9
                mcell = f"ok ({mpk:.1f} GB)"
            elif mstat == "skipped":
                mcell = "skip"
            else:
                mcell = mstat
            if r["status"] == "skipped":
                n_skip += 1
                print(f"| {arch} | {shape} | — | — | — | SKIP: {r['reason'][:44]} | — | — | {mcell} |")
                continue
            if r["status"] != "ok":
                print(f"| {arch} | {shape} | FAILED | | | | | | {mcell} |")
                continue
            n_ok += 1
            pk = r["memory"]["peak_bytes"] / 1e9
            ro = r.get("roofline")
            if ro is None:
                print(f"| {arch} | {shape} | | | | (memory only) | | {pk:.2f} | {mcell} |")
                continue
            print(
                f"| {arch} | {shape} | {fmt_s(ro['compute_s'])} | {fmt_s(ro['memory_s'])} "
                f"| {fmt_s(ro['collective_s'])} | **{ro['dominant']}** "
                f"| {ro['useful_ratio']:.2f} | {pk:.2f} | {mcell} |"
            )
    print(f"\n{n_ok} combinations counted with roofline terms; {n_skip} skipped (sub-quadratic rule).")

    # dominant-term census + hillclimb candidates
    rows = [r["roofline"] | {"peak": r["memory"]["peak_bytes"]} for r in singles.values()
            if r.get("status") == "ok" and "roofline" in r]
    if rows:
        doms = {}
        for ro in rows:
            doms[ro["dominant"]] = doms.get(ro["dominant"], 0) + 1
        print(f"\nDominant-term census: {doms}")
        worst_useful = min(rows, key=lambda ro: ro["useful_ratio"] if ro["useful_ratio"] > 0 else 9)
        most_coll = max(rows, key=lambda ro: ro["collective_s"] / max(ro["compute_s"], 1e-12))
        print(f"Worst useful-flops ratio: {worst_useful['arch']}/{worst_useful['shape']} "
              f"({worst_useful['useful_ratio']:.2f})")
        print(f"Most collective-bound: {most_coll['arch']}/{most_coll['shape']} "
              f"(coll/compute = {most_coll['collective_s'] / max(most_coll['compute_s'], 1e-12):.1f})")


if __name__ == "__main__":
    main()
