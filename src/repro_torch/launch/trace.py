"""Trace-file inspector: ``python -m repro_torch.launch.trace``.

Reads a trace written by ``repro_torch.obs.export`` (or by the reference
package's ``repro.obs.export``: the formats are the same) — either the
Chrome trace-event JSON or the ``.jsonl`` event log — and prints the
per-category wall-share table:

    PYTHONPATH=src python -m repro_torch.launch.trace summarize out.json

For the interactive view, load the ``.json`` file directly in Perfetto
(https://ui.perfetto.dev) or chrome://tracing — this CLI is the
grep-able terminal complement.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.obs import export as obs_export


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.trace", description="inspect repro_torch.obs trace files"
    )
    sub = ap.add_subparsers(dest="command", required=True)
    sm = sub.add_parser(
        "summarize", help="per-category span count / wall seconds / share table"
    )
    sm.add_argument("path", type=Path, help="trace .json (Chrome) or .jsonl file")
    args = ap.parse_args(argv)

    if not args.path.exists():
        print(f"error: {args.path} does not exist", file=sys.stderr)
        return 2
    try:
        print(obs_export.summarize_text(args.path))
    except (ValueError, KeyError) as e:
        print(f"error: {args.path} is not a trace file: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
