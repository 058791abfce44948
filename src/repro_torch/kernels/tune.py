"""The Gram kernel's autotuner: tuned launch shapes, cached on disk.

``schedule.bk=None`` opts a run into it. What it tunes depends on where
the run computes:

* **On the CPU** the bundle (G, v) is the plain ``ell_gram_and_v_blocked``
  panel walk, whose knobs are the reference's: the column-panel width
  ``bk`` and the row tile ``bm``. The tuner times it over the (bk, bm)
  grid by wall time and cross-checks each reading against the panel model
  (``repro_torch.launch.roofline.panel_roofline``): a candidate whose
  working set does not fit a block's shared memory on the card is skipped,
  and a reading below its bound is a timer glitch and discarded — as the
  reference's tuner does on its CPU.
* **On the card** the CUDA kernel ignores ``bk``/``bm``; it reads
  ``gram_geometry(sb, w, tile, ks)``. The tuner times every (tile, ks) the
  kernel supports (``supported_tile_ks``) by **device time** — the median
  of timed replays of a CUDA graph of several launches, so the host's
  launch cost (≈ 5× the kernel's time at the main bundle) is not in it —
  and cross-checks each reading against the function's own bound
  (``probe_bound``). The record keeps the reference's keys with
  ``bk``/``bm`` the static (512, None) and adds the winning ``tile`` and
  ``ks``. Only (tile, ks) is kept: the chunk, the table size and the shared
  memory follow from the width of each bundle the build produces
  (``PanelProfile.width`` is the mean row length, not the built ELL
  width). A profile whose timing bundle ``gram_route`` sends to the dense
  route (epsilon's) has no (tile, ks) to tune: the tuner times that route
  once, records ``route: "dense"`` and no tile or ks, so a Session reads no
  geometry from it.

The timing bundle has the profile's shape and **distinct column ids in
each row**, as every registered dataset has: a repeated id would send the
kernel down its atomic-merge path, which no dataset takes.

Cache keying is the reference's: ``cache_key`` hashes (profile, device
kind, kernel version) to the same string as the reference for equal
arguments. The port keeps its own ``KERNEL_VERSION`` and its own
directory (``default_cache_dir``), so neither package reads the other's
timings as its own. The card's device kind is
``cuda:<torch.cuda.get_device_name()>``, the CPU's ``cpu:cpu``. One JSON
file per key, written atomically, each with the full candidate table.

The heavy-tail rule (``select_gram_path``) is device-keyed: on the CPU a
width above ``HEAVY_TAIL_FACTOR``·s·b sends the bundle build to the dense
oracle, as the reference does; on the card the hash probe does not grow
with the column count and beat densify + matmul at every measured width
(``PERF.md``), so the card keeps the kernel (``CARD_HEAVY_TAIL_FACTOR``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.ell_gram import (
    default_tile_ks,
    dense_geometry,
    ell_gram_and_v,
    ell_gram_and_v_blocked,
    gram_geometry,
    gram_route,
    supported_tile_ks,
)
from repro_torch.launch.roofline import panel_roofline, probe_bound

__all__ = [
    "CARD_HEAVY_TAIL_FACTOR",
    "FALLBACK_BK",
    "FALLBACK_BM",
    "HEAVY_TAIL_FACTOR",
    "KERNEL_VERSION",
    "PanelProfile",
    "cache_key",
    "default_cache_dir",
    "device_kind",
    "heavy_tail_factor",
    "load_record",
    "lookup_panel",
    "resolve_panel",
    "select_gram_path",
    "store_record",
    "tune_panel",
    "tuned_geometry",
]

log = logging.getLogger("repro_torch.kernels.tune")

# Bump when the Gram kernel, its plain version or the geometry rule
# changes: the cache key folds this in, so every stale winner misses at
# once. The port numbers its own kernels from 100, apart from the JAX
# package's versions.
KERNEL_VERSION = 101

BK_CANDIDATES = (128, 256, 512, 1024)
BM_CANDIDATES = (None, 16, 32)

# Static fallback = the pre-autotune defaults.
FALLBACK_BK = 512
FALLBACK_BM = None


@dataclasses.dataclass(frozen=True)
class PanelProfile:
    """What the tuned shape depends on — and nothing else.

    rows      s·b, the bundle row count.
    width     ELL width hint — ⌈z̄⌉ from the dataset registry (the mean
              nnz/row: deterministic from stats, so plan() and the build
              agree; the max-width heavy-tail decision is separate, see
              ``select_gram_path``).
    n_local   per-shard column count ⌈n/p_c⌉.
    dense     registry dense flag (epsilon-style data: width = n).
    precision schedule precision ("fp32" | "bf16").
    """

    rows: int
    width: int
    n_local: int
    dense: bool = False
    precision: str = "fp32"

    @classmethod
    def from_stats(cls, stats, sched, p_c: int | None = None) -> "PanelProfile":
        """The deterministic profile of (DatasetStats, schedule, p_c).
        ``p_c`` defaults to the schedule's own (the simulated engine);
        pass the mesh's for the 2D mesh."""
        p_c = sched.p_c if p_c is None else p_c
        return cls(
            rows=sched.s * sched.b,
            width=max(int(np.ceil(stats.zbar)), 1),
            n_local=-(-stats.n // p_c),
            dense=bool(getattr(stats, "dense", False)),
            precision=sched.precision,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def device_kind(device=None) -> str:
    """The cache's device axis for the device a run computes on:
    ``cuda:<card name>`` or ``cpu:cpu``. ``device=None`` is the port's
    device rule: the CUDA device, or an error."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def cache_key(
    profile: PanelProfile,
    device: str | None = None,
    kernel_version: int = KERNEL_VERSION,
) -> str:
    """Content hash of (profile, device kind, kernel version) — the same
    string as the reference's for equal arguments."""
    device = device_kind() if device is None else device
    payload = json.dumps(
        {"profile": profile.to_dict(), "device": device, "kernel_version": kernel_version},
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def default_cache_dir() -> Path:
    """``$REPRO_TORCH_TUNE_CACHE``, else ``~/.cache/repro_torch/tune`` —
    apart from the JAX package's cache."""
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "tune"


def _record_path(key: str, cache_dir: Path | None = None) -> Path:
    return (default_cache_dir() if cache_dir is None else Path(cache_dir)) / f"{key}.json"


def load_record(key: str, cache_dir: Path | None = None) -> dict | None:
    p = _record_path(key, cache_dir)
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def store_record(record: dict, cache_dir: Path | None = None) -> Path:
    """Atomic write (tmp + rename): concurrent tuners race benignly."""
    p = _record_path(record["key"], cache_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=p.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return p


def _synthesize(profile: PanelProfile, max_n: int | None, device, seed: int = 0):
    """A timing bundle of the profile's shape: (rows, width) ELL rows
    whose column ids are distinct within each row, over ``n`` columns
    (the profile's, capped at ``max_n``)."""
    n = profile.n_local if max_n is None else min(profile.n_local, max_n)
    n = max(n, 8)
    width = min(profile.width, n)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=width, replace=False) for _ in range(profile.rows)])
    val = rng.standard_normal((profile.rows, width)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(idx.astype(np.int32)), to(val), to(x), n, width


def _wall_seconds(fn, repeats: int) -> float:
    """Median wall seconds of ``fn()`` on the CPU (one warm-up call)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _device_seconds(fn, repeats: int, inner: int = 20) -> float:
    """Device seconds of one ``fn()`` on the card: ``inner`` calls
    captured once into a CUDA graph, ``repeats`` replays timed with CUDA
    events, the median over the replays divided by ``inner``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e-3 / inner)
    return statistics.median(samples)


def _tune_cpu(profile, idx, val, x, n, width, repeats, bk_candidates, bm_candidates) -> list:
    """The reference's (bk, bm) sweep of the plain panel walk."""
    rows = profile.rows
    bks = sorted({min(bk, -(-n // 8) * 8) for bk in bk_candidates})
    bms = sorted({bm for bm in bm_candidates if bm is None or bm < rows},
                 key=lambda v: -1 if v is None else v)
    table = []
    for bk in bks:
        for bm in bms:
            rl = panel_roofline(rows, width, n, bk, bm, profile.precision)
            if not rl.fits_vmem:
                table.append({"bk": bk, "bm": bm, "skipped": "vmem", "vmem_bytes": rl.vmem_bytes})
                continue
            t = _wall_seconds(lambda: ell_gram_and_v_blocked(
                idx, val, x, n=n, bk=bk, bm=bm, precision=profile.precision), repeats)
            table.append({
                "bk": bk, "bm": bm, "measured_s": t,
                "attainable_s": rl.attainable_s, "dominant": rl.dominant,
                "vmem_bytes": rl.vmem_bytes,
                "skipped": "sub-roofline" if t < rl.attainable_s else None,
            })
    return table


def _tune_card(profile, idx, val, x, n, repeats, pairs) -> list:
    """Every supported (tile, ks) of the CUDA kernel, by device time."""
    bound = probe_bound(idx, val)
    rows, width = idx.shape
    default = default_tile_ks(rows)
    table = []
    for tile, ks in pairs:
        try:
            geo = gram_geometry(rows, width, tile, ks)
        except ValueError as err:
            table.append({"tile": tile, "ks": ks, "skipped": f"unsupported: {err}"})
            continue
        t = _device_seconds(lambda: ell_gram_and_v(
            idx, val, x, n=n, precision=profile.precision, geometry=(tile, ks)), repeats)
        table.append({
            "tile": tile, "ks": ks, "threads": geo.threads, "smem_bytes": geo.smem_bytes,
            "measured_s": t, "attainable_s": bound.attainable_s, "dominant": bound.bound_by,
            "default": (tile, ks) == default,
            "skipped": "sub-roofline" if t < bound.attainable_s else None,
        })
    return table


def _time_dense(profile, idx, val, x, n, repeats) -> list:
    """The dense route, the one launch a dense-routed profile has: its
    device time beside the bound, no (tile, ks)."""
    bound = probe_bound(idx, val)
    rows, _ = idx.shape
    geo = dense_geometry(rows, n, profile.precision)
    t = _device_seconds(lambda: ell_gram_and_v(idx, val, x, n=n, precision=profile.precision), repeats)
    return [{"route": "dense", "splits": geo.splits, "workspace_bytes": geo.workspace_bytes,
             "measured_s": t, "attainable_s": bound.attainable_s, "dominant": bound.bound_by,
             "skipped": "sub-roofline" if t < bound.attainable_s else None}]


def tune_panel(
    profile: PanelProfile,
    *,
    device: str | None = None,
    run_on=None,
    cache_dir: Path | None = None,
    force: bool = False,
    repeats: int = 3,
    max_n: int = 16384,
    bk_candidates: tuple = BK_CANDIDATES,
    bm_candidates: tuple = BM_CANDIDATES,
) -> dict:
    """Sweep the candidates for ``profile`` on ``run_on`` and cache the
    winner under ``device`` (the kind; default ``device_kind(run_on)``).

    Returns the cache record (reading the existing one unless ``force``):

        key, kernel_version, device, profile   — the cache identity
        bk, bm                                 — the winner (the card:
                                                 the static 512, None)
        tile, ks                               — the card's winner
                                                 (hash route only)
        route                                  — the card's route
        measured_s, attainable_s, efficiency   — winner's score + bound
        candidates                             — the full audited table

    ``run_on`` (a torch device; default: the CPU for a ``cpu:`` kind, else
    the CUDA device) says where to time: the CPU times the plain walk's
    (bk, bm) grid over at most ``max_n`` columns, the card every (tile, ks)
    the kernel supports over the profile's columns. A candidate that does not fit is skipped; a reading
    below its bound is discarded. If every candidate is filtered the
    static fallback is returned and nothing is cached."""
    if run_on is None:
        run_on = "cpu" if device is not None and device.startswith("cpu:") else None
    run_on = resolve_device(run_on)
    device = device_kind(run_on) if device is None else device
    key = cache_key(profile, device)
    if not force:
        hit = load_record(key, cache_dir)
        if hit is not None:
            return hit

    on_card = run_on.type == "cuda"
    idx, val, x, n, width = _synthesize(profile, None if on_card else max_n, run_on)
    route = gram_route(profile.rows, width, n) if on_card else None
    if route == "dense":
        table = _time_dense(profile, idx, val, x, n, max(repeats, 5))
    elif on_card:
        table = _tune_card(profile, idx, val, x, n, max(repeats, 5), supported_tile_ks())
    else:
        table = _tune_cpu(profile, idx, val, x, n, width, repeats, bk_candidates, bm_candidates)
    record = {
        "key": key, "kernel_version": KERNEL_VERSION, "device": device,
        "profile": profile.to_dict(), "bk": FALLBACK_BK, "bm": FALLBACK_BM,
        "measured_s": None, "attainable_s": None, "efficiency": None,
        "route": route, "candidates": table,
    }
    feasible = [c for c in table if c.get("skipped") is None]
    if not feasible:  # every candidate filtered: static fallback, uncached
        return {**record, "fallback": True}
    best = min(feasible, key=lambda c: c["measured_s"])
    record.update(measured_s=best["measured_s"], attainable_s=best["attainable_s"],
                  efficiency=best["attainable_s"] / best["measured_s"])
    if route == "hash":
        record.update(tile=best["tile"], ks=best["ks"])
    elif route is None:  # the CPU: the plain walk's (bk, bm)
        record.update(bk=best["bk"], bm=best["bm"])
    store_record(record, cache_dir)
    return record


def lookup_panel(
    profile: PanelProfile,
    *,
    device: str | None = None,
    cache_dir: Path | None = None,
) -> dict | None:
    """Read-only cache probe — what ``plan()`` reports from (planning
    never tunes)."""
    return load_record(cache_key(profile, device), cache_dir)


def resolve_panel(
    profile: PanelProfile,
    *,
    device: str | None = None,
    run_on=None,
    cache_dir: Path | None = None,
    allow_tune: bool = True,
) -> tuple[int, int | None]:
    """The build-time (bk, bm) for ``bk=None``: the cached winner for
    ``device`` (default ``device_kind(run_on)``) if present, a fresh sweep
    on ``run_on`` if allowed, the static (512, None) otherwise. On the card
    the record's (tile, ks) is ``tuned_geometry(lookup_panel(...))``."""
    if device is None:
        device = device_kind(run_on)
    rec = lookup_panel(profile, device=device, cache_dir=cache_dir)
    if rec is None and allow_tune:
        rec = tune_panel(profile, device=device, run_on=run_on, cache_dir=cache_dir)
    if rec is None:
        return FALLBACK_BK, FALLBACK_BM
    return int(rec["bk"]), None if rec["bm"] is None else int(rec["bm"])


def tuned_geometry(record: dict | None) -> tuple[int, int] | None:
    """The card's tuned (tile, ks) of a record, or None (a CPU record, a
    fallback, no record): what ``ell_gram_and_v(..., geometry=)`` takes."""
    if not record or record.get("tile") is None:
        return None
    return int(record["tile"]), int(record["ks"])


# ---- profile-driven gram-path selection (heavy-tailed ELL widths) ----

_GRAM_CHOICES_LOGGED: set[tuple] = set()

# w/sb above this, the plain walk's one-hot panel expansion (≈ w/sb × the
# dense densify cost) loses to the dense oracle: the reference's rule,
# kept on the CPU.
HEAVY_TAIL_FACTOR = 4
# On the card: None — no width sends the bundle to the dense oracle. The
# hash probe's work grows with the matching ids, not with n, and it beat
# densify + matmul at every measured width above 4·s·b in both modes
# (PERF.md, "heavy-tail rule"); the dense oracle would also turn a bf16
# schedule's (G, v) into fp32.
CARD_HEAVY_TAIL_FACTOR = None


def heavy_tail_factor(device: str | None = "cpu:cpu") -> int | None:
    """The rule's factor for a device kind (None: never flip)."""
    return CARD_HEAVY_TAIL_FACTOR if device and device.startswith("cuda:") else HEAVY_TAIL_FACTOR


def select_gram_path(width: int, rows: int, requested: str = "kernel",
                     device: str | None = "cpu:cpu") -> str:
    """Pick the (G, v) build for an ELL block of ``width`` at bundle size
    ``rows`` = s·b on ``device`` (a kind). Only the default "kernel"
    request (the reference's "pallas") is ever overridden — an explicit
    gram= choice is honored; a heavy-tailed width (w > factor·s·b, see
    ``heavy_tail_factor``) flips to the dense oracle. Logged once per
    (width, rows, device, verdict)."""
    if requested != "kernel":
        return requested
    factor = heavy_tail_factor(device)
    choice = "dense" if factor is not None and width > factor * rows else "kernel"
    tag = (width, rows, device, choice)
    if tag not in _GRAM_CHOICES_LOGGED:
        _GRAM_CHOICES_LOGGED.add(tag)
        if choice != requested:
            log.info(
                "gram auto-select: ELL width %d is heavy-tailed for s·b=%d "
                "(> %d×) on %s: using the dense oracle for (G, v)",
                width, rows, factor, device,
            )
        else:
            log.info("gram auto-select: ELL width %d at s·b=%d on %s: keeping the kernel",
                     width, rows, device)
    return choice
