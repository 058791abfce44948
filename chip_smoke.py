#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the GPU, drives the port's main path
(the simulated HybridSGD engine) on the full-size synthetic ``rcv1``
dataset through the entry points a user calls, checks that the path went
through both kernels, times them, and prints

  * the GPU's name and power limit,
  * one JSON line ``{"kernels": [...]}`` with every kernel's launches on
    the main path, error against its plain version, time, plain time,
    bound and library yardstick,
  * as the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also traces one more run of the main
path with ``torch.profiler`` and prints the device time by kernel.

Any failed phase ends the process with a non-zero exit code; there is no
CPU mode: without a CUDA device the script fails at once.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): the bounds below are
# stated against these, with the card's power limit printed beside them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

GV_TOL = 1e-3  # rtol = atol for (G, v): float32 sums taken in another order
U_TOL = 1e-5  # rtol = atol for u: expf vs exp and the order of short dots
# max |Δx| over max |x| between two runs of one schedule on the card (kernels
# against plain versions, or the same path twice): float32 sums in another
# order, the atomic adds of the Yᵀu scatter among them. Phase 4 also shows
# that both limits can fail: it repeats the runs with a Gram matrix off by 1 %
# and requires the gaps to land outside them.
X_TOL = 5e-6
IDENTITY_TOL = 1e-6  # max |Δx|, s-step against mini-batch SGD

# the main path: full-size rcv1 (m = 20,242, n = 47,236, z̄ = 74), 4 row teams
DATASET = "rcv1"
P_R, S, B, TAU, ROUNDS, ETA = 4, 4, 32, 32, 8, 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED — {what}")


def sync() -> None:
    torch.cuda.synchronize()


def _median_ms(run, per: int, reps: int) -> float:
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        sync()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def eager_ms(fn, *, inner: int, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` eager calls
    ``fn(k)`` each: the larger of the device time and the host's time to
    enqueue the call."""
    for k in range(warmup):
        fn(k)
    sync()
    counter = iter(range(10**9))
    return _median_ms(lambda: [fn(next(counter)) for _ in range(inner)], inner, reps)


def device_ms(fn, *, inner: int, reps: int = 20) -> float:
    """Device time of one call: ``inner`` calls ``fn(k)`` are captured into
    a CUDA graph once, and the median over ``reps`` timed replays is
    divided by ``inner`` — no host enqueue time in it."""
    fn(0)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(inner):
            fn(k)
    graph.replay()
    sync()
    return _median_ms(graph.replay, inner, reps)


def profile_main_path(run, rounds: int) -> None:
    """``--profile``: trace one more run of the main path and print where
    the device time went, by kernel name, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_rows, host_rows = [], []
    for ev in prof.key_averages():
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(ev, "self_cuda_time_total", 0.0)
        if str(ev.device_type).endswith("CUDA"):  # a kernel, not the op that launched it
            if self_us > 0:
                device_rows.append((self_us, ev.count, ev.key))
        elif ev.self_cpu_time_total > 0:
            host_rows.append((ev.self_cpu_time_total, ev.count, ev.key))
    busy_us = sum(r[0] for r in device_rows)
    host_us = sum(r[0] for r in host_rows)
    check(busy_us > 0, "the profiler recorded no device time")
    log(f"[profile] {rounds} rounds under the profiler: wall {wall_us / rounds / 1e3:.3f} ms a round, device busy "
        f"{busy_us / rounds / 1e3:.3f} ms a round = {busy_us / wall_us:.1%} of the wall time (idle {1 - busy_us / wall_us:.1%}); "
        f"host time inside traced operators {host_us / rounds / 1e3:.3f} ms a round")
    for self_us, count, key in sorted(device_rows, reverse=True)[:10]:
        log(f"[profile] device {self_us / rounds:9.1f} us a round  {self_us / busy_us:6.1%}  {count / rounds:6.1f} a round  {key[:80]}")
    for self_us, count, key in sorted(host_rows, reverse=True)[:10]:
        log(f"[profile] host   {self_us / rounds:9.1f} us a round  {self_us / wall_us:6.1%} of wall  {count / rounds:6.1f} a round  {key[:80]}")


def errors(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float, bool]:
    """(max abs error, max rel error, allclose at rtol = atol = tol)."""
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-30)).where(want != 0, torch.zeros_like(diff)).max())
    return max_abs, max_rel, bool(torch.all(diff <= tol + tol * want.abs()))


def matching_pairs(idx: torch.Tensor, val: torch.Tensor, n: int) -> float:
    """Σ_{i>j} of the nonzero entries of rows i and j that share a column id:
    the products G needs on this bundle, whatever the kernel's design."""
    nz = val != 0
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)[nz]
    cols = idx[nz].long()
    per_col = torch.unique(cols, return_counts=True)[1].double()
    per_cell = torch.unique(rows * n + cols, return_counts=True)[1].double()
    return float(((per_col ** 2).sum() - (per_cell ** 2).sum()) / 2)


def random_bundle(sb: int, w: int, n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(sb, w)).astype(np.int32)
    if w >= 2:  # duplicate ids inside a row, always
        idx[:, 1] = idx[:, 0]
    val = rng.standard_normal((sb, w)).astype(np.float32) / math.sqrt(w)
    val[:, w - (w // 4):] = 0.0  # a padded tail, as ELL rows have
    idx[:, w - (w // 4):] = 0
    x = rng.standard_normal(n).astype(np.float32)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device),
            torch.from_numpy(x).to(device))


def main() -> None:
    # ---- phase 1: device ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED — torch.cuda.is_available() is False; this run needs a GPU")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(bool(smi), "nvidia-smi printed nothing")
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.core import engine
    from repro_torch.core.engine import ParallelSGDSchedule, run_engine_chunk, run_parallel_sgd
    from repro_torch.core.teams import stack_row_teams
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_gram import ell_gram_and_v, ell_gram_and_v_blocked
    from repro_torch.kernels.ref import densify_bundle_ref, ell_gram_and_v_ref
    from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref
    from repro_torch.sparse.ell import EllBlock, ell_rmatvec
    from repro_torch.sparse.synthetic import make_dataset

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernels with {_build.find_nvcc()} in {build_s:.1f} s → {_build.build_dir()}")

    t0 = time.perf_counter()
    ds = make_dataset(DATASET, seed=0)
    tp = stack_row_teams(ds.A, ds.y, P_R, row_multiple=S * B)  # device=None: the card
    log(f"[main] {DATASET}: m = {ds.A.m}, n = {ds.A.n}, nnz/row = {ds.A.zbar:.1f}; teams {tuple(tp.indices.shape)} "
        f"on {tp.values.device} ({time.perf_counter() - t0:.1f} s to generate and stack)")
    check(tp.values.is_cuda and tp.values.dtype == torch.float32, "the problem is not float32 on the card")

    # ---- phase 3: each kernel against its plain version, on the card ----
    gram_err = 0.0
    for case, (sb, w, n) in enumerate(
        [(8, 1, 10), (64, 24, 1999), (128, 111, 47236), (512, 111, 47236), (128, 540, 1355191)]
    ):
        idx, val, x = random_bundle(sb, w, n, 100 + case, device)
        g, v = ell_gram_and_v(idx, val, x, n=n)
        sync()
        check(g.shape == (sb, sb) and v.shape == (sb,), f"ell_gram shapes at {(sb, w, n)}")
        check(bool(torch.all(torch.triu(g) == 0)), f"ell_gram: triu(G) != 0 at {(sb, w, n)}")
        pg, pv = ell_gram_and_v_blocked(idx, val, x, n=n, bk=512)
        og, ov = ell_gram_and_v_ref(idx, val, x, n) if sb * n < 2**28 else (pg, pv)
        worst = 0.0
        for got, want, name in ((g, pg, "G~plain"), (v, pv, "v~plain"), (g, og, "G~dense"), (v, ov, "v~dense")):
            max_abs, max_rel, ok = errors(got, want, GV_TOL)
            check(ok and math.isfinite(max_abs), f"ell_gram {name} at {(sb, w, n)}: max abs {max_abs}, max rel {max_rel}")
            worst = max(worst, max_abs)
        gram_err = max(gram_err, worst)
        log(f"[kernels] ell_gram    (sb, w, n) = {(sb, w, n)}: max abs err {worst:.3g} (tol {GV_TOL})")

    inner_err = 0.0
    for case, (s, b) in enumerate([(1, 8), (4, 32), (8, 16), (16, 32)]):
        for eta in (0.05, 1.0):
            rng = np.random.default_rng(200 + case)
            sb = s * b
            y = rng.standard_normal((sb, 200)).astype(np.float32) / math.sqrt(200)
            g = torch.from_numpy(np.tril(y @ y.T, -1).astype(np.float32)).to(device)
            v = torch.from_numpy(rng.standard_normal(sb).astype(np.float32)).to(device)
            u = sstep_inner(g, v, s, b, eta)
            sync()
            max_abs, max_rel, ok = errors(u, sstep_inner_ref(g, v, s, b, eta), U_TOL)
            check(ok and math.isfinite(max_abs), f"sstep_inner at (s, b, eta) = {(s, b, eta)}: max abs {max_abs}, max rel {max_rel}")
            inner_err = max(inner_err, max_abs)
            log(f"[kernels] sstep_inner (s, b, eta) = {(s, b, eta)}: max abs err {max_abs:.3g} (tol {U_TOL})")

    # both kernels on the bundles the main path feeds them: real rows of the
    # dataset (sorted ids, a ragged padded tail) and a nonzero iterate
    x_real = torch.from_numpy(np.random.default_rng(300).standard_normal(tp.n).astype(np.float32) * 0.1).to(device)
    for team, r0 in ((0, 0), (P_R - 1, tp.rows_local - S * B)):
        idx, val = tp.indices[team, r0 : r0 + S * B], tp.values[team, r0 : r0 + S * B]
        g, v = ell_gram_and_v(idx, val, x_real, n=tp.n)
        check(bool(torch.all(torch.triu(g) == 0)), f"ell_gram: triu(G) != 0 on {DATASET} rows")
        pg, pv = ell_gram_and_v_blocked(idx, val, x_real, n=tp.n, bk=512)
        check(float(pg.abs().max()) > 0, f"the {DATASET} bundle has an empty Gram matrix")
        for got, want, name in ((g, pg, "G"), (v, pv, "v")):
            max_abs, max_rel, ok = errors(got, want, GV_TOL)
            check(ok and math.isfinite(max_abs), f"ell_gram {name} on {DATASET} rows: max abs {max_abs}, max rel {max_rel}")
            gram_err = max(gram_err, max_abs)
        max_abs, max_rel, ok = errors(sstep_inner(pg, pv, S, B, ETA), sstep_inner_ref(pg, pv, S, B, ETA), U_TOL)
        check(ok and math.isfinite(max_abs), f"sstep_inner on {DATASET} rows: max abs {max_abs}, max rel {max_rel}")
        inner_err = max(inner_err, max_abs)
    log(f"[kernels] both kernels on {DATASET} bundles (team 0 first rows, team {P_R - 1} last rows): "
        f"worst so far ell_gram {gram_err:.3g}, sstep_inner {inner_err:.3g}")

    # ---- phase 4: the main path at full width ---------------------------
    sched = ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, loss_every=1)
    check(sched.gram == "kernel", "the default gram backend is not the kernel")
    x0 = torch.zeros(tp.n, dtype=torch.float32, device=device)
    expected = ROUNDS * P_R * (TAU // S)

    ell_gram_and_v.launches = 0
    sstep_inner.launches = 0
    x_kernel, losses = run_parallel_sgd(tp, x0, sched)
    launches = {"ell_gram": ell_gram_and_v.launches, "sstep_inner": sstep_inner.launches}
    sync()
    losses_host = [float(t) for t in losses]
    log(f"[main] losses by round: {' '.join(f'{t:.5f}' for t in losses_host)}")
    log(f"[main] launches on the main path: {launches} (expected {expected} each)")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")
        check(count == expected, f"{name}: {count} launches, expected rounds·p_r·τ/s = {expected}")
    check(x_kernel.shape == (tp.n,) and bool(torch.isfinite(x_kernel).all()), "final x is not finite (n,)")
    check(len(losses_host) == ROUNDS and all(math.isfinite(t) for t in losses_host), "losses are not finite")
    check(losses_host[0] < math.log(2.0), f"first loss {losses_host[0]} is not below ln 2")
    check(losses_host[-1] < losses_host[0], "the loss did not fall")

    # the same schedule on the card with the plain versions only: the blocked
    # panel walk for (G, v) and the PyTorch loop for the corrections (the
    # engine looks `inner_corrections` up when it is called; the launch counts
    # checked below would show a kernel that stayed on this run)
    kernel_dispatch = engine.inner_corrections
    engine.inner_corrections = engine.inner_corrections_loop
    try:
        x_plain, losses_plain = run_parallel_sgd(
            tp, x0, ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS,
                                               loss_every=1, gram="blocked"))
    finally:
        engine.inner_corrections = kernel_dispatch
    sync()
    check(ell_gram_and_v.launches == expected and sstep_inner.launches == expected,
          "the plain run launched a kernel")
    x_max = float(x_plain.abs().max())
    path_gap = float((x_kernel - x_plain).abs().max())
    log(f"[main] kernels vs plain versions end to end: max |Δx| = {path_gap:.3g} with max |x| = {x_max:.3g} "
        f"(limit {X_TOL:g}·max |x| = {X_TOL * x_max:.3g}), max |Δloss| = {float((losses - losses_plain).abs().max()):.3g}")
    check(x_max > 0 and path_gap <= X_TOL * x_max, f"final x of the kernel path is {path_gap} from the plain path's")

    # s-step ≡ mini-batch SGD, through the kernels
    tp1 = stack_row_teams(ds.A, ds.y, 1, row_multiple=128)
    x_ss, _ = run_parallel_sgd(tp1, x0, ParallelSGDSchedule.sstep(8, 16, ETA, 64))
    x_sgd, _ = run_parallel_sgd(tp1, x0, ParallelSGDSchedule.mb_sgd(16, ETA, 64))
    gap = float((x_ss - x_sgd).abs().max())
    log(f"[main] s-step (s = 8, b = 16, 64 iterations) vs mini-batch SGD: identity gap {gap:.3g}")
    check(gap <= IDENTITY_TOL, f"s-step ≡ SGD identity gap {gap} > {IDENTITY_TOL}")

    # both limits have teeth: with G off by 1 % the same two comparisons must fail
    true_gram = engine.bundle_gram_v

    def skewed_gram(*args, **kwargs):
        g, v = true_gram(*args, **kwargs)
        return g * 1.01, v

    engine.bundle_gram_v = skewed_gram
    try:
        x_skew, _ = run_parallel_sgd(tp, x0, sched)
        x_ss_skew, _ = run_parallel_sgd(tp1, x0, ParallelSGDSchedule.sstep(8, 16, ETA, 64))
    finally:
        engine.bundle_gram_v = true_gram
    skew_gap = float((x_skew - x_plain).abs().max())
    skew_identity_gap = float((x_ss_skew - x_sgd).abs().max())
    log(f"[main] with G off by 1 %: max |Δx| to the plain path {skew_gap:.3g} (limit {X_TOL * x_max:.3g}), "
        f"identity gap {skew_identity_gap:.3g} (limit {IDENTITY_TOL:g})")
    check(skew_gap > X_TOL * x_max and skew_identity_gap > IDENTITY_TOL,
          "a Gram matrix wrong by 1 % passes the end-to-end limits: they are too loose")

    # run to run: every G element has one writer, but the Yᵀu scatter-add
    # sums with atomics, so two runs agree to the tolerance, not to the bit
    x_again = run_engine_chunk(tp, x0, 0, ROUNDS, sched)
    rerun_gap = float((x_again - x_kernel).abs().max())
    log(f"[main] second run of the main path: max |Δx| = {rerun_gap:.3g} (limit {X_TOL * x_max:.3g})")
    check(rerun_gap <= X_TOL * x_max, f"two runs of the main path differ by {rerun_gap}")

    # ---- phase 5: times --------------------------------------------------
    def round_wall_ms() -> float:
        sync()
        t0 = time.perf_counter()
        run_engine_chunk(tp, x0, 0, ROUNDS, sched)
        sync()
        return (time.perf_counter() - t0) * 1e3 / ROUNDS

    round_ms = statistics.median(round_wall_ms() for _ in range(5))
    log(f"[times] main path: {round_ms:.3f} ms per round of {P_R} teams × {TAU // S} bundles (wall, median of 5 runs of {ROUNDS})")

    team_idx, team_val = tp.indices[0], tp.values[0]
    rows_local = tp.rows_local
    x_now = x_kernel
    report = {}
    for sb, s, b in ((S * B, S, B), (512, 16, 32)):
        offsets = list(range(0, rows_local - sb + 1, sb))

        def bundle(k):
            r0 = offsets[k % len(offsets)]
            return team_idx[r0 : r0 + sb], team_val[r0 : r0 + sb]

        w = int(team_idx.shape[1])
        def gram(k):
            return ell_gram_and_v(*bundle(k), x_now, n=tp.n)

        gram_ms = device_ms(gram, inner=len(offsets))  # one pass over the team's bundles
        gram_eager_ms = eager_ms(gram, inner=10)
        gram_plain_ms = eager_ms(lambda k: ell_gram_and_v_blocked(*bundle(k), x_now, n=tp.n, bk=512), inner=1, warmup=1)

        def library(k):
            dense = densify_bundle_ref(*bundle(k), tp.n)
            return torch.tril(dense @ dense.T, diagonal=-1), dense @ x_now

        gram_lib_ms = eager_ms(library, inner=2)
        g, v = gram(0)

        def corrections(k):
            return sstep_inner(g, v, s, b, ETA)

        inner_ms = device_ms(corrections, inner=20)
        inner_eager_ms = eager_ms(corrections, inner=10)
        inner_plain_ms = eager_ms(lambda k: sstep_inner_ref(g, v, s, b, ETA), inner=1, warmup=1)

        # bounds from this run's inputs (bundle 0): bytes each read or written
        # once over the memory rate, against the FP32 operations that (G, v)
        # needs over the FP32 rate: one multiply-add per pair of nonzeros of
        # rows i > j that share a column id, one per nonzero for v. The
        # kernel's design compares every pair of nonzeros of every row pair;
        # that count is printed beside the bound, not as it.
        bi, bv = bundle(0)
        nnz = (bv != 0).sum(dim=1).double()
        gram_bytes = bi.numel() * 8 + int(torch.unique(bi).numel()) * 4 + sb * sb * 4 + sb * 4
        gram_flop = 2.0 * matching_pairs(bi, bv, tp.n) + 2.0 * float(nnz.sum())
        gram_bound = {"bytes": gram_bytes / HBM_BYTES_PER_S * 1e3, "operations": gram_flop / FP32_FLOP_PER_S * 1e3}
        design_compares = float((nnz.sum() ** 2 - (nnz ** 2).sum()) / 2)  # Σ_{i>j} nnz_i·nnz_j
        gram_design_ms = design_compares / FP32_FLOP_PER_S * 1e3  # at one compare per FP32 lane and cycle
        tri = b * b * s * (s - 1) // 2  # entries of G's strict lower block triangle
        inner_bytes = tri * 4 + 2 * sb * 4
        inner_flop = 2.0 * tri + 8.0 * sb
        inner_bound = {"bytes": inner_bytes / HBM_BYTES_PER_S * 1e3, "operations": inner_flop / FP32_FLOP_PER_S * 1e3}

        report[sb] = {
            "ell_gram": dict(ms=gram_ms, eager_ms=gram_eager_ms, plain_ms=gram_plain_ms,
                             library_ms=gram_lib_ms, bound=gram_bound, design_ops_ms=gram_design_ms),
            "sstep_inner": dict(ms=inner_ms, eager_ms=inner_eager_ms, plain_ms=inner_plain_ms,
                                library_ms=None, bound=inner_bound, design_ops_ms=None),
        }
        for name, row in report[sb].items():
            by = max(row["bound"], key=row["bound"].get)
            row["bound_ms"], row["bound_by"] = row["bound"][by], by
            library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
            log(f"[times] {name:11s} sb = {sb:3d} (s = {s}, b = {b}, w = {w}, n = {tp.n}): kernel {row['ms']:.4f} ms on the "
                f"device ({row['eager_ms']:.4f} ms a call from Python), plain {row['plain_ms']:.4f} ms, library {library}, "
                f"bound {row['bound_ms']:.6f} ms by {by} (bytes {row['bound']['bytes']:.3g}, operations {row['bound']['operations']:.3g})"
                + ("" if row["design_ops_ms"] is None else f", the design's compares alone {row['design_ops_ms']:.3g} ms"))

    # the Yᵀu scatter-add of one main-path bundle (PyTorch's index_add_, no
    # kernel of the port)
    blk = EllBlock(indices=team_idx[: S * B], values=team_val[: S * B], n=tp.n)
    u = torch.rand(S * B, device=device)
    rmat_ms = eager_ms(lambda k: ell_rmatvec(blk, u), inner=10)
    log(f"[times] ell_rmatvec (index_add_) {rmat_ms:.4f} ms a call from Python")

    if "--profile" in sys.argv[1:]:
        profile_main_path(lambda: run_engine_chunk(tp, x0, 0, ROUNDS, sched), ROUNDS)

    # ---- phase 6: the kernels line, the device lines ---------------------
    main_row = report[S * B]
    kernels = []
    for name, replaces, err in (
        ("ell_gram", "src/repro/kernels/ell_gram.py:170", gram_err),
        ("sstep_inner", "src/repro/kernels/sstep_inner.py:68", inner_err),
    ):
        row, wide = main_row[name], report[512][name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err, "max_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "eager_ms": row["eager_ms"],
            "design_ops_ms": row["design_ops_ms"],
            "shape": {"sb": S * B, "w": int(team_idx.shape[1]), "n": tp.n},
            "sb512": {k: wide[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "design_ops_ms")},
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "round_ms": round_ms, "eta": ETA, "build_s": build_s,
                      "rmatvec_ms": rmat_ms, "path_gap": path_gap, "rerun_gap": rerun_gap, "x_max": x_max,
                      "identity_gap": gap, "skew_gap": skew_gap, "skew_identity_gap": skew_identity_gap}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
