#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
mode of each (fp32 and bf16) against its plain PyTorch version on the GPU,
drives the port's paths (the simulated HybridSGD engine: synchronous fp32,
then delay D = 2 in bf16 and in fp32) on the full-size synthetic ``rcv1``
dataset through the entry points a user calls, checks that each path went
through its kernels, reads the comm ledger, times the kernels, drives the
front door at the same width (an ``ExperimentSpec`` read from JSON text →
``plan`` → ``Session`` → save → ``Session.restore`` → ``run`` → report, the
delayed bf16 schedule, a stop policy, timed comm and a resumable sweep,
with the launch counts of each run and the front door's cost a round
beside ``run_engine_chunk``'s), and prints

  * the GPU's name and power limit,
  * one JSON line ``{"kernels": [...]}`` with every kernel's launches on
    the main path, error against its plain version, time, plain time,
    bound and library yardstick,
  * as the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also traces one more run of the
synchronous fp32 path and of the D = 2 bf16 path with ``torch.profiler`` and
prints the device time by kernel. ``--ab OLD.cu`` (a path from the repo root;
it may be given more than once) also builds an earlier kernel source and
times it in turns with this one at each timed shape and mode: an
``ell_gram.cu`` whose C entry point takes no launch geometry, or an
``sstep_inner.cu`` whose entry point is ``sstep_inner_launch(G, v, u, s, b,
eta_over_b, bf16, stream)`` — told apart by the entry point the source
defines. ``--sweep`` also times the corrections kernel at other consumer
block sizes at the timed shapes. Every run prints the launch floor: the
device time of a one-element PyTorch operation in a CUDA graph.

Any failed phase ends the process with a non-zero exit code; there is no
CPU mode: without a CUDA device the script fails at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
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
BF16_FLOP_PER_S = 989e12  # dense, tensor cores

GV_TOL = 1e-3  # rtol = atol for (G, v): float32 sums taken in another order
U_TOL = 1e-5  # rtol = atol for u: expf vs exp and the order of short dots
# max |Δx| over max |x| between two runs of one schedule on the card (kernels
# against plain versions, or the same path twice): float32 sums in another
# order, the atomic adds of the Yᵀu scatter among them. Phase 4 also shows
# that both limits can fail: it repeats the runs with a Gram matrix off by 1 %
# and requires the gaps to land outside them.
X_TOL = 5e-6
IDENTITY_TOL = 1e-6  # max |Δx|, s-step against mini-batch SGD
# bf16 mode against its plain version where a row repeats a column id: the
# kernel rounds each entry to bf16, the plain version (as the reference) the
# per-column sum — up to one bf16 rounding (2⁻⁸ relative) of a G entry.
BF16_DUP_TOL = 2e-2
# bf16 against fp32 (the reference's documented limits): the rounding is live
# and small — (G, v) relative deviation in (0, BF16_REL), u in (0, BF16_DU),
# the final x of the D = 2 run within BF16_DX of the fp32 run at D = 2.
BF16_REL, BF16_DU, BF16_DX = 2e-2, 1e-2, 1e-3
DELAY = 2

# the main path: full-size rcv1 (m = 20,242, n = 47,236, z̄ = 74), 4 row teams
DATASET = "rcv1"
NEWS20_N = 1355191  # news20's columns: a phase-3 shape and a timed one, at its ELL width 540
# the timings kept for each shape beside the main path's in the kernels line
TIMED_KEYS = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "design_ops_ms")
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


def profile_main_path(label: str, run, rounds: int) -> None:
    """``--profile``: trace one more run of a path and print where the
    device time went, by kernel name, and the device's busy share."""
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
    log(f"[profile] {label} path, {rounds} rounds under the profiler: wall {wall_us / rounds / 1e3:.3f} ms a round, device busy "
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


def gram_probes(val: torch.Tensor) -> float:
    """Σ_{i>j} nnz_i: the table lookups of the hash-probe Gram kernel on
    this bundle — each nonzero of row i is looked up in every row j < i."""
    nnz = (val != 0).sum(dim=1).double()
    return float((nnz * torch.arange(val.shape[0], device=val.device, dtype=torch.float64)).sum())


EDGE_KINDS = ("all_pads", "col0_beside_pads", "shuffled", "id_thrice")


def edge_bundle(kind: str, sb: int, w: int, n: int, seed: int):
    """ELL rows (numpy idx, val, x) where a Gram kernel can go wrong. Each
    row has distinct ids in random order (not sorted) in its first 3/4
    entries and pads (idx 0, val 0) after them; then, by ``kind``:
    all_pads — every even row is pads only; col0_beside_pads — each row's
    first entry is a real column 0; shuffled — nothing more; id_thrice —
    column 1 stands three times in every row, at random places."""
    rng = np.random.default_rng(seed)
    nnz = max(4, 3 * w // 4)
    idx = np.zeros((sb, w), np.int32)
    val = np.zeros((sb, w), np.float32)
    for r in range(sb):
        idx[r, :nnz] = 2 + rng.choice(n - 2, size=nnz, replace=False)
        val[r, :nnz] = rng.standard_normal(nnz) / math.sqrt(nnz)
        if kind == "col0_beside_pads":
            idx[r, 0] = 0
        elif kind == "id_thrice":
            idx[r, rng.choice(nnz, size=3, replace=False)] = 1
        elif kind == "all_pads" and r % 2 == 0:
            idx[r], val[r] = 0, 0.0
    return idx, val, rng.standard_normal(n).astype(np.float32)


def random_bundle(sb: int, w: int, n: int, seed: int, device, unique: bool = False):
    """Random ELL rows: with a repeated column id in every row, or (unique)
    with distinct ids a row, as every registered dataset has."""
    rng = np.random.default_rng(seed)
    if unique:
        idx = np.stack([rng.choice(n, size=w, replace=False) for _ in range(sb)]).astype(np.int32)
    else:
        idx = rng.integers(0, n, size=(sb, w)).astype(np.int32)
        if w >= 2:  # duplicate ids inside a row, always
            idx[:, 1] = idx[:, 0]
    val = rng.standard_normal((sb, w)).astype(np.float32) / math.sqrt(w)
    val[:, w - (w // 4):] = 0.0  # a padded tail, as ELL rows have
    idx[:, w - (w // 4):] = 0
    x = rng.standard_normal(n).astype(np.float32)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device),
            torch.from_numpy(x).to(device))


def build_old(old_source: pathlib.Path, name: str, build):
    """An earlier kernel source for ``--ab``, built beside this one's."""
    import ctypes

    out = build.build_dir() / f"ab_{name}_old.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(old_source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def ab_inner_times(old_source: pathlib.Path, inputs: dict, build) -> dict:
    """``--ab OLD.cu`` for the corrections: an earlier ``sstep_inner.cu``
    whose C entry point is (G, v, u, s, b, eta_over_b, bf16, stream),
    timed in turns with this one on the same (G, v) at each timed shape
    and mode, after both agree within U_TOL. Device ms of each turn."""
    import ctypes

    from repro_torch.kernels.sstep_inner import eta_over_b, sstep_inner

    lib = build_old(old_source, "sstep_inner", build)
    lib.sstep_inner_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                               ctypes.c_int, ctypes.c_void_p]
    lib.sstep_inner_launch.restype = ctypes.c_int

    def old(g, v, s, b, precision):
        u = torch.empty((s * b,), dtype=torch.float32, device=g.device)
        rc = lib.sstep_inner_launch(g.data_ptr(), v.data_ptr(), u.data_ptr(), s, b, eta_over_b(ETA, b),
                                    int(precision == "bf16"), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the --ab kernel did not launch: CUDA error {rc}")
        return u

    result = {}
    for label, (s, b, g, v) in inputs.items():
        for mode in ("fp32", "bf16"):
            runs = {"old": lambda k: old(g, v, s, b, mode),
                    "new": lambda k: sstep_inner(g, v, s, b, ETA, precision=mode)}
            max_abs, _, ok = errors(runs["old"](0), runs["new"](0), U_TOL)
            check(ok, f"--ab: the two corrections kernels disagree at {label} {mode}: max abs {max_abs}")
            turns = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                turns[who].append(device_ms(runs[who], inner=20))
            old_ms, new_ms = statistics.mean(turns["old"]), statistics.mean(turns["new"])
            result[f"sstep_inner.{label}.{mode}"] = {"old_ms": turns["old"], "new_ms": turns["new"],
                                                     "max_abs_diff": max_abs}
            log(f"[ab] sstep_inner {mode} {label} (s = {s}, b = {b}): earlier kernel {old_ms:.5f} ms, this one "
                f"{new_ms:.5f} ms on the device ({old_ms / new_ms:.2f}×; turns old {turns['old'][0]:.5f}, new "
                f"{turns['new'][0]:.5f}, new {turns['new'][1]:.5f}, old {turns['old'][1]:.5f}; max |Δu| {max_abs:.3g})")
    return result


def sweep_inner(inputs: dict) -> dict:
    """``--sweep``: the corrections kernel at several consumer block sizes —
    one row a group of LANES lanes, two, and four — on the same (G, v) as
    the timed shapes, each first held against its plain version at U_TOL.
    Device ms by "label.mode.threads"."""
    from repro_torch.kernels.sstep_inner import (
        LANES, MAX_CONSUMERS, inner_geometry, sstep_inner_launch, sstep_inner_ref,
    )

    result = {}
    for label, (s, b, g, v) in inputs.items():
        for threads in sorted({min(MAX_CONSUMERS, max(32, b * LANES // k)) for k in (1, 2, 4)}):
            geo = inner_geometry(s, b, threads=threads)
            for mode in ("fp32", "bf16"):
                max_abs, _, ok = errors(sstep_inner_launch(g, v, s, b, ETA, mode, geo),
                                        sstep_inner_ref(g, v, s, b, ETA, precision=mode), U_TOL)
                check(ok, f"--sweep: {geo} {mode} at {label} is off its plain version by {max_abs}")
                ms = device_ms(lambda k: sstep_inner_launch(g, v, s, b, ETA, mode, geo), inner=20)
                result[f"{label}.{mode}.{threads}"] = ms
                log(f"[sweep] sstep_inner {mode} {label} (s = {s}, b = {b}): {threads:4d} consumer threads, "
                    f"tiles of {geo.cols} columns, {geo.stages} slots: {ms:.5f} ms on the device")
    return result


def ab_times(old_source: pathlib.Path, shapes: dict, gram_fn, build) -> dict:
    """``--ab OLD.cu``: an earlier ``ell_gram.cu`` whose C entry point
    takes no geometry (idx, val, x, G, v, sb, w, bf16, stream), built
    beside this one and timed in turns with it — old, new, new, old — at
    each timed shape and mode, on the same inputs. Device ms of each turn."""
    import ctypes

    lib = build_old(old_source, "ell_gram", build)
    lib.ell_gram_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ell_gram_launch.restype = ctypes.c_int

    def old(idx, val, x, precision):
        sb, w = val.shape
        g = torch.empty((sb, sb), dtype=torch.float32, device=val.device)
        v = torch.empty((sb,), dtype=torch.float32, device=val.device)
        rc = lib.ell_gram_launch(idx.data_ptr(), val.data_ptr(), x.data_ptr(), g.data_ptr(), v.data_ptr(), sb, w,
                                 int(precision == "bf16"), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the --ab kernel did not launch: CUDA error {rc}")
        return g, v

    result = {}
    for label, (sb, _, _, bundle, per_pass, x_in, n_cols) in shapes.items():
        for mode in ("fp32", "bf16"):
            runs = {"old": lambda k: old(*bundle(k), x_in, mode),
                    "new": lambda k: gram_fn(*bundle(k), x_in, n=n_cols, precision=mode)}
            for got, want in zip(runs["old"](0), runs["new"](0)):  # the same function
                max_abs, _, ok = errors(got, want, GV_TOL)
                check(ok, f"--ab: the two kernels disagree at {label} {mode}: max abs {max_abs}")
            turns = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                turns[who].append(device_ms(runs[who], inner=per_pass))
            old_ms, new_ms = statistics.mean(turns["old"]), statistics.mean(turns["new"])
            result[f"{label}.{mode}"] = {"old_ms": turns["old"], "new_ms": turns["new"]}
            log(f"[ab] ell_gram {mode} {label} (sb = {sb}, w = {int(bundle(0)[0].shape[1])}): earlier kernel "
                f"{old_ms:.4f} ms, this one {new_ms:.4f} ms on the device ({old_ms / new_ms:.2f}×; turns old "
                f"{turns['old'][0]:.4f}, new {turns['new'][0]:.4f}, new {turns['new'][1]:.4f}, old {turns['old'][1]:.4f})")
    return result


def check_gram(device, err: dict, grid, edge_shapes) -> tuple[float, int]:
    """Phase 3 for ell_gram: each mode of the kernel against its plain
    version and the dense oracle on random bundles of each (sb, w, n) of
    ``grid`` (rows that repeat an id, and rows that do not), and on the
    ``EDGE_KINDS`` at each shape of ``edge_shapes``; two launches on rows
    with distinct ids must be bitwise equal. Keeps the worst error of each
    mode in ``err``; returns the worst bf16 error on rows that repeat an id
    and the number of bitwise checks."""
    from repro_torch.kernels.ell_gram import ell_gram_and_v, ell_gram_and_v_blocked
    from repro_torch.kernels.ref import ell_gram_and_v_ref

    gram16_dup_err = 0.0
    for case, (sb, w, n) in enumerate(grid):
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
        err["ell_gram.fp32"] = max(err["ell_gram.fp32"], worst)
        log(f"[kernels] ell_gram    (sb, w, n) = {(sb, w, n)}: max abs err {worst:.3g} (tol {GV_TOL})")

        # bf16 mode, rows with a repeated id: within BF16_DUP_TOL of its plain
        # version and of fp32
        g16, v16 = ell_gram_and_v(idx, val, x, n=n, precision="bf16")
        sync()
        check(bool(torch.all(torch.triu(g16) == 0)), f"ell_gram bf16: triu(G) != 0 at {(sb, w, n)}")
        pg16, pv16 = ell_gram_and_v_blocked(idx, val, x, n=n, bk=512, precision="bf16")
        dup = 0.0
        for got, want, name in ((g16, pg16, "G~plain"), (v16, pv16, "v~plain"), (g16, g, "G~fp32"), (v16, v, "v~fp32")):
            max_abs, max_rel, ok = errors(got, want, BF16_DUP_TOL)
            check(ok and math.isfinite(max_abs), f"ell_gram bf16 {name} at {(sb, w, n)}, repeated ids: max abs {max_abs}")
            if "plain" in name:
                dup = max(dup, max_abs)
        gram16_dup_err = max(gram16_dup_err, dup)
        # bf16 mode, distinct ids a row: only the order of float32 sums differs
        idx, val, x = random_bundle(sb, w, n, 150 + case, device, unique=True)
        g16, v16 = ell_gram_and_v(idx, val, x, n=n, precision="bf16")
        pg16, pv16 = ell_gram_and_v_blocked(idx, val, x, n=n, bk=512, precision="bf16")
        sync()
        worst16 = 0.0
        for got, want, name in ((g16, pg16, "G"), (v16, pv16, "v")):
            max_abs, max_rel, ok = errors(got, want, GV_TOL)
            check(ok and math.isfinite(max_abs), f"ell_gram bf16 {name} at {(sb, w, n)}, distinct ids: max abs {max_abs}")
            worst16 = max(worst16, max_abs)
        err["ell_gram.bf16"] = max(err["ell_gram.bf16"], worst16)
        log(f"[kernels] ell_gram    bf16 (sb, w, n) = {(sb, w, n)}: max abs err {worst16:.3g} on distinct ids (tol {GV_TOL}), "
            f"{dup:.3g} on repeated ids (tol {BF16_DUP_TOL})")

    # the Gram kernel's edge cases, in both modes, against its plain version
    # and the dense oracle; on distinct-id rows two launches are bitwise equal
    bitwise = 0
    for case, (kind, (sb, w, n)) in enumerate(
            (k, shape) for k in EDGE_KINDS for shape in edge_shapes):
        idx, val, x = (torch.from_numpy(a).to(device) for a in edge_bundle(kind, sb, w, n, 400 + case))
        repeats = kind == "id_thrice"
        og, ov = ell_gram_and_v_ref(idx, val, x, n)
        for mode in ("fp32", "bf16"):
            g, v = ell_gram_and_v(idx, val, x, n=n, precision=mode)
            pg, pv = ell_gram_and_v_blocked(idx, val, x, n=n, bk=512, precision=mode)
            sync()
            what = f"ell_gram {mode} {kind} at {(sb, w, n)}"
            check(bool(torch.all(torch.triu(g) == 0)), f"{what}: triu(G) != 0")
            if kind == "all_pads":
                check(bool(torch.all(g[0::2] == 0) and torch.all(g[:, 0::2] == 0) and torch.all(v[0::2] == 0)),
                      f"{what}: an all-pad row has a nonzero G or v entry")
            tol = BF16_DUP_TOL if mode == "bf16" and repeats else GV_TOL
            oracle_tol = GV_TOL if mode == "fp32" else BF16_DUP_TOL  # the oracle is fp32
            worst = 0.0
            for got, want, name, t in ((g, pg, "G~plain", tol), (v, pv, "v~plain", tol),
                                       (g, og, "G~dense", oracle_tol), (v, ov, "v~dense", oracle_tol)):
                max_abs, max_rel, ok = errors(got, want, t)
                check(ok and math.isfinite(max_abs), f"{what} {name}: max abs {max_abs}, max rel {max_rel} (tol {t})")
                if "plain" in name:
                    worst = max(worst, max_abs)
            if mode == "bf16" and repeats:
                gram16_dup_err = max(gram16_dup_err, worst)
            else:
                err[f"ell_gram.{mode}"] = max(err[f"ell_gram.{mode}"], worst)
            if not repeats:
                g2, v2 = ell_gram_and_v(idx, val, x, n=n, precision=mode)
                sync()
                check(torch.equal(g, g2) and torch.equal(v, v2), f"{what}: two launches differ")
                bitwise += 1
            log(f"[kernels] ell_gram    {mode} {kind:16s} (sb, w, n) = {(sb, w, n)}: max abs err {worst:.3g} against "
                f"the plain version (tol {tol})" + ("" if repeats else ", a second launch bitwise equal"))

    return gram16_dup_err, bitwise


def rel_dev(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| over max |ref|."""
    return float((got - ref).abs().max() / ref.abs().max())


def front_door_phase(tp, zero_counts, counts, smi: str, device=None) -> dict:
    """The front door at full width: an ``ExperimentSpec`` read from JSON
    text (the reference's wire form), ``plan``, a ``Session`` run to its
    end, a second one saved after two steps and restored into a fresh
    object, the delayed bf16 schedule, a stop policy, timed comm, a
    resumable sweep, and the front door's own cost a round beside
    ``run_engine_chunk``'s. ``tp`` is the main path's team problem (the
    same rows the spec builds); ``device`` is what the entry points get
    (None: the card). Returns the numbers for the phase's JSON line."""
    import tempfile

    from repro_torch.api import (
        ExperimentSpec, RunReport, Session, StopPolicy, plan, run, sweep,
    )
    from repro_torch.core.engine import ParallelSGDSchedule, engine_comm_ledger, run_engine_chunk, run_parallel_sgd
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train.checkpoint import load_session_checkpoint

    started = time.perf_counter()

    expected = ROUNDS * P_R * (TAU // S)
    text = json.dumps({
        "name": f"{DATASET}-front-door", "dataset": DATASET, "seed": 0, "machine": "perlmutter-cpu",
        "autotune": False, "row_multiple": S * B,
        "schedule": {"p_r": P_R, "s": S, "b": B, "tau": TAU, "eta": ETA, "rounds": ROUNDS, "loss_every": 2,
                     "gram": "pallas", "bk": 512, "interpret": True, "p_c": 2},
        "mesh": {"p_r": P_R, "p_c": 2, "backend": "simulated", "partitioner": "cyclic"},
    })
    spec = ExperimentSpec.from_json(text)
    want_sched = ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, loss_every=2, p_c=2)
    check(spec.schedule == want_sched and spec.schedule.gram == "kernel", f"the spec read {spec.schedule}")
    check(ExperimentSpec.from_json(spec.to_json()) == spec and json.loads(spec.to_json())["schedule"]["gram"] == "pallas",
          "the spec does not write back its wire form")
    pl = plan(spec)
    log(f"[front] spec {spec.name}: content hash {spec.content_hash()}; plan: predicted {pl.cost.total:.6g} s an epoch "
        f"on {spec.machine}, regime {pl.regime} (balance {pl.balance:.3g}, model recommends D = {pl.recommended_delay})")

    def path_launches(label: str, want: dict) -> dict:
        got = counts()
        log(f"[front] launches, {label}: {got}")
        for name, count in want.items():
            check(got[name] == count, f"front door, {label}: {name} launched {got[name]} times, expected {count}")
        return got

    fp32 = {"ell_gram.fp32": expected, "ell_gram.bf16": 0, "sstep_inner.fp32": expected, "sstep_inner.bf16": 0}
    out = {"spec_hash": spec.content_hash(), "predicted_s": pl.cost.total, "regime": pl.regime}

    # the uninterrupted run
    zero_counts()
    t0 = time.perf_counter()
    whole = Session(spec, device=device)
    out["session_build_s"] = time.perf_counter() - t0
    check(whole.bundle.team.values.device.type == ("cuda" if device is None else torch.device(device).type),
          f"the session's problem is on {whole.bundle.team.values.device}")
    rep = whole.run()
    out["launches_uninterrupted"] = path_launches("uninterrupted run", fp32)
    check(rep.stop_reason == "rounds" and rep.rounds_completed == ROUNDS, f"the run ended {rep.stop_reason}")
    check(rep.x.shape == (tp.n,) and bool(np.isfinite(rep.x).all()), "the front door's final x is not finite (n,)")
    check(len(rep.losses) == ROUNDS // 2 and bool(np.isfinite(rep.losses).all()) and rep.losses[-1] < rep.losses[0],
          f"the front door's losses are wrong: {rep.losses}")

    # two steps, save, restore into a fresh object, run to the end
    with tempfile.TemporaryDirectory() as tmp:
        ck = pathlib.Path(tmp) / "ck"
        zero_counts()
        first = Session(spec, device=device)
        first.step_rounds(2)
        first.step_rounds(2)
        t0 = time.perf_counter()
        first.save(ck)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_session_checkpoint(ck, expect_spec_hash=spec.content_hash())
        out["checkpoint_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = Session.restore(ck, device=device)
        out["restore_s"] = time.perf_counter() - t0
        check(second.rounds_done == 4 and len(second.losses) == 2, "the restored session lost its round or its losses")
        rep2 = second.run()
        out["launches_restored"] = path_launches("saved after 4 rounds and restored", fp32)
    x_max = float(np.abs(rep.x).max())
    gap_restored = float(np.abs(rep2.x - rep.x).max())
    x_engine, _ = run_parallel_sgd(tp, torch.zeros(tp.n, dtype=torch.float32, device=tp.values.device), spec.schedule)
    gap_engine = float(np.abs(rep.x - x_engine.cpu().numpy()).max())
    loss_gap = float(np.max(np.abs(rep2.losses - rep.losses) / np.abs(rep.losses))) if len(rep2.losses) == len(rep.losses) else math.inf
    log(f"[front] restored vs uninterrupted: max |Δx| = {gap_restored:.3g}; uninterrupted vs run_parallel_sgd: "
        f"{gap_engine:.3g} (limit {X_TOL:g}·max |x| = {X_TOL * x_max:.3g}); losses {' '.join(f'{v:.5f}' for v in rep.losses)}, "
        f"restored {' '.join(f'{v:.5f}' for v in rep2.losses)}, max relative gap {loss_gap:.3g}")
    check(x_max > 0 and gap_restored <= X_TOL * x_max, f"the restored run is {gap_restored} from the uninterrupted one")
    check(gap_engine <= X_TOL * x_max, f"the front door is {gap_engine} from run_parallel_sgd")
    check(loss_gap <= X_TOL, f"the loss traces differ: {rep.losses} vs {rep2.losses}")
    out.update(x_max=x_max, gap_restored=gap_restored, gap_engine=gap_engine, loss_gap=loss_gap,
               compile_time_s=rep.compile_time_s, wall_time_s=rep.wall_time_s, losses=rep.losses.tolist())

    # the delayed bf16 schedule, and fp32 at the same delay
    sched16 = dataclasses.replace(spec.schedule, delay=DELAY, precision="bf16")
    zero_counts()
    rep16 = run(dataclasses.replace(spec, schedule=sched16), device=device)
    out["launches_delay2_bf16"] = path_launches(f"D = {DELAY} bf16", {
        "ell_gram.fp32": 0, "ell_gram.bf16": expected, "sstep_inner.fp32": expected, "sstep_inner.bf16": 0})
    zero_counts()
    rep32 = run(dataclasses.replace(spec, schedule=dataclasses.replace(spec.schedule, delay=DELAY)), device=device)
    path_launches(f"D = {DELAY} fp32", fp32)
    bf16_gap = float(np.abs(rep16.x - rep32.x).max())
    log(f"[front] D = {DELAY} bf16 vs fp32 through run(spec): max |Δx| = {bf16_gap:.3g} (limit {BF16_DX})")
    check(0.0 < bf16_gap < BF16_DX, f"D = 2 bf16 against fp32 through the front door: {bf16_gap}")
    out["delay2_bf16_vs_fp32"] = bf16_gap

    # the stop policy: a target between the second and third samples
    losses = [float(v) for v in rep.losses]
    target = (losses[1] + losses[2]) / 2
    stop_round = 2 * (1 + next(i for i, v in enumerate(losses) if v <= target))
    check(losses[0] > target > losses[-1] and stop_round < ROUNDS, f"no target between the samples {losses}")
    rep_stop = run(dataclasses.replace(spec, stop=StopPolicy(target_loss=target)), device=device)
    log(f"[front] stop at target {target:.6f}: {rep_stop.stop_reason} at round {rep_stop.rounds_completed} with loss "
        f"{float(rep_stop.losses[-1]):.6f} (the uninterrupted run crosses at round {stop_round})")
    check(rep_stop.stop_reason == "target_loss" and rep_stop.rounds_completed < ROUNDS
          and float(rep_stop.losses[-1]) <= target, "the stop policy did not stop at the target")
    out["stop"] = {"target": target, "round": rep_stop.rounds_completed, "loss": float(rep_stop.losses[-1])}

    # timed comm, and the report's JSON round trip
    rep_t = run(dataclasses.replace(spec, comm_timing=True), device=device)
    led = rep_t.ledger
    log(f"[front] timed comm: {led.seconds_per_round * 1e3:.3f} ms a round (median of {len(led.round_seconds)}), "
        f"phase seconds a round {led.phase_seconds}; {smi}")
    check(led.seconds_per_round is not None and len(led.round_seconds) == ROUNDS, "the timed run measured no rounds")
    check(set(led.phase_seconds) == {"bundle_compute", "allreduce_gv", "param_avg"}, f"phase seconds {led.phase_seconds}")
    back = RunReport.from_json(rep_t.to_json())
    check(back.to_json() == rep_t.to_json() and back.ledger == led and back.spec == rep_t.spec,
          "RunReport.to_json() does not round-trip")
    out.update(timed_round_ms=led.seconds_per_round * 1e3, phase_seconds=led.phase_seconds)

    # a resumable sweep of two points: the first call runs one and skips
    # the other (max_points), the second resumes one and runs the other,
    # the third resumes both and runs nothing
    points = [dataclasses.replace(spec, name=f"sweep-{i}", schedule=dataclasses.replace(spec.schedule, rounds=2, eta=eta))
              for i, eta in enumerate((ETA, ETA / 2))]
    reg = obs_metrics.registry()

    def sweep_counts() -> dict:
        return {k: v["value"] for k, v in reg.snapshot().items() if k.startswith("sweep.")}

    with tempfile.TemporaryDirectory() as tmp:
        calls = []
        for max_points in (1, None, None):
            before = sweep_counts()
            result = sweep(points, resume_dir=tmp, max_points=max_points, device=device)
            after = sweep_counts()
            calls.append(({k: after[k] - before.get(k, 0.0) for k in after if after[k] != before.get(k, 0.0)},
                          result.resumed, len(result.skipped)))
    log(f"[front] sweep calls (counter deltas, resumed, skipped): {calls}")
    check(calls[0] == ({"sweep.points_total": 1.0, "sweep.points_skipped_total": 1.0}, [False], 1)
          and calls[1] == ({"sweep.points_total": 1.0, "sweep.points_resumed_total": 1.0}, [True, False], 0)
          and calls[2] == ({"sweep.points_resumed_total": 2.0}, [True, True], 0),
          "the sweep did not resume its finished points")
    out["sweep_calls"] = calls

    # the front door's cost a round: step_rounds(1) against
    # run_engine_chunk(…, 1, …) + synchronize on the same team problem,
    # interleaved round by round (an engine round, a step of a session
    # that samples the loss every 2 rounds, a step of one that never
    # does), so that a shift of the host's speed between runs hits all
    # three alike.
    quiet = dataclasses.replace(spec, schedule=dataclasses.replace(spec.schedule, loss_every=0))
    walls = {"engine": [], "session": [], "session_no_loss": []}  # seconds a round
    for _ in range(4):
        sessions = {"session": Session(spec, device=device), "session_no_loss": Session(quiet, device=device)}
        for sess in sessions.values():
            sess.step_rounds(1)  # the "compile" chunk, not timed
        x = run_engine_chunk(whole.bundle.team, torch.zeros(tp.n, dtype=torch.float32, device=tp.values.device),
                             0, 1, spec.schedule)
        for r in range(1, ROUNDS):
            t0 = time.perf_counter()
            x = run_engine_chunk(whole.bundle.team, x, r, 1, spec.schedule)
            if x.is_cuda:
                sync()
            walls["engine"].append(time.perf_counter() - t0)
            for who, sess in sessions.items():
                t0 = time.perf_counter()
                sess.step_rounds(1)
                walls[who].append(time.perf_counter() - t0)
    ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    over_ms = {k: statistics.median(w - e for w, e in zip(walls[k], walls["engine"])) * 1e3
               for k in ("session", "session_no_loss")}  # paired with the engine round just before
    t0 = time.perf_counter()
    engine_comm_ledger(spec.schedule, tp.n, tp=whole.bundle.team)
    out["ledger_capture_s"] = time.perf_counter() - t0
    log(f"[front] wall a round (medians over 4 × {ROUNDS - 1} rounds, interleaved): run_engine_chunk(…, 1, …) "
        f"{ms['engine']:.3f} ms; Session.step_rounds(1) {ms['session']:.3f} ms with a loss sample every 2 rounds, "
        f"{ms['session_no_loss']:.3f} ms with loss_every = 0; the front door's cost a round, paired with the engine round "
        f"beside it: {over_ms['session']:.3f} ms with loss samples, {over_ms['session_no_loss']:.3f} ms without; "
        f"compile_time_s {rep.compile_time_s:.4f} s; Session() {out['session_build_s']:.3f} s, save {out['save_s']:.4f} s, "
        f"checkpoint load {out['checkpoint_load_s']:.4f} s, Session.restore {out['restore_s']:.3f} s, ledger capture "
        f"{out['ledger_capture_s']:.4f} s; {smi}")
    out.update(round_ms=ms, round_overhead_ms=over_ms)
    if "--profile" in sys.argv[1:]:
        stepped = Session(spec, device=device)
        stepped.step_rounds(1)  # the "compile" chunk, outside the trace
        profile_main_path("front door step_rounds(1)", lambda: [stepped.step_rounds(1) for _ in range(ROUNDS - 1)],
                          ROUNDS - 1)
    out["phase_s"] = time.perf_counter() - started
    log(f"[front] the phase took {out['phase_s']:.1f} s")
    return out


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
    from repro_torch.core.comm import time_phase
    from repro_torch.core.engine import (
        ParallelSGDSchedule, engine_comm_ledger, engine_phase_probes, run_engine_chunk, run_parallel_sgd,
    )
    from repro_torch.core.teams import stack_row_teams
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_gram import MAX_CHUNK, ell_gram_and_v, ell_gram_and_v_blocked
    from repro_torch.kernels.ref import densify_bundle_ref, ell_gram_and_v_ref
    from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref
    from repro_torch.sparse.ell import EllBlock, ell_rmatvec
    from repro_torch.sparse.synthetic import make_dataset

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernels with {_build.find_nvcc()} in {build_s:.1f} s → {_build.build_dir()}")
    # ptxas' report of every kernel instantiation: registers, and no spills
    for name in libs:
        report = _build.build_log(name)
        kernels_seen = re.findall(r"Function properties for (\S+)", report)
        spills = [tuple(map(int, m)) for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
        for line in report.splitlines():
            if "spill" in line or "registers" in line:
                log(f"[ptxas] {name}: {line.strip()}")
        check(len(kernels_seen) == len(spills) == 2, f"ptxas reported {len(kernels_seen)} kernels of {name}, expected 2")
        check(all(s == (0, 0) for s in spills), f"a kernel of {name} spills registers: {spills}")

    t0 = time.perf_counter()
    ds = make_dataset(DATASET, seed=0)
    tp = stack_row_teams(ds.A, ds.y, P_R, row_multiple=S * B)  # device=None: the card
    log(f"[main] {DATASET}: m = {ds.A.m}, n = {ds.A.n}, nnz/row = {ds.A.zbar:.1f}; teams {tuple(tp.indices.shape)} "
        f"on {tp.values.device} ({time.perf_counter() - t0:.1f} s to generate and stack)")
    check(tp.values.is_cuda and tp.values.dtype == torch.float32, "the problem is not float32 on the card")

    def zero_counts() -> None:
        ell_gram_and_v.launches.update(fp32=0, bf16=0)
        sstep_inner.launches.update(fp32=0, bf16=0)

    def counts() -> dict:
        return {f"{name}.{mode}": fn.launches[mode]
                for name, fn in (("ell_gram", ell_gram_and_v), ("sstep_inner", sstep_inner))
                for mode in ("fp32", "bf16")}

    # ---- phase 3: each kernel against its plain version, on the card ----
    # worst max abs error against the plain version, by (kernel, mode); the
    # bf16 Gram on rows with repeated ids is kept apart (its own tolerance)
    err = {"ell_gram.fp32": 0.0, "ell_gram.bf16": 0.0, "sstep_inner.fp32": 0.0, "sstep_inner.bf16": 0.0}
    gram_grid = [(8, 1, 10), (64, 24, 1999), (128, 111, 47236), (512, 111, 47236), (128, 540, NEWS20_N),
                 (8, MAX_CHUNK + 1, 5000),  # one entry over a chunk: two tables a row
                 (32, 3 * MAX_CHUNK + 100, 50000),  # four chunks a row
                 (128, 2000, 2000),  # epsilon's dense rows (the distinct-id bundle)
                 (8, 13100, 3145728)]  # synthetic_uniform's width and columns
    edge_shapes = ((64, 111, 47236), (16, MAX_CHUNK + 88, 20000))  # one chunk a row, and two
    gram16_dup_err, bitwise = check_gram(device, err, gram_grid, edge_shapes)

    # the corrections: s = 1 (no panel), a whole triangle in flight, an s·b
    # that is not a multiple of 4 (no TMA: the producer warp's loads), rings
    # that wrap many times up to s·b = MAX_SB (G 604 MB), and G at an address
    # 4 bytes past a 16-byte boundary (no TMA at the main shape)
    for case, (s, b, offset) in enumerate([(1, 8, 0), (4, 32, 0), (8, 16, 0), (16, 32, 0), (3, 7, 0), (1, 128, 0),
                                           (4, 32, 1), (64, 32, 0), (96, 128, 0)]):
        rng = np.random.default_rng(200 + case)
        sb = s * b
        y = torch.from_numpy(rng.standard_normal((sb, 200)).astype(np.float32) / math.sqrt(200)).to(device)
        store = torch.empty(offset + sb * sb, dtype=torch.float32, device=device)
        g = store[offset:].view(sb, sb)
        g.copy_(torch.tril(y @ y.T, -1))
        del y
        v = torch.from_numpy(rng.standard_normal(sb).astype(np.float32)).to(device)
        for eta in (0.05, 1.0):
            for mode in ("fp32", "bf16"):
                u = sstep_inner(g, v, s, b, eta, precision=mode)
                sync()
                max_abs, max_rel, ok = errors(u, sstep_inner_ref(g, v, s, b, eta, precision=mode), U_TOL)
                check(ok and math.isfinite(max_abs),
                      f"sstep_inner {mode} at (s, b, eta) = {(s, b, eta)}, G {4 * offset} bytes past a 16-byte "
                      f"boundary: max abs {max_abs}, max rel {max_rel}")
                err[f"sstep_inner.{mode}"] = max(err[f"sstep_inner.{mode}"], max_abs)
                log(f"[kernels] sstep_inner {mode} (s, b, eta) = {(s, b, eta)}"
                    + (f", G {4 * offset} bytes past a 16-byte boundary" if offset else "")
                    + f": max abs err {max_abs:.3g} (tol {U_TOL})")
        del store, g
    torch.cuda.empty_cache()

    # both kernels on the bundles the main path feeds them: real rows of the
    # dataset (sorted ids, a ragged padded tail) and a nonzero iterate
    x_real = torch.from_numpy(np.random.default_rng(300).standard_normal(tp.n).astype(np.float32) * 0.1).to(device)
    inner_bitwise = 0
    for team, r0 in ((0, 0), (P_R - 1, tp.rows_local - S * B)):
        idx, val = tp.indices[team, r0 : r0 + S * B], tp.values[team, r0 : r0 + S * B]
        out = {}
        for mode in ("fp32", "bf16"):
            g, v = ell_gram_and_v(idx, val, x_real, n=tp.n, precision=mode)
            g2, v2 = ell_gram_and_v(idx, val, x_real, n=tp.n, precision=mode)
            check(bool(torch.all(torch.triu(g) == 0)), f"ell_gram {mode}: triu(G) != 0 on {DATASET} rows")
            check(torch.equal(g, g2) and torch.equal(v, v2), f"ell_gram {mode}: two launches differ on {DATASET} rows")
            bitwise += 1
            pg, pv = ell_gram_and_v_blocked(idx, val, x_real, n=tp.n, bk=512, precision=mode)
            check(float(pg.abs().max()) > 0, f"the {DATASET} bundle has an empty Gram matrix")
            for got, want, name in ((g, pg, "G"), (v, pv, "v")):
                max_abs, max_rel, ok = errors(got, want, GV_TOL)
                check(ok and math.isfinite(max_abs),
                      f"ell_gram {mode} {name} on {DATASET} rows: max abs {max_abs}, max rel {max_rel}")
                err[f"ell_gram.{mode}"] = max(err[f"ell_gram.{mode}"], max_abs)
            u = sstep_inner(pg, pv, S, B, ETA, precision=mode)
            check(torch.equal(u, sstep_inner(pg, pv, S, B, ETA, precision=mode)),
                  f"sstep_inner {mode}: two launches differ on {DATASET} rows")
            inner_bitwise += 1
            max_abs, max_rel, ok = errors(u, sstep_inner_ref(pg, pv, S, B, ETA, precision=mode), U_TOL)
            check(ok and math.isfinite(max_abs), f"sstep_inner {mode} on {DATASET} rows: max abs {max_abs}, max rel {max_rel}")
            err[f"sstep_inner.{mode}"] = max(err[f"sstep_inner.{mode}"], max_abs)
            out[mode] = (g, v, pg, pv)
        # the bf16 rounding is live, and small: each mode against fp32 on the
        # same inputs (the corrections on the fp32 (G, v))
        g32, v32, pg32, pv32 = out["fp32"]
        g16, v16 = out["bf16"][:2]
        dev_g, dev_v = rel_dev(g16, g32), rel_dev(v16, v32)
        du = float((sstep_inner(pg32, pv32, S, B, ETA, precision="bf16") - sstep_inner(pg32, pv32, S, B, ETA)).abs().max())
        sync()
        log(f"[kernels] bf16 against fp32 on {DATASET} rows of team {team}: (G, v) relative {dev_g:.3g}, {dev_v:.3g} "
            f"(limit {BF16_REL}), u max |Δ| {du:.3g} (limit {BF16_DU})")
        check(0.0 < dev_g < BF16_REL and 0.0 < dev_v < BF16_REL, f"ell_gram bf16 against fp32: {dev_g}, {dev_v}")
        check(0.0 < du < BF16_DU, f"sstep_inner bf16 against fp32: {du}")
    log(f"[kernels] both kernels on {DATASET} bundles (team 0 first rows, team {P_R - 1} last rows): worst so far "
        + ", ".join(f"{k} {e:.3g}" for k, e in err.items()) + f"; {bitwise} two-launch checks of ell_gram and "
        f"{inner_bitwise} of sstep_inner bitwise equal")

    # ---- phase 4: the main path at full width ---------------------------
    sched = ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, loss_every=1)
    check(sched.gram == "kernel", "the default gram backend is not the kernel")
    x0 = torch.zeros(tp.n, dtype=torch.float32, device=device)
    expected = ROUNDS * P_R * (TAU // S)

    def expect_launches(path: str, got: dict, want: dict) -> None:
        log(f"[main] launches on the {path} path: {got}")
        for name, count in want.items():
            check(count == 0 or got[name] > 0, f"the {path} path never launched {name}")
            check(got[name] == count, f"{path} path: {name} launched {got[name]} times, expected {count}")

    zero_counts()
    x_kernel, losses = run_parallel_sgd(tp, x0, sched)
    launches = counts()
    sync()
    losses_host = [float(t) for t in losses]
    log(f"[main] losses by round: {' '.join(f'{t:.5f}' for t in losses_host)}")
    expect_launches("synchronous fp32", launches, {"ell_gram.fp32": expected, "ell_gram.bf16": 0,
                                                   "sstep_inner.fp32": expected, "sstep_inner.bf16": 0})
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
    check(counts() == launches, "the plain run launched a kernel")
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

    # the delay-D pipeline in bf16: every bundle's (G, v) from the bf16 Gram
    # kernel, staged D = 2 bundles deep as bf16 wire words, the corrections
    # in fp32 on the unwired payload (as the reference does)
    sched16 = dataclasses.replace(sched, delay=DELAY, precision="bf16")
    zero_counts()
    x16, losses16 = run_parallel_sgd(tp, x0, sched16)
    launches16 = counts()
    sync()
    l16 = [float(t) for t in losses16]
    log(f"[delay] D = {DELAY} bf16 losses by round: {' '.join(f'{t:.5f}' for t in l16)}")
    expect_launches(f"D = {DELAY} bf16", launches16, {"ell_gram.fp32": 0, "ell_gram.bf16": expected,
                                                      "sstep_inner.fp32": expected, "sstep_inner.bf16": 0})
    check(x16.shape == (tp.n,) and bool(torch.isfinite(x16).all()), "D = 2 bf16: final x is not finite (n,)")
    check(all(math.isfinite(t) for t in l16) and l16[-1] < l16[0], "D = 2 bf16: the loss did not fall")

    # the same schedule with the plain versions only, and with G off by 1 %
    engine.inner_corrections = engine.inner_corrections_loop
    try:
        x16_plain, _ = run_parallel_sgd(tp, x0, dataclasses.replace(sched16, gram="blocked"))
    finally:
        engine.inner_corrections = kernel_dispatch
    sync()
    check(counts() == launches16, "the plain D = 2 bf16 run launched a kernel")
    x16_max = float(x16_plain.abs().max())
    gap16 = float((x16 - x16_plain).abs().max())
    engine.bundle_gram_v = skewed_gram
    try:
        x16_skew, _ = run_parallel_sgd(tp, x0, sched16)
    finally:
        engine.bundle_gram_v = true_gram
    skew16 = float((x16_skew - x16_plain).abs().max())
    log(f"[delay] D = {DELAY} bf16, kernels vs plain versions: max |Δx| = {gap16:.3g} with max |x| = {x16_max:.3g} "
        f"(limit {X_TOL * x16_max:.3g}); with G off by 1 %: {skew16:.3g}")
    check(x16_max > 0 and gap16 <= X_TOL * x16_max, f"D = 2 bf16: final x is {gap16} from the plain path's")
    check(skew16 > X_TOL * x16_max, "D = 2 bf16: a Gram matrix wrong by 1 % passes the end-to-end limit")

    # fp32 at the same delay: bf16 within the reference's 1e-3 of it, and not
    # equal; D = 2 moves the iterate away from D = 0 and still learns
    sched32 = dataclasses.replace(sched, delay=DELAY)
    zero_counts()
    x32, losses32 = run_parallel_sgd(tp, x0, sched32)
    launches32 = counts()
    sync()
    expect_launches(f"D = {DELAY} fp32", launches32, {"ell_gram.fp32": expected, "ell_gram.bf16": 0,
                                                      "sstep_inner.fp32": expected, "sstep_inner.bf16": 0})
    l32 = [float(t) for t in losses32]
    bf16_gap = float((x16 - x32).abs().max())
    delay_gap = float((x32 - x_kernel).abs().max())
    log(f"[delay] D = {DELAY} bf16 vs fp32: max |Δx| = {bf16_gap:.3g} (limit {BF16_DX}), max |Δloss| "
        f"{float((losses16 - losses32).abs().max()):.3g}; D = {DELAY} fp32 vs D = 0: max |Δx| = {delay_gap:.3g}, "
        f"losses {l32[0]:.5f} → {l32[-1]:.5f} (D = 0: {losses_host[0]:.5f} → {losses_host[-1]:.5f})")
    check(0.0 < bf16_gap < BF16_DX, f"D = 2 bf16 against fp32: max |Δx| = {bf16_gap}")
    check(delay_gap > X_TOL * x_max, "D = 2 fp32 is not distinguishable from D = 0")
    check(all(math.isfinite(t) for t in l32) and l32[-1] < l32[0], "D = 2 fp32: the loss did not fall")

    # the comm ledger of the two D = 2 schedules at p_c = 2: bf16 ships the
    # same words as fp32 at half the Gram bytes
    t0 = time.perf_counter()
    led16 = engine_comm_ledger(dataclasses.replace(sched16, p_c=2), tp.n, tp=tp)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    led32 = engine_comm_ledger(dataclasses.replace(sched32, p_c=2), tp.n, tp=tp)
    capture2_s = time.perf_counter() - t0
    for led in (led16, led32):
        led.add_rounds(ROUNDS)
    w16, w32, b16, b32 = led16.counted_words(), led32.counted_words(), led16.counted_bytes(), led32.counted_bytes()
    log(f"[ledger] p_c = 2, {ROUNDS} rounds, D = {DELAY}: bf16 {w16} {b16}; fp32 {w32} {b32} "
        f"(capture on meta tensors {capture_s:.3f} s the first time in this process, {capture2_s:.3f} s the second)")
    check(w16 == w32 and w16["gram_words"] > 0, "bf16 and fp32 ledgers count different words")
    check(b16["gram_bytes"] == b32["gram_bytes"] / 2 and b16["sync_bytes"] == b32["sync_bytes"],
          "the bf16 ledger does not halve the Gram bytes alone")
    check(led16.delay == DELAY and tp.values.is_cuda, "the ledger capture lost the delay or moved the problem")

    # ---- phase 5: times --------------------------------------------------
    def round_wall_ms(run_sched) -> float:
        sync()
        t0 = time.perf_counter()
        run_engine_chunk(tp, x0, 0, ROUNDS, run_sched)
        sync()
        return (time.perf_counter() - t0) * 1e3 / ROUNDS

    round_ms = statistics.median(round_wall_ms(sched) for _ in range(5))
    round16_ms = statistics.median(round_wall_ms(sched16) for _ in range(5))
    log(f"[times] synchronous fp32 path: {round_ms:.3f} ms per round of {P_R} teams × {TAU // S} bundles; "
        f"D = {DELAY} bf16 path: {round16_ms:.3f} ms (wall, median of 5 runs of {ROUNDS} rounds each)")

    # the §6.5 phase probes of the D = 2 bf16 schedule at p_c = 2, into its ledger
    probes = engine_phase_probes(tp, dataclasses.replace(sched16, p_c=2))
    led16.set_phase_seconds({k: time_phase(fn, *args) * calls for k, (fn, args, calls) in probes.items()})
    log(f"[ledger] D = {DELAY} bf16 phase seconds a round {led16.phase_seconds}: exposed comm {led16.exposed_comm_s:.3g} s, "
        f"total {led16.total_comm_s:.3g} s over {led16.rounds} rounds, overlap efficiency {led16.overlap_efficiency:.3g} "
        f"(the simulated engine's Allreduce is the identity)")

    team_idx, team_val = tp.indices[0], tp.values[0]
    x_now = x_kernel

    def team_bundles(sb: int):
        """bundle(k) cycling over team 0's sb-row bundles, and their number"""
        offsets = list(range(0, tp.rows_local - sb + 1, sb))
        return (lambda k: (team_idx[offsets[k % len(offsets)]:][:sb], team_val[offsets[k % len(offsets)]:][:sb]),
                len(offsets))

    # news20's width (540) and columns, distinct ids a row: one bundle
    news_idx, news_val, news_x = random_bundle(128, 540, NEWS20_N, 500, device, unique=True)
    # label: (sb, s, b, bundle(k), bundles a timed pass, x, n) — the main
    # path's bundle, one four times as tall, and news20's width; the
    # corrections are timed at the first two (their time does not depend on w)
    shapes = {"sb128": (S * B, S, B, *team_bundles(S * B), x_now, tp.n),
              "sb512": (512, 16, 32, *team_bundles(512), x_now, tp.n),
              "w540": (128, None, None, lambda k: (news_idx, news_val), 8, news_x, NEWS20_N)}
    report = {}
    inner_inputs = {}  # label: (s, b, G, v) — the corrections' timed inputs
    for label, (sb, s, b, bundle, per_pass, x_in, n_cols) in shapes.items():
        # bounds from this run's inputs (bundle 0): bytes each read or written
        # once over the memory rate, against the operations that (G, v) needs
        # over the peak rate for the mode's type (FP32 outside the tensor
        # cores; bf16 dense): one multiply-add per pair of nonzeros of rows
        # i > j that share a column id, one per nonzero for v. The kernel's
        # own work is a table lookup per nonzero of row i and row j < i; that
        # count, at one lookup per FP32 lane and cycle, is printed beside the
        # bound (design_ops_ms), not as it.
        bi, bv = bundle(0)
        w = int(bi.shape[1])
        nnz = (bv != 0).sum(dim=1).double()
        gram_bytes = bi.numel() * 8 + int(torch.unique(bi).numel()) * 4 + sb * sb * 4 + sb * 4
        gram_flop = 2.0 * matching_pairs(bi, bv, n_cols) + 2.0 * float(nnz.sum())
        gram_design_ms = gram_probes(bv) / FP32_FLOP_PER_S * 1e3
        report[label] = {}
        for mode, flop_rate in (("fp32", FP32_FLOP_PER_S), ("bf16", BF16_FLOP_PER_S)):
            def gram(k):
                return ell_gram_and_v(*bundle(k), x_in, n=n_cols, precision=mode)

            gram_ms = device_ms(gram, inner=per_pass)  # one pass over the bundles
            gram_eager_ms = eager_ms(gram, inner=10)
            gram_plain_ms = eager_ms(lambda k: ell_gram_and_v_blocked(*bundle(k), x_in, n=n_cols, bk=512, precision=mode),
                                     inner=1, warmup=1, reps=20 if n_cols < 10**6 else 5)
            wire = torch.float32 if mode == "fp32" else torch.bfloat16

            def library(k):
                dense = densify_bundle_ref(*bundle(k), n_cols).to(wire)
                return torch.tril(dense @ dense.T, diagonal=-1), dense @ x_in.to(wire)

            gram_lib_ms = eager_ms(library, inner=2)
            report[label][f"ell_gram.{mode}"] = dict(
                ms=gram_ms, eager_ms=gram_eager_ms, plain_ms=gram_plain_ms, library_ms=gram_lib_ms,
                bound={"bytes": gram_bytes / HBM_BYTES_PER_S * 1e3, "operations": gram_flop / flop_rate * 1e3},
                design_ops_ms=gram_design_ms)
            if s is None:
                continue
            g, v = ell_gram_and_v(*bundle(0), x_in, n=n_cols)
            inner_inputs[label] = (s, b, g, v)
            tri = b * b * s * (s - 1) // 2  # entries of G's strict lower block triangle

            def corrections(k):
                return sstep_inner(g, v, s, b, ETA, precision=mode)

            inner_ms = device_ms(corrections, inner=20)
            inner_eager_ms = eager_ms(corrections, inner=10)
            inner_plain_ms = eager_ms(lambda k: sstep_inner_ref(g, v, s, b, ETA, precision=mode), inner=1, warmup=1)
            report[label][f"sstep_inner.{mode}"] = dict(
                ms=inner_ms, eager_ms=inner_eager_ms, plain_ms=inner_plain_ms, library_ms=None,
                bound={"bytes": (tri * 4 + 2 * sb * 4) / HBM_BYTES_PER_S * 1e3,
                       "operations": (2.0 * tri + 8.0 * sb) / flop_rate * 1e3},
                design_ops_ms=None)
        for name, row in report[label].items():
            by = max(row["bound"], key=row["bound"].get)
            row["bound_ms"], row["bound_by"] = row["bound"][by], by
            library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
            log(f"[times] {name:16s} sb = {sb:3d} (s = {s}, b = {b}, w = {w}, n = {n_cols}): kernel {row['ms']:.4f} ms on the "
                f"device ({row['eager_ms']:.4f} ms a call from Python), plain {row['plain_ms']:.4f} ms, library {library}, "
                f"bound {row['bound_ms']:.6f} ms by {by} (bytes {row['bound']['bytes']:.3g}, operations {row['bound']['operations']:.3g})"
                + ("" if row["design_ops_ms"] is None else f", the design's lookups alone {row['design_ops_ms']:.3g} ms"))

    # the launch floor: the least device time of a kernel node in a CUDA
    # graph on this card, timed as the kernels are
    one = torch.zeros(1, dtype=torch.float32, device=device)
    launch_floor_ms = device_ms(lambda k: one.add_(1.0), inner=20)
    log(f"[times] launch floor (a one-element add_ in a CUDA graph): {launch_floor_ms:.5f} ms on the device")

    ab = None
    args = sys.argv[1:]
    for at in (i for i, a in enumerate(args) if a == "--ab"):
        old_source = ROOT / args[at + 1]
        if "sstep_inner_launch" in old_source.read_text():
            ab = {**(ab or {}), **ab_inner_times(old_source, inner_inputs, _build)}
        else:
            ab = {**(ab or {}), **ab_times(old_source, shapes, ell_gram_and_v, _build)}
    sweep = sweep_inner(inner_inputs) if "--sweep" in args else None

    # the Yᵀu scatter-add of one main-path bundle (PyTorch's index_add_, no
    # kernel of the port)
    blk = EllBlock(indices=team_idx[: S * B], values=team_val[: S * B], n=tp.n)
    u = torch.rand(S * B, device=device)
    rmat_ms = eager_ms(lambda k: ell_rmatvec(blk, u), inner=10)
    log(f"[times] ell_rmatvec (index_add_) {rmat_ms:.4f} ms a call from Python")

    if "--profile" in sys.argv[1:]:
        profile_main_path("synchronous fp32", lambda: run_engine_chunk(tp, x0, 0, ROUNDS, sched), ROUNDS)
        profile_main_path(f"D = {DELAY} bf16", lambda: run_engine_chunk(tp, x0, 0, ROUNDS, sched16), ROUNDS)

    # ---- the front door: spec → plan → Session → report → sweep ----------
    front = front_door_phase(tp, zero_counts, counts, smi)
    print(json.dumps({"front_door": front}), flush=True)

    # ---- phase 6: the kernels line, the device lines ---------------------
    # each (kernel, mode) with its launches on the path that runs it: the
    # synchronous fp32 path for both fp32 modes, the D = 2 bf16 path for the
    # bf16 Gram. No engine path runs the bf16 corrections (the reference's
    # engine unwires (G, v) to fp32 first): phase 3 alone launches that mode.
    paths = {"ell_gram.fp32": ("synchronous fp32", launches), "sstep_inner.fp32": ("synchronous fp32", launches),
             "ell_gram.bf16": (f"D = {DELAY} bf16", launches16), "sstep_inner.bf16": (None, None)}
    kernels = []
    for key, (path, path_counts) in paths.items():
        name, mode = key.split(".")
        row = report["sb128"][key]
        kernels.append({
            "name": name if mode == "fp32" else f"{name}_bf16", "precision": mode, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {"ell_gram": "src/repro/kernels/ell_gram.py:170",
                         "sstep_inner": "src/repro/kernels/sstep_inner.py:68"}[name],
            "launches": 0 if path_counts is None else path_counts[key], "path": path,
            "max_abs_err": err[key], "tol": U_TOL if name == "sstep_inner" else GV_TOL,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "eager_ms": row["eager_ms"],
            "design_ops_ms": row["design_ops_ms"], "launch_floor_ms": launch_floor_ms,
            "shape": {"sb": S * B, "w": int(team_idx.shape[1]), "n": tp.n},
            **{label: {k: report[label][key][k] for k in TIMED_KEYS} for label in ("sb512", "w540") if key in report[label]},
        })
        if key == "ell_gram.bf16":  # rows that repeat a column id, at BF16_DUP_TOL
            kernels[-1].update(max_abs_err_repeated_ids=gram16_dup_err, tol_repeated_ids=BF16_DUP_TOL)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "round_ms": round_ms, "round_ms_delay2_bf16": round16_ms, "eta": ETA,
                      "build_s": build_s, "rmatvec_ms": rmat_ms, "path_gap": path_gap, "rerun_gap": rerun_gap,
                      "x_max": x_max, "identity_gap": gap, "skew_gap": skew_gap, "skew_identity_gap": skew_identity_gap,
                      "delay2_bf16_path_gap": gap16, "delay2_bf16_skew_gap": skew16, "delay2_bf16_vs_fp32": bf16_gap,
                      "delay2_vs_delay0": delay_gap, "ledger_capture_s": [capture_s, capture2_s],
                      "ledger_delay2_bf16": led16.to_dict(), "ab": ab, "sweep": sweep}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
