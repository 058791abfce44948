#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
mode of each (fp32 and bf16) against its plain PyTorch version on the GPU
(the Gram kernel's two routes each: the hash probe, and the dense-row route
on epsilon's rows, its shards, 512 rows and a small ragged bundle, with the
crossover between the two that ``gram_route``'s constants are set from),
drives the port's paths (the simulated HybridSGD engine: synchronous fp32,
then delay D = 2 in bf16 and in fp32) on the full-size synthetic ``rcv1``
dataset through the entry points a user calls, checks that each path went
through its kernels, reads the comm ledger, holds the rounds replayed from
CUDA graphs (``repro_torch.core.round_graph``) against the same rounds run
eagerly and times the two in turns (the graph phase), times the kernels (also on the
column-local bundles of a 2 × 2 mesh), drives the front door at the same
width (an ``ExperimentSpec`` read from JSON text → ``plan`` → ``Session`` →
save → ``Session.restore`` → ``run`` → report, the delayed bf16 schedule, a
stop policy, timed comm and a resumable sweep, with the launch counts of
each run and the front door's cost a round beside ``run_engine_chunk``'s),
then the streaming and serving plane (a replay stream through
``Session.step_stream`` in fp32 and at D = 2 in bf16, against the plain
versions, restored from an autosave; a drifting stream behind
``OnlineController``, ``PredictionService`` and its HTTP front, with client
requests beside training; one ``{"serve": ...}`` JSON line),
before those the Gram autotuner (``tune_panel`` on the card for rcv1's
profile in fp32 and bf16 and at rows 512, by device time, each candidate
(tile, ks) beside the default geometry; a second call that must hit the
cache; a ``bk=None`` Session on full rcv1 against the ``bk=512`` run; the
dense oracle against the kernel above the reference's heavy-tail width,
which must agree with the card's rule; one ``{"tune": ...}`` JSON line),
then the 2D-mesh backend (``backend="shard_map"``) through ``run(spec)`` and
``Session``: a 1 × 1 mesh on a world-size-1 NCCL group in this process
(fp32, and bf16 at D = 1, which the fp32 run must miss), and
a 2 × 2 mesh of four spawned processes sharing the card in a gloo group
with CUDA tensors (fp32 at D = 0, bf16 at D = 1), each held against the
simulated engine, with each rank's launch counts and comm ledger checked
against the closed form; then the paper's grid (``paper_mesh_phase``): full
news20 at (1, 4), (2, 2) and (4, 1) in four spawned processes sharing the
card over gloo, each building its own block alone, fp32 at D = 0 (and bf16
at D = 1 on (2, 2)), each held
against the simulated engine at the same p_r with controls that must miss
(one ``{"paper_mesh": ...}`` JSON line) — and, right after the build and before every
solver phase (on an empty card), the language-model trainer
(``repro_torch.train.loop.train``) on qwen2.5-3b at its published width,
depth cut to 2 layers: the loss at weights carried to the card against
the CPU's at the same weights, 20 adamw steps of 8 × 512 tokens in fp32
whose loss must fall, tokens/s and peak device memory (one ``{"lm": ...}``
JSON line), then the rest of the decoder zoo (``zoo_phase``): deepseek-v2-lite-16b
(MLA, MoE) through ``train()`` and falcon-mamba-7b (Mamba-1) through
``launch/steps.py``'s ``make_train_step`` with remat and microbatches, both at
their published widths cut to 2 layers — the first loss and 64 decode steps
against the CPU's, decode ≡ forward, 10 adamw steps whose loss must fall,
tokens/s, peak memory, host syncs a train and a decode step, decode tokens/s
against a 512-deep cache, prefill time — and jamba reduced (decode ≡ forward,
the first loss; one ``{"zoo": ...}`` JSON line), then the model mesh
(``model_mesh_phase``): first on a world-size-1 NCCL group in the script's
own process, qwen2.5-3b at published width, 2 layers, on a (1, 1) mesh —
one ``train(mesh=...)`` step (loss and every gradient) and 8 decode steps
against the single-device step and decode on the card — then four spawned
processes sharing the card in a gloo group with CUDA tensors, published
widths cut to 2 layers — qwen2.5-3b
through ``train(mesh=...)`` on a (2, 1, 2) pod/data/model mesh against a
FedAvg oracle computed on the card first (losses, final parameters, the pods
apart before each sync and bitwise equal after it), and deepseek-v2-lite-16b's
64 experts through ``launch/steps.make_train_step`` on a (2, 2) data/model
mesh at cf = 8 against the single-device step (the loss and every gradient
leaf), with the dropped share of the token copies at cf = 2 and 1, tokens/s,
peak memory a rank and the time of a pod sync and of an ``all_to_all``
(on gloo correctness runs, not measurements of communication; one
``{"model_mesh": ...}`` JSON line), then in the same four ranks (c) decode
on a (2, 2) data/model mesh — qwen2.5-3b, deepseek-v2-lite-16b (experts
stationary, through ``moe_ep``) and falcon-mamba-7b at published width, 2
layers, laid out by ``resolve_config(arch, decode_32k)``, ``param_pspecs``
and ``cache_shardings``, 32 serve steps of batch 8 against a 512-deep cache,
every step's logits against the single-device decode on the card, the
routing first, the cache's placements after every step, a step's
collectives the same at twice the depth and the same as torch's
``CommDebugMode`` counts — and (d) the dry run
(``launch/dryrun.run_combo`` on fake tensors) at (c)'s shape, its parameter
and cache bytes and collective counts held equal to (c)'s real ones, its
peak beside ``max_memory_allocated``, with the full-width dry run of
qwen2.5-3b × train_4k and deepseek-v2-lite-16b × decode_32k on the fake
(16, 16) mesh beside them (predictions against published peaks); then the
paper's other datasets (``paper_phase``): news20 and epsilon at full size and
url with its rows cut to 2^19 (full url under ``--paper``), each from
``make_dataset`` at its registered statistics, through the engine at the main
path's point in fp32 and at D = 2 in bf16 (rounds above the round graph's
cycle cap run eagerly), the FedAvg, s-step and mini-batch SGD corners, and on
news20 and url the logistic (λ > 0), squared-hinge and least-squares
objectives through ``ExperimentSpec`` → ``Session.step_rounds`` (their
corrections take the plain loop, on news20 inside the round graphs), every
run held against the plain versions on the card with a control that must
miss; the build seconds, host and device peaks, cycle and round walls per
dataset and the kernels on one real bundle of each; and the sweep CLI on
``examples/specs/url_sweep.json``'s three points at full url in a process of
its own (started before the model mesh, its first point also opting into the
Gram tuner), each report's loss finite and below log 2 and the tuner's cached
geometry for url's rows (one ``{"paper": ...}`` JSON line); and prints

  * the GPU's name and power limit,
  * one JSON line each ``{"graph": ...}``, ``{"tune": ...}``, ``{"front_door": ...}``,
    ``{"serve": ...}``, ``{"mesh": ...}``, ``{"paper_mesh": ...}``, ``{"paper": ...}``, ``{"lm": ...}``,
    ``{"zoo": ...}`` and ``{"model_mesh": ...}``,
  * one JSON line ``{"kernels": [...]}`` with every kernel's launches on
    the main path, error against its plain version, time, plain time,
    bound and library yardstick,
  * as the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also traces one more run of the
synchronous fp32 path and of the D = 2 bf16 path with ``torch.profiler`` and
prints the device time by kernel. ``--ab OLD.cu`` (a path from the repo root;
it may be given more than once) also builds an earlier kernel source and
times it in turns with this one at each timed shape and mode: an
``ell_gram.cu`` whose C entry point takes no launch geometry, an
``sstep_inner.cu`` whose entry point is ``sstep_inner_launch(G, v, u, s, b,
eta_over_b, bf16, stream)``, or an ``ell_gram_dense.cu`` with this one's
entry point — told apart by the entry point the source defines. ``--sweep`` also times the corrections kernel at other consumer
block sizes at the timed shapes. ``--mesh-nccl`` runs the mesh phase, the
paper's grid (full news20, epsilon and url; bf16 at D = 1 on (2, 2); url's
three partitioners at (1, 4) and a timed run a shape; rank (0, 0)'s first
column-shard bundle timed) and the model_mesh phase alone, their four ranks
over NCCL with one rank a card, on a machine with four cards: the same oracles
and limits as on gloo, DTensor's
functional all-gather held bitwise against c10d's on each mesh dim, and (a)'s
tokens/s at τ = 1 and τ = 2 in turns; its walls, a pod sync's and an
``all_to_all``'s ms are measurements of the cards' communication.
``--paper`` runs the paper phase alone, with full url and the sweep CLI after
the in-process runs (epsilon's runs held on the dense route, the others' on
the hash route, and one eager epsilon round traced). ``--gram`` runs the
Gram routes' checks and times alone. ``--paper-grid [NAME,...]`` runs the
paper's grid alone over NCCL on four cards, on the named datasets. ``--graph`` runs the graph phase alone, ``--zoo`` the zoo phase, ``--model-mesh``
the model_mesh phase, ``--decode-mesh`` its part (c), ``--dryrun`` its parts (c)
and (d). Every run prints the launch floor: the device time of a one-element PyTorch operation in a
CUDA graph.

Any failed phase ends the process with a non-zero exit code; there is no
CPU mode: without a CUDA device the script fails at once.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings

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
# the mesh phase: a 2 × 2 mesh (p_r = p_c = 2) of four processes on the one
# card, fp32 at D = 0 and bf16 at D = 1 (label: delay, precision)
MESH_P = 2
MESH_RUNS = {"fp32_d0": (0, "fp32"), "bf16_d1": (1, "bf16")}
# max |Δx| of the 2 × 2 bf16 run to the simulated one: the mesh rounds each
# shard's partial (G, v) to bf16 before the sum, the simulated engine the
# total, so the two differ by a bf16 rounding (1.53e-6 measured on an H100;
# limit ~30× that). The same run at D = 0 must land outside it. So must the
# fp32 run for the 1 × 1 bf16 run, which has no partial sums and is held at
# X_TOL: at p_c = 2 the double rounding is as large as bf16's own effect.
MESH_BF16_DX = 5e-5
# the serve phase: a drift stream of 32 rounds flipping its concept at batch
# 16, rows of width 16, a hot swap every 4 rounds; 4 client threads of
# 64-row requests beside training and at rest
SERVE_DRIFT_ROUNDS, SERVE_DRIFT_AT, SERVE_WIDTH, SERVE_SWAP_EVERY = 32, 16, 16, 4
SERVE_CLIENTS, SERVE_REQUEST_ROWS, SERVE_IDLE_S = 4, 64, 2.0
# max |Δx| of the D = 2 bf16 replay stream to the fp32 one at D = 2: one
# bf16 rounding of (G, v) (2.07e-6 and 2.09e-6 measured on an H100; limit
# ~25× that). The stream at D = 0 must land outside it (3.98e-4 measured),
# so a stream round that ignored the delay would fail here.
SERVE_BF16_DX = 5e-5
# the probed accuracy (the serve CLI's probe_accuracy, every 4 rounds) must
# fall below DRIFT_ACC_FALL at the first probe after the flip and climb back
# above DRIFT_ACC_RECOVER (chance) by the last probe. A CPU rehearsal of this
# phase at full size probed 0.686 before the flip, 0.313 at the first probe
# after it and 0.588 at the last (PERF.md)
DRIFT_ACC_FALL, DRIFT_ACC_RECOVER = 0.4, 0.5
# the lm phase: qwen2.5-3b at its published width, depth cut to 2 layers,
# 20 adamw steps of 8 × 512 tokens in fp32; the card's loss at the carried
# weights within 1e-4 relative of the CPU's (float32 sums in another order)
LM_LAYERS, LM_STEPS, LM_BATCH, LM_SEQ = 2, 20, 8, 512
LM_FIRST_LOSS_RTOL = 1e-4
# the zoo phase: deepseek-v2-lite-16b and falcon-mamba-7b at their published
# widths, depth cut to 2 layers, 10 adamw steps of 8 × 512 fp32 tokens each
# (falcon-mamba in microbatches of 2 sequences, 4 a step, with remat: the
# scan's (2, 256, 8192, 16) float32 levels of one layer at a time); decode ≡
# forward over 64 decode steps of a 1 × 64 sequence at the reference's own
# 2e-3; the card against the CPU (first loss, decode logits) at 1e-4
# relative; decode tokens/s at batch 8 against a 512-deep cache, 32 steps
ZOO_LAYERS, ZOO_STEPS, ZOO_BATCH, ZOO_SEQ, ZOO_MAMBA_MICROBATCH = 2, 10, 8, 512, 2
# adamw's rate for each: at 3e-4 deepseek's loss fell 0.003 over the 10 steps,
# inside its ±0.03 spread from batch to batch; at 1e-3 falcon-mamba's rose
# 11.547 → 11.949 (no warm-up), at 3e-4 it fell 11.555 → 11.521 (NVIDIA H100
# 80GB HBM3, 700.00 W)
ZOO_LR = {"deepseek-v2-lite-16b": 1e-3, "falcon-mamba-7b": 3e-4}
# each gradient leaf, card vs CPU at the carried weights (1 × 128 tokens):
# max |Δ| over the leaf's max |g|; float32 sums over up to 8,192 terms in
# another order, with room for leaves whose token sums cancel
ZOO_GRAD_RTOL = 1e-3
ZOO_DECODE_LEN, ZOO_DECODE_FORWARD_TOL, ZOO_CPU_RTOL = 64, 2e-3, 1e-4
ZOO_SERVE_BATCH, ZOO_SERVE_DEPTH, ZOO_SERVE_STEPS = 8, 512, 32
# the model_mesh phase: four processes sharing the card (gloo with CUDA
# tensors; one a card over NCCL with --mesh-nccl), published widths, depth
# cut to 2 layers. (a) qwen2.5-3b on a (2, 1, 2) ("pod", "data", "model") mesh
# through train(mesh=...): MM_STEPS adamw steps (lr MM_LR) of MM_BATCH × MM_SEQ
# global fp32 tokens, a pod sync every MM_TAU, against a card-side FedAvg
# oracle (each pod's half batch through the single-device step, separate
# optimizer states, the parameter mean at each sync): each step's loss within
# MM_LOSS_RTOL; the final parameters' mean |Δ| within MM_PARAM_MEAN_ATOL and
# every entry within adam's reach of 2·lr·steps. (Float32 sums over the model
# shards run in another order; where an entry's gradient is mostly rounding —
# a key bias's is zero in exact arithmetic, the softmax ignoring a shift —
# adam's normalised step turns that noise into moves of up to lr a step: 4.8e-5
# on a key bias, 1.4e-5 on w_down after 2 steps of reduced qwen on the CPU,
# where plain SGD agrees to 1.2e-7.)
# (b) deepseek-v2-lite-16b (64 experts) on a (2, 2) ("data", "model") mesh:
# one launch/steps.make_train_step step of MM_MOE_BATCH × MM_SEQ at cf = 8
# against the single-device step: the loss within ZOO_CPU_RTOL, each gradient
# leaf within ZOO_GRAD_RTOL of its largest entry
MM_LAYERS, MM_STEPS, MM_BATCH, MM_SEQ, MM_TAU, MM_MOE_BATCH = 2, 4, 8, 512, 2, 4
MM_LR, MM_LOSS_RTOL, MM_PARAM_MEAN_ATOL = 3e-4, 1e-4, 1e-6
MM_RANKS = 4
# (c) decode on the (2, 2) mesh: qwen2.5-3b (the "dp" profile under decode),
# deepseek-v2-lite-16b (MLA; experts stationary, through moe_ep) and
# falcon-mamba-7b at published width, MM_LAYERS layers, laid out by
# resolve_config(arch, decode_32k), param_pspecs and cache_shardings: batch
# MM_DEC_BATCH against a MM_DEC_DEPTH-deep cache, MM_DEC_STEPS serve steps,
# each step's logits within ZOO_CPU_RTOL of the single-device decode on the
# card (max |Δ| over max |logit|), deepseek's routing equal first
MM_DEC_ARCHS = ("deepseek-v2-lite-16b", "qwen2.5-3b", "falcon-mamba-7b")  # deepseek first: (b) drew its weights
MM_DEC_BATCH, MM_DEC_DEPTH, MM_DEC_STEPS = 8, 512, 32
# (d) the dry run (launch/dryrun.run_combo) in each rank at (c)'s decode shape,
# and on the host at full depth on the (16, 16) fake production mesh
MM_DRY_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b")
MM_HOST_DRY = (("qwen2.5-3b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"))
MM_PARTS = ("hybrid", "moe", "decode", "dryrun")
# (a) over NCCL, one card a rank: tokens/s of train(mesh=...) at τ = 1 and at
# τ = MM_TAU, MM_TAU_TURNS turns of each (the first side alternating), each a
# run of MM_TAU_STEPS steps from the same weights; the paper's trade-off
MM_TAU_TURNS, MM_TAU_STEPS = 3, 8
# the ranks' process-group timeout: gloo carries a 2-layer step of published
# width through the host for minutes; a NCCL collective that waits this long
# on a peer has lost it
MM_TIMEOUT_S = {"gloo": 900, "nccl": 300}
# the world-size-1 NCCL model mesh in the script's own process (qwen2.5-3b,
# published width, MM_LAYERS layers): one train(mesh=...) step of
# MM_NCCL1_BATCH × MM_SEQ on a (1, 1) ("data", "model") mesh, its loss and
# gradients against the single-device step's (ZOO_CPU_RTOL, ZOO_GRAD_RTOL),
# and MM_NCCL1_DECODE decode steps of MM_DEC_BATCH against a MM_DEC_DEPTH-deep
# cache against the single-device decode (ZOO_CPU_RTOL)
MM_NCCL1_BATCH, MM_NCCL1_DECODE = 4, 8
# served margins against a float64 host einsum over the version's
# checkpoint weights: max |Δ| over max |margin| of the version's answers
MARGIN_RTOL = 1e-6
# the graph phase: runs of 128 rounds (a benchmark window) graphed against
# eager, and GRAPH_TURNS windows of each of eager, serial and branched
# graphs in turns
GRAPH_ROUNDS, GRAPH_TURNS = 128, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED — {what}")


def sync() -> None:
    torch.cuda.synchronize()


@contextlib.contextmanager
def deferred_checks():
    """Inside the block a failed ``check`` is logged and kept in the list
    the block gets, instead of ending the run, and an exception ends only
    the block, kept the same way: the caller fails on the list."""
    failed: list = []
    real = globals()["check"]

    def keep(cond: bool, what: str) -> None:
        if not cond:
            log(f"chip_smoke: FAILED — {what}")
            failed.append(what)

    globals()["check"] = keep
    try:
        yield failed
    except Exception:
        log(traceback.format_exc())
        failed.append(traceback.format_exc().strip().splitlines()[-1])
    finally:
        globals()["check"] = real


@contextlib.contextmanager
def plain_corrections():
    """Inside: the corrections of the simulated engine and of the mesh's
    round body run the plain PyTorch loop instead of the ``sstep_inner``
    kernel (each module looks the function up when it runs). With
    ``gram="blocked"`` in the schedule a round then launches no kernel of
    the port."""
    from repro_torch.core import distributed, engine

    kernel = engine.inner_corrections
    engine.inner_corrections = distributed.inner_corrections = engine.inner_corrections_loop
    try:
        yield
    finally:
        engine.inner_corrections = distributed.inner_corrections = kernel


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


def profile_main_path(label: str, run, rounds: int) -> dict:
    """``--profile``: trace one more run of a path and print where the
    device time went, by kernel name, and the device's busy share.
    Returns the wall and the device's busy time a round, in ms, and the
    idle share of the wall. Busy is the union of the device activities'
    spans: where kernels overlap (a round graph's teams on side streams)
    it is less than their summed time (``kernel_ms``)."""
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
    kernel_us = sum(r[0] for r in device_rows)
    host_us = sum(r[0] for r in host_rows)
    busy_us, reached = 0.0, -math.inf
    for start, end in sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                             if str(ev.device_type).endswith("CUDA")):
        if end > reached:
            busy_us += end - max(start, reached)
            reached = end
    check(busy_us > 0, "the profiler recorded no device time")
    log(f"[profile] {label} path, {rounds} rounds under the profiler: wall {wall_us / rounds / 1e3:.3f} ms a round, device busy "
        f"{busy_us / rounds / 1e3:.3f} ms a round = {busy_us / wall_us:.1%} of the wall time (idle {1 - busy_us / wall_us:.1%}; "
        f"kernels {kernel_us / rounds / 1e3:.3f} ms a round summed); host time inside traced operators "
        f"{host_us / rounds / 1e3:.3f} ms a round")
    for self_us, count, key in sorted(device_rows, reverse=True)[:10]:
        log(f"[profile] device {self_us / rounds:9.1f} us a round  {self_us / kernel_us:6.1%}  {count / rounds:6.1f} a round  {key[:80]}")
    for self_us, count, key in sorted(host_rows, reverse=True)[:10]:
        log(f"[profile] host   {self_us / rounds:9.1f} us a round  {self_us / wall_us:6.1%} of wall  {count / rounds:6.1f} a round  {key[:80]}")
    return {"wall_ms": wall_us / rounds / 1e3, "busy_ms": busy_us / rounds / 1e3, "idle_share": 1 - busy_us / wall_us,
            "kernel_ms": kernel_us / rounds / 1e3}


def errors(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float, bool]:
    """(max abs error, max rel error, allclose at rtol = atol = tol)."""
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-30)).where(want != 0, torch.zeros_like(diff)).max())
    return max_abs, max_rel, bool(torch.all(diff <= tol + tol * want.abs()))


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


def ab_dense_times(old_source: pathlib.Path, device, build) -> dict:
    """``--ab OLD.cu`` for the dense route: an earlier ``ell_gram_dense.cu``
    with this one's C entry point, built beside it and timed in turns with
    it — old, new, new, old — at the dense route's timed shapes in both
    modes, after the two agree to the bit on distinct ids. Device ms of
    each turn."""
    import ctypes

    from repro_torch.kernels.ell_gram import dense_geometry, ell_gram_dense

    lib = build_old(old_source, "ell_gram_dense", build)
    lib.ell_gram_dense_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.ell_gram_dense_launch.restype = ctypes.c_int

    def old(idx, val, x, n, precision):
        sb, w = val.shape
        geo = dense_geometry(sb, n, precision)
        g = torch.empty((sb, sb), dtype=torch.float32, device=val.device)
        v = torch.empty((sb,), dtype=torch.float32, device=val.device)
        work = torch.empty((geo.workspace_bytes,), dtype=torch.uint8, device=val.device)
        base = work.data_ptr()
        rc = lib.ell_gram_dense_launch(idx.data_ptr(), val.data_ptr(), x.data_ptr(), g.data_ptr(), v.data_ptr(), base,
                                       base + geo.ws_offset, base + geo.ticket_offset, sb, w, n, geo.n_pad, geo.tiles,
                                       geo.splits, geo.per, int(precision == "bf16"), geo.densify_smem,
                                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the --ab dense kernel did not launch: CUDA error {rc}")
        return g, v

    result = {}
    for label in ("shuffled", "sb512", "col2", "col4"):
        kind, sb, w, n = DENSE_CHECKS[label]
        idx, val, x = dense_bundle(kind, sb, w, n, 850, device)
        for mode in ("fp32", "bf16"):
            runs = {"old": lambda k: old(idx, val, x, n, mode),
                    "new": lambda k: ell_gram_dense(idx, val, x, n=n, precision=mode)}
            check(all(torch.equal(a, b) for a, b in zip(runs["old"](0), runs["new"](0))),
                  f"--ab: the two dense kernels differ at {label} {mode}")
            turns = _turns(runs, 10, ("old", "new", "new", "old"))
            old_ms, new_ms = statistics.mean(turns["old"]), statistics.mean(turns["new"])
            result[f"ell_gram_dense.{label}.{mode}"] = {"old_ms": turns["old"], "new_ms": turns["new"]}
            log(f"[ab] ell_gram dense {mode} {label} (sb, w, n) = {(sb, w, n)}: earlier kernel {old_ms:.5f} ms, this one "
                f"{new_ms:.5f} ms on the device ({old_ms / new_ms:.2f}×; turns old {turns['old'][0]:.5f}, new "
                f"{turns['new'][0]:.5f}, new {turns['new'][1]:.5f}, old {turns['old'][1]:.5f}; bitwise equal)")
    return result


def check_gram(device, err: dict, grid, edge_shapes) -> tuple[float, int]:
    """Phase 3 for ell_gram's hash route (``ell_gram_hash``, called
    directly: every shape holds the hash kernel, whichever route
    ``gram_route`` gives it): each mode against its plain version and the
    dense oracle on random bundles of each (sb, w, n) of ``grid`` (rows
    that repeat an id, and rows that do not), and on the ``EDGE_KINDS`` at
    each shape of ``edge_shapes``; two launches on rows with distinct ids
    must be bitwise equal. Keeps the worst error of each mode in ``err``;
    returns the worst bf16 error on rows that repeat an id and the number
    of bitwise checks."""
    from repro_torch.kernels.ell_gram import ell_gram_and_v_blocked
    from repro_torch.kernels.ell_gram import ell_gram_hash as ell_gram_and_v
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


# the dense route's phase-3 shapes (label: kind, sb, w, n): epsilon's
# bundle as its rows lie (every id, in order), shuffled distinct ids, ids
# drawn with repeats and a padded tail, the s-step corner's 512 rows, the
# paper grid's column shards at p_c = 2 and 4, and a small ragged bundle
DENSE_CHECKS = {"epsilon": ("ordered", 128, 2000, 2000), "shuffled": ("shuffled", 128, 2000, 2000),
                "repeated": ("repeated", 128, 2000, 2000), "sb512": ("shuffled", 512, 2000, 2000),
                "col2": ("shuffled", 128, 1000, 1000), "col4": ("shuffled", 128, 500, 500),
                "small": ("shuffled", 72, 64, 64)}
# the routes' crossover (phase 5): sb = 128, each width, n = ratio·w (at
# w = 2,000 a densified row of n = 32,000 is about the most pass A holds)
CROSSOVER_WIDTHS = {2000: (1, 2, 4, 8, 16), 500: (1, 2, 4, 8, 16, 32, 64), 256: (1, 2, 4, 8, 16), 128: (1, 2, 4, 8)}
# a route wins a point where its device time is below this share of the
# other's: the turns of one reading spread by < 1 % (NVIDIA H100 80GB HBM3)
CROSSOVER_MARGIN = 0.95


def crossover(wins: dict) -> tuple[int, int]:
    """(DENSE_MIN_WIDTH, DENSE_RATIO) from {(w, ratio): dense won}: of the
    rules "w ≥ floor and n ≤ ratio·w" (floor a measured width, ratio a
    measured ratio) that send no point the dense route did not win to it,
    the one that sends it the most points it won (ties: the lower floor,
    then the higher ratio); (0, 0) if none sends it any."""
    widths = sorted({w for w, _ in wins})
    ratios = sorted({r for _, r in wins})
    best, rule = 0, (0, 0)
    for floor in widths:
        for ratio in ratios:
            sent = [won for (w, r), won in wins.items() if w >= floor and r <= ratio]
            if all(sent) and len(sent) > best:
                best, rule = len(sent), (floor, ratio)
    return rule


def dense_bundle(kind: str, sb: int, w: int, n: int, seed: int, device):
    """Rows that cover their columns: "ordered" every id 0..n−1 in order
    (epsilon's rows as ``make_dataset`` lays them out), "shuffled" w
    distinct ids a row in random order, "repeated" ``random_bundle``'s
    rows (an id twice in every row, a padded tail)."""
    if kind == "repeated":
        return random_bundle(sb, w, n, seed, device)
    rng = np.random.default_rng(seed)
    if kind == "ordered":
        idx = np.tile(np.arange(w, dtype=np.int32), (sb, 1))
    else:
        idx = np.stack([rng.permutation(n)[:w] for _ in range(sb)]).astype(np.int32)
    val = (rng.standard_normal((sb, w)) / math.sqrt(w)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device),
            torch.from_numpy(x).to(device))


def route_counts() -> dict:
    """{"hash.fp32": n, ...}: the Gram wrapper's launches by route and mode."""
    from repro_torch.kernels.ell_gram import ell_gram_and_v

    return {f"{route}.{mode}": n for route, counts in ell_gram_and_v.route_launches.items()
            for mode, n in counts.items()}


def check_gram_dense(device, err: dict) -> int:
    """Phase 3 for the dense route: at each of DENSE_CHECKS, in both modes,
    the wrapper (which must take the dense route: its count moves, the
    hash count does not) against both plain versions (the panel walk and
    ``ell_gram_dense_plain``) at GV_TOL — repeated ids too, since the route
    rounds as they do — and against the fp32 dense oracle (BF16_DUP_TOL in
    bf16); on distinct-id rows a second launch bitwise equal. The small
    bundle, whose width the rule keeps on the hash route, calls
    ``ell_gram_dense`` directly (its count moves all the same). Keeps the
    worst error of each mode under "ell_gram_dense.<mode>"; returns the
    number of bitwise checks."""
    from repro_torch.kernels.ell_gram import (
        ell_gram_and_v, ell_gram_and_v_blocked, ell_gram_dense, ell_gram_dense_plain, gram_route,
    )
    from repro_torch.kernels.ref import ell_gram_and_v_ref

    bitwise = 0
    for case, (label, (kind, sb, w, n)) in enumerate(DENSE_CHECKS.items()):
        routed = gram_route(sb, w, n) == "dense"
        check(routed or label == "small", f"{label} {(sb, w, n)} does not take the dense route")
        # the small bundle sits below DENSE_MIN_WIDTH: the route is called directly
        gram = ell_gram_and_v if routed else ell_gram_dense
        idx, val, x = dense_bundle(kind, sb, w, n, 700 + case, device)
        og, ov = ell_gram_and_v_ref(idx, val, x, n)
        for mode in ("fp32", "bf16"):
            before = route_counts()
            g, v = gram(idx, val, x, n=n, precision=mode)
            sync()
            moved = {k: c - before[k] for k, c in route_counts().items() if c != before[k]}
            check(moved == {f"dense.{mode}": 1}, f"ell_gram {mode} {label}: launches by route moved by {moved}")
            what = f"ell_gram dense {mode} {label} {(sb, w, n)}"
            check(g.shape == (sb, sb) and v.shape == (sb,) and bool(torch.all(torch.triu(g) == 0)),
                  f"{what}: shapes or triu(G) != 0")
            pg, pv = ell_gram_and_v_blocked(idx, val, x, n=n, bk=512, precision=mode)
            dg, dv = ell_gram_dense_plain(idx, val, x, n=n, precision=mode)
            oracle_tol = GV_TOL if mode == "fp32" else BF16_DUP_TOL  # the oracle is fp32
            worst = 0.0
            for got, want, name, t in ((g, pg, "G~plain", GV_TOL), (v, pv, "v~plain", GV_TOL),
                                       (g, dg, "G~dense plain", GV_TOL), (v, dv, "v~dense plain", GV_TOL),
                                       (g, og, "G~oracle", oracle_tol), (v, ov, "v~oracle", oracle_tol)):
                max_abs, max_rel, ok = errors(got, want, t)
                check(ok and math.isfinite(max_abs), f"{what} {name}: max abs {max_abs}, max rel {max_rel} (tol {t})")
                if "plain" in name:
                    worst = max(worst, max_abs)
            err[f"ell_gram_dense.{mode}"] = max(err.get(f"ell_gram_dense.{mode}", 0.0), worst)
            if kind != "repeated":
                g2, v2 = gram(idx, val, x, n=n, precision=mode)
                sync()
                check(torch.equal(g, g2) and torch.equal(v, v2), f"{what}: two launches differ")
                bitwise += 1
            log(f"[kernels] ell_gram    dense {mode} {label:9s} (sb, w, n) = {(sb, w, n)}"
                + ("" if routed else " (called directly)") + f": max abs err {worst:.3g} against "
                f"both plain versions (tol {GV_TOL})" + ("" if kind == "repeated" else ", a second launch bitwise equal"))
    return bitwise


def _turns(runs: dict, inner: int, order: tuple) -> dict:
    """Device ms of each of ``runs`` (label: fn(k)), timed in the turns of
    ``order`` in one process; {label: [ms of each turn]}."""
    turns = {label: [] for label in runs}
    for label in order:
        turns[label].append(device_ms(runs[label], inner=inner))
    return turns


def time_gram_routes(device) -> dict:
    """Phase 5 for the dense route: at each of DENSE_CHECKS but the repeated
    and the ordered one (whose times are the shuffled one's), in both modes,
    the wrapper (routed: device and eager ms), the dense route and the hash
    route called directly, in turns (dense, hash, hash, dense) by CUDA-graph
    device time, the library (densify + ``torch.matmul``, eager), the dense
    plain version (eager) and the bound; then the crossover: at sb = 128
    and each of CROSSOVER_WIDTHS, n = ratio·w, the two routes in turns on
    the same rows, each first held against the panel walk. Returns
    {"shapes": ..., "crossover": ..., "crossover_ratio": ...}."""
    from repro_torch.kernels.ell_gram import (
        DENSE_MIN_WIDTH, DENSE_RATIO, dense_geometry, ell_gram_and_v, ell_gram_and_v_blocked, ell_gram_dense,
        ell_gram_dense_plain, ell_gram_hash, gram_route,
    )
    from repro_torch.kernels.ref import densify_bundle_ref
    from repro_torch.launch.roofline import probe_bound

    out = {"shapes": {}, "crossover": {}}
    for label in ("shuffled", "sb512", "col2", "col4", "small"):
        kind, sb, w, n = DENSE_CHECKS[label]
        idx, val, x = dense_bundle(kind, sb, w, n, 800, device)
        bound = probe_bound(idx, val)
        geo = dense_geometry(sb, n)
        row = {"sb": sb, "w": w, "n": n, "splits": geo.splits, "tiles": geo.tile_count,
               "workspace_bytes": geo.workspace_bytes}
        for mode in ("fp32", "bf16"):
            wire = torch.float32 if mode == "fp32" else torch.bfloat16

            def library(k):
                dense = densify_bundle_ref(idx, val, n).to(wire)
                return torch.tril(dense @ dense.T, diagonal=-1), dense @ x.to(wire)

            runs = {"dense": lambda k: ell_gram_dense(idx, val, x, n=n, precision=mode),
                    "hash": lambda k: ell_gram_hash(idx, val, x, n=n, precision=mode)}
            turns = _turns(runs, 10, ("dense", "hash", "hash", "dense"))
            lib = [eager_ms(library, inner=2) for _ in range(2)]
            t = dict(ms=device_ms(lambda k: ell_gram_and_v(idx, val, x, n=n, precision=mode), inner=10),
                     eager_ms=eager_ms(lambda k: ell_gram_and_v(idx, val, x, n=n, precision=mode), inner=10),
                     dense_ms=statistics.mean(turns["dense"]), hash_ms=statistics.mean(turns["hash"]),
                     turns=turns, library_ms=statistics.mean(lib), library_turns=lib,
                     plain_ms=eager_ms(lambda k: ell_gram_dense_plain(idx, val, x, n=n, precision=mode),
                                       inner=1, warmup=1),
                     bound={"bytes": bound.memory_s * 1e3, "operations": bound.compute_s * 1e3})
            by = max(t["bound"], key=t["bound"].get)
            t.update(bound_ms=t["bound"][by], bound_by=by)
            row[mode] = t
            log(f"[times] ell_gram dense route {mode} {label:8s} (sb, w, n) = {(sb, w, n)}, {geo.tile_count} tiles × "
                f"{geo.splits} splits: routed {t['ms']:.5f} ms on the device ({t['eager_ms']:.4f} ms a call from "
                f"Python); in turns dense {t['dense_ms']:.5f}, hash {t['hash_ms']:.5f} ms ({t['hash_ms'] / t['dense_ms']:.2f}×); "
                f"library {t['library_ms']:.4f} ms; dense plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.6f} ms by {by}")
        out["shapes"][label] = row

    wins = {}
    for w, ratios in CROSSOVER_WIDTHS.items():
        for ratio in ratios:
            n = ratio * w
            idx, val, x = dense_bundle("shuffled", 128, w, n, 900 + ratio, device)
            row = {}
            for mode in ("fp32", "bf16"):
                pg, pv = ell_gram_and_v_blocked(idx, val, x, n=n, bk=512, precision=mode)
                for route, fn in (("dense", ell_gram_dense), ("hash", ell_gram_hash)):
                    g, v = fn(idx, val, x, n=n, precision=mode)
                    ok = errors(g, pg, GV_TOL)[2] and errors(v, pv, GV_TOL)[2]
                    check(ok, f"crossover {route} {mode} at (128, {w}, {n}): off the plain version")
                runs = {"dense": lambda k: ell_gram_dense(idx, val, x, n=n, precision=mode),
                        "hash": lambda k: ell_gram_hash(idx, val, x, n=n, precision=mode)}
                turns = _turns(runs, 10, ("dense", "hash", "hash", "dense"))
                row[mode] = {"dense_ms": statistics.mean(turns["dense"]), "hash_ms": statistics.mean(turns["hash"]),
                             "turns": turns}
            wins[(w, ratio)] = all(row[m]["dense_ms"] < CROSSOVER_MARGIN * row[m]["hash_ms"] for m in ("fp32", "bf16"))
            out["crossover"][f"w{w}_n{n}"] = {"w": w, "n": n, "ratio": ratio, "dense_won": wins[(w, ratio)], **row}
            log(f"[times] crossover sb = 128, w = {w}, n = {n} (n/w = {ratio}): "
                + "; ".join(f"{m} dense {row[m]['dense_ms']:.5f} ms, hash {row[m]['hash_ms']:.5f} ms" for m in ("fp32", "bf16")))
    # what DENSE_MIN_WIDTH and DENSE_RATIO are set from
    floor, ratio = crossover(wins)
    out.update(crossover_min_width=floor, crossover_ratio=ratio, dense_min_width=DENSE_MIN_WIDTH,
               dense_ratio=DENSE_RATIO)
    log(f"[times] crossover: the dense route won (by {1 - CROSSOVER_MARGIN:.0%} in both modes) from w = {floor} up to "
        f"n/w = {ratio}; the rule has DENSE_MIN_WIDTH = {DENSE_MIN_WIDTH}, DENSE_RATIO = {DENSE_RATIO}")
    check(all(wins[(w, r)] for w, r in wins if gram_route(128, w, w * r) == "dense"),
          "the route rule sends a measured point to the dense route where the hash route was as fast")
    return out


def rel_dev(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| over max |ref|."""
    return float((got - ref).abs().max() / ref.abs().max())


@contextlib.contextmanager
def eager_rounds():
    """Inside: the simulated engine's round dispatcher is rebound to the
    plain loop of ``_one_round``, so every round runs eagerly (as before
    rounds were replayed from CUDA graphs)."""
    from repro_torch.core import engine

    graphed = engine._run_rounds

    def eager(tp, x, rounds, eta, sched, geometry=None):
        for r in rounds:
            x = engine._one_round(tp, x, r, eta, sched, geometry)
        return x

    engine._run_rounds = eager
    try:
        yield
    finally:
        engine._run_rounds = graphed


def graph_phase(tp, smi: str) -> dict:
    """The simulated engine's rounds replayed from CUDA graphs
    (``repro_torch.core.round_graph``) on the main path's team problem,
    against the same rounds run eagerly (the dispatcher rebound by
    ``eager_rounds``): GRAPH_ROUNDS rounds synchronous fp32 and at
    D = DELAY bf16, x within X_TOL·max |x| (the Yᵀu scatter's atomics) and
    the launch counts equal; one graph a round residue; the plain versions
    launch nothing and capture nothing; a Gram off by 1 % is captured
    anew and misses the limit; then the wall and the timing thread's CPU
    time a round, in turns: eager, the graphs (teams on side streams), and
    graphs with the teams in series (``SerialRoundGraph``, on a copy of the
    problem, so each layout has graphs of its own), and a traced run of
    each layout. Returns the numbers for the phase's JSON line."""
    from repro_torch.core import engine, round_graph
    from repro_torch.core.engine import ParallelSGDSchedule, run_engine_chunk

    device = tp.values.device
    x0 = torch.zeros(tp.n, dtype=torch.float32, device=device)
    sync_sched = ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=GRAPH_ROUNDS)
    scheds = {"sync_fp32": sync_sched, f"d{DELAY}_bf16": dataclasses.replace(sync_sched, delay=DELAY, precision="bf16")}
    cycle = round_graph.round_cycle(tp.rows_local, S * B, TAU // S)
    check(cycle <= round_graph.CYCLE_CAP, f"{DATASET}'s cycle {cycle} exceeds the cap {round_graph.CYCLE_CAP}")
    # each residue runs eagerly at its first sight and is captured at its second
    want = {"captures": min(cycle, GRAPH_ROUNDS - cycle), "replays": GRAPH_ROUNDS - cycle}
    out = {"card": smi, "cycle": cycle, "cycle_cap": round_graph.CYCLE_CAP, "rounds": GRAPH_ROUNDS}

    def captured() -> dict:
        return dict(round_graph.counts)

    for label, sched in scheds.items():
        before = captured()
        zero_launch_counts()
        x_graph = run_engine_chunk(tp, x0, 0, GRAPH_ROUNDS, sched)
        sync()
        graphed = launch_counts()
        made = {k: round_graph.counts[k] - before[k] for k in before}
        check(made == want, f"{label}: {made} over {GRAPH_ROUNDS} rounds, expected {want}")
        with eager_rounds():
            zero_launch_counts()
            x_eager = run_engine_chunk(tp, x0, 0, GRAPH_ROUNDS, sched)
            sync()
            eager = launch_counts()
        x_max = float(x_eager.abs().max())
        gap = float((x_graph - x_eager).abs().max())
        log(f"[graph] {label}, {GRAPH_ROUNDS} rounds: graphed vs eager max |Δx| = {gap:.3g} with max |x| = {x_max:.3g} "
            f"(limit {X_TOL * x_max:.3g}); launches graphed {graphed}, eager {eager}; {made}")
        check(bool(torch.isfinite(x_graph).all()) and x_max > 0 and gap <= X_TOL * x_max,
              f"{label}: the graphed rounds are {gap} from the eager ones")
        check(graphed == eager and sum(graphed.values()) == 2 * GRAPH_ROUNDS * P_R * (TAU // S),
              f"{label}: launches graphed {graphed} against eager {eager}")
        out[label] = {"gap": gap, "x_max": x_max, "launches": graphed, **made}

    # one graph a residue, and the memory they hold
    held = round_graph.graphs_of(tp)
    per_sched = {label: len(round_graph.graphs_for(tp, x0, sched, None).graphs) for label, sched in scheds.items()}
    check(all(n == want["captures"] for n in per_sched.values()),
          f"graphs a schedule {per_sched}, expected {want['captures']} each")
    out["graphs_per_schedule"] = per_sched
    out["graphs_on_problem"] = sum(len(g.graphs) for g in held)
    pools = {tuple(g.pool) for g in held if g.pool is not None}
    out["pool_bytes"] = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                            if tuple(seg["segment_pool_id"]) in pools)
    out["static_x_bytes"] = sum(g.x.numel() * g.x.element_size() for g in held if g.x is not None)
    log(f"[graph] graphs a schedule {per_sched} ({out['graphs_on_problem']} on the problem, every schedule of the run); "
        f"their pools hold {out['pool_bytes']} bytes, the static iterates {out['static_x_bytes']}")
    check(out["pool_bytes"] > 0, "the graphs' pools hold no memory")

    # the plain versions: no launch, no capture
    before = captured()
    zero_launch_counts()
    with plain_corrections():
        run_engine_chunk(tp, x0, 0, 4, dataclasses.replace(sync_sched, gram="blocked"))
    sync()
    check(not any(launch_counts().values()) and captured() == before,
          f"the plain versions launched {launch_counts()} and made {captured()} (before: {before})")

    # a Gram off by 1 % on the graphed problem, over ROUNDS rounds as phase 4
    # (over GRAPH_ROUNDS the iterate converges and the skew's gap shrinks
    # below the limit): captured anew, outside the limit
    with eager_rounds():
        x_sync = run_engine_chunk(tp, x0, 0, ROUNDS, sync_sched)
    sync_max = float(x_sync.abs().max())
    true_gram = engine.bundle_gram_v

    def skewed_gram(*args, **kwargs):
        g, v = true_gram(*args, **kwargs)
        return g * 1.01, v

    before = captured()
    engine.bundle_gram_v = skewed_gram
    try:
        x_skew = run_engine_chunk(tp, x0, 0, ROUNDS, sync_sched)
    finally:
        engine.bundle_gram_v = true_gram
    skew_gap = float((x_skew - x_sync).abs().max())
    skew_made = round_graph.counts["captures"] - before["captures"]
    log(f"[graph] with G off by 1 %: {skew_made} captures, max |Δx| to the eager run {skew_gap:.3g} "
        f"(limit {X_TOL * sync_max:.3g})")
    check(skew_made == max(min(cycle, ROUNDS - cycle), 0) and skew_gap > X_TOL * sync_max,
          "a Gram matrix wrong by 1 % replayed an old graph or passed the limit")
    out["skew"] = {"gap": skew_gap, "captures": skew_made}

    # the wall a round in turns: eager, the graphs, and graphs with the teams
    # in series (on a copy of the problem, captured by SerialRoundGraph at
    # its warm-up run)
    class SerialRoundGraph(round_graph.CudaRoundGraph):
        side_streams = staticmethod(lambda n: None)

    problems = {"eager": tp, "branched": tp, "serial": dataclasses.replace(tp)}
    modes = tuple(problems)

    def window(mode: str, sched) -> tuple[float, float]:
        with eager_rounds() if mode == "eager" else contextlib.nullcontext():
            sync()
            t0, c0 = time.perf_counter(), time.thread_time()
            run_engine_chunk(problems[mode], x0, 0, GRAPH_ROUNDS, sched)
            sync()
            return time.perf_counter() - t0, time.thread_time() - c0

    for label, sched in scheds.items():
        round_graph.GRAPH = SerialRoundGraph
        try:
            window("serial", sched)
        finally:
            round_graph.GRAPH = round_graph.CudaRoundGraph
        check(all(g.streams is None for g in round_graph.graphs_of(problems["serial"])), "a serial graph has branches")
        window("eager", sched)
        walls = {mode: [] for mode in modes}
        cpus = {mode: [] for mode in modes}
        for turn in range(GRAPH_TURNS):
            for mode in (modes if turn % 2 == 0 else modes[::-1]):
                wall, cpu = window(mode, sched)
                walls[mode].append(wall * 1e3 / GRAPH_ROUNDS)
                cpus[mode].append(cpu * 1e3 / GRAPH_ROUNDS)
        timed = {mode: {"round_ms": statistics.fmean(walls[mode]), "host_cpu_ms": statistics.fmean(cpus[mode]),
                        "windows_ms": walls[mode]} for mode in modes}
        for mode in ("branched", "serial"):
            timed[mode]["profile"] = profile_main_path(
                f"graphed ({mode}) {label}", lambda: run_engine_chunk(problems[mode], x0, 0, ROUNDS, sched), ROUNDS)
        out[label]["timed"] = timed
        log(f"[graph] {label}: wall a round pooled over {GRAPH_TURNS} windows of {GRAPH_ROUNDS} rounds each, in turns: "
            + ", ".join(f"{m} {timed[m]['round_ms']:.4f} ms (host CPU {timed[m]['host_cpu_ms']:.4f})" for m in modes)
            + f"; eager / graphs {timed['eager']['round_ms'] / timed['branched']['round_ms']:.2f}×, "
            f"serial / graphs {timed['serial']['round_ms'] / timed['branched']['round_ms']:.2f}× ({smi})")
    return out


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


def _percentile_ms(samples: list, q: float) -> float:
    return float(np.percentile(np.asarray(samples), q) * 1e3) if samples else math.nan


class _Clients:
    """``clients`` threads sending ``PredictionService.predict`` requests
    (cycling over ``requests``, a list of (idx, val) of equal rows) until
    stopped; each answer is kept with its latency, its request and the
    version that served it."""

    def __init__(self, service, requests: list, clients: int = SERVE_CLIENTS):
        import threading

        self.service, self.requests, self.clients = service, requests, clients
        self.stop_event = threading.Event()
        self.answers = []  # (request number, model version, margins)
        self.latencies = []
        self.errors = []
        self._threads = [threading.Thread(target=self._loop, args=(c,), daemon=True) for c in range(clients)]

    def _loop(self, c: int) -> None:
        k = c
        try:
            while not self.stop_event.is_set():
                r = k % len(self.requests)
                t0 = time.perf_counter()
                res = self.service.predict(*self.requests[r], timeout=60.0)
                self.latencies.append(time.perf_counter() - t0)
                self.answers.append((r, res.model_version, res.margins))
                k += self.clients
        except BaseException as e:  # surfaced by stop()
            self.errors.append(e)

    def start(self) -> "_Clients":
        self.t0 = time.perf_counter()
        for th in self._threads:
            th.start()
        return self

    def stop(self) -> dict:
        self.stop_event.set()
        for th in self._threads:
            th.join(timeout=120)
        elapsed = time.perf_counter() - self.t0
        check(not self.errors, f"a client's request failed: {self.errors[:1]}")
        rows = len(self.answers) * len(self.requests[0][0])
        return {"requests": len(self.answers), "seconds": elapsed, "predictions_per_s": rows / elapsed,
                "p50_ms": _percentile_ms(self.latencies, 50), "p99_ms": _percentile_ms(self.latencies, 99)}


def serve_phase(err: dict, smi: str, device=None) -> dict:
    """The streaming and serving plane at full width (``DATASET``, the main
    path's p_r, s, b, τ, η; a loss sample every 2 rounds):

    (1) a replay stream, synchronous fp32, through ``Session.step_stream``:
        launches, the same stream through the plain versions on the device
        (as phase 4), ``step_stream(k=1)`` × 8 against ``step_stream()``, and
        a session restored from its round-4 autosave;
    (2) the replay stream at D = 2 in bf16 against fp32 at D = 2, and
        against fp32 at D = 0, which must land outside that limit;
    (3) a drift stream through ``OnlineController`` + ``PredictionService``
        + ``serve_http``: probed accuracy across the flip, client requests
        beside training (each answer against a host einsum over its
        version's checkpoint weights), HTTP against in-process, the store
        at rest;
    (4) recorded: the stream round against the resident round, paired round
        by round; the batch build and upload; predictions/s and latency with
        and without training beside; the swap's save, load and publish.

    Also holds ``ell_gram`` against its plain version on streamed bundles
    (replay rows; drift rows, which repeat ids). ``device`` is what the
    entry points get (None: the card). Returns the numbers for the phase's
    JSON line; keeps the worst kernel errors in ``err``."""
    import tempfile
    import urllib.request

    from repro_torch.api import ExperimentSpec, FaultPolicy, MeshSpec, Session, StreamSpec
    from repro_torch.core import round_graph
    from repro_torch.core.engine import ParallelSGDSchedule
    from repro_torch.core.objective import LOGISTIC
    from repro_torch.kernels.ell_gram import ell_gram_and_v, ell_gram_and_v_blocked
    from repro_torch.launch.serve import probe_accuracy
    from repro_torch.serve import ModelStore, OnlineController, PredictionService, make_stream_source, serve_http
    from repro_torch.serve.ingest import stream_team_problem
    from repro_torch.sparse.synthetic import dataset_stats
    from repro_torch.train.checkpoint import load_model_weights

    started = time.perf_counter()
    want_type = "cuda" if device is None else torch.device(device).type

    def wait() -> None:
        if want_type == "cuda":
            sync()

    def per_run(rounds: int) -> int:
        return rounds * P_R * (TAU // S)

    def launches_of(label: str, want: dict) -> dict:
        got = launch_counts()
        log(f"[serve] launches, {label}: {got}")
        for name, count in want.items():
            check(got[name] == count, f"serve, {label}: {name} launched {got[name]} times, expected {count}")
        return got

    def fp32_counts(rounds: int) -> dict:
        return {"ell_gram.fp32": per_run(rounds), "ell_gram.bf16": 0, "sstep_inner.fp32": per_run(rounds),
                "sstep_inner.bf16": 0}

    def spec_(source: str, rounds: int = ROUNDS, loss_every: int = 2, **sched_kw) -> "ExperimentSpec":
        return ExperimentSpec(
            dataset=DATASET, seed=0, row_multiple=S * B, name=f"{DATASET}-serve-{source}",
            schedule=ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=rounds,
                                                loss_every=loss_every, **sched_kw),
            mesh=MeshSpec(p_r=P_R, p_c=1),
            stream=StreamSpec(source=source, width=SERVE_WIDTH, seed=0,
                              drift_at=SERVE_DRIFT_AT if source == "drift" else 0, swap_every=SERVE_SWAP_EVERY),
            faults=FaultPolicy(autosave_every=4),
        )

    def stream_run(spec, k=None, **kw):
        sess = Session(spec, device=device, **kw)
        src = make_stream_source(spec)
        while not sess.done:
            sess.step_stream(src, k)
        return sess

    def gap(a, b) -> float:
        return float(np.abs(a.current_x() - b.current_x()).max())

    out = {"rows_per_round": P_R * TAU * B}
    replay = spec_("replay")
    drift = spec_("drift", rounds=SERVE_DRIFT_ROUNDS)

    # ell_gram on the streamed bundles: replay rows (real rows, sorted ids,
    # pads) and drift rows (ids drawn with replacement: repeats)
    n = dataset_stats(DATASET).n
    for label, spec in (("replay", replay), ("drift", drift)):
        batch = make_stream_source(spec).batch(1)
        tp = stream_team_problem(batch, P_R, n, LOGISTIC, device=device)
        x_in = torch.from_numpy(np.random.default_rng(600).standard_normal(n).astype(np.float32) * 0.1).to(tp.values.device)
        worst = {}
        for team, r0 in ((0, 0), (P_R - 1, tp.rows_local - S * B)):
            idx, val = tp.indices[team, r0 : r0 + S * B], tp.values[team, r0 : r0 + S * B]
            for mode in ("fp32", "bf16"):
                g, v = ell_gram_and_v(idx, val, x_in, n=n, precision=mode)
                pg, pv = ell_gram_and_v_blocked(idx, val, x_in, n=n, bk=512, precision=mode)
                repeats = label == "drift" and mode == "bf16"
                tol = BF16_DUP_TOL if repeats else GV_TOL
                for got, want, name in ((g, pg, "G"), (v, pv, "v")):
                    max_abs, max_rel, ok = errors(got, want, tol)
                    check(ok and math.isfinite(max_abs),
                          f"ell_gram {mode} {name} on {label} stream rows: max abs {max_abs}, max rel {max_rel} (tol {tol})")
                    worst[mode] = max(worst.get(mode, 0.0), max_abs)
                    if repeats:
                        out["gram_bf16_repeated_ids_err"] = max(out.get("gram_bf16_repeated_ids_err", 0.0), max_abs)
                    else:
                        err[f"ell_gram.{mode}"] = max(err[f"ell_gram.{mode}"], max_abs)
        out[f"gram_err_{label}"] = worst
        log(f"[serve] ell_gram on {label} stream bundles {(S * B, batch.width)}, n = {n}: max abs err fp32 "
            f"{worst['fp32']:.3g} (tol {GV_TOL}), bf16 {worst['bf16']:.3g} "
            f"(tol {BF16_DUP_TOL if label == 'drift' else GV_TOL}{', repeated ids' if label == 'drift' else ''})")

    # (1) the replay stream, synchronous fp32
    with tempfile.TemporaryDirectory() as tmp:
        zero_launch_counts()
        captures = round_graph.counts["captures"]
        whole = stream_run(replay)  # step_stream(): to each loss boundary
        out["launches_replay_fp32"] = launches_of("replay stream, fp32", fp32_counts(ROUNDS))
        out["stream_captures"] = round_graph.counts["captures"] - captures
        check(out["stream_captures"] == 0, f"a stream session captured {out['stream_captures']} round graphs")
        x = whole.current_x()
        x_max = float(np.abs(x).max())
        check(x.shape == (n,) and bool(np.isfinite(x).all()) and x_max > 0, "the stream's final x is not finite (n,)")
        check(len(whole.losses) == ROUNDS // 2 and all(math.isfinite(v) for v in whole.losses)
              and whole.losses[-1] < whole.losses[0], f"the stream's holdout losses are wrong: {whole.losses}")
        stepped = Session(replay, device=device, autosave_dir=tmp)
        src = make_stream_source(replay)
        for _ in range(4):
            stepped.step_stream(src, 1)
        restored = Session.restore(stepped.autosave_path, spec=replay, device=device)
        check(restored.rounds_done == 4 and len(restored.losses) == 2, "the round-4 autosave lost its round")
        for _ in range(ROUNDS - 4):
            stepped.step_stream(src, 1)
        src_r = make_stream_source(replay)
        while not restored.done:
            restored.step_stream(src_r)
    limit = X_TOL * x_max
    gaps = {"stepped": gap(stepped, whole), "restored": gap(restored, whole)}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(restored.losses, whole.losses))

    # the same stream through the plain versions on the device (as phase 4)
    with plain_corrections():
        zero_launch_counts()
        plain = stream_run(dataclasses.replace(replay, schedule=dataclasses.replace(replay.schedule, gram="blocked")))
        launches_of("replay stream, plain versions", {k: 0 for k in fp32_counts(0)})
    gaps["plain"] = gap(whole, plain)
    log(f"[serve] replay stream fp32, {ROUNDS} rounds of {P_R * TAU * B} rows: max |Δx| to the plain versions "
        f"{gaps['plain']:.3g}, step_stream(k=1) × {ROUNDS} {gaps['stepped']:.3g}, restored from the round-4 autosave "
        f"{gaps['restored']:.3g} (limit {X_TOL:g}·max |x| = {limit:.3g}); holdout losses "
        f"{' '.join(f'{v:.5f}' for v in whole.losses)}, restored's max relative gap {loss_gap:.3g}")
    for what, g in gaps.items():
        check(g <= limit, f"replay stream: {what} run is {g} from the kernel run, limit {limit}")
    check(loss_gap <= X_TOL, f"replay stream: the restored loss trace is {loss_gap} off")
    out.update(x_max=x_max, limit=limit, gaps=gaps, loss_gap=loss_gap, losses=list(whole.losses))

    # (2) D = 2 bf16 against fp32 at D = 2
    zero_launch_counts()
    run16 = stream_run(dataclasses.replace(replay, schedule=dataclasses.replace(replay.schedule, delay=DELAY,
                                                                              precision="bf16")))
    out["launches_replay_delay2_bf16"] = launches_of(f"replay stream, D = {DELAY} bf16", {
        "ell_gram.fp32": 0, "ell_gram.bf16": per_run(ROUNDS), "sstep_inner.fp32": per_run(ROUNDS), "sstep_inner.bf16": 0})
    run32 = stream_run(dataclasses.replace(replay, schedule=dataclasses.replace(replay.schedule, delay=DELAY)))
    bf16_gap, d0_gap = gap(run16, run32), gap(run16, whole)
    log(f"[serve] replay stream D = {DELAY}: bf16 vs fp32 max |Δx| = {bf16_gap:.3g} (limit {SERVE_BF16_DX}); "
        f"to the D = 0 fp32 run {d0_gap:.3g} (must exceed the limit)")
    check(0.0 < bf16_gap < SERVE_BF16_DX, f"replay stream D = 2 bf16 against fp32: {bf16_gap}")
    check(d0_gap > SERVE_BF16_DX, f"replay stream D = 2 bf16 is only {d0_gap} from the D = 0 run")
    out.update(delay2_bf16_vs_fp32=bf16_gap, delay2_bf16_vs_delay0=d0_gap)

    # (3) the drift stream behind the prediction service and its HTTP front
    session = Session(drift, device=device)
    source = make_stream_source(drift)
    store = ModelStore(device=device)
    check(store.device.type == want_type, f"the store is on {store.device}")
    pool = source.batch(10**6)  # held-out rows: the client requests
    requests = [(pool.indices[r : r + SERVE_REQUEST_ROWS], pool.values[r : r + SERVE_REQUEST_ROWS])
                for r in range(0, pool.rows - SERVE_REQUEST_ROWS + 1, SERVE_REQUEST_ROWS)]
    weights = {}  # version → the host weights it serves
    acc = {}
    with tempfile.TemporaryDirectory() as tmp, PredictionService(store) as service:
        server, _ = serve_http(service, "127.0.0.1", 0)
        try:
            ctrl = OnlineController(session, source, store, service=service, swap_every=SERVE_SWAP_EVERY, swap_dir=tmp)
            check(store.snapshot().weights.device.type == want_type, "the served weights left the device")
            weights[store.version] = store.snapshot().x
            zero_launch_counts()
            clients = _Clients(service, requests).start()
            train_walls = []
            while not session.done:
                before = store.version
                t0 = time.perf_counter()
                ctrl.step()
                train_walls.append(time.perf_counter() - t0)
                if store.version > before:
                    weights[store.version] = load_model_weights(pathlib.Path(tmp) / f"swap-{session.rounds_done}")[0]
                if session.rounds_done % SERVE_SWAP_EVERY == 0:
                    acc[session.rounds_done] = probe_accuracy(service, source, session.rounds_done)
            beside = clients.stop()
            out["launches_drift"] = launches_of("drift stream behind the service", fp32_counts(SERVE_DRIFT_ROUNDS))
            m = ctrl.finish()
            check(m.staleness_rounds == 0 and m.failed_swaps == 0 and m.rounds_done == SERVE_DRIFT_ROUNDS,
                  f"the store is not clean at rest: {m.to_dict()}")
            check(m.swaps == SERVE_DRIFT_ROUNDS // SERVE_SWAP_EVERY + 1 and len(weights) == m.swaps,
                  f"{m.swaps} swaps, {len(weights)} versions seen")

            # every answer against a float64 host einsum over its version's weights
            worst_rel = {}
            for r, version, margins in clients.answers:
                idx, val = requests[r]
                want = np.einsum("rw,rw->r", val.astype(np.float64), weights[version][idx].astype(np.float64))
                d = float(np.abs(margins - want).max())
                worst_rel.setdefault(version, [0.0, 0.0])
                worst_rel[version][0] = max(worst_rel[version][0], d)
                worst_rel[version][1] = max(worst_rel[version][1], float(np.abs(want).max()))
            rel = {v: d / s if s > 0 else (0.0 if d == 0 else math.inf) for v, (d, s) in worst_rel.items()}
            check(max(rel.values()) <= MARGIN_RTOL,
                  f"served margins off the version's checkpoint weights: {rel} (limit {MARGIN_RTOL})")
            stats = service.stats()

            # HTTP against in-process, at rest: bitwise
            idx, val = requests[0]
            body = json.dumps({"rows": [{"idx": i.tolist(), "val": v.tolist()} for i, v in zip(idx, val)]}).encode()
            host, port = server.server_address[:2]
            req = urllib.request.Request(f"http://{host}:{port}/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                http = json.loads(resp.read())
            local = service.predict(idx, val)
            check(http["margins"] == local.margins.tolist() and http["model_version"] == local.model_version
                  and http["labels"] == local.labels.tolist(), "HTTP answers differ from in-process answers")

            # at rest: the same clients with no training beside them
            idle = _Clients(service, requests).start()
            time.sleep(SERVE_IDLE_S)
            at_rest = idle.stop()

            # the swap's parts: save, load (verify + read), publish (upload)
            swap_s = {"save": [], "load": [], "publish": []}
            for i in range(5):
                path = pathlib.Path(tmp) / f"timed-{i}"
                t0 = time.perf_counter()
                session.save(path)
                t1 = time.perf_counter()
                xs, _ = load_model_weights(path)
                t2 = time.perf_counter()
                store.publish(xs, rounds_done=session.rounds_done)
                wait()
                t3 = time.perf_counter()
                for k, v in zip(swap_s, (t1 - t0, t2 - t1, t3 - t2)):
                    swap_s[k].append(v)
        finally:
            server.shutdown()
    probes = sorted(acc)
    first_after = min(r for r in probes if r >= SERVE_DRIFT_AT)
    before_flip = max(r for r in probes if r < SERVE_DRIFT_AT)
    log(f"[serve] drift stream, {SERVE_DRIFT_ROUNDS} rounds, flip at batch {SERVE_DRIFT_AT}: probed accuracy "
        + " ".join(f"r{r}={a:.3f}" for r, a in sorted(acc.items()))
        + f" (must fall below {DRIFT_ACC_FALL} at round {first_after} and end above {DRIFT_ACC_RECOVER}); "
        f"{m.swaps} swaps, staleness {m.staleness_rounds}, failed swaps {m.failed_swaps}")
    check(acc[first_after] < DRIFT_ACC_FALL and acc[first_after] < acc[before_flip],
          f"accuracy did not fall at the first probe after the flip: {acc}")
    check(acc[probes[-1]] > DRIFT_ACC_RECOVER, f"accuracy did not recover after the flip: {acc}")
    log(f"[serve] {beside['requests']} requests of {SERVE_REQUEST_ROWS} rows from {SERVE_CLIENTS} clients beside "
        f"training in {stats['batches']} coalesced batches, {len(rel)} versions: margins within {max(rel.values()):.3g} "
        f"(relative, limit {MARGIN_RTOL}) of a host einsum over each version's weights; HTTP = in-process, bitwise")
    log(f"[serve] clients beside training: {beside['predictions_per_s']:.0f} predictions/s, p50 {beside['p50_ms']:.3f} ms, "
        f"p99 {beside['p99_ms']:.3f} ms; at rest: {at_rest['predictions_per_s']:.0f} predictions/s, p50 "
        f"{at_rest['p50_ms']:.3f} ms, p99 {at_rest['p99_ms']:.3f} ms; a controller step with clients beside "
        f"{statistics.median(train_walls) * 1e3:.3f} ms (median); swap: save {statistics.median(swap_s['save']) * 1e3:.3f} ms, "
        f"load {statistics.median(swap_s['load']) * 1e3:.3f} ms, publish {statistics.median(swap_s['publish']) * 1e3:.3f} ms "
        f"(medians of 5); {smi}")
    out.update(accuracy={str(r): a for r, a in sorted(acc.items())}, acc_fall=DRIFT_ACC_FALL, acc_recover=DRIFT_ACC_RECOVER,
               swaps=m.swaps, staleness=m.staleness_rounds, failed_swaps=m.failed_swaps, margin_rel=max(rel.values()),
               coalesced_batches=stats["batches"], clients_beside_training=beside, clients_at_rest=at_rest,
               controller_step_ms=statistics.median(train_walls) * 1e3,
               swap_ms={k: statistics.median(v) * 1e3 for k, v in swap_s.items()},
               swap_total_ms=sum(statistics.median(v) for v in swap_s.values()) * 1e3)

    # (4) the stream round against the resident round, paired round by
    # round (one session each, no loss samples): what the stream adds is the
    # host's batch build and the upload
    pairs = 4 * (ROUNDS - 1)
    quiet = dataclasses.replace(replay, faults=FaultPolicy(),
                                schedule=dataclasses.replace(replay.schedule, loss_every=0, rounds=pairs + 1))
    resident, streamed = Session(quiet, device=device), Session(quiet, device=device)
    src = make_stream_source(quiet)
    resident.step_rounds(1)
    streamed.step_stream(src, 1)  # the first round of each, not timed
    walls = {"resident": [], "stream": []}
    for _ in range(pairs):
        t0 = time.perf_counter()
        resident.step_rounds(1)
        walls["resident"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        streamed.step_stream(src, 1)
        walls["stream"].append(time.perf_counter() - t0)
    build, upload = [], []
    for k in range(8):
        t0 = time.perf_counter()
        b = src.batch(100 + k)
        t1 = time.perf_counter()
        stream_team_problem(b, P_R, n, LOGISTIC, device=device)
        wait()
        build.append(t1 - t0)
        upload.append(time.perf_counter() - t1)
    ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    extra_ms = statistics.median(s - r for s, r in zip(walls["stream"], walls["resident"])) * 1e3
    out.update(round_ms=ms, stream_extra_ms=extra_ms, build_ms=statistics.median(build) * 1e3,
               upload_ms=statistics.median(upload) * 1e3, round_walls=walls)
    log(f"[serve] a round (medians of {pairs}, interleaved): resident step_rounds(1) {ms['resident']:.3f} ms, "
        f"step_stream(source, 1) {ms['stream']:.3f} ms; the stream's extra a round, paired {extra_ms:.3f} ms; "
        f"batch build {out['build_ms']:.3f} ms, team problem upload {out['upload_ms']:.3f} ms (medians of 8); {smi}")
    out["phase_s"] = time.perf_counter() - started
    log(f"[serve] the phase took {out['phase_s']:.1f} s")
    return out


def tune_phase(tp, smi: str, device=None) -> dict:
    """The Gram autotuner on the card (``repro_torch.kernels.tune``):
    ``tune_panel`` for rcv1's profile (rows 128, width 74, n_local 47,236)
    in fp32 and bf16 and at rows 512, each candidate (tile, ks) by device
    time beside the default geometry's; a second call that must hit the
    cache (the same bytes, nothing measured); a ``bk=None`` Session on
    full rcv1 (exactly the main path's launches, final x within X_TOL of
    the ``bk=512`` run); and the heavy-tail rule's two paths — the dense
    oracle against the kernel in both modes at sb = 16 on rcv1's rows and
    at (128, 540) — which must agree with ``select_gram_path``'s verdict
    on the card. ``tp`` is the main path's team problem. Returns the
    numbers for the phase's JSON line."""
    import tempfile

    from repro_torch.api import ExperimentSpec, MeshSpec, Session
    from repro_torch.core.engine import ParallelSGDSchedule
    from repro_torch.kernels import tune
    from repro_torch.kernels.ell_gram import (
        default_tile_ks, ell_gram_and_v, ell_gram_and_v_blocked, supported_tile_ks,
    )
    from repro_torch.kernels.ref import ell_gram_and_v_ref

    started = time.perf_counter()
    cache = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-tune-"))
    kind = tune.device_kind(device)
    out = {"device": kind, "card": smi, "profiles": {}}
    profiles = {
        "rcv1_fp32": tune.PanelProfile(rows=S * B, width=74, n_local=tp.n, precision="fp32"),
        "rcv1_bf16": tune.PanelProfile(rows=S * B, width=74, n_local=tp.n, precision="bf16"),
        "rcv1_rows512": tune.PanelProfile(rows=512, width=74, n_local=tp.n, precision="fp32"),
    }
    records = {}
    for label, profile in profiles.items():
        t0 = time.perf_counter()
        rec = tune.tune_panel(profile, run_on=device, cache_dir=cache)
        tune_s = time.perf_counter() - t0
        records[label] = rec
        path = cache / f"{rec['key']}.json"
        check(path.exists() and not rec.get("fallback"), f"tune_panel cached no record for {label}")
        check(rec["device"] == kind and rec["kernel_version"] == tune.KERNEL_VERSION
              and (rec["bk"], rec["bm"]) == (tune.FALLBACK_BK, tune.FALLBACK_BM)
              and rec["profile"] == profile.to_dict(), f"the {label} record is not the card's: {rec}")
        live = [c for c in rec["candidates"] if c.get("skipped") is None]
        default = next(c for c in rec["candidates"] if c.get("default"))
        check((default["tile"], default["ks"]) == default_tile_ks(profile.rows) and default.get("skipped") is None,
              f"the default geometry was not timed for {label}")
        check((rec["tile"], rec["ks"]) == min(((c["measured_s"], (c["tile"], c["ks"])) for c in live))[1],
              f"the {label} winner is not the fastest candidate")
        for c in rec["candidates"]:
            log(f"[tune ] {label}: tile {c['tile']:2d} ks {c['ks']:2d}: "
                + (f"{c['measured_s'] * 1e3:.5f} ms on the device (bound {c['attainable_s'] * 1e3:.6f} ms)"
                   if "measured_s" in c else f"skipped ({c['skipped']})")
                + (" ← default" if c.get("default") else "") + (" ← winner" if (c["tile"], c["ks"]) == (rec["tile"], rec["ks"]) else ""))
        # a second call hits the cache: the same bytes, nothing measured
        raw = path.read_bytes()
        timed = tune._device_seconds

        def no_measure(*a, **k):
            raise AssertionError("a cache hit re-measured")

        tune._device_seconds = no_measure
        try:
            hit = tune.tune_panel(profile, run_on=device, cache_dir=cache)
        finally:
            tune._device_seconds = timed
        check(hit == rec and path.read_bytes() == raw, f"the second tune_panel call for {label} did not hit the cache")
        out["profiles"][label] = {
            "profile": profile.to_dict(), "key": rec["key"], "tile": rec["tile"], "ks": rec["ks"],
            "ms": rec["measured_s"] * 1e3, "default": [default["tile"], default["ks"]],
            "default_ms": default["measured_s"] * 1e3, "bound_ms": rec["attainable_s"] * 1e3,
            "bound_by": default["dominant"], "efficiency": rec["efficiency"], "tune_s": tune_s,
            "candidates": {f"{c['tile']}x{c['ks']}": (c.get("measured_s") or 0.0) * 1e3 for c in rec["candidates"]},
        }
        log(f"[tune ] {label}: winner tile {rec['tile']} ks {rec['ks']} {rec['measured_s'] * 1e3:.5f} ms against the "
            f"default ({default['tile']}, {default['ks']}) {default['measured_s'] * 1e3:.5f} ms; bound "
            f"{rec['attainable_s'] * 1e3:.6f} ms ({tune_s:.1f} s to tune); the second call hit the cache")

    # every candidate geometry against the plain version on the main path's
    # real rows (sb = 128 and 512), both modes; the winners twice, bitwise
    geo_err = {}
    for sb in (S * B, 512):
        bi, bv = tp.indices[0][:sb].contiguous(), tp.values[0][:sb].contiguous()
        x = torch.zeros(tp.n, device=bi.device).normal_()
        for mode in ("fp32", "bf16"):
            g_ref, v_ref = ell_gram_and_v_blocked(bi, bv, x, n=tp.n, precision=mode)
            worst = 0.0
            for tile, ks in supported_tile_ks():
                g, v = ell_gram_and_v(bi, bv, x, n=tp.n, precision=mode, geometry=(tile, ks))
                for got, want in ((g, g_ref), (v, v_ref)):
                    max_abs, _, ok = errors(got, want, GV_TOL)
                    worst = max(worst, max_abs)
                    check(ok, f"ell_gram {mode} at geometry ({tile}, {ks}), sb = {sb}: max abs error {max_abs}")
            label = "rcv1_rows512" if sb == 512 else f"rcv1_{mode}"
            win = (records[label]["tile"], records[label]["ks"])
            g1, v1 = ell_gram_and_v(bi, bv, x, n=tp.n, precision=mode, geometry=win)
            g2, v2 = ell_gram_and_v(bi, bv, x, n=tp.n, precision=mode, geometry=win)
            check(torch.equal(g1, g2) and torch.equal(v1, v2), f"two launches at the tuned {win} differ (sb = {sb}, {mode})")
            geo_err[f"sb{sb}.{mode}"] = worst
            # the tuned and the default geometry on team 0's real bundles (a
            # pass over them, device time): what the timing bundle stood for
            offsets = list(range(0, tp.rows_local - sb + 1, sb))
            real = {}
            for which, geo in (("default", default_tile_ks(sb)), ("tuned", win)):
                real[which] = device_ms(lambda k: ell_gram_and_v(
                    tp.indices[0][offsets[k % len(offsets)]:][:sb], tp.values[0][offsets[k % len(offsets)]:][:sb],
                    x, n=tp.n, precision=mode, geometry=geo), inner=len(offsets))
            out["profiles"][label][f"real_{mode}"] = {"default_ms": real["default"], "tuned_ms": real["tuned"],
                                                      "bundles": len(offsets)}
            log(f"[tune ] sb = {sb} {mode}: all {len(supported_tile_ks())} geometries within {GV_TOL:g} of the plain "
                f"version (worst {worst:.3g}); the winner {win} twice, bitwise equal; on rcv1's real bundles "
                f"(team 0, {len(offsets)} of them) the winner {real['tuned']:.5f} ms, the default "
                f"{default_tile_ks(sb)} {real['default']:.5f} ms on the device")
    out["geometry_max_abs_err"] = geo_err

    # a bk=None Session on full rcv1 (p_c = 1: the tuned rcv1_fp32 profile)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(cache)
    try:
        def spec_(bk):
            return ExperimentSpec(
                dataset=DATASET, seed=0, row_multiple=S * B, name=f"{DATASET}-tuned",
                schedule=ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, bk=bk),
                mesh=MeshSpec(p_r=P_R, p_c=1))

        tuned = Session(spec_(None), device=device)
        want = (records["rcv1_fp32"]["tile"], records["rcv1_fp32"]["ks"])
        check(tuned.gram_geometry == want and tuned.spec.schedule.gram == "kernel"
              and (tuned.spec.schedule.bk, tuned.spec.schedule.bm) == (512, None),
              f"the bk=None Session resolved {tuned.gram_geometry}, {tuned.spec.schedule}, not the cached {want}")
        zero_launch_counts()
        x_tuned = tuned.run().x
        got = launch_counts()
        expected = ROUNDS * P_R * (TAU // S)
        log(f"[tune ] bk=None Session (geometry {tuned.gram_geometry}): launches {got}")
        check(got["ell_gram.fp32"] == expected and got["sstep_inner.fp32"] == expected
              and got["ell_gram.bf16"] == got["sstep_inner.bf16"] == 0,
              f"the bk=None Session launched {got}, expected {expected} of each fp32 kernel")
        x_static = Session(spec_(512), device=device).run().x
    finally:
        del os.environ["REPRO_TORCH_TUNE_CACHE"]
    x_max = float(np.abs(x_static).max())
    tuned_gap = float(np.abs(x_tuned - x_static).max())
    log(f"[tune ] bk=None vs bk=512: max |Δx| {tuned_gap:.3g} (limit {X_TOL * x_max:.3g})")
    check(x_max > 0 and tuned_gap <= X_TOL * x_max, f"the tuned run is {tuned_gap} from the bk=512 run")
    out.update(session_launches=got, session_gap=tuned_gap, session_x_max=x_max, session_geometry=list(want))

    # the heavy-tail rule: the dense oracle against the kernel above 4·s·b
    news_idx, news_val, news_x = random_bundle(128, 540, NEWS20_N, 500, tp.values.device, unique=True)
    shapes = {"rcv1_sb16": (tp.indices[0][:16].contiguous(), tp.values[0][:16].contiguous(),
                            torch.zeros(tp.n, device=tp.values.device).normal_(), tp.n),
              "w540": (news_idx, news_val, news_x, NEWS20_N)}
    heavy = {}
    for label, (idx, val, x, n_cols) in shapes.items():
        sb, w = idx.shape
        dense_ms = device_ms(lambda k: ell_gram_and_v_ref(idx, val, x, n_cols), inner=2 if n_cols > 10**6 else 10)
        row = {"sb": sb, "w": w, "n": n_cols, "dense_ms": dense_ms}
        for mode in ("fp32", "bf16"):
            kernel_ms = device_ms(lambda k: ell_gram_and_v(idx, val, x, n=n_cols, precision=mode), inner=20)
            faster = "kernel" if kernel_ms < dense_ms else "dense"
            rule = tune.select_gram_path(w, sb, device=kind)
            row[mode] = {"kernel_ms": kernel_ms, "faster": faster, "rule": rule}
            log(f"[tune ] heavy tail {label} (sb = {sb}, w = {w} > {tune.HEAVY_TAIL_FACTOR}·sb = {tune.HEAVY_TAIL_FACTOR * sb}, "
                f"n = {n_cols}) {mode}: kernel {kernel_ms:.5f} ms, dense oracle (fp32) {dense_ms:.5f} ms on the device → "
                f"{faster} is faster; the card's rule picks {rule}")
            check(w > tune.HEAVY_TAIL_FACTOR * sb, f"{label} is not above the reference's heavy-tail width")
            check(rule == faster, f"the card's heavy-tail rule picks {rule} at {label} {mode}, but {faster} is faster")
        heavy[label] = row
    out["heavy_tail"] = heavy
    out["card_heavy_tail_factor"] = tune.CARD_HEAVY_TAIL_FACTOR
    out["phase_s"] = time.perf_counter() - started
    log(f"[tune ] phase done in {out['phase_s']:.1f} s")
    return out


def lm_phase(smi: str, device=None) -> dict:
    """The language-model trainer (``repro_torch.train.loop.train``, what
    ``python -m repro_torch.launch.train`` runs) on qwen2.5-3b at its
    published width, depth cut to ``LM_LAYERS``: weights drawn on the host
    from a seed and carried to the card through the numpy tree
    (``params_to_numpy`` → ``params_from_numpy``, as the reference's would
    be); the loss at those weights on a 1 × 128 batch held against the CPU's
    plain run at the same weights (``LM_FIRST_LOSS_RTOL``); then
    ``LM_STEPS`` adamw steps of ``LM_BATCH`` × ``LM_SEQ`` tokens in fp32
    (TF32 off), after one warm-up step, whose loss must fall. Returns the
    numbers for the phase's JSON line."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, lm_loss, params_from_numpy, params_to_numpy
    from repro_torch.train.data import MarkovTextStream
    from repro_torch.train.loop import train

    started = time.perf_counter()
    published = get_config("qwen2.5-3b")
    cfg = dataclasses.replace(published, n_layers=LM_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias, cfg.rope_theta)
          == (2048, 16, 2, 11008, 151936, True, 1e6), f"qwen2.5-3b is not at its published width: {cfg}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for fp32 matmuls")
    t0 = time.perf_counter()
    host = init_params(cfg, dtype=torch.float32, device="cpu", seed=0)
    card = params_from_numpy(params_to_numpy(host), device=device)
    n_params = sum(t.numel() for t in tree_leaves(host))
    init_s = time.perf_counter() - t0
    log(f"[lm   ] qwen2.5-3b at its published width (d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QKV bias, rope θ {cfg.rope_theta:g}), depth cut {published.n_layers} → "
        f"{cfg.n_layers} layers: {n_params / 1e6:.1f} M parameters, drawn and carried to the card in {init_s:.1f} s")

    toks, targs = next(MarkovTextStream(cfg.vocab_size, seed=0).batches(1, 128))
    with torch.no_grad():
        loss_cpu = float(lm_loss(cfg, host, torch.from_numpy(toks), torch.from_numpy(targs)))
        dev = card["embed"].device
        loss_card = float(lm_loss(cfg, card, torch.from_numpy(toks).to(dev), torch.from_numpy(targs).to(dev)))
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"[lm   ] loss at the carried weights on 1 × 128 tokens: card {loss_card:.7f}, CPU {loss_cpu:.7f}, "
        f"relative {rel:.3g} (limit {LM_FIRST_LOSS_RTOL:g})")
    check(math.isfinite(loss_card) and rel <= LM_FIRST_LOSS_RTOL, f"the card's first loss is {rel} from the CPU's")
    del host

    train(cfg, steps=1, batch=LM_BATCH, seq_len=LM_SEQ, params=card, device=device, log_every=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    report = train(cfg, steps=LM_STEPS, batch=LM_BATCH, seq_len=LM_SEQ, params=card, device=device, log_every=1)
    peak = torch.cuda.max_memory_allocated()
    losses = report.losses
    log(f"[lm   ] {LM_STEPS} adamw steps of {LM_BATCH} × {LM_SEQ} tokens, fp32: losses {losses[0]:.4f} → {losses[-1]:.4f}; "
        f"{report.tokens_per_s:.0f} tokens/s; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB — {smi}")
    check(len(losses) == LM_STEPS and all(math.isfinite(v) for v in losses), f"the LM losses are {losses}")
    check(losses[-1] < losses[0], f"the LM loss did not fall over {LM_STEPS} steps: {losses}")
    tokens_per_s = report.tokens_per_s
    del card, report
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "card": smi, "layers": cfg.n_layers, "published_layers": published.n_layers,
            "reduced": [f"n_layers {published.n_layers} -> {cfg.n_layers}"], "params": n_params,
            "batch": LM_BATCH, "seq_len": LM_SEQ, "steps": LM_STEPS, "optimizer": "adamw(3e-4)", "dtype": "float32",
            "tf32": False, "first_loss_card": loss_card, "first_loss_cpu": loss_cpu, "first_loss_rel": rel,
            "losses": losses, "tokens_per_s": tokens_per_s, "max_memory_allocated": peak,
            "init_s": init_s, "phase_s": time.perf_counter() - started}


def count_syncs(fn):
    """``fn()`` with CUDA's sync debug mode at "warn": returns its result,
    the number of calls in it that made the host wait for the card (a copy
    to the host, a ``.tolist()``, a stream synchronize) and where each was
    made ({"file:line": count}). A sync in the backward pass, which runs on
    autograd's device thread, is reported at the line that resets the mode."""
    sync()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    at: dict = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            path = pathlib.Path(w.filename).resolve()  # this repo's file, or an installed package's
            where = path.relative_to(ROOT) if path.is_relative_to(ROOT) else re.sub(r".*/site-packages/", "", str(path))
            at[f"{where}:{w.lineno}"] = at.get(f"{where}:{w.lineno}", 0) + 1
    return out, sum(at.values()), at


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|, on the host in float64."""
    got, want = got.detach().to("cpu", torch.float64), want.detach().to("cpu", torch.float64)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _decode_checks(cfg, host, card, device, out: dict) -> None:
    """Decode ≡ forward on the card (``ZOO_DECODE_LEN`` ``serve_step``s of
    a 1 × ``ZOO_DECODE_LEN`` sequence against ``forward``'s logits at each
    position, ``ZOO_DECODE_FORWARD_TOL``), then the card's decode logits
    against the CPU's on the same weights (``ZOO_CPU_RTOL``)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import forward, init_cache
    from repro_torch.train.data import MarkovTextStream

    serve = make_serve_step(cfg)
    toks, _ = next(MarkovTextStream(cfg.vocab_size, seed=1).batches(1, ZOO_DECODE_LEN))
    toks = torch.from_numpy(toks)

    def decode(params, dev):
        cache = init_cache(cfg, 1, ZOO_DECODE_LEN, dtype=torch.float32, device=dev)
        outs = []
        for i in range(ZOO_DECODE_LEN):
            logits, cache = serve(params, cache, toks[:, i : i + 1].to(dev))
            outs.append(logits[:, 0])
        check(int(cache["pos"]) == ZOO_DECODE_LEN and cache["pos"].device.type == torch.device(dev).type,
              f"{cfg.name}: the decode position is {cache['pos']}")
        return torch.stack(outs, dim=1)

    with torch.no_grad():
        full = forward(cfg, card, toks.to(device))
    dec = decode(card, device)
    gap = float((dec - full).abs().max())
    ok = bool(torch.allclose(dec, full, rtol=ZOO_DECODE_FORWARD_TOL, atol=ZOO_DECODE_FORWARD_TOL))
    dec_cpu = decode(host, "cpu")
    rel = _rel_gap(dec, dec_cpu)
    log(f"[zoo  ] {cfg.name}: decode ≡ forward over {ZOO_DECODE_LEN} steps, max |Δ| {gap:.3g} (rtol = atol = "
        f"{ZOO_DECODE_FORWARD_TOL:g}); card decode vs CPU decode relative {rel:.3g} (limit {ZOO_CPU_RTOL:g})")
    check(ok and math.isfinite(gap), f"{cfg.name}: decode differs from forward on the card by {gap}")
    check(rel <= ZOO_CPU_RTOL, f"{cfg.name}: the card's decode logits are {rel} from the CPU's")
    out.update(decode_forward_max_abs=gap, decode_cpu_rel=rel, decode_steps=ZOO_DECODE_LEN)


def _first_loss(cfg, host, card, out: dict) -> None:
    """The loss and every gradient at the carried weights on 1 × 128
    tokens, card vs CPU: the loss within ``ZOO_CPU_RTOL`` relative, each
    gradient leaf within ``ZOO_GRAD_RTOL`` of its largest entry."""
    from repro_torch._tree import tree_paths, tree_replace_leaves
    from repro_torch.models import lm_loss
    from repro_torch.train.data import MarkovTextStream

    toks, targs = next(MarkovTextStream(cfg.vocab_size, seed=0).batches(1, 128))

    def loss_and_grads(params):
        dev = params["embed"].device
        paths, leaves = zip(*[(path, t.detach().requires_grad_(True)) for path, t in tree_paths(params)])
        loss = lm_loss(cfg, tree_replace_leaves(params, list(leaves)), torch.from_numpy(toks).to(dev),
                       torch.from_numpy(targs).to(dev))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return float(loss), paths, grads

    loss_cpu, paths, grads_cpu = loss_and_grads(host)
    loss_card, _, grads_card = loss_and_grads(card)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_rel = {"/".join(map(str, path)): _rel_gap(g, want) for path, g, want in zip(paths, grads_card, grads_cpu)}
    worst = max(grad_rel, key=grad_rel.get)
    del grads_card, grads_cpu
    log(f"[zoo  ] {cfg.name}: at the carried weights on 1 × 128 tokens: loss card {loss_card:.7f}, CPU {loss_cpu:.7f}, "
        f"relative {rel:.3g} (limit {ZOO_CPU_RTOL:g}); gradients card vs CPU, worst leaf {worst} "
        f"{grad_rel[worst]:.3g} (limit {ZOO_GRAD_RTOL:g}) over {len(grad_rel)} leaves")
    check(math.isfinite(loss_card) and rel <= ZOO_CPU_RTOL, f"{cfg.name}: the card's first loss is {rel} from the CPU's")
    check(grad_rel[worst] <= ZOO_GRAD_RTOL,
          f"{cfg.name}: the card's gradient of {worst} is {grad_rel[worst]} from the CPU's")
    out.update(first_loss_card=loss_card, first_loss_cpu=loss_cpu, first_loss_rel=rel, grad_rel_worst=grad_rel[worst],
               grad_rel_worst_leaf=worst)


def _draw(cfg, device):
    """Weights drawn on the host from seed 0 (float32) and their copy on
    the card; the count of parameters and the seconds it took."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    host = init_params(cfg, dtype=torch.float32, device="cpu", seed=0)
    card = tree_map(lambda t: t.to(device), host)
    return host, card, sum(t.numel() for t in tree_leaves(host)), time.perf_counter() - t0


def _serve_numbers(cfg, card, device, out: dict) -> None:
    """Decode tokens/s of ``serve_step`` at batch ``ZOO_SERVE_BATCH`` against
    a ``ZOO_SERVE_DEPTH``-deep cache of random entries (the median of three
    windows of ``ZOO_SERVE_STEPS`` steps), the host syncs a decode step, and the prefill time of ``make_prefill_step`` on
    ``ZOO_BATCH`` × ``ZOO_SEQ`` tokens (median of 3, after a warm-up)."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_cache

    serve = make_serve_step(cfg)
    gen = torch.Generator(device=device).manual_seed(2)
    cache = init_cache(cfg, ZOO_SERVE_BATCH, ZOO_SERVE_DEPTH + 3 * ZOO_SERVE_STEPS + 3, dtype=torch.float32,
                       device=device)
    cache = {"layers": tree_map(lambda t: torch.randn(t.shape, generator=gen, device=device), cache["layers"]),
             "pos": torch.tensor(ZOO_SERVE_DEPTH, dtype=torch.int32, device=device)}
    tok = torch.randint(0, cfg.vocab_size, (ZOO_SERVE_BATCH, 1), generator=gen, device=device)
    for _ in range(2):
        _, cache = serve(card, cache, tok)
    (_, cache), syncs, syncs_at = count_syncs(lambda: serve(card, cache, tok))
    rates = []
    for _ in range(3):  # three windows of ZOO_SERVE_STEPS steps, the median kept
        sync()
        t0 = time.perf_counter()
        for _ in range(ZOO_SERVE_STEPS):
            logits, cache = serve(card, cache, tok)
        sync()
        rates.append(ZOO_SERVE_BATCH * ZOO_SERVE_STEPS / (time.perf_counter() - t0))
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite decode logits at depth {ZOO_SERVE_DEPTH}")
    del cache
    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_SEQ), generator=gen, device=device)
    prefill(card, toks)
    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        last = prefill(card, toks)
        sync()
        walls.append(time.perf_counter() - t0)
    check(last.shape == (ZOO_BATCH, 1, cfg.vocab_size) and bool(torch.isfinite(last).all()),
          f"{cfg.name}: prefill gave {tuple(last.shape)}")
    out.update(decode_tokens_per_s=statistics.median(rates), decode_tokens_per_s_all=rates, decode_batch=ZOO_SERVE_BATCH,
               decode_depth=ZOO_SERVE_DEPTH, syncs_decode_step=syncs, syncs_decode_step_at=syncs_at,
               prefill_ms=1e3 * statistics.median(walls),
               prefill_ms_all=[1e3 * w for w in walls])
    log(f"[zoo  ] {cfg.name}: decode {out['decode_tokens_per_s']:.0f} tokens/s at batch {ZOO_SERVE_BATCH} against a "
        f"{ZOO_SERVE_DEPTH}-deep cache, {syncs} host syncs a decode step ({syncs_at}); "
        f"prefill of {ZOO_BATCH} × {ZOO_SEQ} tokens "
        f"{out['prefill_ms']:.1f} ms")


def _train_deepseek(cfg, card, device, lr: float, out: dict) -> None:
    """``train()`` (what ``python -m repro_torch.launch.train`` runs): a
    warm-up step, then ``ZOO_STEPS`` adamw steps of ``ZOO_BATCH`` ×
    ``ZOO_SEQ`` tokens; then the host syncs of one more step."""
    from repro_torch.optim.sgd import adamw
    from repro_torch.train.data import MarkovTextStream
    from repro_torch.train.loop import make_train_step, train

    train(cfg, steps=1, batch=ZOO_BATCH, seq_len=ZOO_SEQ, params=card, device=device, log_every=1, opt=adamw(lr))
    sync()
    torch.cuda.reset_peak_memory_stats()
    report = train(cfg, steps=ZOO_STEPS, batch=ZOO_BATCH, seq_len=ZOO_SEQ, params=card, device=device, log_every=1,
                   opt=adamw(lr))
    peak = torch.cuda.max_memory_allocated()
    # one more step, its host syncs counted; the parameters and moments it
    # starts from, and its own peak above them
    opt = adamw(lr)
    step = make_train_step(cfg, opt)
    toks, targs = next(MarkovTextStream(cfg.vocab_size, seed=3).batches(ZOO_BATCH, ZOO_SEQ))
    batch = (torch.from_numpy(toks).to(device), torch.from_numpy(targs).to(device))
    state = (card, opt.init(card))
    sync()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, syncs, syncs_at = count_syncs(lambda: step(state, batch))
    step_peak = torch.cuda.max_memory_allocated()
    del state
    out.update(trainer="train() (train/loop.py): one step a batch, no remat", lr=lr, losses=report.losses,
               tokens_per_s=report.tokens_per_s, max_memory_allocated=peak, syncs_train_step=syncs,
               syncs_train_step_at=syncs_at, step_resident_bytes=resident, step_peak_bytes=step_peak)


def _train_mamba(cfg, card, device, lr: float, out: dict) -> None:
    """``launch/steps.py``'s ``make_train_step`` with remat and
    ``ZOO_BATCH // ZOO_MAMBA_MICROBATCH`` microbatches a step: a warm-up
    step, then ``ZOO_STEPS`` adamw steps (the host syncs of the first of
    them counted)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.sgd import adamw
    from repro_torch.train.data import MarkovTextStream

    opt = adamw(lr)
    step = make_train_step(cfg, opt=opt, microbatch_per_shard=ZOO_MAMBA_MICROBATCH)
    it = MarkovTextStream(cfg.vocab_size, seed=0).batches(ZOO_BATCH, ZOO_SEQ)

    def batch():
        toks, targs = next(it)
        return torch.from_numpy(toks).to(device), torch.from_numpy(targs).to(device)

    params, state = card, opt.init(card)
    params, state, _ = step(params, state, *batch())  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(ZOO_STEPS):
        b = batch()
        if i == 0:
            (params, state, loss), syncs, syncs_at = count_syncs(lambda: step(params, state, *b))
        else:
            params, state, loss = step(params, state, *b)
        losses.append(float(loss))
    sync()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del params, state
    out.update(trainer=f"launch/steps.py make_train_step: {ZOO_BATCH // ZOO_MAMBA_MICROBATCH} microbatches of "
                       f"{ZOO_MAMBA_MICROBATCH} × {ZOO_SEQ} a step, remat", microbatches=ZOO_BATCH // ZOO_MAMBA_MICROBATCH,
               lr=lr,
               losses=losses, tokens_per_s=ZOO_STEPS * ZOO_BATCH * ZOO_SEQ / elapsed, max_memory_allocated=peak,
               syncs_train_step=syncs, syncs_train_step_at=syncs_at)


def zoo_phase(smi: str, device=None) -> dict:
    """The rest of the decoder zoo at published width, depth cut to
    ``ZOO_LAYERS``: deepseek-v2-lite-16b (MLA, 64 routed experts top-6 and 2
    shared) trained through ``train()`` and falcon-mamba-7b (Mamba-1,
    d_inner 8192) through ``make_train_step`` with remat and microbatches.
    For each: weights drawn on the host from a seed and carried to the card,
    the first loss against the CPU's, decode ≡ forward on the card and the
    card's decode against the CPU's, ``ZOO_STEPS`` adamw steps (``ZOO_LR``)
    of ``ZOO_BATCH`` × ``ZOO_SEQ`` fp32 tokens (TF32 off) whose loss must fall,
    tokens/s, peak memory and host syncs a step, decode tokens/s against a
    deep cache and the prefill time. Then jamba-1.5-large-398b reduced:
    decode ≡ forward and the first loss. Returns the phase's JSON."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced

    started = time.perf_counter()
    device = resolve_device(device)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for fp32 matmuls")
    out: dict = {"card": smi, "dtype": "float32", "tf32": False, "batch": ZOO_BATCH, "seq_len": ZOO_SEQ,
                 "steps": ZOO_STEPS, "optimizer": "adamw", "archs": {}}
    for name, want, trainer in (
        ("deepseek-v2-lite-16b", (2048, 16, 102400, 512, 128, 64, 128, 64, 6, 2, 1408), _train_deepseek),
        ("falcon-mamba-7b", (4096, 65024, 16, 4, 2, 256, ("mamba", "none")), _train_mamba),
    ):
        t_arch = time.perf_counter()
        published = get_config(name)
        cfg = dataclasses.replace(published, n_layers=ZOO_LAYERS)
        if cfg.mla is not None:
            m, e = cfg.mla, cfg.moe
            got = (cfg.d_model, cfg.n_heads, cfg.vocab_size, m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
                   m.v_head_dim, e.n_experts, e.top_k, e.n_shared, e.d_ff_expert)
        else:
            mb = cfg.mamba
            got = (cfg.d_model, cfg.vocab_size, mb.d_state, mb.d_conv, mb.expand, mb.dt_rank or -(-cfg.d_model // 16),
                   (cfg.period[0].mixer, cfg.period[0].ff))
        check(got == want, f"{name} is not at its published width: {got}")
        host, card, n_params, init_s = _draw(cfg, device)
        row = {"layers": cfg.n_layers, "published_layers": published.n_layers,
               "reduced": [f"n_layers {published.n_layers} -> {cfg.n_layers}"], "params": n_params, "init_s": init_s}
        log(f"[zoo  ] {name} at its published width, depth cut {published.n_layers} → {cfg.n_layers} layers: "
            f"{n_params / 1e9:.3f} B parameters, drawn on the host and carried to the card in {init_s:.1f} s")
        _first_loss(cfg, host, card, row)
        _decode_checks(cfg, host, card, device, row)
        del host
        gc.collect()
        trainer(cfg, card, device, ZOO_LR[name], row)
        losses = row["losses"]
        log(f"[zoo  ] {name}: {row['trainer']}; {ZOO_STEPS} adamw steps of {ZOO_BATCH} × {ZOO_SEQ} tokens, fp32: "
            f"losses {losses[0]:.4f} → {losses[-1]:.4f}; {row['tokens_per_s']:.0f} tokens/s; "
            f"torch.cuda.max_memory_allocated {row['max_memory_allocated'] / 2**30:.2f} GiB; "
            f"{row['syncs_train_step']} host syncs a step ({row['syncs_train_step_at']}) — {smi}")
        check(len(losses) == ZOO_STEPS and all(math.isfinite(v) for v in losses), f"{name}: the losses are {losses}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall over {ZOO_STEPS} steps: {losses}")
        _serve_numbers(cfg, card, device, row)
        moe_layers = sum(s.ff == "moe" for s in cfg.period) * cfg.n_periods
        check(row["syncs_train_step"] >= moe_layers and row["syncs_decode_step"] >= moe_layers,
              f"{name}: counted fewer host syncs than group-size reads ({moe_layers} MoE layers): "
              f"{row['syncs_train_step']} a train step, {row['syncs_decode_step']} a decode step")
        del card
        gc.collect()
        torch.cuda.empty_cache()
        row["phase_s"] = time.perf_counter() - t_arch
        out["archs"][name] = row

    # jamba: attention, Mamba and MoE in one period — reduced, since one
    # period at its published width does not fit one card
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    check({(s.mixer, s.ff) for s in cfg.period} == {("attn", "dense"), ("mamba", "moe")},
          f"reduced jamba's period is {cfg.period}")
    host, card, n_params, init_s = _draw(cfg, device)
    row = {"config": "configs.reduced", "params": n_params, "reduced": [
        "configs.reduced: d_model 8192 -> 256, 4 heads, one attention + one Mamba/MoE layer, 4 experts of 128, "
        "vocab 512: at its published width one 8-layer period holds 4 MoE layers of 16 x 3 x 8192 x 24576 "
        "= 9.7 B parameters each (38.7 GB in fp32 each), so no period fits one 80 GB card"]}
    _first_loss(cfg, host, card, row)
    _decode_checks(cfg, host, card, device, row)
    del host, card
    out["jamba-1.5-large-398b"] = row
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - started
    log(f"[zoo  ] phase done in {out['phase_s']:.1f} s")
    return out


def _mm_setup(device=None, reduced: bool = False, parts=MM_PARTS) -> dict:
    """The model_mesh phase's sizes, device (None: the card) and parts (of
    ``MM_PARTS``, run by the spawned ranks). ``reduced`` (a CPU rehearsal
    only): the reduced configs at small batches."""
    sizes = dict(steps=MM_STEPS, batch=MM_BATCH, seq=MM_SEQ, tau=MM_TAU, moe_batch=MM_MOE_BATCH,
                 dec_batch=MM_DEC_BATCH, dec_depth=MM_DEC_DEPTH, dec_steps=MM_DEC_STEPS,
                 nccl1_batch=MM_NCCL1_BATCH, nccl1_decode=MM_NCCL1_DECODE, tau_steps=MM_TAU_STEPS)
    if reduced:
        sizes.update(batch=4, seq=16, moe_batch=4, dec_batch=4, dec_depth=16, dec_steps=6, nccl1_batch=2,
                     nccl1_decode=4, tau_steps=4)
    return {"device": None if device is None else str(device), "reduced": reduced, "parts": list(parts), **sizes}


_HOST_PARAMS: dict = {}


def _host_params(cfg) -> dict:
    """``init_params(cfg, float32, "cpu", seed=0)``, kept for the next call
    of the same weights (one tree at a time): (b) and (c) share deepseek's,
    the oracles (b) and (c) theirs. The layout flags do not change what is
    drawn, so they are not part of the key."""
    from repro_torch.models import init_params

    key = dataclasses.replace(cfg, sharding_profile="tp", expert_weight_stationary=False, max_seq_len=0)
    if key not in _HOST_PARAMS:
        _HOST_PARAMS.clear()
        _HOST_PARAMS[key] = init_params(cfg, dtype=torch.float32, device="cpu", seed=0)
    return _HOST_PARAMS[key]


def _mm_decode_config(arch: str, setup: dict):
    """(c)'s config of ``arch``: published width cut to ``MM_LAYERS`` layers
    (reduced in a CPU rehearsal), with the profile and expert placement
    ``resolve_config(arch, decode_32k)`` gives."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.input_specs import SHAPES, resolve_config

    full = resolve_config(arch, SHAPES["decode_32k"])
    base = reduced(get_config(arch)) if setup["reduced"] else dataclasses.replace(get_config(arch), n_layers=MM_LAYERS)
    return dataclasses.replace(base, sharding_profile=full.sharding_profile,
                               expert_weight_stationary=full.expert_weight_stationary)


def _decode_shape(setup: dict):
    from repro_torch.launch.input_specs import ShapeSpec

    return ShapeSpec("decode_32k", setup["dec_depth"], setup["dec_batch"], "decode")


def _capture_routes(routes: list, routers: list):
    """Wraps ``blocks.moe`` to append, for each MoE layer a step runs, the
    experts its tokens go to (top-k of the float32 softmax router) as
    (first row, routes of this rank's rows) — on a mesh from the layer's
    input rows this rank holds (whole along d_model), with ``routers`` (the
    whole router of each MoE layer, in call order) gathered beforehand.
    Returns the function that undoes it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import blocks
    from repro_torch.models.sharding import split_offset

    real = blocks.moe
    calls = [0]

    def moe(p, cfg, x):
        first, x_rows = 0, x
        if isinstance(x, DTensor):  # whole rows: a gather of the (B, 1, d) input where it is split off the batch
            rows = x.redistribute(x.device_mesh, [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
                                                  for q in x.placements])
            first, x_rows = split_offset(rows, 0)[1], rows.to_local()
        router = routers[calls[0] % len(routers)]
        calls[0] += 1
        t = x_rows.reshape(-1, x_rows.shape[-1]).to(torch.float32)
        top = torch.topk(torch.softmax(t @ router.to(device=t.device, dtype=torch.float32), dim=-1),
                         cfg.moe.top_k, dim=-1)[1]
        routes.append((first * x_rows.shape[1], top.cpu().numpy()))
        return real(p, cfg, x)

    blocks.moe = moe
    return lambda: setattr(blocks, "moe", real)


def _routers(cfg, params) -> list:
    """The whole router of each MoE layer, in the order a step calls them."""
    from torch.distributed.tensor import DTensor

    out = []
    for r in range(cfg.n_periods):
        for spec, stacked in zip(cfg.period, params["layers"]):
            if spec.ff == "moe":
                t = stacked["router"]
                out.append((t.full_tensor() if isinstance(t, DTensor) else t)[r])
    return out


def _decode_oracle(root: pathlib.Path, setup: dict, device) -> dict:
    """(c)'s oracle, on the card in this process: each arch's single-device
    decode of ``dec_steps`` steps from the same weights (seed 0) and ids;
    its logits, ids and (MoE) routes saved under ``root``. Returns each
    arch's decode tokens/s on one card."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_cache, init_params

    root.mkdir()
    rates = {}
    B, depth, steps = setup["dec_batch"], setup["dec_depth"], setup["dec_steps"]
    for arch in MM_DEC_ARCHS:
        cfg = _mm_decode_config(arch, setup)
        card = tree_map(lambda t: t.to(device), _host_params(cfg))
        cache = init_cache(cfg, B, depth, torch.float32, device)
        ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (steps, B, 1))
        step = make_serve_step(cfg)
        routes, logits = [], []
        undo = _capture_routes(routes, _routers(cfg, card)) if cfg.moe is not None else (lambda: None)
        try:
            for s in range(steps):
                out, cache = step(card, cache, torch.from_numpy(ids[s]).to(device))
                logits.append(out.cpu().numpy())
        finally:
            undo()
        # the single card's decode rate, without the route capture
        cache = init_cache(cfg, B, depth, torch.float32, device)
        _mm_sync(device)
        t0 = time.perf_counter()
        for s in range(steps):
            out, cache = step(card, cache, torch.from_numpy(ids[s]).to(device))
        _mm_sync(device)
        rates[arch] = B * steps / (time.perf_counter() - t0)
        np.save(root / f"{arch}.ids.npy", ids)
        np.save(root / f"{arch}.logits.npy", np.stack(logits))
        if routes:
            np.save(root / f"{arch}.routes.npy", np.stack([top for _, top in routes]))
        del card, cache, out
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rates


def _mm_decode(out: pathlib.Path, setup: dict) -> dict:
    """(c), on one rank: each arch decoded on the (2, 2) mesh from the
    oracle's weights and ids. Per step: the gap of this rank's block of the
    logits to the oracle's (max |Δ| over the oracle's max |logit|), the
    routes of this rank's rows of each MoE layer, and whether every cache
    leaf kept its placements; then one step on a fresh cache of the same
    depth and one twice as deep, without the checks, their collectives
    counted (kind, count, bytes: they must agree — nothing moves the
    cache), the second also by torch's ``CommDebugMode``. Also the wall
    of the steps without the checks, the local bytes of the parameters and
    the cache, and the peak memory."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import resolve_device
    from repro_torch._tree import path_key, tree_paths
    from repro_torch.launch.input_specs import cache_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import count_collectives
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import distribute_params, init_cache, init_params, param_pspecs, sharding

    device = resolve_device(setup["device"])
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    shape = _decode_shape(setup)
    B, depth, steps = setup["dec_batch"], setup["dec_depth"], setup["dec_steps"]
    res = {}
    for arch in MM_DEC_ARCHS:
        t_setup = time.perf_counter()
        cfg = _mm_decode_config(arch, setup)
        host = _host_params(cfg)
        params = distribute_params(host, param_pspecs(cfg, host, mesh), mesh)
        del host

        def fresh_cache(d):
            c = init_cache(cfg, B, d, torch.float32, device)
            return distribute_params(c, cache_shardings(cfg, dataclasses.replace(shape, seq_len=d), mesh, c), mesh)

        cache = fresh_cache(depth)
        want = {path_key(p): list(map(str, t.placements)) for p, t in tree_paths(cache)}

        def local_bytes(tree):
            return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
                       for _, t in tree_paths(tree))

        param_bytes, cache_bytes = local_bytes(params), local_bytes(cache)
        ids = np.load(out / "oracle_c" / f"{arch}.ids.npy")
        oracle = np.load(out / "oracle_c" / f"{arch}.logits.npy", mmap_mode="r")
        oracle_routes = np.load(out / "oracle_c" / f"{arch}.routes.npy") if cfg.moe is not None else None
        step = make_serve_step(cfg)
        routes, gaps, kept, step_s, counted = [], [], True, 0.0, {}
        undo = _capture_routes(routes, _routers(cfg, params)) if cfg.moe is not None else (lambda: None)
        setup_s = time.perf_counter() - t_setup
        _mm_sync(device)
        _mm_peak(device, reset=True)
        try:
            for s in range(steps):
                tok = torch.from_numpy(ids[s]).to(device)
                _mm_sync(device)
                t0 = time.perf_counter()
                with sharding.use_mesh(mesh):
                    logits, cache = step(params, cache, tok)
                _mm_sync(device)
                step_s += time.perf_counter() - t0
                if any(isinstance(q, Partial) for q in logits.placements):
                    logits = logits.redistribute(mesh, [Replicate() if isinstance(q, Partial) else q
                                                        for q in logits.placements])
                mine = distribute_tensor(torch.from_numpy(np.array(oracle[s])), mesh, logits.placements,
                                         src_data_rank=None).to_local()
                gaps.append(float((logits.to_local() - mine).abs().max()) / float(np.abs(oracle[s]).max()))
                kept &= all(isinstance(t, DTensor) and list(map(str, t.placements)) == want[path_key(p)]
                            for p, t in tree_paths(cache))
        finally:
            undo()
        peak = _mm_peak(device)
        for d in (depth, 2 * depth):
            with sharding.use_mesh(mesh), CommDebugMode() as torch_counted, count_collectives() as stats:
                step(params, fresh_cache(d), torch.from_numpy(ids[0]).to(device))
            counted[d] = [stats.count_by_kind, stats.bytes_by_kind]
            torch_kinds = _torch_kinds(torch_counted)
        routes_equal = None
        if routes:  # the i-th MoE call of the run, both sides; each rank checks its rows
            routes_equal = len(routes) == len(oracle_routes) and all(
                np.array_equal(top, oracle_routes[i][first:first + len(top)]) for i, (first, top) in enumerate(routes))
        res[arch] = {"gaps": gaps, "kept": kept, "routes_equal": routes_equal,
                     "step_s": step_s, "setup_s": setup_s, "tokens_per_s": B * steps / step_s,
                     "param_bytes": param_bytes, "cache_bytes": cache_bytes, "max_memory_allocated": peak,
                     "collectives": counted[depth], "collectives_2x": counted[2 * depth],
                     "torch_counted_2x": torch_kinds}
        del params, cache, logits
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def _mm_dryrun(setup: dict, decode: dict) -> dict:
    """(d), on one rank: ``dryrun.run_combo`` of each of ``MM_DRY_ARCHS`` at
    (c)'s decode shape and config on (c)'s (2, 2) mesh (fake tensors on this
    rank's device: nothing moves), in float32 as (c) ran; the record beside
    what (c) held and counted on this rank."""
    from repro_torch import resolve_device
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    device = resolve_device(setup["device"])
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    res = {}
    for arch in MM_DRY_ARCHS:
        t0 = time.perf_counter()
        rec = dryrun.run_combo(arch, "decode_32k", mesh, device=device.type, cfg=_mm_decode_config(arch, setup),
                               shape=_decode_shape(setup), dtype=torch.float32)
        res[arch] = {"record": rec, "s": time.perf_counter() - t0, "real": {
            k: decode[arch][k] for k in ("param_bytes", "cache_bytes", "max_memory_allocated", "collectives")}}
    return res


def dryrun_host(out: str, device_type: str) -> None:
    """The full-width dry run in its own process (a spawned one, with no
    process group): ``MM_HOST_DRY`` on the fake (16, 16) production mesh,
    fake tensors on ``device_type``; the records written to ``out``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    recs = {}
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device=device_type)
        for arch, shape in MM_HOST_DRY:
            t0 = time.perf_counter()
            recs[f"{arch}|{shape}"] = dryrun.run_combo(arch, shape, mesh, device=device_type)
            recs[f"{arch}|{shape}"]["wall_s"] = time.perf_counter() - t0
    pathlib.Path(out).write_text(json.dumps(recs))


def _mm_configs(setup: dict):
    """The model_mesh phase's two configs at their published widths, depth
    cut to ``MM_LAYERS``: (qwen2.5-3b, deepseek-v2-lite-16b, published
    depths)."""
    from repro_torch.configs import get_config, reduced

    qwen, deepseek = get_config("qwen2.5-3b"), get_config("deepseek-v2-lite-16b")
    published = {"qwen2.5-3b": qwen.n_layers, "deepseek-v2-lite-16b": deepseek.n_layers}
    if setup["reduced"]:
        return reduced(qwen), reduced(deepseek), published
    check((qwen.d_model, qwen.n_heads, qwen.n_kv_heads, qwen.d_ff, qwen.vocab_size) == (2048, 16, 2, 11008, 151936),
          f"qwen2.5-3b is not at its published width: {qwen}")
    check((deepseek.d_model, deepseek.vocab_size, deepseek.moe.n_experts, deepseek.moe.top_k, deepseek.moe.d_ff_expert)
          == (2048, 102400, 64, 6, 1408), f"deepseek-v2-lite-16b is not at its published width: {deepseek}")
    return dataclasses.replace(qwen, n_layers=MM_LAYERS), dataclasses.replace(deepseek, n_layers=MM_LAYERS), published


def _mm_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mm_peak(device: torch.device, reset: bool = False) -> int:
    if device.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device)


def _torch_kinds(comm) -> dict:
    """``CommDebugMode``'s counts (torch's own collective counter) by the
    dry run's kinds."""
    from repro_torch.launch.roofline import _KIND_OF

    kinds: dict = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        kind = _KIND_OF.get(name, name)
        kinds[kind] = kinds.get(kind, 0) + n
    return kinds


def _mm_nccl1(setup: dict, smi: str) -> dict:
    """The model mesh on a world-size-1 group in this process — NCCL on the
    card (gloo in a CPU rehearsal): qwen2.5-3b at published width, depth cut
    to ``MM_LAYERS``, on a (1, 1) ("data", "model") mesh. One
    ``train(mesh=...)`` step (its loss and gradients, taken by an optimizer
    that records them) against the single-device ``train`` step from the
    same weights and batch, then ``nccl1_decode`` serve steps against the
    single-device decode, each run's collectives counted. Each mesh run
    goes through the backend's process group, DTensor on it and the
    all-gather rule (``launch/mesh.plain_all_gather_needed``)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import resolve_device
    from repro_torch._tree import tree_map, tree_paths
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.input_specs import cache_shardings
    from repro_torch.launch.roofline import count_collectives
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import distribute_params, init_cache, param_pspecs, sharding
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.train.loop import train

    started = time.perf_counter()
    device = resolve_device(setup["device"])
    backend = "nccl" if device.type == "cuda" else "gloo"
    cfg = _mm_configs(setup)[0]
    dcfg = _mm_decode_config("qwen2.5-3b", setup)
    batch, seq = setup["nccl1_batch"], setup["seq"]
    B, depth, n_dec = setup["dec_batch"], setup["dec_depth"], setup["nccl1_decode"]
    host = _host_params(cfg)  # dcfg's too: the layout flags draw nothing
    card = tree_map(lambda t: t.to(device), host)

    def one_step(mesh, params):
        grads = []
        opt = Optimizer(init=lambda p: (), update=lambda g, state, p: (grads.append(g) or p, state))
        with count_collectives() as stats:
            report = train(cfg, steps=1, batch=batch, seq_len=seq, tau=1, mesh=mesh, opt=opt, log_every=1, seed=0,
                           device=device, params=params)
        return report.losses[0], grads[0], {k: v for k, v in stats.count_by_kind.items() if v}

    ids = np.random.default_rng(5).integers(0, dcfg.vocab_size, (n_dec, B, 1))
    serve = make_serve_step(dcfg)

    def decode(params, cache, mesh):
        logits = []
        with sharding.use_mesh(mesh), count_collectives() as stats:
            for k in range(n_dec):
                out, cache = serve(params, cache, torch.from_numpy(ids[k]).to(device))
                logits.append((out.full_tensor() if isinstance(out, DTensor) else out).cpu().numpy())
        return np.stack(logits), {k: v for k, v in stats.count_by_kind.items() if v}

    loss_1, grads_1, _ = one_step(None, card)
    want_logits, _ = decode(card, init_cache(dcfg, B, depth, torch.float32, device), None)
    grads_1 = {"/".join(map(str, p)): t.detach().cpu() for p, t in tree_paths(grads_1)}
    del card
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device=device)
            plain_gather = bool(mesh_mod._PLAIN_ALL_GATHER)
            probe = _all_gather_probe(mesh)
            loss_m, grads_m, train_coll = one_step(mesh, host)
            grad_rel = {}
            for p, g in tree_paths(grads_m):
                key = "/".join(map(str, p))
                got = (g.full_tensor() if isinstance(g, DTensor) else g).detach().cpu()
                grad_rel[key] = float((got - grads_1[key]).abs().max()) / max(float(grads_1[key].abs().max()), 1e-30)
            del grads_m
            params = distribute_params(host, param_pspecs(dcfg, host, mesh), mesh)
            cache = init_cache(dcfg, B, depth, torch.float32, device)
            cache = distribute_params(cache, cache_shardings(dcfg, _decode_shape(setup), mesh, cache), mesh)
            got_logits, decode_coll = decode(params, cache, mesh)
            del params, cache
        finally:
            dist.destroy_process_group()
    gaps = [float(np.abs(g - w).max()) / float(np.abs(w).max()) for g, w in zip(got_logits, want_logits)]
    loss_rel = abs(loss_m - loss_1) / abs(loss_1)
    worst = max(grad_rel, key=grad_rel.get)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    wall = time.perf_counter() - started
    log(f"[mmesh] world-size-1 {backend} model mesh in this process: qwen2.5-3b (published width, {MM_LAYERS} layers) "
        f"on (1, 1) (data, model); one train(mesh=...) step of {batch} × {seq}: loss {loss_m:.7f} vs the single-device "
        f"step's {loss_1:.7f} (relative {loss_rel:.3g}, limit {ZOO_CPU_RTOL:g}), gradients worst leaf {worst} "
        f"{grad_rel[worst]:.3g} (limit {ZOO_GRAD_RTOL:g}) over {len(grad_rel)} leaves, collectives {train_coll}; "
        f"{n_dec} decode steps of batch {B} against a {depth}-deep cache: worst step {max(gaps):.3g} from the "
        f"single-device decode (limit {ZOO_CPU_RTOL:g}), collectives {decode_coll}; plain all-gather registered: "
        f"{plain_gather}; the functional all-gather on the group bitwise c10d's: {all(probe.values())} ({wall:.1f} s) "
        f"— {smi}")
    check(math.isfinite(loss_m) and loss_rel <= ZOO_CPU_RTOL,
          f"world-size-1 {backend} mesh: the loss is {loss_rel} from the single-device step's")
    check(grad_rel[worst] <= ZOO_GRAD_RTOL,
          f"world-size-1 {backend} mesh: the gradient of {worst} is {grad_rel[worst]} from the single-device step's")
    check(all(math.isfinite(g) for g in gaps) and max(gaps) <= ZOO_CPU_RTOL,
          f"world-size-1 {backend} mesh: the decode is {max(gaps)} from the single-device decode")
    check(plain_gather == mesh_mod.plain_all_gather_needed(backend),
          f"world-size-1 {backend} mesh: the plain all-gather is {'' if plain_gather else 'not '}registered")
    check(all(probe.values()), f"world-size-1 {backend} mesh: the all-gather probe {probe}")
    return {"backend": backend, "mesh": [1, 1], "axes": ["data", "model"], "arch": "qwen2.5-3b", "layers": MM_LAYERS,
            "batch": batch, "seq_len": seq, "loss": loss_m, "single_loss": loss_1, "loss_rel": loss_rel,
            "grad_rel_worst": grad_rel[worst], "grad_rel_worst_leaf": worst, "train_collectives": train_coll,
            "decode_steps": n_dec, "decode_batch": B, "cache_depth": depth, "decode_gap_worst": max(gaps),
            "decode_collectives": decode_coll, "plain_all_gather": plain_gather, "all_gather_probe": probe,
            "wall_s": wall}


def _leaf_file(root: pathlib.Path, path) -> pathlib.Path:
    return root / (".".join(map(str, path)) + ".npy")


def _local_oracle(root: pathlib.Path, path, t) -> torch.Tensor:
    """The oracle's leaf at ``path`` laid out as ``t`` (this rank's shard of
    a DTensor, or the whole tensor)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    want = torch.from_numpy(np.ascontiguousarray(np.load(_leaf_file(root, path), mmap_mode="r")))
    if isinstance(t, DTensor):
        return distribute_tensor(want, t.device_mesh, t.placements, src_data_rank=None).to_local()
    return want.to(t.device)


def _mm_hybrid(out: pathlib.Path, setup: dict) -> dict:
    """(a), on one rank: qwen2.5-3b through ``train(mesh=...)`` on the
    (2, 1, 2) mesh. Each pod sync is wrapped to time it and to read, over
    the "pod" group, how far the pods drifted before it (max − min of every
    parameter entry) and whether they hold the same bits after it (max ==
    min); the final parameters are held against the oracle's, shard by
    shard."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import repro_torch.train.loop as loop
    from repro_torch._tree import tree_paths
    from repro_torch.launch.mesh import make_mesh
    from repro_torch import resolve_device
    from repro_torch.optim.sgd import adamw

    cfg = _mm_configs(setup)[0]
    device = resolve_device(setup["device"])
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device=device)
    group = mesh.get_group("pod")
    syncs, final = [], [None]
    checks_s = [0.0]
    real_sync = loop.make_sync_step

    def spread(params):
        """max over the entries of (max − min over the pods), a leaf at a time."""
        worst = 0.0
        for _, t in tree_paths(params):
            hi = (t.to_local() if isinstance(t, DTensor) else t).detach().clone()
            lo = hi.clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
            worst = max(worst, float((hi - lo).max()))
            del hi, lo
        return worst

    def instrumented(mesh_):
        sync = real_sync(mesh_)

        def run(params):
            t0 = time.perf_counter()
            drift = spread(params)
            _mm_sync(device)
            t1 = time.perf_counter()
            new = sync(params)
            _mm_sync(device)
            t2 = time.perf_counter()
            after = spread(new)
            _mm_sync(device)
            checks_s[0] += (t1 - t0) + (time.perf_counter() - t2)
            syncs.append({"drift_before": drift, "spread_after": after, "sync_ms": (t2 - t1) * 1e3})
            final[0] = new
            return new

        return run

    loop.make_sync_step = instrumented
    try:
        _mm_peak(device, reset=True)
        report = loop.train(cfg, steps=setup["steps"], batch=setup["batch"], seq_len=setup["seq"], tau=setup["tau"],
                            mesh=mesh, log_every=1, opt=adamw(MM_LR), seed=0, device=device)
        peak = _mm_peak(device)
    finally:
        loop.make_sync_step = real_sync
    leaves = {}
    for path, t in tree_paths(final[0]):
        want = _local_oracle(out / "oracle_a", path, t)
        got = t.to_local() if isinstance(t, DTensor) else t
        diff = (got - want).abs()
        leaves["/".join(map(str, path))] = (float(diff.max()), float(diff.sum()), diff.numel())
        del want, diff
    del final[0]
    tokens = setup["steps"] * setup["batch"] * setup["seq"]
    wall = tokens / report.tokens_per_s
    # τ = 1 against τ = MM_TAU in turns, each run from the same weights
    turns = []
    for turn in range(setup["tau_turns"]):
        row = {}
        for tau in ((1, setup["tau"]) if turn % 2 == 0 else (setup["tau"], 1)):
            rep = loop.train(cfg, steps=setup["tau_steps"], batch=setup["batch"], seq_len=setup["seq"], tau=tau,
                             mesh=mesh, log_every=setup["tau_steps"], opt=adamw(MM_LR), seed=0, device=device,
                             params=_host_params(cfg))
            row[f"tau{tau}"] = rep.tokens_per_s
        turns.append(row)
    return {"losses": report.losses, "syncs": syncs, "leaves": leaves,
            "tokens_per_s": report.tokens_per_s, "checks_s": checks_s[0],
            "tokens_per_s_without_checks": tokens / (wall - checks_s[0]),
            "max_memory_allocated": peak, "tau_turns": turns}


def _grad_optimizer():
    """An ``Optimizer`` whose update returns the gradient as the new
    parameters: one train step then gives its gradients exactly."""
    from repro_torch.optim.sgd import Optimizer

    return Optimizer(init=lambda params: (), update=lambda grads, state, params: (grads, state))


def _mm_moe(out: pathlib.Path, setup: dict) -> dict:
    """(b), on one rank: deepseek-v2-lite-16b, one ``make_train_step`` step on
    the (2, 2) mesh at cf = 8 (its gradients, shard by shard, against the
    oracle's); the dropped share of the token copies at cf = 2 and 1 (a
    forward of the first microbatch); the time of one ``all_to_all`` of the
    dispatch buffer of a microbatch at cf = 2 over the "model" group."""
    import torch.distributed as dist

    from repro_torch._tree import tree_paths
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import distribute_params, init_params, lm_loss, moe_ep, param_pspecs, sharding
    from repro_torch import resolve_device
    from repro_torch.train.data import MarkovTextStream

    cfg = _mm_configs(setup)[1]
    device = resolve_device(setup["device"])
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    host = _host_params(cfg)
    specs = param_pspecs(cfg, host, mesh)
    params = distribute_params(host, specs, mesh)
    del host
    toks, targs = next(MarkovTextStream(cfg.vocab_size, seed=0).batches(setup["moe_batch"], setup["seq"]))
    tok, tgt = torch.from_numpy(toks).to(device), torch.from_numpy(targs).to(device)
    step = make_train_step(cfg, mesh, opt=_grad_optimizer(), param_specs=specs)
    moe_ep.CAPACITY_FACTOR = 8.0
    moe_ep.copies.update(routed=0, dropped=0)
    _mm_sync(device)
    _mm_peak(device, reset=True)
    t0 = time.perf_counter()
    grads, _, loss = step(params, (), tok, tgt)
    _mm_sync(device)
    step_s = time.perf_counter() - t0
    peak = _mm_peak(device)
    drops = {"cf8": dict(moe_ep.copies)}
    leaves = {}
    for path, g in tree_paths(grads):
        want = _local_oracle(out / "oracle_b", path, g)
        leaves["/".join(map(str, path))] = (float((g.to_local() - want).abs().max()), float(want.abs().max()))
        del want
    del grads
    dp = mesh.size(0)
    for cf in (2.0, 1.0):
        moe_ep.CAPACITY_FACTOR = cf
        moe_ep.copies.update(routed=0, dropped=0)
        with torch.no_grad(), sharding.use_mesh(mesh):
            lm_loss(cfg, params, tok[:dp], tgt[:dp])
        drops[f"cf{cf:g}"] = dict(moe_ep.copies)
    moe_ep.CAPACITY_FACTOR = 2.0
    m, k, d = mesh.size(1), cfg.moe.top_k, cfg.d_model
    t_pad = -(-setup["seq"] // m)  # one sequence a data rank, split over "model"
    cap = (t_pad * k * 8) // (4 * m)
    send = torch.randn((m * cap, d), device=device)
    recv = torch.empty_like(send)
    group = mesh.get_group("model")
    times = []
    for _ in range(6):
        _mm_sync(device)
        t0 = time.perf_counter()
        dist.all_to_all_single(recv, send, group=group)
        _mm_sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": float(loss), "step_s": step_s, "tokens_per_s": setup["moe_batch"] * setup["seq"] / step_s,
            "max_memory_allocated": peak, "leaves": leaves, "copies": drops,
            "all_to_all_ms": statistics.median(times[1:]), "all_to_all_bytes": send.numel() * 4}


def _all_gather_probe(mesh) -> dict:
    """DTensor's functional all-gather (``funcol.all_gather_tensor``, which
    ``redistribute`` calls) against ``dist.all_gather_into_tensor`` on each
    dim's group of ``mesh``, on this rank's tensors: a float32 and a bf16
    tensor gathered along dim 0 and dim 1 (non-contiguous input). Returns
    {case: bitwise equal}."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch import resolve_device

    device = torch.device("cpu") if mesh.device_type == "cpu" else resolve_device(None)
    gen = torch.Generator().manual_seed(100 + dist.get_rank())
    res = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        group = mesh.get_group(i)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((6, 5, 3), generator=gen).to(device=device, dtype=dtype)
            for dim in (0, 1):
                got = funcol.all_gather_tensor(x, dim, (mesh, i))
                got = got.wait() if isinstance(got, funcol.AsyncCollectiveTensor) else got
                m = dist.get_world_size(group)
                flat = x.new_empty((m,) + tuple(x.shape))
                dist.all_gather_into_tensor(flat, x.contiguous()[None], group=group)
                want = torch.cat(list(flat.unbind(0)), dim=dim)
                res[f"{name}/{str(dtype).split('.')[-1]}/dim{dim}"] = bool(torch.equal(got, want))
    return res


def model_mesh_rank(rank: int, world: int, store: str, out: str, backend: str, setup: dict) -> None:
    """One rank of the model_mesh phase (a spawned process): the
    all-gather probe, then the parts of ``setup`` in order, (a) to (d);
    writes its numbers under ``out``. A part that raises leaves its
    traceback under ``errors`` and the rank goes on to the next part, so
    one fault does not hide the other parts' readings (the phase fails on
    it)."""
    import datetime
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MM_TIMEOUT_S[backend]))
    try:
        from repro_torch import resolve_device
        from repro_torch.launch import mesh as mesh_mod

        res = {"device": str(resolve_device(setup["device"])), "errors": {}}
        res["all_gather_probe"] = _all_gather_probe(mesh_mod.make_mesh((2, 2), ("data", "model"),
                                                                        device=setup["device"]))
        res["plain_all_gather"] = bool(mesh_mod._PLAIN_ALL_GATHER)
        parts = {"hybrid": lambda: _mm_hybrid(pathlib.Path(out), setup), "moe": lambda: _mm_moe(pathlib.Path(out), setup),
                 "decode": lambda: _mm_decode(pathlib.Path(out), setup),
                 "dryrun": lambda: _mm_dryrun(setup, res["decode"])}
        for part in setup["parts"]:
            try:
                res[part] = parts[part]()
            except Exception:
                res["errors"][part] = traceback.format_exc()
                log(f"[mmesh] rank {rank}: part {part} raised\n{res['errors'][part]}")
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        (pathlib.Path(out) / f"mm_rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _save_leaves(root: pathlib.Path, tree) -> None:
    from repro_torch._tree import tree_paths

    root.mkdir()
    for path, t in tree_paths(tree):
        np.save(_leaf_file(root, path), t.detach().cpu().numpy())


def _mm_note(backend: str) -> str:
    """What the model_mesh phase's walls are, by the ranks' backend."""
    if backend == "gloo":
        return ("correctness runs, not measurements of communication: gloo moves each CUDA tensor through the "
                "host, and four processes share one card")
    return f"{backend}, one card a rank: the walls and the collectives' times are measurements on the cards"


def _report_decode(ranks: list, single_rates: dict, setup: dict, where: str, smi: str, backend: str) -> dict:
    """(c)'s checks and numbers from the ranks' results."""
    res = {}
    for arch in MM_DEC_ARCHS:
        dec = [r["decode"][arch] for r in ranks]
        gaps = [max(d["gaps"][s] for d in dec) for s in range(setup["dec_steps"])]
        routes_ok = dec[0]["routes_equal"]
        # the routing first: other experts would explain any gap of the logits
        check(all(d["routes_equal"] is not False for d in dec),
              f"(c) {arch}: the mesh routed tokens to other experts than the single-device decode")
        check(all(math.isfinite(g) for g in gaps) and max(gaps) <= ZOO_CPU_RTOL,
              f"(c) {arch}: the mesh decode's logits are {max(gaps)} from the single-device decode's")
        check(all(d["kept"] for d in dec), f"(c) {arch}: a cache leaf left its cache_shardings placements")
        check(all(d["collectives"] == d["collectives_2x"] for d in dec),
              f"(c) {arch}: a step's collectives change with the cache's depth: "
              f"{dec[0]['collectives']} vs {dec[0]['collectives_2x']}")
        for r, d in enumerate(dec):
            ours = {k: v for k, v in d["collectives_2x"][0].items() if v}
            check(ours == d["torch_counted_2x"],
                  f"(c) {arch} rank {r}: count_collectives counted {ours}, torch's CommDebugMode {d['torch_counted_2x']}")
        rates = [d["tokens_per_s"] for d in dec]
        log(f"[mmesh] (c) {arch} decode on (2, 2) (data, model), {where}: {setup['dec_steps']} serve steps of batch "
            f"{setup['dec_batch']} against a {setup['dec_depth']}-deep cache; logits vs the single-device decode, worst "
            f"step {max(gaps):.3g} (limit {ZOO_CPU_RTOL:g})" + ("" if routes_ok is None else ", routes equal")
            + f"; cache placements kept; collectives a step {dec[0]['collectives'][0]} the same at twice the depth "
            f"and = torch's CommDebugMode; {[round(x) for x in rates]} tokens/s a rank (one card alone "
            f"{single_rates[arch]:.0f}; {_mm_note(backend)}); set-up {max(d['setup_s'] for d in dec):.1f} s, "
            f"steps {max(d['step_s'] for d in dec):.1f} s; max_memory_allocated "
            f"{[round(d['max_memory_allocated'] / 2**30, 3) for d in dec]} GiB — {smi}")
        res[arch] = {"gap_worst": max(gaps), "gaps": gaps, "routes_equal": routes_ok, "placements_kept": True,
                     "collectives_step": dec[0]["collectives"], "tokens_per_s": rates,
                     "single_card_tokens_per_s": single_rates[arch], "setup_s": [d["setup_s"] for d in dec],
                     "step_s": [d["step_s"] for d in dec],
                     "max_memory_allocated": [d["max_memory_allocated"] for d in dec],
                     "param_bytes": [d["param_bytes"] for d in dec], "cache_bytes": [d["cache_bytes"] for d in dec]}
    return {"mesh": [2, 2], "axes": ["data", "model"], "layers": MM_LAYERS, "batch": setup["dec_batch"],
            "cache_depth": setup["dec_depth"], "steps": setup["dec_steps"], "tol": ZOO_CPU_RTOL, "archs": res,
            "note": _mm_note(backend)}


def _report_dryrun(ranks: list, host_recs: dict, setup: dict, smi: str) -> dict:
    """(d)'s checks and numbers: each rank's dry-run record against what
    (c) held and counted there; the host's full-width records."""
    res = {}
    for arch in MM_DRY_ARCHS:
        rows = []
        for r, rank in enumerate(ranks):
            d = rank["dryrun"][arch]
            rec, real = d["record"], d["real"]
            check(rec["status"] == "ok", f"(d) {arch}: the dry run's status is {rec['status']}")
            mem = rec["memory"]
            check((mem["param_bytes"], mem["cache_bytes"]) == (real["param_bytes"], real["cache_bytes"]),
                  f"(d) {arch} rank {r}: predicted parameter and cache bytes {mem['param_bytes']}, {mem['cache_bytes']}"
                  f" vs the real shards' {real['param_bytes']}, {real['cache_bytes']}")
            want = {k: v for k, v in real["collectives"][0].items() if v}
            check(rec["roofline"]["collective_counts"] == want,
                  f"(d) {arch} rank {r}: predicted collectives {rec['roofline']['collective_counts']} vs counted {want}")
            rows.append({"param_bytes": mem["param_bytes"], "cache_bytes": mem["cache_bytes"],
                         "predicted_peak": mem["peak_bytes"], "max_memory_allocated": real["max_memory_allocated"],
                         "peak_ratio": real["max_memory_allocated"] / mem["peak_bytes"],
                         "collective_counts": rec["roofline"]["collective_counts"], "s": d["s"]})
        log(f"[mmesh] (d) {arch} dry run on (c)'s (2, 2) mesh and shape (fake tensors, float32): parameter and cache "
            f"bytes a rank {rows[0]['param_bytes']} / {rows[0]['cache_bytes']} = the real shards'; collectives "
            f"{rows[0]['collective_counts']} = a real step's; predicted peak "
            f"{[round(x['predicted_peak'] / 2**30, 3) for x in rows]} GiB vs max_memory_allocated "
            f"{[round(x['max_memory_allocated'] / 2**30, 3) for x in rows]} GiB (ratio "
            f"{[round(x['peak_ratio'], 3) for x in rows]}; no limit) — {smi}")
        res[arch] = rows
    check(host_recs["exitcode"] == 0, f"(d) the host's dry run ended with {host_recs['exitcode']}")
    host = {}
    for key, rec in host_recs["recs"].items():
        check(rec["status"] == "ok", f"(d) the host's dry run of {key}: {rec['status']}")
        row = rec["roofline"]
        log(f"[mmesh] (d) dry run {key} on the fake (16, 16) mesh, full depth, fake {rec['device']} tensors: "
            f"PREDICTED against the H100 SXM's published peaks at 700 W (989 TFLOP/s bf16, 3.35 TB/s, 50 GB/s a GPU "
            f"between nodes): compute {row['compute_s'] * 1e3:.3f} ms, memory {row['memory_s'] * 1e3:.3f} ms, "
            f"collective {row['collective_s'] * 1e3:.3f} ms, dominant {row['dominant']}, useful {row['useful_ratio']:.3f}"
            f", peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB a rank ({rec['wall_s']:.1f} s) — run on {smi}")
        host[key] = {"roofline": row, "memory": rec["memory"], "depth_check": rec["depth_check"],
                     "wall_s": rec["wall_s"]}
    return {"ranks": res, "host": host, "note": "predictions against published peaks, not measurements"}


def _report_hybrid(ranks: list, oracle: dict, setup: dict, where: str, smi: str) -> dict:
    """(a)'s checks and numbers from the ranks' results and the oracle's."""
    steps, batch, seq, tau = (setup[k] for k in ("steps", "batch", "seq", "tau"))
    oracle_losses, n_qwen, oracle_a_s = oracle["losses_a"], oracle["n_qwen"], oracle["s_a"]
    published = _mm_configs(setup)[2]
    hyb = [r["hybrid"] for r in ranks]
    losses = hyb[0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, oracle_losses))
    gaps = {leaf: max(h["leaves"][leaf][0] for h in hyb) for leaf in hyb[0]["leaves"]}
    worst = max(gaps, key=gaps.get)
    param_gap, reach = gaps[worst], 2 * MM_LR * steps
    param_mean = (sum(v[1] for h in hyb for v in h["leaves"].values())
                  / sum(v[2] for h in hyb for v in h["leaves"].values()))
    syncs = hyb[0]["syncs"]
    log(f"[mmesh] (a) qwen2.5-3b (published width, {MM_LAYERS} of {published['qwen2.5-3b']} layers, "
        f"{n_qwen / 1e6:.1f} M parameters) through train(mesh=...) on (2, 1, 2) (pod, data, model), {where}: "
        f"{steps} adamw steps of {batch} × {seq} fp32 tokens, τ = {tau}: losses {losses} vs the FedAvg "
        f"oracle's {oracle_losses} (worst relative {loss_rel:.3g}, limit {MM_LOSS_RTOL:g}); final parameters mean |Δ| "
        f"{param_mean:.3g} (limit {MM_PARAM_MEAN_ATOL:g}), max |Δ| {param_gap:.3g} at {worst} (limit 2·lr·steps = "
        f"{reach:.3g}); per sync: drift before "
        f"{[s['drift_before'] for s in syncs]}, spread after {[s['spread_after'] for s in syncs]}, "
        f"{[round(s['sync_ms'], 1) for s in syncs]} ms; {hyb[0]['tokens_per_s']:.0f} tokens/s "
        f"({hyb[0]['tokens_per_s_without_checks']:.0f} without the drift checks); max_memory_allocated per rank "
        f"{[round(h['max_memory_allocated'] / 2**30, 2) for h in hyb]} GiB — {smi}")
    check(all(h["losses"] == losses for h in hyb), "(a): the ranks report different losses")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"(a): the losses are {losses}")
    check(loss_rel <= MM_LOSS_RTOL, f"(a): the losses are {loss_rel} from the oracle's")
    check(param_mean <= MM_PARAM_MEAN_ATOL, f"(a): the final parameters are {param_mean} from the oracle's on average")
    check(param_gap <= reach, f"(a): the final {worst} is {param_gap} from the oracle's")
    for h in hyb:
        check(len(h["syncs"]) == steps // tau, f"(a): {len(h['syncs'])} syncs, expected {steps // tau}")
        check(all(s["drift_before"] > 0 for s in h["syncs"]), f"(a): the pods did not drift before a sync: {h['syncs']}")
        check(all(s["spread_after"] == 0 for s in h["syncs"]), f"(a): the pods differ after a sync: {h['syncs']}")
    turns = hyb[0]["tau_turns"]
    tau_rates = {key: [t[key] for t in turns] for key in (turns[0] if turns else ())}
    if turns:
        med = {key: statistics.median(v) for key, v in tau_rates.items()}
        log(f"[mmesh] (a) tokens/s of train(mesh=...) in {len(turns)} turns of {setup['tau_steps']} steps from the same "
            f"weights, {where}: τ = 1 {tau_rates['tau1']}, τ = {tau} {tau_rates[f'tau{tau}']} (medians "
            f"{med['tau1']:.0f} / {med[f'tau{tau}']:.0f}, ratio τ = 1 / τ = {tau} {med['tau1'] / med[f'tau{tau}']:.4f}) "
            f"— {smi}")
        check(all(v > 0 for v in med.values()), f"(a): tokens/s in turns {tau_rates}")
    return {"arch": "qwen2.5-3b", "mesh": [2, 1, 2], "axes": ["pod", "data", "model"],
            "entry": "repro_torch.train.loop.train(mesh=...)", "layers": MM_LAYERS,
            "published_layers": published["qwen2.5-3b"],
            "reduced": [f"n_layers {published['qwen2.5-3b']} -> {MM_LAYERS}"], "params": n_qwen,
            "batch": batch, "seq_len": seq, "steps": steps, "tau": tau, "optimizer": f"adamw({MM_LR:g})",
            "losses": losses, "oracle_losses": oracle_losses, "loss_rel": loss_rel, "param_gap": param_gap,
            "param_gap_leaf": worst, "param_mean_gap": param_mean, "leaf_gaps": gaps, "syncs_rank0": syncs,
            "sync_ms": statistics.median(s["sync_ms"] for h in hyb for s in h["syncs"]),
            "tokens_per_s": hyb[0]["tokens_per_s"],
            "tokens_per_s_without_checks": hyb[0]["tokens_per_s_without_checks"],
            "tokens_per_s_tau_turns": tau_rates, "tau_turn_steps": setup["tau_steps"],
            "max_memory_allocated": [h["max_memory_allocated"] for h in hyb], "oracle_s": oracle_a_s}


def _report_moe(ranks: list, oracle: dict, setup: dict, where: str, smi: str) -> dict:
    """(b)'s checks and numbers from the ranks' results and the oracle's."""
    seq, moe_batch = setup["seq"], setup["moe_batch"]
    oracle_b_loss, n_deepseek, oracle_b_s = oracle["loss_b"], oracle["n_deepseek"], oracle["s_b"]
    published = _mm_configs(setup)[2]
    moe = [r["moe"] for r in ranks]
    loss_b = moe[0]["loss"]
    loss_b_rel = abs(loss_b - oracle_b_loss) / abs(oracle_b_loss)
    grad_rel = {leaf: max(m["leaves"][leaf][0] for m in moe) / max(max(m["leaves"][leaf][1] for m in moe), 1e-30)
                for leaf in moe[0]["leaves"]}
    worst = max(grad_rel, key=grad_rel.get)

    def share(key):
        routed = sum(m["copies"][key]["routed"] for m in moe)
        return sum(m["copies"][key]["dropped"] for m in moe) / max(routed, 1)

    shares = {key: share(key) for key in ("cf8", "cf2", "cf1")}
    log(f"[mmesh] (b) deepseek-v2-lite-16b (published width, 64 experts top-6, {MM_LAYERS} of "
        f"{published['deepseek-v2-lite-16b']} layers, {n_deepseek / 1e9:.3f} B parameters) on (2, 2) (data, model), "
        f"{where}: one launch/steps.make_train_step step of {moe_batch} × {seq} at cf = 8: loss {loss_b:.7f} vs "
        f"the single-device step's {oracle_b_loss:.7f} (relative {loss_b_rel:.3g}, limit {ZOO_CPU_RTOL:g}); gradients, "
        f"worst leaf {worst} {grad_rel[worst]:.3g} (limit {ZOO_GRAD_RTOL:g}) over {len(grad_rel)} leaves; dropped "
        f"copies {shares}; the step {moe[0]['step_s']:.2f} s ({moe[0]['tokens_per_s']:.0f} tokens/s); all_to_all of "
        f"{moe[0]['all_to_all_bytes'] / 2**20:.1f} MiB over 'model' {[round(m['all_to_all_ms'], 2) for m in moe]} ms; "
        f"max_memory_allocated per rank {[round(m['max_memory_allocated'] / 2**30, 2) for m in moe]} GiB — {smi}")
    check(math.isfinite(loss_b) and loss_b_rel <= ZOO_CPU_RTOL, f"(b): the loss is {loss_b_rel} from the oracle's")
    check(grad_rel[worst] <= ZOO_GRAD_RTOL, f"(b): the gradient of {worst} is {grad_rel[worst]} from the oracle's")
    check(shares["cf8"] == 0.0, f"(b): copies dropped at cf = 8: {shares}")
    check(all(m["copies"]["cf8"]["routed"] > 0 for m in moe), "(b): a rank routed no copy through moe_ep")
    return {"arch": "deepseek-v2-lite-16b", "mesh": [2, 2], "axes": ["data", "model"],
            "entry": "repro_torch.launch.steps.make_train_step(cfg, mesh, ...)", "layers": MM_LAYERS,
            "published_layers": published["deepseek-v2-lite-16b"],
            "reduced": [f"n_layers {published['deepseek-v2-lite-16b']} -> {MM_LAYERS}"], "params": n_deepseek,
            "batch": moe_batch, "seq_len": seq, "cf": 8.0, "loss": loss_b, "oracle_loss": oracle_b_loss,
            "loss_rel": loss_b_rel, "grad_rel_worst": grad_rel[worst], "grad_rel_worst_leaf": worst,
            "dropped_share": shares, "step_s": moe[0]["step_s"], "tokens_per_s": moe[0]["tokens_per_s"],
            "all_to_all_ms": [m["all_to_all_ms"] for m in moe], "all_to_all_bytes": moe[0]["all_to_all_bytes"],
            "max_memory_allocated": [m["max_memory_allocated"] for m in moe], "oracle_s": oracle_b_s}


def model_mesh_phase(smi: str, ranks_backend: str = "gloo", setup: dict | None = None) -> dict:
    """The model mesh at published width, depth cut to ``MM_LAYERS``: a
    world-size-1 model mesh in this process (``_mm_nccl1``), the card-side
    oracles, also in this process (their results kept on the host, their
    memory freed), then ``MM_RANKS`` spawned processes in a
    ``ranks_backend`` group — gloo with CUDA tensors: four ranks on the one
    card; NCCL (``--mesh-nccl``): a card each — run (a) the hybrid-2D
    trainer, (b) the expert-parallel MoE, (c) decode on a (2, 2) mesh and
    (d) the dry run at (c)'s shape against what (c) held and counted
    (``_mm_hybrid``, ``_mm_moe``, ``_mm_decode``, ``_mm_dryrun``; the parts
    ``setup`` names), while (d)'s full-width dry run (``dryrun_host``) runs
    beside them in a process of its own; over NCCL (a card a rank) (a) also
    times τ = 1 against τ = ``MM_TAU``. ``setup``: ``_mm_setup()`` (the
    card, published widths, every part) unless a caller passes its own.
    Each part reports (and fails) on its own; the phase fails if any did.
    Returns the numbers for the phase's JSON line."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch import resolve_device
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import plain_all_gather_needed
    from repro_torch.launch.steps import make_train_step as steps_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.sgd import adamw
    from repro_torch.train.data import MarkovTextStream
    from repro_torch.train.loop import make_train_step

    started = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for fp32 matmuls")
    # (a)'s τ turns time communication: only where each rank has a card of its own
    setup = {**(setup or _mm_setup()), "tau_turns": 0 if ranks_backend == "gloo" else MM_TAU_TURNS}
    parts = setup["parts"]
    device = resolve_device(setup["device"])
    qwen, deepseek, _ = _mm_configs(setup)
    steps, batch, seq, tau, moe_batch = (setup[k] for k in ("steps", "batch", "seq", "tau", "moe_batch"))
    where = ("gloo, CUDA tensors, 4 processes on one card" if ranks_backend == "gloo"
             else f"{ranks_backend}, a card a rank")
    out = {"card": smi, "ranks": where, "dtype": "float32", "tf32": False, "note": _mm_note(ranks_backend)}
    out["nccl1"] = _mm_nccl1(setup, smi)
    oracle = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if "hybrid" in parts:
            # (a)'s oracle: two pods, each its own parameters and adamw state, on
            # its half of each global batch; the parameter mean every MM_TAU steps
            t0 = time.perf_counter()
            host = _host_params(qwen)
            n_qwen = sum(t.numel() for t in tree_leaves(host))
            opt = adamw(MM_LR)
            step = make_train_step(qwen, opt)
            states = []
            for _ in range(2):
                card = tree_map(lambda t: t.to(device), host)
                states.append((card, opt.init(card)))
            del host, card
            it = MarkovTextStream(qwen.vocab_size, seed=0).batches(batch, seq)
            half = batch // 2
            oracle_losses = []
            for k in range(steps):
                toks, targs = next(it)
                pod_losses = []
                for p in range(2):
                    pod_batch = (torch.from_numpy(toks[p * half:(p + 1) * half]).to(device),
                                 torch.from_numpy(targs[p * half:(p + 1) * half]).to(device))
                    states[p], loss = step(states[p], pod_batch)
                    pod_losses.append(loss)
                oracle_losses.append(float(torch.mean(torch.stack(pod_losses))))
                if (k + 1) % tau == 0:
                    mean = tree_map(lambda a, b: (a + b) / 2, states[0][0], states[1][0])
                    states = [(mean, s) for _, s in states]
            _save_leaves(tmp / "oracle_a", states[0][0])
            del states, mean, step
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            oracle.update(losses_a=oracle_losses, n_qwen=n_qwen, s_a=time.perf_counter() - t0)
            log(f"[mmesh] oracle (a) on the card: qwen2.5-3b, 2 pods × {steps} steps, losses {oracle_losses} "
                f"({oracle['s_a']:.1f} s)")
        if "moe" in parts:
            # (b)'s oracle: the single-device step's loss and gradients
            t0 = time.perf_counter()
            host = _host_params(deepseek)
            n_deepseek = sum(t.numel() for t in tree_leaves(host))
            card = tree_map(lambda t: t.to(device), host)
            del host
            toks, targs = next(MarkovTextStream(deepseek.vocab_size, seed=0).batches(moe_batch, seq))
            grads, _, loss = steps_train_step(deepseek, None, opt=_grad_optimizer())(
                card, (), torch.from_numpy(toks).to(device), torch.from_numpy(targs).to(device))
            oracle.update(loss_b=float(loss), n_deepseek=n_deepseek)
            _save_leaves(tmp / "oracle_b", grads)
            del card, grads, loss
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            oracle["s_b"] = time.perf_counter() - t0
            log(f"[mmesh] oracle (b) on the card: deepseek-v2-lite-16b one step of {moe_batch} × {seq}, loss "
                f"{oracle['loss_b']:.7f} ({oracle['s_b']:.1f} s)")
        if "decode" in parts:
            t0 = time.perf_counter()
            single_rates = _decode_oracle(tmp / "oracle_c", setup, device)
            oracle_c_s = time.perf_counter() - t0
            log(f"[mmesh] oracle (c) on the card: {', '.join(MM_DEC_ARCHS)}, {setup['dec_steps']} decode steps of "
                f"batch {setup['dec_batch']} against a {setup['dec_depth']}-deep cache ({oracle_c_s:.1f} s); one card "
                f"{ {a: round(r) for a, r in single_rates.items()} } tokens/s")
        # (d)'s full-width dry run on the host, beside the ranks
        host_dry = None
        if "dryrun" in parts:
            host_dry = mp.get_context("spawn").Process(target=dryrun_host,
                                                       args=(str(tmp / "host_dry.json"), device.type))
            host_dry.start()
        t0 = time.perf_counter()
        try:
            mp.start_processes(model_mesh_rank, args=(MM_RANKS, str(tmp / "store"), str(tmp), ranks_backend, setup),
                               nprocs=MM_RANKS, start_method="spawn", join=True)
        except BaseException:
            if host_dry is not None:
                host_dry.kill()
            for r in range(MM_RANKS):  # what the ranks that got to the end wrote of their parts' faults
                if (tmp / f"mm_rank{r}.json").exists():
                    for part, tb in json.loads((tmp / f"mm_rank{r}.json").read_text())["errors"].items():
                        log(f"[mmesh] rank {r}, part {part}:\n{tb}")
            raise
        spawned_s = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"mm_rank{r}.json").read_text()) for r in range(MM_RANKS)]
        host_recs = None
        if host_dry is not None:  # read after the ranks' numbers are reported
            host_dry.join(timeout=900)
            host_recs = {"exitcode": host_dry.exitcode, "recs": json.loads((tmp / "host_dry.json").read_text())
                         if host_dry.exitcode == 0 else {}}

    # each part's report; a part that raised on a rank, or failed a check,
    # does not keep the others from reporting: the phase fails at the end
    failed = []
    probes = [r["all_gather_probe"] for r in ranks]
    plain = [r["plain_all_gather"] for r in ranks]
    log(f"[mmesh] all-gather probe ({where}): DTensor's functional all-gather against c10d's, every case bitwise "
        f"equal on every rank: {all(all(p.values()) for p in probes)}; plain all-gather registered {plain}")
    if not (all(all(p.values()) for p in probes) and plain == [plain_all_gather_needed(ranks_backend)] * MM_RANKS):
        failed.append(f"the all-gather probe: {probes}, plain all-gather registered {plain}")
    out["all_gather_probe"] = {"cases": probes[0], "plain_all_gather": plain}
    reports = {"hybrid": lambda: _report_hybrid(ranks, oracle, setup, where, smi),
               "moe": lambda: _report_moe(ranks, oracle, setup, where, smi),
               "decode": lambda: _report_decode(ranks, single_rates, setup, where, smi, ranks_backend),
               "dryrun": lambda: _report_dryrun(ranks, host_recs, setup, smi)}
    for part in parts:
        errors = {r: rank["errors"][part] for r, rank in enumerate(ranks) if part in rank["errors"]}
        if errors:
            r, tb = next(iter(errors.items()))
            log(f"[mmesh] part {part} raised on ranks {sorted(errors)}; rank {r}:\n{tb}")
            failed.append(f"part {part} raised on ranks {sorted(errors)}")
            continue
        with deferred_checks() as part_failed:
            out[part] = reports[part]()
        failed += part_failed
    out["devices"] = sorted({r["device"] for r in ranks})
    out["spawned_s"] = spawned_s
    out["phase_s"] = time.perf_counter() - started
    log(f"[mmesh] the phase took {out['phase_s']:.1f} s (spawned ranks {spawned_s:.1f} s)")
    check(not failed, f"the model_mesh phase ({where}): " + " | ".join(failed))
    return out


def mesh_spec(p_r: int, p_c: int, backend: str, delay: int = 0, precision: str = "fp32"):
    """The mesh phase's spec: full-size rcv1, the main path's s, b, τ, η and
    rounds on a p_r × p_c mesh, a loss sample every 4 rounds."""
    from repro_torch.api import ExperimentSpec, MeshSpec
    from repro_torch.core.engine import ParallelSGDSchedule

    return ExperimentSpec(
        dataset=DATASET, seed=0, row_multiple=S * B, name=f"{DATASET}-mesh-{p_r}x{p_c}",
        schedule=ParallelSGDSchedule.hybrid(p_r=p_r, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, loss_every=4,
                                            p_c=p_c, delay=delay, precision=precision),
        mesh=MeshSpec(p_r=p_r, p_c=p_c, backend=backend),
    )


def launch_counts() -> dict:
    from repro_torch.kernels import sstep_inner
    from repro_torch.kernels.ell_gram import ell_gram_and_v

    return {f"{name}.{mode}": fn.launches[mode]
            for name, fn in (("ell_gram", ell_gram_and_v), ("sstep_inner", sstep_inner))
            for mode in ("fp32", "bf16")}


def zero_launch_counts() -> None:
    from repro_torch.kernels import sstep_inner
    from repro_torch.kernels.ell_gram import ell_gram_and_v

    ell_gram_and_v.launches.update(fp32=0, bf16=0)
    for counts in ell_gram_and_v.route_launches.values():
        counts.update(fp32=0, bf16=0)
    sstep_inner.launches.update(fp32=0, bf16=0)


def stepped_run(sess) -> list:
    """Drive a session to its end one round a step; the wall of each step
    (a round, the gather of x for its ``RoundEvent``, a loss sample every
    4 rounds), in seconds."""
    walls = []
    while not sess.done:
        t0 = time.perf_counter()
        sess.step_rounds(1)
        walls.append(time.perf_counter() - t0)
    return walls


def mesh_rank(rank: int, world: int, store: str, out: str, device, backend: str) -> None:
    """One rank of the 2 × 2 mesh (a spawned process): joins a ``backend``
    group through a file store, runs each of ``MESH_RUNS`` through
    ``Session`` on ``device`` (None: ``cuda:(rank % device_count)`` — the
    one card the four ranks share, or a card each; the kernels are already
    built), and writes its launch counts, ledger, step walls and final x
    under ``out``; then a timed run at D = 1 (``comm_timing``: per-round
    walls and the §6.5 phase probes on the real groups)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.api import Session

    # the ranks share the host's cores: one share each, not each all of them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    try:
        result = {}
        for label, (delay, precision) in MESH_RUNS.items():
            sess = Session(mesh_spec(MESH_P, MESH_P, "shard_map", delay, precision), device=device)
            zero_launch_counts()
            walls = stepped_run(sess)
            result[label] = {"launches": launch_counts(), "ledger": sess.ledger.to_dict(), "walls": walls,
                             "losses": [float(v) for v in sess.losses], "device": str(sess.device)}
            np.save(pathlib.Path(out) / f"{label}.rank{rank}.npy", sess.current_x())
        timed = Session(dataclasses.replace(mesh_spec(MESH_P, MESH_P, "shard_map", delay=1), comm_timing=True),
                        device=device).run()
        result["timed_d1"] = {"ledger": timed.ledger.to_dict()}
        (pathlib.Path(out) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def mesh_phase(smi: str, device=None, backend: str = "nccl", ranks_backend: str = "gloo") -> dict:
    """The 2D-mesh backend at full width, through the front door:
    (a) a world-size-1 ``backend`` group driven by ``run(spec)`` with
    ``backend="shard_map"`` on a 1 × 1 mesh, fp32 at D = 0 and bf16 at D = 1,
    and a replay stream through ``Session.step_stream`` (held against the
    simulated stream at p_r = 1); (b) four spawned processes in
    a ``ranks_backend`` group — gloo with CUDA tensors: a 2 × 2 mesh on the
    one card; NCCL (``--mesh-nccl``): a card each — fp32 at D = 0 and bf16
    at D = 1, then a timed run at D = 1. Each is held against the simulated engine on
    the card with the same schedule; each rank must launch each kernel of
    its path ROUNDS·τ/s times and hold the simulated run's ledger, whose
    bytes a round are the closed form. ``device`` is what the entry points
    get (None: the card). Returns the numbers for the phase's JSON line."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.api import MeshSpec, Session, StreamSpec, run
    from repro_torch.core.comm import CommLedger
    from repro_torch.serve import make_stream_source

    started = time.perf_counter()
    expected = ROUNDS * (TAU // S)  # launches a rank: one bundle of each kind a step
    fp32 = {"ell_gram.fp32": expected, "ell_gram.bf16": 0, "sstep_inner.fp32": expected, "sstep_inner.bf16": 0}
    bf16 = {"ell_gram.fp32": 0, "ell_gram.bf16": expected, "sstep_inner.fp32": expected, "sstep_inner.bf16": 0}
    out = {}

    def stream_to_end(sess):
        src = make_stream_source(sess.spec)
        while not sess.done:
            sess.step_stream(src)
        return sess

    def simulated(spec):
        sim = dataclasses.replace(spec, mesh=MeshSpec(p_r=spec.mesh.p_r, p_c=spec.mesh.p_c))
        sess = Session(sim, device=device)
        walls = stepped_run(sess)
        return sess, walls

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the 1 × 1 mesh, in this process
        spec1 = mesh_spec(1, 1, "shard_map")
        spec1_bf16 = mesh_spec(1, 1, "shard_map", 1, "bf16")
        spec1_stream = dataclasses.replace(spec1, stream=StreamSpec(source="replay"))
        dist.init_process_group(backend, init_method=f"file://{tmp}/store1", rank=0, world_size=1)
        try:
            zero_launch_counts()
            rep1 = run(spec1, device=device)
            got1 = launch_counts()
            zero_launch_counts()
            rep1_bf16 = run(spec1_bf16, device=device)
            got1_bf16 = launch_counts()
            zero_launch_counts()
            mesh_stream = stream_to_end(Session(spec1_stream, device=device))
            got1_stream = launch_counts()
        finally:
            dist.destroy_process_group()
        sim1, _ = simulated(spec1)
        x_sim1 = sim1.current_x()
        x_max1 = float(np.abs(x_sim1).max())
        gap1 = float(np.abs(rep1.x - x_sim1).max())
        led1 = rep1.ledger
        log(f"[mesh] 1 × 1 ({backend}, world size 1) through run(spec): launches {got1}; max |Δx| to the simulated "
            f"engine {gap1:.3g} (limit {X_TOL:g}·max |x| = {X_TOL * x_max1:.3g}); losses {rep1.losses.tolist()}; "
            f"counted bytes {led1.counted_bytes()}")
        check(got1 == fp32, f"1 × 1 mesh: launches {got1}, expected {fp32}")
        check(x_max1 > 0 and gap1 <= X_TOL * x_max1, f"1 × 1 mesh: {gap1} from the simulated engine")
        check(led1.rates == sim1.ledger.rates and led1.counted_bytes()["total_bytes"] == 0.0,
              f"1 × 1 mesh ledger {led1.rates} vs simulated {sim1.ledger.rates}")
        out["1x1"] = {"backend": backend, "launches": got1, "gap": gap1, "x_max": x_max1,
                      "losses": rep1.losses.tolist(), "wall_time_s": rep1.wall_time_s}
        # bf16 at D = 1 on the 1 × 1 mesh: one (G, v) rounding, as in the
        # simulated engine, so it is held at X_TOL, and the fp32 run must
        # land outside that limit (the rounding is live)
        x_sim1b = simulated(spec1_bf16)[0].current_x()
        x_fp32_1b = simulated(mesh_spec(1, 1, "shard_map", 1, "fp32"))[0].current_x()
        limit1b = X_TOL * float(np.abs(x_sim1b).max())
        gap1b = float(np.abs(rep1_bf16.x - x_sim1b).max())
        fp32_gap1b = float(np.abs(rep1_bf16.x - x_fp32_1b).max())
        log(f"[mesh] 1 × 1 bf16 D = 1 through run(spec): launches {got1_bf16}; max |Δx| to the simulated engine "
            f"{gap1b:.3g} (limit {limit1b:.3g}), to the simulated fp32 run {fp32_gap1b:.3g} (must exceed the limit)")
        check(got1_bf16 == bf16, f"1 × 1 bf16 mesh: launches {got1_bf16}, expected {bf16}")
        check(gap1b <= limit1b, f"1 × 1 bf16 mesh: {gap1b} from the simulated engine, limit {limit1b}")
        check(fp32_gap1b > limit1b, f"1 × 1 bf16 mesh: the fp32 run is only {fp32_gap1b} away, limit {limit1b}")
        out["1x1_bf16_d1"] = {"launches": got1_bf16, "gap": gap1b, "limit": limit1b, "fp32_gap": fp32_gap1b}
        # a replay stream through the 1 × 1 mesh's step_stream (column-local
        # shards of each batch) against the simulated stream at p_r = 1
        sim_stream = stream_to_end(Session(dataclasses.replace(spec1_stream, mesh=MeshSpec(p_r=1, p_c=1)),
                                           device=device))
        x_ms = sim_stream.current_x()
        limit1s = X_TOL * float(np.abs(x_ms).max())
        gap1s = float(np.abs(mesh_stream.current_x() - x_ms).max())
        log(f"[mesh] 1 × 1 replay stream through Session.step_stream: launches {got1_stream}; max |Δx| to the simulated "
            f"stream {gap1s:.3g} (limit {limit1s:.3g}); losses {mesh_stream.losses} (simulated {sim_stream.losses})")
        check(got1_stream == fp32, f"1 × 1 mesh stream: launches {got1_stream}, expected {fp32}")
        check(limit1s > 0 and gap1s <= limit1s, f"1 × 1 mesh stream: {gap1s} from the simulated stream, limit {limit1s}")
        out["1x1_stream"] = {"launches": got1_stream, "gap": gap1s, "limit": limit1s,
                             "losses": mesh_stream.losses, "sim_losses": sim_stream.losses}

        # (b) the 2 × 2 mesh: four processes on the one card
        t0 = time.perf_counter()
        mp.start_processes(mesh_rank, args=(MESH_P * MESH_P, f"{tmp}/store4", tmp, device, ranks_backend),
                           nprocs=MESH_P * MESH_P, start_method="spawn", join=True)
        out["spawned_s"] = time.perf_counter() - t0
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text()) for r in range(MESH_P * MESH_P)]
        where = ("gloo, CUDA tensors, 4 processes on one card" if ranks_backend == "gloo"
                 else f"{ranks_backend}, a card a rank: {sorted({res['fp32_d0']['device'] for res in ranks})}")
        n = int(np.load(pathlib.Path(tmp) / f"fp32_d0.rank0.npy").shape[0])
        for label, (delay, precision) in MESH_RUNS.items():
            spec = mesh_spec(MESH_P, MESH_P, "shard_map", delay, precision)
            sim, sim_walls = simulated(spec)
            x_sim = sim.current_x()
            xs = [np.load(pathlib.Path(tmp) / f"{label}.rank{r}.npy") for r in range(MESH_P * MESH_P)]
            check(all(np.array_equal(x, xs[0]) for x in xs), f"2 × 2 {label}: the ranks gathered different x")
            x_max = float(np.abs(x_sim).max())
            gap = float(np.abs(xs[0] - x_sim).max())
            limit = X_TOL * x_max if precision == "fp32" else MESH_BF16_DX
            want_launches = fp32 if precision == "fp32" else bf16
            word = 4 if precision == "fp32" else 2
            want_bytes = {"gram_bytes": float((S * B * S * B + S * B) * (TAU // S) * word),
                          "sync_bytes": float(4 * -(-n // MESH_P))}
            for r, res in enumerate(ranks):
                got = res[label]["launches"]
                led = CommLedger.from_dict(res[label]["ledger"])
                check(got == want_launches, f"2 × 2 {label}, rank {r}: launches {got}, expected {want_launches}")
                check(led.rates == sim.ledger.rates and led.rounds == ROUNDS,
                      f"2 × 2 {label}, rank {r}: ledger {led.rates} vs simulated {sim.ledger.rates}")
                per_round = led.counted_bytes(1)
                check(per_round["gram_bytes"] == want_bytes["gram_bytes"]
                      and per_round["sync_bytes"] == want_bytes["sync_bytes"],
                      f"2 × 2 {label}, rank {r}: bytes a round {per_round}, closed form {want_bytes}")
                check(res[label]["losses"] == ranks[0][label]["losses"], f"2 × 2 {label}: rank {r}'s losses differ")
            mesh_ms = statistics.median(max(res[label]["walls"][k] for res in ranks) for k in range(1, ROUNDS)) * 1e3
            sim_ms = statistics.median(sim_walls[1:]) * 1e3
            log(f"[mesh] 2 × 2 {label} ({where}): launches a rank "
                f"{ranks[0][label]['launches']}; max |Δx| to the simulated engine at p_r = {MESH_P} {gap:.3g} "
                f"(limit {limit:.3g}); bytes a round {want_bytes}; losses {ranks[0][label]['losses']} "
                f"(simulated {sim.losses}); step wall {mesh_ms:.2f} ms (median, slowest rank) vs the simulated "
                f"engine's {sim_ms:.2f} ms — a correctness run, not a comm measurement; {smi}")
            check(x_max > 0 and gap <= limit, f"2 × 2 {label}: max |Δx| {gap} to the simulated engine, limit {limit}")
            controls = {}
            if precision == "bf16":
                # the delay is live: the D = 0 run lands outside the limit;
                # the fp32 run's gap is recorded (inside it: see MESH_BF16_DX)
                for what, (d, prec) in (("d0_gap", (0, "bf16")), ("fp32_gap", (delay, "fp32"))):
                    x_ctl = simulated(mesh_spec(MESH_P, MESH_P, "shard_map", d, prec))[0].current_x()
                    controls[what] = float(np.abs(xs[0] - x_ctl).max())
                log(f"[mesh] 2 × 2 {label}: max |Δx| to the simulated D = 0 run {controls['d0_gap']:.3g} (must exceed "
                    f"{limit:.3g}), to the simulated fp32 run {controls['fp32_gap']:.3g}")
                check(controls["d0_gap"] > limit, f"2 × 2 {label}: the D = 0 run is only {controls['d0_gap']} away")
            out[label] = {**controls, "launches_per_rank": ranks[0][label]["launches"], "gap": gap, "limit": limit,
                          "x_max": x_max, "bytes_per_round": want_bytes, "losses": ranks[0][label]["losses"],
                          "sim_losses": sim.losses, "step_ms": mesh_ms, "sim_step_ms": sim_ms,
                          "walls_rank0": ranks[0][label]["walls"], "sim_walls": sim_walls,
                          "devices": sorted({res[label]["device"] for res in ranks})}
        # the timed D = 1 run: per-round walls and phase probes on the real groups
        timed = [CommLedger.from_dict(res["timed_d1"]["ledger"]) for res in ranks]
        for r, led in enumerate(timed):
            check(len(led.round_seconds) == ROUNDS and set(led.phase_seconds) == {"bundle_compute", "allreduce_gv",
                                                                                   "param_avg"},
                  f"2 × 2 timed D = 1, rank {r}: {len(led.round_seconds)} round walls, phases {led.phase_seconds}")
        out["timed_d1"] = [{"round_s": led.seconds_per_round, "phase_s": led.phase_seconds,
                            "exposed_comm_s": led.exposed_comm_s, "total_comm_s": led.total_comm_s,
                            "overlap_efficiency": led.overlap_efficiency} for led in timed]
        log(f"[mesh] 2 × 2 timed D = 1 ({where}), rank 0: {timed[0].seconds_per_round * 1e3:.3f} ms a round (median), "
            f"phase seconds a round {timed[0].phase_seconds}, exposed comm {timed[0].exposed_comm_s:.4g} s of "
            f"{timed[0].total_comm_s:.4g} s over {ROUNDS} rounds (overlap efficiency "
            f"{timed[0].overlap_efficiency:.3g}); {smi}")
    out["phase_s"] = time.perf_counter() - started
    log(f"[mesh] the phase took {out['phase_s']:.1f} s (spawned ranks {out['spawned_s']:.1f} s)")
    return out


# the paper phase: the paper's other datasets at full size (Table 6's news20,
# epsilon and url) through the engine at the cells' point (P_R, S, B, TAU,
# ETA), PAPER_ROUNDS rounds a run; the corners PAPER_CORNER_ROUNDS rounds each
PAPER_DATASETS = ("news20", "epsilon", "url")
PAPER_ROUNDS, PAPER_CORNER_ROUNDS = 8, 4
# the s-step corner's depth: s·b = 512 rows a bundle
PAPER_SSTEP_S = 16
# the plain runs' panel width: url's 3.2 M columns in 50 panels a bundle (at
# 512, 6,313 panels made the plain round take seconds); the walk's result
# does not depend on it beyond the order of its float32 sums
PAPER_PLAIN_BK = 1 << 16
# url's rows in the default run (full url, 2,396,130 rows, under --paper):
# make_skewed_csr with url's columns, mean width and skew, the rows cut to
# 2^19 — generating full url took 83 s of the run's limit on the host of an
# NVIDIA H100 80GB HBM3 (and the sweep CLI generates it again)
PAPER_URL_ROWS = 1 << 19
# the other objectives through the front door, each with its λ
PAPER_OBJECTIVES = (("logistic", 1e-4), ("squared_hinge", 1e-3), ("least_squares", 1e-4))
PAPER_FRONT_DOOR = ("news20", "url")
# the sweep CLI's spec, its points one round each; the first also opts into
# the Gram tuner (bk = null), so its Session tunes and caches a geometry
PAPER_SWEEP_SPEC = "examples/specs/url_sweep.json"
PAPER_SWEEP_TIMEOUT_S = 900


def _host_peak_gb() -> float:
    """The process's peak resident set so far (``ru_maxrss``), in GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def paper_url_name(rows: int | None) -> str:
    """The registered name of url with its rows cut to ``rows`` (None: url
    itself). The cut is registered in this process only, with url's
    columns, mean width and skew, so ``make_dataset`` and every spec take
    it by name."""
    from repro_torch.sparse import synthetic

    if rows is None:
        return "url"
    full = synthetic.DATASET_STATS["url"]
    name = f"url-rows{rows}"
    synthetic.SM_STATS[name] = dataclasses.replace(full, name=name, m=rows)
    return name


def start_sweep_cli(device=None) -> dict:
    """``python -m repro_torch.launch.sweep`` on url's spec in a process of
    its own, started now and collected by ``finish_sweep_cli``: the three
    points of ``PAPER_SWEEP_SPEC``, the first with ``bk`` null, into a
    temporary directory that also holds the tuner's cache."""
    import tempfile

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-sweep-"))
    points = json.loads((ROOT / PAPER_SWEEP_SPEC).read_text())
    points[0]["schedule"]["bk"] = None
    spec = tmp / "url_sweep.json"
    spec.write_text(json.dumps(points, indent=2))
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--spec", str(spec), "--out", str(tmp / "reports.json")]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_TUNE_CACHE=str(tmp / "tune"))
    log(f"[paper] sweep CLI started beside the run: {' '.join(cmd[1:])} ({PAPER_SWEEP_SPEC}'s points, the first "
        f"with bk = null)")
    with open(tmp / "cli.log", "w") as sink:  # a file, not a pipe: nothing reads it until the end
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=sink, stderr=subprocess.STDOUT)
    return {"proc": proc, "tmp": tmp, "points": points, "t0": time.time()}


def stop_sweep_cli(handle: dict | None) -> None:
    """Kill the sweep CLI's process if it still runs (a failed run)."""
    if handle is not None and handle["proc"].poll() is None:
        handle["proc"].kill()
        handle["proc"].wait()


def finish_sweep_cli(handle: dict) -> dict:
    """Wait for the sweep CLI and check what it wrote: a report with a finite
    loss for every point, and the tuner's record for url's profile at the
    first point's autotuned (s, b)."""
    import shutil

    from repro_torch.api import plan
    from repro_torch.api.spec import ExperimentSpec, dataset_stats
    from repro_torch.kernels import tune
    from repro_torch.kernels.ell_gram import supported_tile_ks

    try:
        handle["proc"].wait(timeout=PAPER_SWEEP_TIMEOUT_S)
    finally:
        stop_sweep_cli(handle)
    output = (handle["tmp"] / "cli.log").read_text()
    for line in output.splitlines():
        if line.startswith("["):
            log(f"[paper] sweep CLI: {line}")
    check(handle["proc"].returncode == 0, f"the sweep CLI exited {handle['proc'].returncode}:\n{output[-4000:]}")
    tmp = handle["tmp"]
    reports = json.loads((tmp / "reports.json").read_text())["reports"]
    wall_s = (tmp / "reports.json").stat().st_mtime - handle["t0"]  # its start to its last write
    check(len(reports) == len(handle["points"]), f"the sweep CLI wrote {len(reports)} reports for {len(handle['points'])} points")
    out = {"wall_s": wall_s, "reports": []}
    for point, rep in zip(handle["points"], reports):
        check(rep["spec"]["name"] == point["name"] and math.isfinite(rep["final_loss"]) and rep["final_loss"] < math.log(2.0),
              f"the sweep CLI's report of {point['name']}: final loss {rep['final_loss']}")
        out["reports"].append({k: rep[k] for k in ("final_loss", "rounds_completed", "wall_time_s", "compile_time_s")}
                              | {"name": point["name"], "s": rep["spec"]["schedule"]["s"], "b": rep["spec"]["schedule"]["b"],
                                 "p_r": rep["spec"]["mesh"]["p_r"], "bk": rep["spec"]["schedule"]["bk"]})
    # the first point: autotuned (s, b), and the tuner's record for url's rows
    first = plan(ExperimentSpec.from_dict(handle["points"][0])).spec
    profile = tune.PanelProfile.from_stats(dataset_stats(first.dataset), first.schedule, first.mesh.p_c)
    records = [json.loads(p.read_text()) for p in sorted((tmp / "tune").glob("*.json"))]
    check(len(records) == 1 and records[0]["profile"] == profile.to_dict()
          and [records[0].get("tile"), records[0].get("ks")] in [list(g) for g in supported_tile_ks()],
          f"the tuner cached {[r.get('profile') for r in records]}, not one geometry for {profile}")
    rec = records[0]
    out["tuned"] = {"profile": rec["profile"], "tile": rec.get("tile"), "ks": rec.get("ks"),
                    "ms": rec["measured_s"] * 1e3, "s_b": [first.schedule.s, first.schedule.b]}
    log(f"[paper] sweep CLI: {len(reports)} reports, final losses {[round(r['final_loss'], 6) for r in reports]} "
        f"(log 2 = {math.log(2.0):.6f}); the first point autotuned to s = {first.schedule.s}, b = {first.schedule.b} and "
        f"the tuner cached geometry ({rec.get('tile')}, {rec.get('ks')}) for {first.dataset}'s profile {rec['profile']} "
        f"({rec['measured_s'] * 1e3:.5f} ms on the device); {wall_s:.1f} s from its start")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


@contextlib.contextmanager
def gram_v_off_by_one_percent():
    """Inside: every bundle's (G, v) comes out 1 % too large (the simulated
    engine looks ``bundle_gram_v`` up when it runs; the round graphs key on
    it and capture anew) — a fault the end-to-end limits must catch. G
    alone is not enough on news20: its rows rarely share a column, G is
    nearly empty, and a G 1 % off moved x by 9.69e-7 against a limit of
    1.81e-6 (NVIDIA H100 80GB HBM3, 700.00 W)."""
    from repro_torch.core import engine

    true_gram = engine.bundle_gram_v

    def skewed(*args, **kwargs):
        g, v = true_gram(*args, **kwargs)
        return g * 1.01, v * 1.01

    engine.bundle_gram_v = skewed
    try:
        yield
    finally:
        engine.bundle_gram_v = true_gram


def _graphs_expected(cycle: int, rounds: int) -> dict:
    """Captures and replays of a fresh run of ``rounds`` rounds from round 0:
    each residue runs eagerly at its first sight and is captured (then
    replayed) at its second; none above the cycle cap."""
    from repro_torch.core import round_graph

    if cycle > round_graph.CYCLE_CAP:
        return {"captures": 0, "replays": 0}
    return {"captures": max(min(cycle, rounds - cycle), 0), "replays": max(rounds - cycle, 0)}


def _plain_gap(label: str, x, x_plain, controls: dict, limit_rel: float = X_TOL) -> dict:
    """x against the all-plain run's, within ``limit_rel``·max |x_plain|;
    each control (another run of the same inputs that must differ) outside
    it. Logs and checks; returns the readings."""
    x_max = float(x_plain.abs().max())
    gap = float((x - x_plain).abs().max())
    limit = limit_rel * x_max
    ctl = {name: float((xc - x_plain).abs().max()) for name, xc in controls.items()}
    log(f"[paper] {label}: kernels vs plain versions max |Δx| = {gap:.3g} with max |x| = {x_max:.4g} (limit "
        f"{limit:.3g}); controls " + ", ".join(f"{k} {v:.3g}" for k, v in ctl.items()))
    check(bool(torch.isfinite(x).all()) and x_max > 0 and gap <= limit, f"{label}: x is {gap} from the plain run's")
    for name, value in ctl.items():
        check(value > limit, f"{label}: the control ({name}) is within the limit: {value}")
    return {"gap": gap, "x_max": x_max, "limit": limit, "controls": ctl}


def _paper_route(name: str) -> str:
    """The Gram route a paper dataset's bundles must take: epsilon's rows
    cover their columns (the dense route), the others' are sparse."""
    return "dense" if name.startswith("epsilon") else "hash"


def _check_routes(label: str, got: dict, route: str, gram: dict) -> None:
    """The launches by route of a run whose Gram launches were ``gram``
    ({mode: n}): all on ``route``, none on the other."""
    want = {f"{r}.{mode}": n * (r == route) for r in ("hash", "dense") for mode, n in gram.items()}
    check(got == want, f"{label}: launches by route {got}, expected {want}")


def _paper_engine(name: str, tp, smi: str) -> dict:
    """(a) the main path on ``tp`` at D = 0 fp32 and D = 2 bf16, each against
    the all-plain run, with (G, v) off by 1 % as the control (the other wire
    precision is read beside it: bf16 must move x), every Gram launch on the
    dataset's route (``_paper_route``); the rounds' walls eager and graphed;
    on the dense route a traced eager round; the kernels' times on one real
    bundle, the Gram's through the wrapper and through each route called
    directly (the dense route where a densified row fits)."""
    from repro_torch.core import round_graph
    from repro_torch.core.engine import ParallelSGDSchedule, engine_loss, run_engine_chunk
    from repro_torch.core.teams import global_problem
    from repro_torch.kernels.ell_gram import (
        dense_fits, ell_gram_and_v, ell_gram_and_v_blocked, ell_gram_dense, ell_gram_dense_plain, ell_gram_hash,
        gram_route,
    )
    from repro_torch.kernels.ref import densify_bundle_ref
    from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref
    from repro_torch.launch.roofline import probe_bound

    route = _paper_route(name)
    width = int(tp.indices.shape[-1])
    check(gram_route(S * B, width, tp.n) == route, f"{name}: (sb, w, n) = {(S * B, width, tp.n)} does not take the {route} route")

    x0 = torch.zeros(tp.n, dtype=torch.float32, device=tp.values.device)
    gp = global_problem(tp)
    cycle = round_graph.round_cycle(tp.rows_local, S * B, TAU // S)
    graphed = cycle <= round_graph.CYCLE_CAP
    base = ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=PAPER_ROUNDS)
    runs = {"fp32_d0": base, f"bf16_d{DELAY}": dataclasses.replace(base, delay=DELAY, precision="bf16")}
    other = {"fp32_d0": dataclasses.replace(base, precision="bf16"), f"bf16_d{DELAY}": dataclasses.replace(base, delay=DELAY)}
    expected = PAPER_ROUNDS * P_R * (TAU // S)
    loss0 = float(engine_loss(gp, x0))
    out = {"cycle": cycle, "cycle_cap": round_graph.CYCLE_CAP, "graphed": graphed, "loss_x0": loss0, "runs": {}}
    log(f"[paper] {name}: teams {tuple(tp.indices.shape)}, cycle {cycle} rounds → "
        + ("graphed (one CUDA graph a residue)" if graphed else f"eager (cycle > CYCLE_CAP = {round_graph.CYCLE_CAP})"))
    xs = {}
    for label, sched in runs.items():
        mode = sched.precision
        zero_launch_counts()
        before = dict(round_graph.counts)
        x = run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, sched)
        sync()
        got = launch_counts()
        routes = route_counts()
        made = {k: round_graph.counts[k] - before[k] for k in before}
        want_graphs = _graphs_expected(cycle, PAPER_ROUNDS)
        want = {"ell_gram.fp32": expected * (mode == "fp32"), "ell_gram.bf16": expected * (mode == "bf16"),
                "sstep_inner.fp32": expected, "sstep_inner.bf16": 0}
        check(got == want, f"{name} {label}: launches {got}, expected {want}")
        _check_routes(f"{name} {label}", routes, route, {"fp32": want["ell_gram.fp32"], "bf16": want["ell_gram.bf16"]})
        check(made == want_graphs, f"{name} {label}: round graphs {made}, expected {want_graphs}")
        loss = float(engine_loss(gp, x))
        check(math.isfinite(loss) and loss < loss0, f"{name} {label}: the loss after {PAPER_ROUNDS} rounds is {loss} (x = 0: {loss0})")
        with plain_corrections():
            x_plain = run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, dataclasses.replace(sched, gram="blocked", bk=PAPER_PLAIN_BK))
        sync()
        check(launch_counts() == got, f"{name} {label}: the plain run launched a kernel")
        with gram_v_off_by_one_percent():
            x_skew = run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, sched)
        x_other = run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, other[label])
        xs[label], xs[f"{label}_other"] = x, x_other
        row = _plain_gap(f"{name} {label}", x, x_plain, {"(G, v) off by 1 %": x_skew})
        row["other_wire_gap"] = float((x_other - x_plain).abs().max())
        log(f"[paper] {name} {label}: the {other[label].precision} wire's run is {row['other_wire_gap']:.3g} from the "
            f"plain run's")
        # the wall of a run of PAPER_ROUNDS rounds: eager, and (after the
        # warm-up runs above captured every residue) replayed from graphs
        walls = {}
        for how in ("eager", "graphed") if graphed else ("eager",):
            run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, sched)
            samples = []
            for _ in range(3):
                with eager_rounds() if how == "eager" else contextlib.nullcontext():
                    sync()
                    t0 = time.perf_counter()
                    run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, sched)
                    sync()
                samples.append((time.perf_counter() - t0) * 1e3 / PAPER_ROUNDS)
            walls[f"round_ms_{how}"] = statistics.median(samples)
        row.update(walls, launches=got, launches_by_route=routes, launches_a_round=sum(got.values()) / PAPER_ROUNDS,
                   graphs=made, loss=loss)
        log(f"[paper] {name} {label}: {PAPER_ROUNDS} rounds, loss {loss0:.6f} → {loss:.6f} (log 2 = {math.log(2.0):.6f}); "
            f"kernel launches {got} ({row['launches_a_round']:.0f} a round; by route {routes}); round graphs {made}; wall a round "
            + ", ".join(f"{k[9:]} {v:.3f} ms" for k, v in walls.items()) + f" (median of 3 runs) — {smi}")
        out["runs"][label] = row
    if route == "dense":  # where an eager round's device time goes, index_add_ among it
        with eager_rounds():
            out["profile_eager_round"] = profile_main_path(f"{name} fp32 D = 0, eager", lambda: run_engine_chunk(
                tp, x0, 0, 2, base), 2)
    bf16_gap = float((xs[f"bf16_d{DELAY}"] - xs[f"bf16_d{DELAY}_other"]).abs().max())
    out["bf16_vs_fp32_d2"] = bf16_gap
    log(f"[paper] {name}: D = {DELAY} bf16 vs fp32 max |Δx| = {bf16_gap:.3g} (the rounding moved x)")
    check(bf16_gap > 0.0, f"{name}: bf16 did not move x")

    # the kernels on one real bundle of team 0 (its first S·B rows)
    bi, bv = tp.indices[0, : S * B].contiguous(), tp.values[0, : S * B].contiguous()
    x_in = xs["fp32_d0"]
    gram_bound = probe_bound(bi, bv)
    times = {}
    for mode in ("fp32", "bf16"):
        wire = torch.float32 if mode == "fp32" else torch.bfloat16

        def library():
            dense = densify_bundle_ref(bi, bv, tp.n).to(wire)
            return torch.tril(dense @ dense.T, diagonal=-1), dense @ x_in.to(wire)

        g_p, v_p = ell_gram_and_v_blocked(bi, bv, x_in, n=tp.n, bk=PAPER_PLAIN_BK, precision=mode)
        # the wrapper (its route) and each route called directly, where it fits
        direct = {"hash": ell_gram_hash} | ({"dense": ell_gram_dense} if dense_fits(tp.n) else {})
        err = 0.0
        for fn in (ell_gram_and_v, *direct.values()):
            g_k, v_k = fn(bi, bv, x_in, n=tp.n, precision=mode)
            err = max(err, errors(g_k, g_p, GV_TOL)[0], errors(v_k, v_p, GV_TOL)[0])
            check(all(errors(a, b, GV_TOL)[2] for a, b in ((g_k, g_p), (v_k, v_p))),
                  f"ell_gram {mode} ({getattr(fn, '__name__', fn)}) on a {name} bundle: max abs error {err}")
        turns = _turns({r: (lambda k, fn=fn: fn(bi, bv, x_in, n=tp.n, precision=mode)) for r, fn in direct.items()},
                       10, tuple(direct) + tuple(reversed(direct)))
        times[f"ell_gram.{mode}"] = dict(
            route=route, ms=device_ms(lambda k: ell_gram_and_v(bi, bv, x_in, n=tp.n, precision=mode), inner=10),
            eager_ms=eager_ms(lambda k: ell_gram_and_v(bi, bv, x_in, n=tp.n, precision=mode), inner=10),
            **{f"{r}_ms": statistics.mean(t) for r, t in turns.items()}, route_turns=turns,
            plain_ms=eager_ms(lambda k: ell_gram_and_v_blocked(bi, bv, x_in, n=tp.n, bk=PAPER_PLAIN_BK, precision=mode),
                              inner=1, warmup=1, reps=5),
            dense_plain_ms=(eager_ms(lambda k: ell_gram_dense_plain(bi, bv, x_in, n=tp.n, precision=mode), inner=1,
                                     warmup=1, reps=5) if "dense" in direct else None),
            library_ms=eager_ms(lambda k: library(), inner=1, warmup=1, reps=5),
            bound={"bytes": gram_bound.memory_s * 1e3, "operations": gram_bound.compute_s * 1e3}, max_abs_err=err)
    g, v = ell_gram_and_v(bi, bv, x_in, n=tp.n)
    u_err = errors(sstep_inner(g, v, S, B, ETA), sstep_inner_ref(g, v, S, B, ETA), U_TOL)
    check(u_err[2], f"sstep_inner on a {name} bundle: max abs error {u_err[0]}")
    tri = B * B * S * (S - 1) // 2
    times["sstep_inner.fp32"] = dict(
        ms=device_ms(lambda k: sstep_inner(g, v, S, B, ETA), inner=20),
        plain_ms=eager_ms(lambda k: sstep_inner_ref(g, v, S, B, ETA), inner=1, warmup=1, reps=5), library_ms=None,
        bound={"bytes": (tri * 4 + 2 * S * B * 4) / HBM_BYTES_PER_S * 1e3,
               "operations": (2.0 * tri + 8.0 * S * B) / FP32_FLOP_PER_S * 1e3}, max_abs_err=u_err[0])
    for key, row in times.items():
        by = max(row["bound"], key=row["bound"].get)
        row.update(bound_ms=row["bound"][by], bound_by=by)
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        routes = ("" if "route" not in row else f" ({row['route']} route; called directly in turns: "
                  + ", ".join(f"{r} {row[f'{r}_ms']:.5f} ms" for r in row["route_turns"])
                  + ("" if "dense_ms" in row else ", dense: a densified row does not fit") + ")")
        log(f"[paper] {name} bundle (sb, w, n) = {(S * B, int(bi.shape[1]), tp.n)}: {key:16s} {row['ms']:.5f} ms on the "
            f"device{routes}, plain {row['plain_ms']:.4f} ms, library {library}, bound {row['bound_ms']:.6f} ms by {by}; "
            f"max abs err {row['max_abs_err']:.3g}")
    out["kernels"] = times
    out["bundle"] = {"sb": S * B, "w": int(bi.shape[1]), "n": tp.n}
    return out


def _paper_corners(name: str, tp, tp1) -> dict:
    """(b) FedAvg (p_r = P_R, s = 1) on ``tp``; s-step (p_r = 1, s =
    PAPER_SSTEP_S) and mini-batch SGD (p_r = 1, s = 1) on ``tp1``: each
    PAPER_CORNER_ROUNDS rounds in fp32 against the all-plain run, the same
    run with η off by 0.1 % as the control (at s = 1 there is no G to skew,
    and the bf16 wire rounds only the margins: over mini-batch SGD's 4 steps
    on news20-sm it moved x by less than the limit)."""
    from repro_torch.core.engine import ParallelSGDSchedule, run_engine_chunk

    route = _paper_route(name)
    r = PAPER_CORNER_ROUNDS
    corners = {
        "fedavg": (tp, ParallelSGDSchedule.fedavg(P_R, B, ETA, TAU, r)),
        "sstep": (tp1, ParallelSGDSchedule.sstep(PAPER_SSTEP_S, B, ETA, PAPER_SSTEP_S * r)),
        "mb_sgd": (tp1, ParallelSGDSchedule.mb_sgd(B, ETA, r)),
    }
    out = {}
    for corner, (problem, sched) in corners.items():
        x0 = torch.zeros(problem.n, dtype=torch.float32, device=problem.values.device)
        zero_launch_counts()
        x = run_engine_chunk(problem, x0, 0, sched.rounds, sched)
        sync()
        got = launch_counts()
        routes = route_counts()
        bundles = sched.rounds * sched.p_r * (sched.tau // sched.s)
        want = bundles if sched.s > 1 else 0  # s = 1: one SpMV and one SpMVᵀ a step, no Gram
        check(got == {"ell_gram.fp32": want, "ell_gram.bf16": 0, "sstep_inner.fp32": want, "sstep_inner.bf16": 0},
              f"{name} {corner}: launches {got}, expected {want} of each fp32 kernel")
        _check_routes(f"{name} {corner}", routes, route, {"fp32": want, "bf16": 0})
        with plain_corrections():
            x_plain = run_engine_chunk(problem, x0, 0, sched.rounds, dataclasses.replace(sched, gram="blocked", bk=PAPER_PLAIN_BK))
        x_eta = run_engine_chunk(problem, x0, 0, sched.rounds, dataclasses.replace(sched, eta=sched.eta * 1.001))
        out[corner] = _plain_gap(f"{name} {corner} (p_r = {sched.p_r}, s = {sched.s}, b = {sched.b}, τ = {sched.tau}, "
                                 f"{sched.rounds} rounds)", x, x_plain, {"η off by 0.1 %": x_eta})
        out[corner].update(launches=got, launches_by_route=routes)
    return out


def _paper_front_door(dataset: str, device=None) -> dict:
    """(c) ``ExperimentSpec`` → ``Session.step_rounds`` under each of
    PAPER_OBJECTIVES: the corrections go to ``inner_corrections_loop`` (no
    ``sstep_inner`` launch, one loop call a bundle on an eager or captured
    round, none on a replayed one), x against an all-plain Session, (G, v)
    off by 1 % on the same problem as the control, the bf16 wire read beside."""
    from repro_torch.api import ExperimentSpec, MeshSpec, Session
    from repro_torch.core import engine, round_graph
    from repro_torch.core.engine import ParallelSGDSchedule, run_engine_chunk

    loop = engine.inner_corrections_loop
    calls = [0]

    def counted_loop(*args, **kwargs):
        calls[0] += 1
        return loop(*args, **kwargs)

    def spec_(objective, l2, **sched_kw):
        return ExperimentSpec(
            dataset=dataset, seed=0, row_multiple=S * B, name=f"{dataset}-{objective}", objective=objective, l2=l2,
            schedule=ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=PAPER_ROUNDS,
                                                loss_every=PAPER_ROUNDS // 2, **sched_kw),
            mesh=MeshSpec(p_r=P_R, p_c=1))

    bundles = P_R * (TAU // S)
    out = {}
    for objective, l2 in PAPER_OBJECTIVES:
        spec = spec_(objective, l2)
        sess = Session(spec, device=device)
        tp = sess.bundle.team
        cycle = round_graph.round_cycle(tp.rows_local, S * B, TAU // S)
        graphed = cycle <= round_graph.CYCLE_CAP
        zero_launch_counts()
        before = dict(round_graph.counts)
        calls[0] = 0
        engine.inner_corrections_loop = counted_loop
        try:
            t0 = time.perf_counter()
            while not sess.done:
                sess.step_rounds(PAPER_ROUNDS // 2)
            sync()
            wall = time.perf_counter() - t0
        finally:
            engine.inner_corrections_loop = loop
        got = launch_counts()
        routes = route_counts()
        _check_routes(f"{dataset} {objective}", routes, _paper_route(dataset), {"fp32": PAPER_ROUNDS * bundles, "bf16": 0})
        made = {k: round_graph.counts[k] - before[k] for k in before}
        replayed = made["replays"]
        want_graphs = _graphs_expected(cycle, PAPER_ROUNDS)
        check(got == {"ell_gram.fp32": PAPER_ROUNDS * bundles, "ell_gram.bf16": 0, "sstep_inner.fp32": 0,
                      "sstep_inner.bf16": 0},
              f"{dataset} {objective}: launches {got}: the corrections did not take the loop")
        check(made == want_graphs, f"{dataset} {objective}: round graphs {made}, expected {want_graphs}")
        # a bundle calls the loop once in an eager round and once while its
        # round is captured; a replay runs no Python
        want_calls = (PAPER_ROUNDS - replayed + made["captures"]) * bundles
        check(calls[0] == want_calls, f"{dataset} {objective}: {calls[0]} calls of inner_corrections_loop, expected {want_calls}")
        if dataset == "news20":
            check(graphed and made["captures"] > 0 and replayed > 0, f"news20 {objective}: the loop was not captured and replayed")
        x = torch.from_numpy(sess.current_x()).to(tp.values.device)
        losses = list(sess.losses)
        check(all(math.isfinite(v) for v in losses), f"{dataset} {objective}: losses {losses}")
        with plain_corrections():
            plain = Session(spec_(objective, l2, gram="blocked", bk=PAPER_PLAIN_BK), device=device)
            while not plain.done:
                plain.step_rounds(PAPER_ROUNDS // 2)
        x_plain = torch.from_numpy(plain.current_x()).to(tp.values.device)
        x0 = torch.zeros(tp.n, dtype=torch.float32, device=tp.values.device)
        with gram_v_off_by_one_percent():
            x_skew = run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, sess.spec.schedule)
        x_bf16 = run_engine_chunk(tp, x0, 0, PAPER_ROUNDS, dataclasses.replace(sess.spec.schedule, precision="bf16"))
        row = _plain_gap(f"{dataset} {objective} λ = {l2:g} (Session.step_rounds)", x, x_plain, {"(G, v) off by 1 %": x_skew})
        row.update(other_wire_gap=float((x_bf16 - x_plain).abs().max()), launches=got, launches_by_route=routes, graphs=made,
                   loop_calls=calls[0], losses=losses, wall_s=wall, cycle=cycle)
        log(f"[paper] {dataset} {objective} λ = {l2:g}: the bf16 wire's run is {row['other_wire_gap']:.3g} from the "
            f"plain run's; losses {' '.join(f'{v:.6f}' for v in losses)}; "
            f"{calls[0]} calls of inner_corrections_loop, launches {got}, round graphs {made} "
            f"({'graphed' if graphed else 'eager'}, cycle {cycle}); {wall:.2f} s for {PAPER_ROUNDS} rounds")
        out[f"{objective}_l2_{l2:g}"] = row
        del sess, plain
    return out


def paper_phase(smi: str, url_rows: int | None = PAPER_URL_ROWS, sweep: dict | None = None, device=None) -> dict:
    """The paper's other datasets end to end (``--paper`` alone, with full
    url): for each of PAPER_DATASETS, built by ``make_dataset`` at its
    registered statistics (url's rows cut to ``url_rows`` unless None), (a)
    the main path at D = 0 fp32 and D = 2 bf16, (b) the corners, (c) on
    PAPER_FRONT_DOOR the other objectives through the front door; each
    dataset's host arrays are let go before the next is built. (d) the
    sweep CLI on url's spec: ``sweep`` is its process if the caller started
    it (``start_sweep_cli``), else it starts after (c) and is waited for.
    Returns the numbers for the phase's JSON line."""
    from repro_torch.api.run import _cached_dataset
    from repro_torch.core.teams import stack_row_teams
    from repro_torch.sparse.synthetic import DATASET_STATS

    started = time.perf_counter()
    out = {"card": smi, "point": {"p_r": P_R, "s": S, "b": B, "tau": TAU, "eta": ETA, "rounds": PAPER_ROUNDS},
           "plain_bk": PAPER_PLAIN_BK, "datasets": {}}
    names = {"url": paper_url_name(url_rows)}
    if url_rows is not None:
        log(f"[paper] url runs with its rows cut to {url_rows} (of {DATASET_STATS['url'].m:,}): make_skewed_csr with url's "
            f"columns, mean width and skew, registered as {names['url']!r}; full url under --paper")
    out["url_rows"] = url_rows
    for base in PAPER_DATASETS:
        name = names.get(base, base)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ds = _cached_dataset(name, seed=0)  # the front door's sessions find it in the cache (build_problem's call)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp = stack_row_teams(ds.A, ds.y, P_R, row_multiple=S * B, device=device)
        sync()
        stack_s = time.perf_counter() - t0
        row = {"m": ds.A.m, "n": ds.A.n, "nnz": ds.A.nnz, "generate_s": gen_s, "stack_s": stack_s,
               "teams": list(tp.indices.shape), "host_peak_gb": _host_peak_gb()}
        log(f"[paper] {name}: m = {ds.A.m:,}, n = {ds.A.n:,}, nnz = {ds.A.nnz:,}; generated in {gen_s:.1f} s, "
            f"stacked into {P_R} teams {tuple(tp.indices.shape)} on the card in {stack_s:.1f} s; host peak "
            f"{row['host_peak_gb']:.1f} GB so far")
        row["engine"] = _paper_engine(name, tp, smi)
        t0 = time.perf_counter()
        tp1 = stack_row_teams(ds.A, ds.y, 1, row_multiple=PAPER_SSTEP_S * B, device=device)
        row["stack1_s"] = time.perf_counter() - t0
        row["corners"] = _paper_corners(name, tp, tp1)
        del tp, tp1
        if base in PAPER_FRONT_DOOR:
            row["front_door"] = _paper_front_door(name, device=device)
        row["device_peak_bytes"] = torch.cuda.max_memory_allocated()
        row["host_peak_gb"] = _host_peak_gb()
        log(f"[paper] {name}: device peak {row['device_peak_bytes']:,} B (max_memory_allocated); host peak "
            f"{row['host_peak_gb']:.1f} GB so far")
        out["datasets"][name] = row
        del ds
        _cached_dataset.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
    if sweep is None:
        sweep = start_sweep_cli(device)
    out["sweep_cli"] = finish_sweep_cli(sweep)
    out["phase_s"] = time.perf_counter() - started
    log(f"[paper] phase done in {out['phase_s']:.1f} s")
    return out


# the paper's grid: the three factorizations of p = 4 — (1, 4) the s-step
# corner, (2, 2), (4, 1) the FedAvg corner — on the paper's datasets in one
# spawned group of four ranks, each rank building its own block alone, at
# the cells' point (S, B, TAU, ETA, ROUNDS rounds, a loss every 4): fp32 at
# D = 0 on every shape, bf16 at D = 1 on (2, 2); on url also (1, 4) under
# the other partitioners and a timed run (comm_timing) a shape
PAPER_MESH_SHAPES = ((1, 4), (2, 2), (4, 1))
PAPER_MESH_PARTITIONERS = ("cyclic", "rows", "nnz")
# the ranks' group timeout: four concurrent generations of url (83 s alone
# on the card's host) come before a collective
PAPER_MESH_TIMEOUT_S = 900
# max |Δx| over max |x| of a bf16 run at D = 1 on (2, 2) to the simulated
# one: the mesh rounds each shard's partial (G, v) to bf16, the simulated
# engine the total (MESH_BF16_DX's reason, relative here: the datasets' x
# differ in scale), about bf16's own effect, which PR 27 read at 3.7e-6,
# 2.0e-6 and 5.0e-6 of max |x| on news20, epsilon and url. On news20 over gloo
# on one NVIDIA H100 80GB HBM3 (700 W) this gap read 3.7e-6, and the controls
# on the simulated engine (the D = 0 run; (G, v) 1 % off) 4.3e-4 / 1.6e-4 on
# epsilon and 1.4e-3 / 5.0e-4 on url, all at D = 1, p_r = 2
PAPER_MESH_BF16_RTOL = 2e-5


def paper_mesh_runs(name: str) -> dict:
    """label: (p_r, p_c, delay, precision, partitioner, timed) of the runs
    on ``name`` (url and its cuts: also the partitioners and timed runs)."""
    runs = {}
    for p_r, p_c in PAPER_MESH_SHAPES:
        runs[f"{p_r}x{p_c}_fp32_d0"] = (p_r, p_c, 0, "fp32", "cyclic", False)
        if (p_r, p_c) == (MESH_P, MESH_P):
            runs[f"{p_r}x{p_c}_bf16_d1"] = (p_r, p_c, 1, "bf16", "cyclic", False)
    if name.startswith("url"):
        for part in PAPER_MESH_PARTITIONERS[1:]:
            runs[f"1x4_fp32_d0_{part}"] = (1, 4, 0, "fp32", part, False)
        for p_r, p_c in PAPER_MESH_SHAPES:
            runs[f"{p_r}x{p_c}_timed"] = (p_r, p_c, 0, "fp32", "cyclic", True)
    return runs


def paper_mesh_spec(name: str, p_r: int, p_c: int, delay: int = 0, precision: str = "fp32",
                    partitioner: str = "cyclic", timed: bool = False):
    """A run of the paper's grid through the front door: ``name`` on a
    p_r × p_c ``shard_map`` mesh at the cells' point."""
    from repro_torch.api import ExperimentSpec, MeshSpec
    from repro_torch.core.engine import ParallelSGDSchedule

    return ExperimentSpec(
        dataset=name, seed=0, row_multiple=S * B, name=f"{name}-mesh-{p_r}x{p_c}", comm_timing=timed,
        schedule=ParallelSGDSchedule.hybrid(p_r=p_r, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, loss_every=4,
                                            p_c=p_c, delay=delay, precision=precision),
        mesh=MeshSpec(p_r=p_r, p_c=p_c, backend="shard_map", partitioner=partitioner),
    )


def _col_bundle_times(bi: torch.Tensor, bv: torch.Tensor, x_in: torch.Tensor, n_loc: int) -> dict:
    """``ell_gram`` on a column-shard bundle (ids < n_loc) and a weight
    shard, on the current card: device and eager ms of the wrapper (its
    route) and of each route called directly (the dense one where a
    densified row fits) in turns, the plain walk's (bk PAPER_PLAIN_BK) and
    the library's (densify + ``torch.matmul``) ms and the bound, in both
    modes."""
    from repro_torch.kernels.ell_gram import (
        dense_fits, ell_gram_and_v, ell_gram_and_v_blocked, ell_gram_dense, ell_gram_hash, gram_route,
    )
    from repro_torch.kernels.ref import densify_bundle_ref
    from repro_torch.launch.roofline import probe_bound

    gram_bound = probe_bound(bi, bv)
    out = {"sb": S * B, "w": int(bi.shape[1]), "n_loc": n_loc, "route": gram_route(S * B, int(bi.shape[1]), n_loc)}
    direct = {"hash": ell_gram_hash} | ({"dense": ell_gram_dense} if dense_fits(n_loc) else {})
    for mode in ("fp32", "bf16"):
        wire = torch.float32 if mode == "fp32" else torch.bfloat16

        def library(k):
            dense = densify_bundle_ref(bi, bv, n_loc).to(wire)
            return torch.tril(dense @ dense.T, diagonal=-1), dense @ x_in.to(wire)

        g_p, v_p = ell_gram_and_v_blocked(bi, bv, x_in, n=n_loc, bk=PAPER_PLAIN_BK, precision=mode)
        outs = [fn(bi, bv, x_in, n=n_loc, precision=mode) for fn in (ell_gram_and_v, *direct.values())]
        err = max(max(errors(g_k, g_p, GV_TOL)[0], errors(v_k, v_p, GV_TOL)[0]) for g_k, v_k in outs)
        turns = _turns({r: (lambda k, fn=fn: fn(bi, bv, x_in, n=n_loc, precision=mode)) for r, fn in direct.items()},
                       10, tuple(direct) + tuple(reversed(direct)))
        row = dict(ms=device_ms(lambda k: ell_gram_and_v(bi, bv, x_in, n=n_loc, precision=mode), inner=10),
                   **{f"{r}_ms": statistics.mean(t) for r, t in turns.items()}, route_turns=turns,
                   eager_ms=eager_ms(lambda k: ell_gram_and_v(bi, bv, x_in, n=n_loc, precision=mode), inner=10),
                   plain_ms=eager_ms(lambda k: ell_gram_and_v_blocked(bi, bv, x_in, n=n_loc, bk=PAPER_PLAIN_BK,
                                                                      precision=mode), inner=1, warmup=1, reps=5),
                   library_ms=eager_ms(library, inner=1, warmup=1, reps=5),
                   bound={"bytes": gram_bound.memory_s * 1e3, "operations": gram_bound.compute_s * 1e3},
                   max_abs_err=err, within_tol=all(errors(a, b, GV_TOL)[2] for g_k, v_k in outs
                                                   for a, b in ((g_k, g_p), (v_k, v_p))))
        by = max(row["bound"], key=row["bound"].get)
        row.update(bound_ms=row["bound"][by], bound_by=by)
        out[f"ell_gram.{mode}"] = row
    return out


def paper_mesh_rank(rank: int, world: int, store: str, out: str, backend: str, datasets: tuple,
                    device=None) -> None:
    """One rank of the paper's grid (a spawned process): joins a ``backend``
    group through a file store; for each dataset generates it
    (``_cached_dataset``, the front door's cache) and runs each of
    ``paper_mesh_runs`` through ``Session`` (the rank builds its own block
    alone) on ``device`` (None: ``cuda:(rank % device_count)``), one round a
    step; writes its launch counts, ledger, step walls, losses, x's digest,
    block dimensions, build seconds, host and device peaks under ``out``
    (rank 0 also x, the partition's κ at (1, 4), and over NCCL, a card to
    itself, the Gram kernel's times on its first column-shard bundle, timed
    once the group is gone: no communicator beside the CUDA graphs that time
    it)."""
    import datetime
    import hashlib

    import torch.distributed as dist

    from repro_torch.api import Session
    from repro_torch.api.run import _cached_dataset
    from repro_torch.sparse.partition import partition_stats

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PAPER_MESH_TIMEOUT_S))
    result, bundles = {}, {}
    try:
        for name in datasets:
            t0 = time.perf_counter()
            ds = _cached_dataset(name, seed=0)
            row = {"generate_s": time.perf_counter() - t0, "host_peak_gb_generated": _host_peak_gb(), "runs": {}}
            for label, (p_r, p_c, delay, precision, partitioner, timed) in paper_mesh_runs(name).items():
                spec = paper_mesh_spec(name, p_r, p_c, delay, precision, partitioner, timed)
                t0 = time.perf_counter()
                sess = Session(spec, device=device)
                build_s = time.perf_counter() - t0
                if sess.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(sess.device)
                zero_launch_counts()
                walls = stepped_run(sess)
                launches = launch_counts()
                x = sess.current_x()
                prob = sess.bundle.prob2d
                rec = {"launches": launches, "launches_by_route": route_counts(), "ledger": sess.ledger.to_dict(), "walls": walls,
                       "losses": [float(v) for v in sess.losses], "x_sha256": hashlib.sha256(x.tobytes()).hexdigest(),
                       "block": list(prob.block), "block_shape": list(prob.indices.shape),
                       "rows_local": prob.rows_local, "width": prob.width, "n_loc": prob.n_loc,
                       "build_s": build_s, "host_peak_gb": _host_peak_gb(), "device_peak": torch.cuda.max_memory_allocated(sess.device) if sess.device.type == "cuda" else None,
                       "device": str(sess.device)}
                if rank == 0:
                    np.save(pathlib.Path(out) / f"{name}.{label}.npy", x)
                    if p_r == 1 and not timed:
                        st = partition_stats(ds.A, sess.bundle.cp)
                        rec["partition"] = {"kind": st.kind, "kappa": st.kappa, "max_n_local": st.max_n_local,
                                            "nnz_per_rank": st.nnz_per_rank.tolist()}
                    if backend == "nccl" and p_c > 1 and label.endswith("fp32_d0"):
                        drv = sess._driver  # the first bundle of round 0, and the final shard
                        bundles[(name, label)] = (drv._idx[: S * B].clone(), drv._val[: S * B].clone(),
                                                  drv._x_loc.clone(), prob.n_loc)
                row["runs"][label] = rec
                del sess, prob
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            row["host_peak_gb"] = _host_peak_gb()
            result[name] = row
            del ds
            _cached_dataset.cache_clear()
            gc.collect()
    finally:
        dist.destroy_process_group()
    for (name, label), args in bundles.items():
        try:
            times = _col_bundle_times(*args)
        except Exception:  # kept as a failure of the report, beside every other reading
            times = {"error": traceback.format_exc()[-2000:]}
        result[name]["runs"][label]["bundle_times"] = times
    (pathlib.Path(out) / f"rank{rank}.json").write_text(json.dumps(result))


def _paper_mesh_oracles(name: str, ds, device) -> dict:
    """The simulated engine on ``ds`` at each shape's p_r (stacked once a
    p_r, on ``device``), with the schedules of ``paper_mesh_runs``: fp32 at
    D = 0, at p_r = MESH_P bf16 at D = 1 and at D = 0; each but the last
    also with (G, v) 1 % off. Each: x and losses on the host, its ledger."""
    from repro_torch.core.engine import ParallelSGDSchedule, engine_comm_ledger, run_parallel_sgd
    from repro_torch.core.teams import stack_row_teams

    sims = {"stack_s": {}}
    for p_r, p_c in PAPER_MESH_SHAPES:
        t0 = time.perf_counter()
        tp = stack_row_teams(ds.A, ds.y, p_r, row_multiple=S * B, device=device)
        sims["stack_s"][p_r] = time.perf_counter() - t0
        x0 = torch.zeros(tp.n, dtype=torch.float32, device=tp.values.device)
        base = ParallelSGDSchedule.hybrid(p_r=p_r, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS, loss_every=4, p_c=p_c)
        scheds = {"fp32_d0": base}
        if (p_r, p_c) == (MESH_P, MESH_P):
            scheds["bf16_d1"] = dataclasses.replace(base, delay=1, precision="bf16")
            scheds["bf16_d0"] = dataclasses.replace(base, precision="bf16")
        for label, sched in scheds.items():
            x, losses = run_parallel_sgd(tp, x0, sched)
            rec = {"x": x.cpu().numpy(), "losses": [float(v) for v in losses.cpu()],
                   "ledger": engine_comm_ledger(sched, tp.n, tp=tp)}
            if label != "bf16_d0":
                with gram_v_off_by_one_percent():
                    rec["x_skew"] = run_parallel_sgd(tp, x0, sched)[0].cpu().numpy()
            sims[(p_r, label)] = rec
        del tp, x0
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return sims


def _paper_mesh_report(name: str, ranks: list, sims: dict, tmp: pathlib.Path, where: str, smi: str) -> dict:
    """Hold each run of ``name`` on the grid: the ranks' x bitwise equal and
    their losses equal; x within X_TOL·max |x| of the simulated engine at
    the same p_r, with controls that must miss (the simulated engine at the
    other p_r's, (G, v) 1 % off, for bf16 D = 1 the D = 0 run; bf16 at
    PAPER_MESH_BF16_RTOL), the factor by which each misses printed; the
    launches; each rank's ledger = the simulated one (under another
    partitioner than cyclic, with its own n_loc as the weight average's
    words), its bytes a round the closed form (0 on an axis of size
    1: the ledger keeps the call at span 1 and counts no bytes for it); url's
    partitioners within X_TOL·max |x| of each other. Returns the readings."""
    from repro_torch.core.comm import CommLedger

    expected = ROUNDS * (TAU // S)
    out = {"generate_s": [r[name]["generate_s"] for r in ranks],
           "host_peak_gb": [r[name]["host_peak_gb"] for r in ranks], "runs": {}}
    xs = {}
    for label, (p_r, p_c, delay, precision, partitioner, timed) in paper_mesh_runs(name).items():
        recs = [r[name]["runs"][label] for r in ranks]
        x = np.load(tmp / f"{name}.{label}.npy")
        xs[label] = x
        check(all(rec["x_sha256"] == recs[0]["x_sha256"] for rec in recs), f"{name} {label}: the ranks gathered different x")
        check(all(rec["losses"] == recs[0]["losses"] for rec in recs), f"{name} {label}: the ranks' losses differ")
        check(all(rec["block"] == [r // p_c, r % p_c] and rec["block_shape"] == [rec["rows_local"], rec["width"]]
                  for r, rec in enumerate(recs)), f"{name} {label}: a rank holds another block than its own")
        sim_label = "bf16_d1" if precision == "bf16" else "fp32_d0"
        sim = sims[(p_r, sim_label)]
        x_max = float(np.abs(sim["x"]).max())
        limit = (X_TOL if precision == "fp32" else PAPER_MESH_BF16_RTOL) * x_max
        gap = float(np.abs(x - sim["x"]).max())
        controls = {"(G, v) off by 1 %": sim["x_skew"]}
        if precision == "bf16":
            controls["simulated D = 0"] = sims[(p_r, "bf16_d0")]["x"]
        else:
            controls.update({f"simulated p_r = {q}": sims[(q, "fp32_d0")]["x"] for q, _ in PAPER_MESH_SHAPES if q != p_r})
        misses = {what: float(np.abs(x - xc).max()) for what, xc in controls.items()}
        check(np.isfinite(x).all() and x_max > 0 and gap <= limit,
              f"{name} {label}: max |Δx| {gap} to the simulated engine at p_r = {p_r}, limit {limit}")
        for what, miss in misses.items():
            check(miss > limit, f"{name} {label}: the control ({what}) is within the limit: {miss} ≤ {limit}")
        # launches: one bundle of each kind a step; the timed run's phase
        # probes launch the Gram kernel besides
        word = 4 if precision == "fp32" else 2
        want = {"ell_gram.fp32": expected * (precision == "fp32"), "ell_gram.bf16": expected * (precision == "bf16"),
                "sstep_inner.fp32": expected, "sstep_inner.bf16": 0}
        want_bytes = {"gram_bytes": float((S * B * S * B + S * B) * (TAU // S) * word) if p_c > 1 else 0.0,
                      "sync_bytes": float(4 * recs[0]["n_loc"]) if p_r > 1 else 0.0}
        # the simulated ledger prices the weight average at an even split of
        # the columns, which the cyclic partition is; another partitioner's
        # shards pad to their own n_loc
        sim_rates = tuple(dataclasses.replace(rt, words_per_call=recs[0]["n_loc"])
                          if rt.axis == "rows" and partitioner != "cyclic" else rt for rt in sim["ledger"].rates)
        for r, rec in enumerate(recs):
            got = rec["launches"]
            ok = (got == want if not timed else
                  all(got[k] >= v if v else got[k] == 0 for k, v in want.items()) and got["sstep_inner.fp32"] == expected)
            check(ok, f"{name} {label}, rank {r}: launches {got}, expected {want}" + (" (+ the probes')" if timed else ""))
            _check_routes(f"{name} {label}, rank {r}", rec["launches_by_route"], _paper_route(name),
                          {mode: got[f"ell_gram.{mode}"] for mode in ("fp32", "bf16")})
            led = CommLedger.from_dict(rec["ledger"])
            check(led.rates == sim_rates and led.rounds == ROUNDS,
                  f"{name} {label}, rank {r}: ledger {led.rates} vs simulated {sim_rates}")
            per_round = led.counted_bytes(1)
            check(per_round["gram_bytes"] == want_bytes["gram_bytes"] and per_round["sync_bytes"] == want_bytes["sync_bytes"],
                  f"{name} {label}, rank {r}: bytes a round {per_round}, closed form {want_bytes}")
        step_ms = statistics.median(max(rec["walls"][k] for rec in recs) for k in range(1, ROUNDS)) * 1e3
        row = {"shape": [p_r, p_c], "delay": delay, "precision": precision, "partitioner": partitioner,
               "gap": gap, "x_max": x_max, "limit": limit, "controls": misses,
               "control_factor": min(misses.values()) / limit, "launches_per_rank": recs[0]["launches"],
               "launches_by_route_per_rank": recs[0]["launches_by_route"],
               "bytes_per_round": want_bytes, "losses": recs[0]["losses"], "sim_losses": sim["losses"],
               "step_ms": step_ms, "rows_local": recs[0]["rows_local"], "width": recs[0]["width"],
               "n_loc": recs[0]["n_loc"], "build_s": [rec["build_s"] for rec in recs],
               "host_peak_gb": [rec["host_peak_gb"] for rec in recs],
               "device_peak": [rec["device_peak"] for rec in recs], "devices": [rec["device"] for rec in recs]}
        for key in ("partition", "bundle_times"):
            if key in recs[0]:
                row[key] = recs[0][key]
        log(f"[pmesh] {name} {label} ({where}): rows_local {row['rows_local']:,}, width {row['width']}, n_loc "
            f"{row['n_loc']:,}; max |Δx| to the simulated engine at p_r = {p_r} {gap:.3g} (limit {limit:.3g}); controls "
            + ", ".join(f"{k} {v:.3g} ({v / limit:.1f}× the limit)" for k, v in misses.items())
            + f"; launches a rank {recs[0]['launches']}; bytes a round {want_bytes}; losses {recs[0]['losses']} "
            f"(simulated {sim['losses']}); step wall {step_ms:.3f} ms (median, slowest rank); build s "
            f"{[round(v, 2) for v in row['build_s']]}; host peak GB {[round(v, 2) for v in row['host_peak_gb']]}; "
            f"device peak B {row['device_peak']}; {smi}")
        if "partition" in row:
            st = row["partition"]
            log(f"[pmesh] {name} {label}: partitioner {st['kind']}: κ = {st['kappa']:.6f}, max n_local "
                f"{st['max_n_local']:,}, nnz a shard {st['nnz_per_rank']}; step wall {step_ms:.3f} ms")
        if timed:
            leds = [CommLedger.from_dict(rec["ledger"]) for rec in recs]
            for r, led in enumerate(leds):
                check(len(led.round_seconds) == ROUNDS
                      and set(led.phase_seconds) == {"bundle_compute", "allreduce_gv", "param_avg"},
                      f"{name} {label}, rank {r}: {len(led.round_seconds)} round walls, phases {led.phase_seconds}")
            row["timed"] = [{"round_s": led.round_seconds, "seconds_per_round": led.seconds_per_round,
                             "phase_s": led.phase_seconds} for led in leds]
            log(f"[pmesh] {name} {label} timed: rank 0 {leds[0].seconds_per_round * 1e3:.3f} ms a round (median), "
                f"slowest rank {max(led.seconds_per_round for led in leds) * 1e3:.3f} ms; phase seconds a round (rank 0) "
                f"{leds[0].phase_seconds}; {smi}")
        if "bundle_times" in row:
            bt = row["bundle_times"]
            check("error" not in bt, f"{name} {label}: timing rank (0, 0)'s first bundle failed: {bt.get('error')}")
            for mode in ("fp32", "bf16") if "error" not in bt else ():
                t = bt[f"ell_gram.{mode}"]
                check(t["within_tol"], f"{name} {label}: ell_gram {mode} on rank 0's first bundle, max abs error "
                      f"{t['max_abs_err']}")
                log(f"[pmesh] {name} {label} rank (0, 0)'s first bundle (sb, w, n_loc) = {(bt['sb'], bt['w'], bt['n_loc'])}, "
                    f"{bt['route']} route: ell_gram.{mode} {t['ms']:.5f} ms on the device ({t['eager_ms']:.4f} ms a call from "
                    "Python; called directly in turns " + ", ".join(f"{r} {t[f'{r}_ms']:.5f} ms" for r in t["route_turns"])
                    + "), plain "
                    f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms by "
                    f"{t['bound_by']}; max abs err {t['max_abs_err']:.3g}")
        out["runs"][label] = row
    parts = {p: xs[f"1x4_fp32_d0_{p}" if p != "cyclic" else "1x4_fp32_d0"] for p in PAPER_MESH_PARTITIONERS
             if f"1x4_fp32_d0_{p}" in xs or p == "cyclic"}
    if len(parts) > 1:
        limit = X_TOL * float(np.abs(parts["cyclic"]).max())
        gaps = {f"{a}-{b}": float(np.abs(parts[a] - parts[b]).max()) for a in parts for b in parts if a < b}
        log(f"[pmesh] {name} (1, 4): the partitioners' x pairwise max |Δx| {gaps} (limit {limit:.3g})")
        check(all(g <= limit for g in gaps.values()), f"{name}: the partitioners disagree: {gaps}, limit {limit}")
        out["partitioner_gaps"] = gaps
    return out


def paper_mesh_phase(smi: str, datasets: tuple = PAPER_DATASETS, ranks_backend: str = "nccl",
                     device=None) -> dict:
    """The paper's grid: four spawned ranks (``paper_mesh_rank``) in one
    ``ranks_backend`` group — NCCL, a card a rank (``--mesh-nccl``), or gloo
    with CUDA tensors sharing one card — run ``paper_mesh_runs`` of each of
    ``datasets`` at full size, each rank building its own block alone. This
    process generates the datasets while they run and, after they finish
    (so it does not share card 0 with rank 0), runs the simulated oracles on
    ``device`` (None: the card) and holds every run against them
    (``_paper_mesh_report``). Failures are gathered and reported together at
    the end. Returns the numbers for the phase's JSON line."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.sparse.synthetic import make_dataset

    started = time.perf_counter()
    world = MESH_P * MESH_P
    meminfo = {k: int(v.split()[0]) * 1024 for k, v in (line.split(":", 1) for line in
                                                        pathlib.Path("/proc/meminfo").read_text().splitlines())
               if k in ("MemTotal", "MemAvailable")}
    out = {"card": smi, "backend": ranks_backend, "point": {"s": S, "b": B, "tau": TAU, "eta": ETA, "rounds": ROUNDS},
           "host_memory": meminfo, "datasets": {}}
    log(f"[pmesh] host memory: {meminfo['MemTotal'] / 1e9:.1f} GB, {meminfo['MemAvailable'] / 1e9:.1f} GB available; "
        f"{os.cpu_count()} cores")
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(paper_mesh_rank, args=(world, f"{tmp}/store", tmp, ranks_backend, tuple(datasets),
                                                        device),
                                 nprocs=world, start_method="spawn", join=False)
        data, gen_s = {}, {}
        try:
            for name in datasets:  # host work only, beside the ranks
                t0 = time.perf_counter()
                data[name] = make_dataset(name, seed=0)
                gen_s[name] = time.perf_counter() - t0
            while not ctx.join():
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out["spawned_s"] = time.perf_counter() - started
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text()) for r in range(world)]
        where = ("gloo, CUDA tensors, 4 processes on one card" if ranks_backend == "gloo"
                 else f"{ranks_backend}, a card a rank")
        log(f"[pmesh] {world} ranks ({where}) ran {', '.join(datasets)} in {out['spawned_s']:.1f} s; this process "
            f"generated them meanwhile in {', '.join(f'{v:.1f}' for v in gen_s.values())} s")
        for name in datasets:
            t0 = time.perf_counter()
            sims = None
            with deferred_checks() as fails:
                sims = _paper_mesh_oracles(name, data.pop(name), device)
                row = _paper_mesh_report(name, ranks, sims, pathlib.Path(tmp), where, smi)
                row["oracle_stack_s"] = sims["stack_s"]
                row["oracle_s"] = time.perf_counter() - t0
                out["datasets"][name] = row
            failed += [f"{name}: {f}" for f in fails]
            del sims
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - started
    log(f"[pmesh] the phase took {out['phase_s']:.1f} s (ranks {out['spawned_s']:.1f} s)")
    check(not failed, "the paper's grid: " + " | ".join(failed))
    return out


# the kernel instantiations ptxas reports for each source: the two modes
# of each kernel (the dense route has two kernels, pass A and pass B)
PTXAS_KERNELS = {"ell_gram": 2, "ell_gram_dense": 4, "sstep_inner": 2}


def build_kernels() -> float:
    """Phase 2: build every source (one ``nvcc`` each, together) and read
    ptxas' report of every kernel instantiation: registers, and no spills.
    Returns the build's seconds."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel sources with {_build.find_nvcc()} in {build_s:.1f} s → {_build.build_dir()}")
    for name in libs:
        report = _build.build_log(name)
        kernels_seen = re.findall(r"Function properties for (\S+)", report)
        spills = [tuple(map(int, m)) for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
        for line in report.splitlines():
            if "spill" in line or "registers" in line:
                log(f"[ptxas] {name}: {line.strip()}")
        want = PTXAS_KERNELS[name]
        check(len(kernels_seen) == len(spills) == want, f"ptxas reported {len(kernels_seen)} kernels of {name}, expected {want}")
        check(all(s == (0, 0) for s in spills), f"a kernel of {name} spills registers: {spills}")
    return build_s


def gram_main(smi: str) -> None:
    """``--gram``: the Gram kernel's two routes alone, after the build: the
    dense route's phase-3 checks and its phase-5 times beside the hash
    route and the library, and the crossover the route rule is set from."""
    device = torch.device("cuda")
    build_s = build_kernels()
    err = {}
    bitwise = check_gram_dense(device, err)
    times = time_gram_routes(device)
    print(smi, flush=True)
    print(json.dumps({"gram": {"card": smi, "build_s": build_s, "max_abs_err": err, "bitwise_checks": bitwise,
                               **times}}), flush=True)
    device_line()


def device_line() -> None:
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def mesh_nccl_main(smi: str) -> None:
    """``--mesh-nccl``: the mesh phase, the paper's grid (full news20,
    epsilon and url) and the model_mesh phase alone, their four ranks over
    NCCL with one rank a card (needs four cards), after building the
    kernels; (a) also times τ = 1 against τ = ``MM_TAU`` in turns."""
    from repro_torch.kernels import _build

    check(torch.cuda.device_count() >= MESH_P * MESH_P,
          f"--mesh-nccl needs {MESH_P * MESH_P} cards, found {torch.cuda.device_count()}")
    _build.build_all()
    cards = smi.splitlines()  # nvidia-smi prints a line a card: the phases' lines name them once
    label = f"{len(cards)} × {cards[0]}" if len(set(cards)) == 1 else "; ".join(cards)
    mesh = mesh_phase(label, ranks_backend="nccl")
    paper_mesh = paper_mesh_phase(label, ranks_backend="nccl")
    model_mesh = model_mesh_phase(label, ranks_backend="nccl")
    print(smi, flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"paper_mesh": paper_mesh}), flush=True)
    print(json.dumps({"model_mesh": model_mesh}), flush=True)
    device_line()


def paper_grid_main(smi: str) -> None:
    """``--paper-grid [NAME,...]``: the paper's grid alone over NCCL, a card
    a rank (needs four cards), on the named datasets (default
    PAPER_DATASETS), after building the kernels."""
    args = sys.argv[1:]
    at = args.index("--paper-grid") + 1
    names = tuple(args[at].split(",")) if at < len(args) and not args[at].startswith("--") else PAPER_DATASETS
    check(torch.cuda.device_count() >= MESH_P * MESH_P,
          f"--paper-grid needs {MESH_P * MESH_P} cards, found {torch.cuda.device_count()}")
    build_kernels()
    cards = smi.splitlines()
    label = f"{len(cards)} × {cards[0]}" if len(set(cards)) == 1 else "; ".join(cards)
    paper_mesh = paper_mesh_phase(label, datasets=names, ranks_backend="nccl")
    print(smi, flush=True)
    print(json.dumps({"paper_mesh": paper_mesh}), flush=True)
    device_line()


def paper_launches(paper: dict, key: str) -> dict:
    """{dataset.path: launches of ``key``} over the paper phase's runs."""
    return {f"{name}.{label}": run["launches"][key] for name, row in paper["datasets"].items()
            for runs in (row["engine"]["runs"], row["corners"], row.get("front_door", {})) for label, run in runs.items()}


def paper_main(smi: str) -> None:
    """``--paper``: the paper phase alone, after building the kernels, with
    full url and the sweep CLI after (a)–(c)."""
    from repro_torch.kernels import _build

    _build.build_all()
    paper = paper_phase(smi, url_rows=None)
    print(smi, flush=True)
    print(json.dumps({"paper": paper}), flush=True)
    device_line()


def graph_main(smi: str) -> None:
    """``--graph``: the graph phase alone on the main path's team problem,
    after building the kernels."""
    from repro_torch.core.teams import stack_row_teams
    from repro_torch.kernels import _build
    from repro_torch.sparse.synthetic import make_dataset

    _build.build_all()
    ds = make_dataset(DATASET, seed=0)
    graph = graph_phase(stack_row_teams(ds.A, ds.y, P_R, row_multiple=S * B), smi)
    print(smi, flush=True)
    print(json.dumps({"graph": graph}), flush=True)
    device_line()


def main() -> None:
    started = time.perf_counter()
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
    if "--mesh-nccl" in sys.argv[1:]:
        mesh_nccl_main(smi)
        return
    if "--zoo" in sys.argv[1:]:
        zoo = zoo_phase(smi)
        print(smi, flush=True)
        print(json.dumps({"zoo": zoo}), flush=True)
        device_line()
        return
    if "--graph" in sys.argv[1:]:
        graph_main(smi)
        return
    if "--gram" in sys.argv[1:]:
        gram_main(smi)
        return
    if "--paper-grid" in sys.argv[1:]:
        paper_grid_main(smi)
        return
    if "--paper" in sys.argv[1:]:
        paper_main(smi)
        return
    alone = {"--model-mesh": MM_PARTS, "--decode-mesh": ("decode",), "--dryrun": ("decode", "dryrun")}
    for flag, parts in alone.items():
        if flag in sys.argv[1:]:
            model_mesh = model_mesh_phase(smi, setup=_mm_setup(parts=parts))
            print(smi, flush=True)
            print(json.dumps({"model_mesh": model_mesh}), flush=True)
            device_line()
            return

    from repro_torch.core import engine, round_graph
    from repro_torch.core.comm import time_phase
    from repro_torch.core.distributed import build_2d_problem
    from repro_torch.core.engine import (
        ParallelSGDSchedule, engine_comm_ledger, engine_phase_probes, run_engine_chunk, run_parallel_sgd,
    )
    from repro_torch.core.teams import stack_row_teams
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_gram import MAX_CHUNK, ell_gram_and_v, ell_gram_and_v_blocked
    from repro_torch.kernels.ref import densify_bundle_ref, ell_gram_and_v_ref
    from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref
    from repro_torch.launch.roofline import probe_bound
    from repro_torch.sparse.ell import EllBlock, ell_rmatvec
    from repro_torch.sparse.synthetic import make_dataset

    # ---- phase 2: build -------------------------------------------------
    build_s = build_kernels()

    # ---- the language-model trainer: qwen2.5-3b at its published width ---
    # (first, on an empty card: its ~28 GiB peak does not share the card
    # with what the solver's phases keep); then the rest of the zoo
    lm = lm_phase(smi)
    zoo = zoo_phase(smi)
    # the paper phase's sweep CLI generates full url in a process of its own
    # beside the model mesh's host-bound ranks; the paper phase collects it
    sweep_cli = start_sweep_cli()
    atexit.register(stop_sweep_cli, sweep_cli)
    model_mesh = model_mesh_phase(smi)

    t0 = time.perf_counter()
    ds = make_dataset(DATASET, seed=0)
    tp = stack_row_teams(ds.A, ds.y, P_R, row_multiple=S * B)  # device=None: the card
    log(f"[main] {DATASET}: m = {ds.A.m}, n = {ds.A.n}, nnz/row = {ds.A.zbar:.1f}; teams {tuple(tp.indices.shape)} "
        f"on {tp.values.device} ({time.perf_counter() - t0:.1f} s to generate and stack)")
    check(tp.values.is_cuda and tp.values.dtype == torch.float32, "the problem is not float32 on the card")

    zero_counts, counts = zero_launch_counts, launch_counts

    # ---- phase 3: each kernel against its plain version, on the card ----
    # worst max abs error against the plain version, by (kernel, mode); the
    # bf16 Gram on rows with repeated ids is kept apart (its own tolerance)
    err = {"ell_gram.fp32": 0.0, "ell_gram.bf16": 0.0, "sstep_inner.fp32": 0.0, "sstep_inner.bf16": 0.0,
           "ell_gram_dense.fp32": 0.0, "ell_gram_dense.bf16": 0.0}
    gram_grid = [(8, 1, 10), (64, 24, 1999), (128, 111, 47236), (512, 111, 47236), (128, 540, NEWS20_N),
                 (8, MAX_CHUNK + 1, 5000),  # one entry over a chunk: two tables a row
                 (32, 3 * MAX_CHUNK + 100, 50000),  # four chunks a row
                 (128, 2000, 2000),  # epsilon's dense rows (the distinct-id bundle)
                 (8, 13100, 3145728)]  # synthetic_uniform's width and columns
    edge_shapes = ((64, 111, 47236), (16, MAX_CHUNK + 88, 20000))  # one chunk a row, and two
    gram16_dup_err, bitwise = check_gram(device, err, gram_grid, edge_shapes)
    dense_bitwise = check_gram_dense(device, err)

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

    # the Gram kernel on the bundles the 2 × 2 mesh feeds it: a column shard's
    # block (p_c = 2), ids < n_loc, the mesh layout's ELL width
    prob2, _ = build_2d_problem(ds.A, ds.y, MESH_P, MESH_P, "cyclic", row_multiple=S * B)
    x_loc = torch.from_numpy(np.random.default_rng(301).standard_normal(prob2.n_loc).astype(np.float32) * 0.1).to(device)
    for i, j, r0 in ((0, 1, 0), (MESH_P - 1, 0, prob2.rows_local - S * B)):
        idx = prob2.indices[i, j, r0 : r0 + S * B].to(device).contiguous()
        val = prob2.values[i, j, r0 : r0 + S * B].to(device).contiguous()
        worst = {}
        for mode in ("fp32", "bf16"):
            g, v = ell_gram_and_v(idx, val, x_loc, n=prob2.n_loc, precision=mode)
            g2, v2 = ell_gram_and_v(idx, val, x_loc, n=prob2.n_loc, precision=mode)
            check(bool(torch.all(torch.triu(g) == 0)), f"ell_gram {mode}: triu(G) != 0 on a column shard")
            check(torch.equal(g, g2) and torch.equal(v, v2), f"ell_gram {mode}: two launches differ on a column shard")
            bitwise += 1
            pg, pv = ell_gram_and_v_blocked(idx, val, x_loc, n=prob2.n_loc, bk=512, precision=mode)
            check(float(pg.abs().max()) > 0, "the column-shard bundle has an empty Gram matrix")
            for got, want, name in ((g, pg, "G"), (v, pv, "v")):
                max_abs, max_rel, ok = errors(got, want, GV_TOL)
                check(ok and math.isfinite(max_abs),
                      f"ell_gram {mode} {name} on block ({i}, {j}): max abs {max_abs}, max rel {max_rel}")
                err[f"ell_gram.{mode}"] = max(err[f"ell_gram.{mode}"], max_abs)
                worst[mode] = max(worst.get(mode, 0.0), max_abs)
        log(f"[kernels] ell_gram    column shard ({i}, {j}) of the {MESH_P} × {MESH_P} mesh, rows {r0}.. "
            f"(sb, w, n_loc) = {(S * B, prob2.width, prob2.n_loc)}: max abs err fp32 {worst['fp32']:.3g}, "
            f"bf16 {worst['bf16']:.3g} (tol {GV_TOL}), a second launch bitwise equal")

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
    launches, routes = counts(), route_counts()
    sync()
    losses_host = [float(t) for t in losses]
    log(f"[main] losses by round: {' '.join(f'{t:.5f}' for t in losses_host)}")
    expect_launches("synchronous fp32", launches, {"ell_gram.fp32": expected, "ell_gram.bf16": 0,
                                                   "sstep_inner.fp32": expected, "sstep_inner.bf16": 0})
    _check_routes("the synchronous fp32 path", routes, "hash", {"fp32": expected, "bf16": 0})
    check(x_kernel.shape == (tp.n,) and bool(torch.isfinite(x_kernel).all()), "final x is not finite (n,)")
    check(len(losses_host) == ROUNDS and all(math.isfinite(t) for t in losses_host), "losses are not finite")
    check(losses_host[0] < math.log(2.0), f"first loss {losses_host[0]} is not below ln 2")
    check(losses_host[-1] < losses_host[0], "the loss did not fall")

    # the same schedule on the card with the plain versions only: the blocked
    # panel walk for (G, v) and the PyTorch loop for the corrections (the
    # engine looks `inner_corrections` up when it is called; the launch counts
    # checked below would show a kernel that stayed on this run)
    with plain_corrections():
        x_plain, losses_plain = run_parallel_sgd(
            tp, x0, ParallelSGDSchedule.hybrid(p_r=P_R, s=S, b=B, eta=ETA, tau=TAU, rounds=ROUNDS,
                                               loss_every=1, gram="blocked"))
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

    # (the main path's rounds past the first cycle were replayed from CUDA
    # graphs: the skewed rounds must be captured anew, not replay those)
    captures = round_graph.counts["captures"]
    engine.bundle_gram_v = skewed_gram
    try:
        x_skew, _ = run_parallel_sgd(tp, x0, sched)
        x_ss_skew, _ = run_parallel_sgd(tp1, x0, ParallelSGDSchedule.sstep(8, 16, ETA, 64))
    finally:
        engine.bundle_gram_v = true_gram
    skew_captures = round_graph.counts["captures"] - captures
    skew_gap = float((x_skew - x_plain).abs().max())
    skew_identity_gap = float((x_ss_skew - x_sgd).abs().max())
    log(f"[main] with G off by 1 %: max |Δx| to the plain path {skew_gap:.3g} (limit {X_TOL * x_max:.3g}), "
        f"identity gap {skew_identity_gap:.3g} (limit {IDENTITY_TOL:g}); {skew_captures} round graphs captured anew")
    check(skew_gap > X_TOL * x_max and skew_identity_gap > IDENTITY_TOL,
          "a Gram matrix wrong by 1 % passes the end-to-end limits: they are too loose")
    cycle = round_graph.round_cycle(tp.rows_local, S * B, TAU // S)
    check(skew_captures == max(min(cycle, ROUNDS - cycle), 0),
          f"the skewed run captured {skew_captures} round graphs")

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
    launches16, routes16 = counts(), route_counts()
    sync()
    l16 = [float(t) for t in losses16]
    log(f"[delay] D = {DELAY} bf16 losses by round: {' '.join(f'{t:.5f}' for t in l16)}")
    expect_launches(f"D = {DELAY} bf16", launches16, {"ell_gram.fp32": 0, "ell_gram.bf16": expected,
                                                      "sstep_inner.fp32": expected, "sstep_inner.bf16": 0})
    _check_routes(f"the D = {DELAY} bf16 path", routes16, "hash", {"fp32": 0, "bf16": expected})
    check(x16.shape == (tp.n,) and bool(torch.isfinite(x16).all()), "D = 2 bf16: final x is not finite (n,)")
    check(all(math.isfinite(t) for t in l16) and l16[-1] < l16[0], "D = 2 bf16: the loss did not fall")

    # the same schedule with the plain versions only, and with G off by 1 %
    with plain_corrections():
        x16_plain, _ = run_parallel_sgd(tp, x0, dataclasses.replace(sched16, gram="blocked"))
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

    # ---- the rounds as CUDA graphs, against the eager rounds --------------
    graph = graph_phase(tp, smi)
    print(json.dumps({"graph": graph}), flush=True)

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
    # column shard (0, 0) of the 2 × 2 mesh: the bundles each mesh rank feeds it
    col_idx, col_val = prob2.indices[0, 0].to(device), prob2.values[0, 0].to(device)
    col_offsets = list(range(0, prob2.rows_local - S * B + 1, S * B))

    def col_bundle(k):
        r0 = col_offsets[k % len(col_offsets)]
        return col_idx[r0 : r0 + S * B], col_val[r0 : r0 + S * B]

    # the drift stream's bundles: (128, 16) over n, ids drawn with
    # replacement (repeats), team 0 of one batch (τ/s bundles)
    from repro_torch.serve import DriftStream

    drift_batch = DriftStream(n=tp.n, rows=P_R * TAU * B, width=SERVE_WIDTH, seed=0, drift_at=SERVE_DRIFT_AT).batch(0)
    drift_idx = torch.from_numpy(drift_batch.indices[: TAU * B]).to(device)
    drift_val = torch.from_numpy(drift_batch.ya_values()[: TAU * B]).to(device)

    def drift_bundle(k):
        r0 = (k % (TAU // S)) * S * B
        return drift_idx[r0 : r0 + S * B], drift_val[r0 : r0 + S * B]

    shapes = {"sb128": (S * B, S, B, *team_bundles(S * B), x_now, tp.n),
              "sb512": (512, 16, 32, *team_bundles(512), x_now, tp.n),
              "w540": (128, None, None, lambda k: (news_idx, news_val), 8, news_x, NEWS20_N),
              "col2": (S * B, None, None, col_bundle, len(col_offsets), x_loc, prob2.n_loc),
              "drift16": (S * B, None, None, drift_bundle, TAU // S, x_now, tp.n)}
    report = {}
    inner_inputs = {}  # label: (s, b, G, v) — the corrections' timed inputs
    for label, (sb, s, b, bundle, per_pass, x_in, n_cols) in shapes.items():
        # bounds from this run's inputs (bundle 0), the count the autotuner
        # reads (repro_torch.launch.roofline.probe_bound): bytes each read or
        # written once over the memory rate, against the operations that
        # (G, v) needs over the FP32 rate (the kernel multiplies in fp32 in
        # both modes): one multiply-add per pair of nonzeros of rows i > j
        # that share a column id, one per nonzero for v. The kernel's own
        # work is a table lookup per nonzero of row i and row j < i; that
        # count, at one lookup per FP32 lane and cycle, is printed beside the
        # bound (design_ops_ms), not as it.
        bi, bv = bundle(0)
        w = int(bi.shape[1])
        gram_bound = probe_bound(bi, bv)
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
                bound={"bytes": gram_bound.memory_s * 1e3, "operations": gram_bound.compute_s * 1e3},
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
    gram_routes = time_gram_routes(device)

    ab = None
    args = sys.argv[1:]
    for at in (i for i, a in enumerate(args) if a == "--ab"):
        old_source = ROOT / args[at + 1]
        if "sstep_inner_launch" in old_source.read_text():
            ab = {**(ab or {}), **ab_inner_times(old_source, inner_inputs, _build)}
        elif "ell_gram_dense_launch" in old_source.read_text():
            ab = {**(ab or {}), **ab_dense_times(old_source, device, _build)}
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

    # ---- the Gram autotuner: tune_panel, its cache, a bk=None Session ------
    tuned = tune_phase(tp, smi)
    print(json.dumps({"tune": tuned}), flush=True)

    # ---- the front door: spec → plan → Session → report → sweep ----------
    front = front_door_phase(tp, zero_counts, counts, smi)
    print(json.dumps({"front_door": front}), flush=True)

    # ---- streaming and serving: stream → Session.step_stream → store → service/HTTP
    serve = serve_phase(err, smi)
    gram16_dup_err = max(gram16_dup_err, serve["gram_bf16_repeated_ids_err"])
    print(json.dumps({"serve": {"card": smi, **serve}}), flush=True)

    # ---- the 2D mesh: 1 × 1 over NCCL, 2 × 2 of four processes on the card --
    mesh = mesh_phase(smi)
    print(json.dumps({"mesh": mesh}), flush=True)

    # ---- the paper's grid: full news20 at (1, 4), (2, 2), (4, 1), gloo ----
    paper_mesh = paper_mesh_phase(smi, datasets=("news20",), ranks_backend="gloo")
    print(json.dumps({"paper_mesh": paper_mesh}), flush=True)

    # ---- the paper's other datasets: news20, epsilon, url (rows cut) -------
    paper = paper_phase(smi, sweep=sweep_cli)
    print(json.dumps({"paper": paper}), flush=True)
    log(f"[mem  ] device memory held after the solver's phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    print(json.dumps({"lm": lm}), flush=True)
    print(json.dumps({"zoo": zoo}), flush=True)
    print(json.dumps({"model_mesh": model_mesh}), flush=True)

    # ---- phase 6: the kernels line, the device lines ---------------------
    # each (kernel, mode) with its launches on the path that runs it: the
    # synchronous fp32 path for both fp32 modes, the D = 2 bf16 path for the
    # bf16 Gram. No engine path runs the bf16 corrections (the reference's
    # engine unwires (G, v) to fp32 first): phase 3 alone launches that mode.
    paths = {"ell_gram.fp32": ("synchronous fp32", launches), "sstep_inner.fp32": ("synchronous fp32", launches),
             "ell_gram.bf16": (f"D = {DELAY} bf16", launches16), "sstep_inner.bf16": (None, None)}
    # the stream paths' launches (serve phase): replay fp32, replay D = 2
    # bf16, the drift stream behind the prediction service
    stream_runs = {"replay_fp32": serve["launches_replay_fp32"],
                   f"replay_delay{DELAY}_bf16": serve["launches_replay_delay2_bf16"], "drift": serve["launches_drift"]}
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
            "launches_stream": {run: got[key] for run, got in stream_runs.items()},
            **{label: {k: report[label][key][k] for k in TIMED_KEYS} for label in ("sb512", "w540", "col2", "drift16")
               if key in report[label]},
        })
        if name == "ell_gram":  # the autotuner's (tile, ks) for rcv1's profile beside the default's
            prof = tuned["profiles"][f"rcv1_{mode}"]
            kernels[-1]["tuned"] = {k: prof[k] for k in ("tile", "ks", "ms", "default", "default_ms", "bound_ms")}
        # the paper phase: launches on each dataset's paths, and the kernel on
        # one real bundle of each dataset
        kernels[-1]["launches_paper"] = paper_launches(paper, key)
        kernels[-1]["launches_paper_mesh"] = {f"{name}.{label}": run["launches_per_rank"][key]
                                              for name, row in paper_mesh["datasets"].items()
                                              for label, run in row["runs"].items()}
        kernels[-1]["paper"] = {name: {k: row["engine"]["kernels"][key][k] for k in TIMED_KEYS if k in row["engine"]["kernels"][key]}
                                | row["engine"]["bundle"] for name, row in paper["datasets"].items()
                                if key in row["engine"]["kernels"]}
        if key == "ell_gram.bf16":  # rows that repeat a column id, at BF16_DUP_TOL
            kernels[-1].update(max_abs_err_repeated_ids=gram16_dup_err, tol_repeated_ids=BF16_DUP_TOL)
        if name == "ell_gram":  # the main path's launches by route
            kernels[-1]["launches_by_route"] = {r: (routes if mode == "fp32" else routes16)[f"{r}.{mode}"]
                                                for r in ("hash", "dense")}
    # the dense route: its path is epsilon's through the engine (the paper
    # phase's fp32 D = 0 run, and D = 2 bf16 for the bf16 mode), its times
    # those of epsilon's first bundle (its plain version the route's own)
    eps = paper["datasets"]["epsilon"]["engine"]
    for mode, run in (("fp32", "fp32_d0"), ("bf16", f"bf16_d{DELAY}")):
        row = eps["kernels"][f"ell_gram.{mode}"]
        got = eps["runs"][run]["launches_by_route"]
        check(got[f"dense.{mode}"] > 0, f"epsilon's {run} path never launched the dense route in {mode}")
        kernels.append({
            "name": "ell_gram_dense" if mode == "fp32" else "ell_gram_dense_bf16", "precision": mode, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ell_gram_dense.cu", "replaces": "src/repro/kernels/ell_gram.py:170",
            "launches": got[f"dense.{mode}"], "path": f"epsilon {run} (paper phase)",
            "launches_by_route": {r: got[f"{r}.{mode}"] for r in ("hash", "dense")},
            "max_abs_err": max(err[f"ell_gram_dense.{mode}"], row["max_abs_err"]), "tol": GV_TOL,
            "ms": row["ms"], "eager_ms": row["eager_ms"], "hash_ms": row["hash_ms"], "plain_ms": row["dense_plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "launch_floor_ms": launch_floor_ms, "shape": eps["bundle"],
            "launches_paper": {f"{name}.{label}": r["launches_by_route"][f"dense.{mode}"]
                               for name, drow in paper["datasets"].items()
                               for runs in (drow["engine"]["runs"], drow["corners"], drow.get("front_door", {}))
                               for label, r in runs.items()},
            "shapes": {label: {"sb": t["sb"], "w": t["w"], "n": t["n"], **{k: t[mode][k] for k in (
                "ms", "eager_ms", "dense_ms", "hash_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
                       for label, t in gram_routes["shapes"].items()},
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "round_ms": round_ms, "round_ms_delay2_bf16": round16_ms, "eta": ETA,
                      "build_s": build_s, "rmatvec_ms": rmat_ms, "path_gap": path_gap, "rerun_gap": rerun_gap,
                      "x_max": x_max, "identity_gap": gap, "skew_gap": skew_gap, "skew_identity_gap": skew_identity_gap,
                      "delay2_bf16_path_gap": gap16, "delay2_bf16_skew_gap": skew16, "delay2_bf16_vs_fp32": bf16_gap,
                      "delay2_vs_delay0": delay_gap, "ledger_capture_s": [capture_s, capture2_s],
                      "ledger_delay2_bf16": led16.to_dict(), "ab": ab, "sweep": sweep,
                      "gram_crossover": {k: gram_routes[k] for k in ("crossover", "crossover_min_width", "crossover_ratio",
                                                                     "dense_min_width", "dense_ratio")},
                      "dense_bitwise_checks": dense_bitwise}), flush=True)
    log(f"[done ] the run took {time.perf_counter() - started:.1f} s")
    device_line()


if __name__ == "__main__":
    main()
