"""The simulated engine's round graphs (``repro_torch.core.round_graph``)
on the CPU: the cache's bookkeeping, driven through ``run_engine_chunk``
and ``run_parallel_sgd`` with a stand-in for ``torch.cuda.CUDAGraph``
whose capture runs the round's Python once, as a real capture does, and
whose replay runs it again. The graphs themselves (CUDA only) are held
against the eager rounds on the card by ``chip_smoke.py``'s graph phase."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import engine, round_graph
from repro_torch.core.comm import capture_rates
from repro_torch.core.engine import ParallelSGDSchedule, run_engine_chunk, run_parallel_sgd
from repro_torch.core.teams import team_problem_from_numpy
from repro_torch.kernels.ell_gram import ell_gram_and_v
from repro_torch.kernels.sstep_inner import sstep_inner

P, ROWS, WIDTH, N = 2, 64, 5, 50
# p_r = 2, s·b = 8, τ/s = 4 bundles a round over 64 rows a team: a cycle of 2
SCHEDULES = {
    "sync_fp32": ParallelSGDSchedule.hybrid(p_r=P, s=2, b=4, eta=0.5, tau=8, rounds=6, loss_every=2),
    "d2_bf16": ParallelSGDSchedule.hybrid(p_r=P, s=2, b=4, eta=0.5, tau=8, rounds=6, loss_every=2,
                                          delay=2, precision="bf16"),
    "fedavg": ParallelSGDSchedule.fedavg(P, 4, 0.5, 8, 6, loss_every=2),
}
SYNC = SCHEDULES["sync_fp32"]


class FakeGraph:
    """``CudaRoundGraph``'s stand-in on the CPU. Its capture runs the
    round's Python once and keeps nothing of it, as a real capture (which
    records the launches) does; a replay runs ``out.copy_(fn())`` and puts
    the launch counters back, since a real replay runs no Python."""

    new_pool = staticmethod(lambda: (0, 0))  # a pool handle is a pair of ids
    side_streams = staticmethod(lambda n: None)
    can_capture = staticmethod(lambda x: x.device.type == "cpu")

    def __init__(self, fn, out, pool):
        self.fn, self.out = fn, out
        fn()

    def replay(self):
        saved = {fn: dict(fn.launches) for fn in (ell_gram_and_v, sstep_inner)}
        self.out.copy_(self.fn())
        for fn, launches in saved.items():
            fn.launches.update(launches)


class ForgetfulGraph(FakeGraph):
    """A stand-in that, like a CUDA graph, keeps no Python reference to
    what it captured (its replays compute nothing)."""

    def __init__(self, fn, out, pool):
        pass

    def replay(self):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """The stand-in in place, an empty cache, counts from zero."""
    monkeypatch.setattr(round_graph, "GRAPH", FakeGraph)
    monkeypatch.setattr(round_graph, "_CACHE", {})
    monkeypatch.setattr(round_graph, "counts", {"captures": 0, "replays": 0})
    monkeypatch.setattr(ell_gram_and_v, "launches", {"fp32": 0, "bf16": 0})
    monkeypatch.setattr(sstep_inner, "launches", {"fp32": 0, "bf16": 0})


def _problem(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, size=(P, rows, WIDTH)).astype(np.int32)
    val = (rng.standard_normal((P, rows, WIDTH)) / np.sqrt(WIDTH)).astype(np.float32)
    return team_problem_from_numpy(idx, val, np.ones((P, rows), bool), p=P, m=P * rows, n=N,
                                   device="cpu")


def _x0(seed=1):
    return torch.from_numpy((0.1 * np.random.default_rng(seed).standard_normal(N)).astype(np.float32))


def _eager(tp, x, rounds, sched):
    """The rounds as the engine ran them before it had graphs."""
    for r in rounds:
        x = engine._one_round(tp, x, r, np.float32(sched.eta), sched)
    return x


def _counting(fn, kernel):
    """``fn`` adding one to ``kernel``'s fp32 count a call, as a kernel
    wrapper does where it launches."""
    def wrapped(*args, **kwargs):
        kernel.launches["fp32"] += 1
        return fn(*args, **kwargs)

    return wrapped


def _skewed(name, fn):
    """``fn`` with its result off by 1 %: the Gram matrix, or u."""
    def skewed(*args, **kwargs):
        out = fn(*args, **kwargs)
        return (out[0] * 1.01, out[1]) if name == "bundle_gram_v" else out * 1.01

    return skewed


# ---------------- the cycle ----------------


@settings(max_examples=200, deadline=None)
@given(rows_local=st.integers(1, 200), s=st.integers(1, 4), b=st.integers(1, 6), k=st.integers(1, 5))
def test_cycle_is_the_period_of_the_bundle_starts(rows_local, s, b, k):
    sb, bundles = s * b, k

    def starts(r):
        return tuple(engine.bundle_start(r * bundles + t, sb, rows_local) for t in range(bundles))

    # the starts repeat every rows_local rounds; their least period divides it
    period = next(d for d in range(1, rows_local + 1) if rows_local % d == 0
                  and all(starts(r + d) == starts(r) for r in range(rows_local)))
    assert round_graph.round_cycle(rows_local, sb, bundles) == period


def test_cycle_of_the_main_path():
    # rcv1 over 4 teams padded to 128-row bundles: 5,120 rows, 8 bundles a round
    assert round_graph.round_cycle(5120, 128, 8) == 5
    assert round_graph.round_cycle(ROWS, 8, 4) == 2


def test_a_cycle_above_the_cap_runs_eagerly(fake_graphs):
    tp = _problem(rows=8 * (round_graph.CYCLE_CAP + 1))  # gcd with 32 is 8: cycle CAP + 1
    assert round_graph.round_cycle(tp.rows_local, 8, 4) == round_graph.CYCLE_CAP + 1
    x = run_engine_chunk(tp, _x0(), 0, 3 * (round_graph.CYCLE_CAP + 1), SYNC)
    assert round_graph.counts == {"captures": 0, "replays": 0}
    assert torch.equal(x, _eager(tp, _x0(), range(3 * (round_graph.CYCLE_CAP + 1)), SYNC))


# ---------------- when a round is captured ----------------


def test_a_residue_is_captured_on_its_second_sight(fake_graphs):
    tp = _problem()
    x = _x0()
    for r in range(2):  # each residue once: eager
        x = run_engine_chunk(tp, x, r, 1, SYNC)
    assert round_graph.counts == {"captures": 0, "replays": 0}
    x = run_engine_chunk(tp, x, 2, 1, SYNC)  # residue 0 again: captured, replayed
    assert round_graph.counts == {"captures": 1, "replays": 1}
    x = run_engine_chunk(tp, x, 3, 3, SYNC)  # residue 1 captured; then both replayed
    assert round_graph.counts == {"captures": 2, "replays": 4}
    (graphs,) = round_graph.graphs_of(tp)
    assert sorted(key[0] for key in graphs.graphs) == [0, 1]
    assert torch.equal(x, _eager(tp, _x0(), range(6), SYNC))


def test_a_problem_that_runs_one_round_is_never_captured(fake_graphs):
    for seed in range(4):
        run_engine_chunk(_problem(seed), _x0(), 0, 1, SYNC)
    assert round_graph.counts["captures"] == 0


def test_a_stream_session_captures_no_graph(fake_graphs):
    from repro_torch.api import ExperimentSpec, MeshSpec, Session, StreamSpec
    from repro_torch.serve import make_stream_source

    spec = ExperimentSpec(dataset="rcv1-sm", schedule=dataclasses.replace(SYNC, rounds=6),
                          mesh=MeshSpec(p_r=P, p_c=1, backend="simulated"),
                          stream=StreamSpec(source="drift", seed=3))
    sess = Session(spec, device="cpu")
    while not sess.done:
        sess.step_stream(make_stream_source(spec), 1)
    assert sess.rounds_done == 6
    assert round_graph.counts == {"captures": 0, "replays": 0}


def test_a_comm_recorder_keeps_the_rounds_eager(fake_graphs):
    tp = _problem()
    capture_rates(lambda: run_engine_chunk(tp, _x0(), 0, 6, SYNC), spans={"cols": 1, "rows": P})
    assert round_graph.counts == {"captures": 0, "replays": 0}


@pytest.mark.parametrize("name", ["bundle_gram_v", "inner_corrections"])
def test_rebinding_a_round_function_captures_anew(fake_graphs, monkeypatch, name):
    tp = _problem()
    x_true = run_engine_chunk(tp, _x0(), 0, 4, SYNC)  # both residues captured
    assert round_graph.counts["captures"] == 2
    monkeypatch.setattr(engine, name, _skewed(name, getattr(engine, name)))
    x_skew = run_engine_chunk(tp, _x0(), 0, 4, SYNC)
    assert round_graph.counts == {"captures": 4, "replays": 4}  # a new key: eager twice, then captured
    assert torch.equal(x_skew, _eager(tp, _x0(), range(4), SYNC))
    assert not torch.equal(x_skew, x_true)
    (graphs,) = round_graph.graphs_of(tp)
    assert len(graphs.graphs) == 4


def test_a_capture_keeps_the_launch_counts_and_each_replay_adds_its_graphs(fake_graphs, monkeypatch):
    monkeypatch.setattr(engine, "bundle_gram_v", _counting(engine.bundle_gram_v, ell_gram_and_v))
    monkeypatch.setattr(engine, "inner_corrections", _counting(engine.inner_corrections, sstep_inner))
    tp = _problem()
    per_round = P * (SYNC.tau // SYNC.s)
    x = _x0()
    for r in range(6):
        before = round_graph._launch_counts()
        x = run_engine_chunk(tp, x, r, 1, SYNC)
        assert ell_gram_and_v.launches["fp32"] - before[("ell_gram", "fp32")] == per_round
        assert sstep_inner.launches["fp32"] - before[("sstep_inner", "fp32")] == per_round
    assert round_graph.counts == {"captures": 2, "replays": 4}
    (graphs,) = round_graph.graphs_of(tp)
    for _, launches in graphs.graphs.values():
        assert launches == {("ell_gram", "fp32"): per_round, ("sstep_inner", "fp32"): per_round}
    run_parallel_sgd(tp, _x0(), SYNC)
    assert ell_gram_and_v.launches == sstep_inner.launches == {"fp32": 12 * per_round, "bf16": 0}


def test_the_cache_drops_a_problems_graphs_with_the_problem(fake_graphs, monkeypatch):
    monkeypatch.setattr(round_graph, "GRAPH", ForgetfulGraph)
    tp = _problem()
    run_engine_chunk(tp, _x0(), 0, 4, SYNC)
    (graphs,) = round_graph.graphs_of(tp)
    assert len(graphs.graphs) == 2 and graphs.x is not None
    gone = weakref.ref(graphs)
    del tp, graphs
    gc.collect()
    assert gone() is None and round_graph._CACHE == {}


# ---------------- what the rounds compute ----------------


@pytest.mark.parametrize("label", sorted(SCHEDULES))
def test_cpu_rounds_stay_bitwise_the_eager_loop(label):
    # no stand-in: CPU tensors are never graphed, and the results are the
    # eager loop's, chunked or not
    sched = SCHEDULES[label]
    tp, x0 = _problem(), _x0()
    x, losses = run_parallel_sgd(tp, x0, sched)
    assert torch.equal(x, _eager(tp, x0, range(sched.rounds), sched))
    assert losses.shape == (3,)
    x_chunked = x0
    for offset in range(0, sched.rounds, 2):
        x_chunked = run_engine_chunk(tp, x_chunked, offset, 2, sched)
    assert torch.equal(x_chunked, x)
    assert round_graph.graphs_of(tp) == []


@pytest.mark.parametrize("label", sorted(SCHEDULES))
def test_graphed_rounds_equal_the_eager_ones(fake_graphs, label):
    sched = SCHEDULES[label]
    tp, x0 = _problem(), _x0()
    x0_before = x0.clone()
    want = _eager(tp, x0, range(12), sched)
    x_whole = run_engine_chunk(tp, x0, 0, 12, sched)
    assert round_graph.counts["replays"] > 0
    assert torch.equal(x_whole, want)
    # chunks starting at any round, on the same graphs, from the same x0
    x = x0
    for offset, k in ((0, 1), (1, 3), (4, 2), (6, 5), (11, 1)):
        x = run_engine_chunk(tp, x, offset, k, sched)
    assert torch.equal(x, want)
    (graphs,) = round_graph.graphs_of(tp)
    # the caller's x0 is untouched, and what a chunk returned survives
    # later replays over the static iterate
    kept = x_whole.clone()
    run_engine_chunk(tp, x0, 3, 6, sched)
    assert torch.equal(x0, x0_before) and torch.equal(x_whole, kept)
    assert x_whole is not graphs.x and x is not graphs.x
    x_sgd, losses = run_parallel_sgd(tp, x0, dataclasses.replace(sched, rounds=12, loss_every=3))
    assert torch.equal(x_sgd, want) and losses.shape == (4,)
