"""CUDA graphs of the simulated engine's resident rounds.

A round of the simulated engine is a few hundred small launches (4 teams
× 8 bundles × ~7 on rcv1) whose device work takes under a tenth of the
host's time to issue them. Its launches depend on the round index only
through the bundle offsets, and those repeat every ``round_cycle``
rounds, so a resident team problem's rounds are captured once per round
residue r mod cycle and replayed after that: one ``CUDAGraph.replay()``
for all teams, all bundles and the team mean.

``engine._run_rounds`` sends the rounds of ``gram="kernel"`` here when
no comm recorder is installed; the rounds of CUDA tensors are graphed.
This module keeps the cache:

* one ``RoundGraphs`` per (team problem, schedule, geometry, x dtype,
  the problem's tensors as the graphs read them), the problem held by weak
  reference, so its graphs go when it does;
* inside it one graph per (residue, the round's late-bound functions),
  captured the *second* time that key is seen — the first sight runs
  eagerly and doubles as the warm-up, and a problem that runs one round
  (every stream round) is never captured;
* each team's chain on a side stream of its own inside the graph, forked
  from the capture stream and joined before the mean, so the teams'
  kernels overlap on the device (2.2–2.3× faster a round than the teams
  in series on an H100, ``PERF.md``);
* one static iterate ``x`` per ``RoundGraphs``, allocated outside any
  capture: each graph reads it and ends by copying the new mean into it.
  Nothing allocated inside a capture outlives it, so the graphs of one
  ``RoundGraphs`` share one memory pool whatever round a chunk starts at;
* the launch counters stay true: a capture runs no kernel, so the counts
  its wrappers add are taken back, and each replay adds the counts its
  graph holds.

A cycle above ``CYCLE_CAP`` rounds runs eagerly. The bookkeeping is
plain Python; ``GRAPH`` (the class that makes pools and side streams,
captures and replays) is looked up when a round is captured, so a test
can put a stand-in there.
"""

from __future__ import annotations

import collections
import math
import weakref

import torch

from repro_torch.kernels.ell_gram import ell_gram_and_v
from repro_torch.kernels.sstep_inner import sstep_inner

# the most graphs one (problem, schedule, geometry) may hold: a longer
# cycle runs its rounds eagerly (rcv1's is 5 at s·b = 128, τ = 32)
CYCLE_CAP = 16

# captures and replays since the process started (or a caller zeroed them)
counts = {"captures": 0, "replays": 0}


def round_cycle(rows_local: int, sb: int, bundles: int) -> int:
    """The period, in rounds, of the bundle starts a round slices
    (``engine.bundle_start`` of k0 = r·bundles + t, t < bundles): 1 when
    a team holds at most one bundle (every start clamps to 0), else
    rows_local / gcd(rows_local, bundles·sb). The start of bundle 0 takes
    a distinct value in each round of that period, clamped or not, so no
    shorter period exists."""
    if rows_local <= sb:
        return 1
    return rows_local // math.gcd(rows_local, bundles * sb)


# the kernel wrappers whose ``launches`` counts a graph holds
_KERNELS = {"ell_gram": ell_gram_and_v, "sstep_inner": sstep_inner}


def _counters() -> dict:
    """{counter: {mode: launches}}: each wrapper's ``launches``, and the
    Gram wrapper's count by route ("ell_gram.hash", "ell_gram.dense")."""
    out = {name: fn.launches for name, fn in _KERNELS.items()}
    out.update({f"ell_gram.{route}": counts for route, counts in ell_gram_and_v.route_launches.items()})
    return out


def _launch_counts() -> dict:
    """{(counter, mode): launches} of the kernel wrappers, read now."""
    return {(name, mode): n for name, counts in _counters().items() for mode, n in counts.items()}


def _add_launches(delta: dict, sign: int = 1) -> None:
    counters = _counters()
    for (name, mode), n in delta.items():
        counters[name][mode] += sign * n


class CudaRoundGraph:
    """``out.copy_(fn())`` captured into a ``torch.cuda.CUDAGraph`` on a
    side stream, its allocations in ``pool``. ``capture_error_mode=
    "thread_local"``: other threads (a serving plane's clients) may use
    the card meanwhile. A failed capture raises."""

    new_pool = staticmethod(torch.cuda.graph_pool_handle)

    @staticmethod
    def can_capture(x: torch.Tensor) -> bool:
        return x.is_cuda

    @staticmethod
    def side_streams(n: int) -> list | None:
        """The teams' streams inside a graph (None: the teams in series)."""
        return [torch.cuda.Stream() for _ in range(n)] if n > 1 else None

    def __init__(self, fn, out: torch.Tensor, pool):
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out.copy_(fn())
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)

    def replay(self) -> None:
        self.graph.replay()


GRAPH = CudaRoundGraph


class RoundGraphs:
    """The captured rounds of one (team problem, schedule, geometry, x
    dtype) — see the module note."""

    def __init__(self, cycle: int, teams: int):
        self.cycle, self.teams = cycle, teams
        self.seen = collections.Counter()
        self.graphs = {}  # key → (graph, {(kernel, mode): launches})
        self.x = None  # the static iterate
        self.pool = None
        self.streams = None  # the teams' side streams

    def round(self, x: torch.Tensor, r: int, bindings: tuple, body) -> torch.Tensor:
        """Round ``r`` from ``x``: ``body(x, streams)`` eagerly (the first
        sight of its key), or its graph, captured now if this is the
        second. The result of a replay is the static iterate: the caller
        copies it before handing it out (``release``)."""
        key = (r % self.cycle, bindings)
        held = self.graphs.get(key)
        if held is None:
            self.seen[key] += 1
            if self.seen[key] < 2:
                return body(x, None)
            held = self.graphs[key] = self._capture(x, body)
        if x is not self.x:
            self.x.copy_(x)
        graph, launches = held
        graph.replay()
        _add_launches(launches)
        counts["replays"] += 1
        return self.x

    def _capture(self, x: torch.Tensor, body):
        if self.x is None:
            self.x = torch.empty_like(x)
        if self.pool is None:
            self.pool = GRAPH.new_pool()
            self.streams = GRAPH.side_streams(self.teams)
        before = _launch_counts()
        try:
            graph = GRAPH(lambda: body(self.x, self.streams), self.x, self.pool)
        finally:  # the capture launched nothing, whether or not it held
            launches = {k: n - before[k] for k, n in _launch_counts().items() if n != before[k]}
            _add_launches(launches, -1)
        counts["captures"] += 1
        return graph, launches

    def release(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the caller may keep it: a copy where it is the static
        iterate, which the next replay overwrites."""
        return x.clone() if x is self.x else x


# id(team problem) → (weak reference to it, {key: RoundGraphs})
_CACHE: dict[int, tuple[weakref.ref, dict]] = {}


def graphs_for(tp, x: torch.Tensor, sched, geometry) -> RoundGraphs | None:
    """The ``RoundGraphs`` of ``tp`` under ``sched`` and ``geometry``
    (made on first use), or None where ``GRAPH`` cannot capture ``x``'s
    device (CUDA only) or the cycle exceeds ``CYCLE_CAP``."""
    sb, bundles = sched.s * sched.b, sched.tau // sched.s
    cycle = round_cycle(tp.rows_local, sb, bundles)
    if not GRAPH.can_capture(x) or cycle > CYCLE_CAP:
        return None
    key_tp = id(tp)
    if key_tp not in _CACHE:
        _CACHE[key_tp] = (weakref.ref(tp, lambda _, k=key_tp: _CACHE.pop(k, None)), {})
    by_key = _CACHE[key_tp][1]
    # the graphs read the problem's tensors at the addresses they had when
    # captured: a problem whose fields were rebound gets graphs of its own
    key = (sched, None if geometry is None else tuple(geometry), x.dtype, tp.indices.data_ptr(),
           tp.values.data_ptr(), tuple(tp.indices.shape), tp.n, tp.objective)
    if key not in by_key:
        by_key[key] = RoundGraphs(cycle, tp.p)
    return by_key[key]


def graphs_of(tp) -> list[RoundGraphs]:
    """Every ``RoundGraphs`` the cache holds for ``tp``."""
    ref, by_key = _CACHE.get(id(tp), (None, {}))
    return list(by_key.values()) if ref is not None and ref() is tp else []
