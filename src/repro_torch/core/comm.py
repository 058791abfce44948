"""The communication plane of the simulated engine, with a per-round
communication ledger.

The paper's thesis is that communication, not compute, bounds parallel
SGD (Eq. 4, Tables 2–3). Every collective the round body issues goes
through one ``Collectives`` object, and the structure of what was
issued — op, mesh axis, span, payload words, bytes per word, calls per
round — is recorded into a ``CommLedger`` that reports place next to
the Hockney model's predictions (repro_torch.costmodel).

Three kinds:

  counting   the simulated engine's ops. Numerically the identity /
             plain team mean (the simulated ranks already hold globally
             reduced values), but the call sites are the ones a mesh
             reduces over — so counting them *is* counting the
             algorithm's communication.
  mesh       the 2D-mesh backend's ops (repro_torch.core.distributed):
             ``torch.distributed.all_reduce`` over the "cols" process
             group (the per-bundle (G, v) sum) and over the "rows" group
             followed by a division by p_r (the per-round weight
             average). The groups ride on the instance (``groups``),
             bound by the driver from the ``ProcessMesh``.
  timed      the mesh ops; the driver also waits for each round and
             records its wall seconds (the §6.5 calibration input).

Ledger capture is *structural*, not statistical: ``capture_rates`` runs
the actual round body once on ``device="meta"`` tensors (shapes and
dtypes, no data, no arithmetic) with a recorder installed; every
collective call records its span and payload from the real shapes and
dtypes. A collective added to (or dropped from) a round body is seen at
once — the ledger cannot drift from the code the way a hand-kept
formula can. Outside ``capture_rates`` nothing records (the recorder is
a ContextVar), so real runs are untouched. The round body runs its
Python loops over teams and bundles, so one call site executes many
times during the capture; the recorder keeps each distinct rate once,
in the order first seen — the per-rank rate of that site, which is what
the reference's abstract trace records.

Accounting conventions (shared with the Table 2–3 closed forms in
``repro_torch.costmodel.hockney.schedule_comm_volume``):

* words are **per rank** per call, counted from the buffers actually
  reduced — the dense (sb, sb) Gram block plus the (sb,) residual, i.e.
  s²b² + sb words per bundle (the strictly-lower-triangular s(s-1)b²/2
  of Table 3 is the payload's information content; the wire carries the
  dense block);
* a collective whose span is 1 rank moves nothing: it is recorded (the
  call exists) but contributes zero words and zero calls to the counted
  totals;
* the column weight-sync payload is the per-rank weight shard —
  ⌈n/p_c⌉ words under a balanced partition.

The JSON forms (``CommRate.to_dict`` / ``CommLedger.to_dict``) are the
reference's, key for key: each side loads the other's files.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from contextvars import ContextVar

import torch
import torch.distributed as dist

__all__ = [
    "COUNTING",
    "MESH",
    "TIMED",
    "Collectives",
    "CommLedger",
    "CommRate",
    "capture_rates",
    "time_dispatch",
    "time_phase",
]

COLLECTIVE_KINDS = ("counting", "mesh", "timed")


@dataclasses.dataclass(frozen=True)
class CommRate:
    """One collective call site of a round body, as captured.

    op              "allreduce" (sum) or "allmean" (average).
    axis            mesh axis reduced over: "cols" (row-team Gram
                    Allreduce) or "rows" (column weight sync).
    span            ranks the collective spans (p_c for "cols", p_r for
                    "rows"); span 1 moves no bytes.
    words_per_call  per-rank payload words of one call.
    calls_per_round how many times the site executes per outer round
                    (the s-bundle loop issues τ/s Gram Allreduces).
    word_bytes      on-wire bytes per word of this payload, captured
                    from the payload's dtype (2 for a bf16 (G, v)
                    collective, 4 for fp32 — the default). The word
                    *counts* above stay the Table 2–3 closed forms
                    regardless of precision; this is the β multiplier's
                    other factor.
    """

    op: str
    axis: str
    span: int
    words_per_call: int
    calls_per_round: int
    word_bytes: int = 4

    @property
    def phases_per_call(self) -> int:
        """Hockney latency phases: 2⌈log₂ span⌉ (reduce-scatter +
        all-gather), 0 when the span is a single rank."""
        if self.span <= 1:
            return 0
        return 2 * math.ceil(math.log2(self.span))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.word_bytes == 4:
            # emitted only when non-default: fp32 ledgers serialize
            # without the key, as the reference's do.
            del d["word_bytes"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CommRate":
        return cls(**d)


@dataclasses.dataclass
class CommLedger:
    """What a run communicated: captured per-round rates × committed
    rounds, plus (timed runs) host-measured per-round wall seconds.

    rates          the round body's collective call sites (captured
                   once; identical every round — the schedule is
                   static).
    rounds         rounds accounted so far (the caller commits them as
                   it advances).
    round_seconds  per-round wall seconds, appended by a timed run;
                   empty for counting runs.
    phase_seconds  per-round seconds attributed to each §6.5 phase
                   ("bundle_compute" / "allreduce_gv" / "param_avg"),
                   measured by the phase probes (``engine_phase_probes``
                   + ``time_phase``) outside the training step.
    delay          the schedule's staleness D. D ≥ 1 pipelines the
                   (G, v) Allreduce D bundles deep, so each collective
                   has D bundle-computes to hide behind — the exposed
                   (critical-path) comm time drops below the total
                   while the counted volume is unchanged.
    """

    rates: tuple[CommRate, ...] = ()
    rounds: int = 0
    round_seconds: list[float] = dataclasses.field(default_factory=list)
    phase_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    delay: int = 0

    # ---- accumulation (by the caller that runs the rounds) ----

    def add_rounds(self, k: int) -> None:
        self.rounds += int(k)

    def add_round_seconds(self, dt: float) -> None:
        self.round_seconds.append(float(dt))

    def set_phase_seconds(self, phases: dict[str, float]) -> None:
        self.phase_seconds = {k: float(v) for k, v in phases.items()}

    def snapshot(self) -> "CommLedger":
        """An independent copy."""
        return CommLedger(
            rates=self.rates,
            rounds=self.rounds,
            round_seconds=list(self.round_seconds),
            phase_seconds=dict(self.phase_seconds),
            delay=self.delay,
        )

    # ---- counted totals (span-1 collectives move nothing) ----

    def _per_round(self, axis: str, field: str) -> int:
        return sum(
            getattr(r, field) * (r.calls_per_round if field != "calls_per_round" else 1)
            for r in self.rates
            if r.axis == axis and r.span > 1
        )

    def counted_words(self, rounds: int | None = None) -> dict[str, float]:
        """Per-rank communicated words over ``rounds`` (default: the
        committed count) — same keys as the modeled dict, so reports can
        print the two side by side."""
        r = self.rounds if rounds is None else int(rounds)
        gram = float(r * self._per_round("cols", "words_per_call"))
        sync = float(r * self._per_round("rows", "words_per_call"))
        return {"gram_words": gram, "sync_words": sync, "total_words": gram + sync}

    def counted_calls(self, rounds: int | None = None) -> dict[str, int]:
        """Collective calls that actually spanned >1 rank."""
        r = self.rounds if rounds is None else int(rounds)
        return {
            "gram_calls": r * self._per_round("cols", "calls_per_round"),
            "sync_calls": r * self._per_round("rows", "calls_per_round"),
        }

    def phases_per_round(self) -> int:
        """Hockney α-phases per round: Σ calls · 2⌈log₂ span⌉."""
        return sum(
            r.calls_per_round * r.phases_per_call for r in self.rates if r.span > 1
        )

    def bytes_per_round(self, word_bytes: int | None = None) -> float:
        """On-wire bytes per rank per round (the β multiplier).

        With ``word_bytes=None`` each call site is priced at its own
        captured ``word_bytes`` (so a bf16 (G, v) Allreduce counts half
        the fp32 bytes); an explicit ``word_bytes`` prices every word at
        that size (the uniform calibration pricing)."""
        if word_bytes is None:
            return float(sum(
                r.words_per_call * r.calls_per_round * r.word_bytes
                for r in self.rates
                if r.span > 1
            ))
        return float(word_bytes) * (
            self._per_round("cols", "words_per_call")
            + self._per_round("rows", "words_per_call")
        )

    def counted_bytes(self, rounds: int | None = None) -> dict[str, float]:
        """Per-rank on-wire bytes over ``rounds``, at each call site's
        captured ``word_bytes`` — the precision-aware twin of
        ``counted_words`` (whose word counts are invariant)."""
        r = self.rounds if rounds is None else int(rounds)

        def axis_bytes(axis):
            return float(r * sum(
                rt.words_per_call * rt.calls_per_round * rt.word_bytes
                for rt in self.rates
                if rt.axis == axis and rt.span > 1
            ))

        gram, sync = axis_bytes("cols"), axis_bytes("rows")
        return {"gram_bytes": gram, "sync_bytes": sync, "total_bytes": gram + sync}

    # ---- measured (timed runs) ----

    @property
    def seconds_per_round(self) -> float | None:
        """Median measured round wall (None when the run was untimed)."""
        if not self.round_seconds:
            return None
        return statistics.median(self.round_seconds)

    @property
    def total_comm_s(self) -> float | None:
        """Total communication time over the committed rounds: the
        per-round comm phases ("allreduce_gv" + "param_avg") × rounds —
        what the run pays on the wire regardless of overlap. None until
        the phase probes have run."""
        comm = [v for k, v in self.phase_seconds.items() if k != "bundle_compute"]
        if not comm:
            return None
        return float(sum(comm)) * self.rounds

    @property
    def exposed_comm_s(self) -> float | None:
        """Communication time on the *critical path* over the committed
        rounds. At delay 0 nothing overlaps, so exposed ≡ total. At
        delay D ≥ 1 each per-bundle (G, v) Allreduce is consumed D
        bundles after it is issued, so it has D bundle-computes to hide
        behind: the exposed Gram-phase remainder per round is
        max(allreduce_gv − D · bundle_compute, 0). The parameter average
        stays synchronous at the round boundary and is always exposed.
        None until the phase probes have run."""
        comm = {k: v for k, v in self.phase_seconds.items() if k != "bundle_compute"}
        if not comm:
            return None
        gv = comm.pop("allreduce_gv", 0.0)
        if self.delay:
            compute = self.phase_seconds.get("bundle_compute", 0.0)
            gv = max(gv - self.delay * compute, 0.0)
        return float(gv + sum(comm.values())) * self.rounds

    @property
    def overlap_efficiency(self) -> float | None:
        """exposed_comm_s / total_comm_s — the fraction of paid comm
        time still on the critical path (1.0 = nothing hidden, the
        delay-0 value; lower is better). None until the phase probes
        have run."""
        total = self.total_comm_s
        exposed = self.exposed_comm_s
        if total is None or exposed is None:
            return None
        if total <= 0.0:
            return 1.0
        return exposed / total

    # ---- serialization ----

    def to_dict(self) -> dict:
        d = {
            "rates": [r.to_dict() for r in self.rates],
            "rounds": self.rounds,
            "round_seconds": list(self.round_seconds),
            # derived, for human-readable reports (ignored on load)
            "counted": self.counted_words(),
        }
        if any(r.word_bytes != 4 for r in self.rates):
            # bytes are derived too, and emitted only when some payload
            # is narrower than a word
            d["counted_bytes"] = self.counted_bytes()
        if self.delay:
            d["delay"] = self.delay  # emitted only when nonzero
        if self.phase_seconds:
            d["phase_seconds"] = dict(self.phase_seconds)
            # derived trio, for human-readable reports (ignored on load)
            d["exposed_comm_s"] = self.exposed_comm_s
            d["total_comm_s"] = self.total_comm_s
            d["overlap_efficiency"] = self.overlap_efficiency
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CommLedger":
        return cls(
            rates=tuple(CommRate.from_dict(r) for r in d.get("rates", ())),
            rounds=int(d.get("rounds", 0)),
            round_seconds=[float(v) for v in d.get("round_seconds", ())],
            phase_seconds={
                k: float(v) for k, v in d.get("phase_seconds", {}).items()
            },
            delay=int(d.get("delay", 0)),
        )


# ---- capture machinery -------------------------------------------------
#
# Recording is scoped to capture_rates via a ContextVar: inside it the
# collective ops add a CommRate (from the payload's shapes and dtypes)
# and return their input unchanged. Outside it every op is exactly the
# plain computation.


@dataclasses.dataclass
class _Recorder:
    spans: dict[str, int]
    rates: dict[CommRate, None]  # insertion-ordered set

    def add(self, op: str, axis: str, words: int, calls_per_round: int, word_bytes: int):
        rate = CommRate(
            op=op,
            axis=axis,
            span=self.spans.get(axis, 1),
            words_per_call=int(words),
            calls_per_round=int(calls_per_round),
            word_bytes=int(word_bytes),
        )
        self.rates.setdefault(rate, None)


_RECORDER: ContextVar[_Recorder | None] = ContextVar("repro_torch_comm_recorder", default=None)


def capture_rates(fn, *meta_args, spans: dict[str, int]) -> tuple[CommRate, ...]:
    """Run ``fn(*meta_args)`` with recording on and return every
    collective call site it issued, each once. The arguments are meant
    to hold ``device="meta"`` tensors, so nothing is computed. ``spans``
    maps mesh axis name → rank count ({"cols": p_c, "rows": p_r})."""
    rec = _Recorder(spans=dict(spans), rates={})
    token = _RECORDER.set(rec)
    try:
        fn(*meta_args)
    finally:
        _RECORDER.reset(token)
    return tuple(rec.rates)


def recording() -> bool:
    """Whether ``capture_rates`` is recording in this context."""
    return _RECORDER.get() is not None


def _tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _tree_words(tree) -> int:
    return int(sum(leaf.numel() for leaf in _tree_leaves(tree)))


def _tree_word_bytes(tree) -> int:
    """On-wire bytes per word, from the leaf dtypes (the widest leaf
    prices the payload; 4 when the tree carries no leaves)."""
    sizes = [leaf.element_size() for leaf in _tree_leaves(tree)]
    return int(max(sizes)) if sizes else 4


@dataclasses.dataclass
class _InFlight:
    """An issued, not yet awaited mesh Allreduce: the tensors it reduces
    in place and the ``torch.distributed`` work handles to wait on."""

    tree: object
    works: list


@dataclasses.dataclass(frozen=True)
class Collectives:
    """The collective ops a round body issues, by kind.

    Instances compare by ``kind`` alone. The module singletons
    ``COUNTING`` / ``MESH`` / ``TIMED`` name the three kinds; a mesh run
    executes with ``bind(mesh)`` — the same kind carrying the rank's
    "cols" and "rows" process groups (``groups``, a
    ``repro_torch.core.distributed.ProcessMesh``). While a recorder is
    installed (``capture_rates``) every kind records and returns its
    input, so capture needs no process group. ``TIMED`` shares ``MESH``'s
    ops — the timing itself is host-side, in the driver.
    """

    kind: str = "counting"
    groups: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {COLLECTIVE_KINDS}")

    @property
    def timed(self) -> bool:
        return self.kind == "timed"

    @property
    def on_mesh(self) -> bool:
        return self.kind in ("mesh", "timed")

    def bind(self, groups) -> "Collectives":
        """This kind, executing over ``groups`` (a ``ProcessMesh``)."""
        return dataclasses.replace(self, groups=groups)

    def _group(self, axis: str):
        """The process group of ``axis`` for a mesh kind, or None when the
        axis spans one rank (the collective is then the identity)."""
        if self.groups is None:
            raise RuntimeError(
                f"{self.kind!r} collectives need a process mesh: bind one with "
                f"Collectives.bind(mesh) (HybridDriver does)"
            )
        return self.groups.group(axis)

    # ---- the row-team (Gram) Allreduce: sum over column shards ----

    def allreduce_cols(self, tree, *, calls_per_round: int = 1,
                       words_per_call: int | None = None):
        """Sum ``tree`` across the "cols" mesh axis (the per-bundle (G, v)
        Allreduce — Table 3's row-team payload).

        counting: identity — the simulated ranks compute the full (G, v)
        directly. mesh/timed: one ``all_reduce(SUM)`` per tensor over the
        "cols" group, in place (the reference's two psums).

        ``words_per_call`` overrides the payload derived from the leaf
        shapes — the s = 1 engine corner uses it to account the full
        (G, v) payload its distributed twin puts on the wire even
        though the simulated body only materializes v."""
        rec = _RECORDER.get()
        if rec is not None:
            words = words_per_call if words_per_call is not None else _tree_words(tree)
            rec.add("allreduce", "cols", words, calls_per_round, _tree_word_bytes(tree))
            return tree
        if not self.on_mesh:
            return tree
        group = self._group("cols")
        if group is not None:
            for leaf in _tree_leaves(tree):
                dist.all_reduce(leaf, op=dist.ReduceOp.SUM, group=group)
        return tree

    # ---- the split of the Gram Allreduce for the delay-D pipeline ----
    #
    # ``issue_allreduce_cols`` at bundle k starts the reduction,
    # ``await_allreduce`` at bundle k+D marks where its value is first
    # consumed. On the simulated engine the issue records the payload
    # (same accounting as the fused call) and both are the identity; on
    # the mesh the issue starts ``all_reduce(..., async_op=True)`` and the
    # await waits on its work handles, so the D bundle-computes in between
    # run while the reduction is in flight.

    def issue_allreduce_cols(self, tree, *, calls_per_round: int = 1,
                             words_per_call: int | None = None):
        """Start the per-bundle (G, v) Allreduce for a delayed schedule.
        Same reduction, recording and payload conventions as
        ``allreduce_cols``; on the mesh it returns a handle for
        ``await_allreduce``."""
        rec = _RECORDER.get()
        if rec is not None or not self.on_mesh:
            return self.allreduce_cols(
                tree, calls_per_round=calls_per_round, words_per_call=words_per_call
            )
        group = self._group("cols")
        works = []
        if group is not None:
            works = [dist.all_reduce(leaf, op=dist.ReduceOp.SUM, group=group, async_op=True)
                     for leaf in _tree_leaves(tree)]
        return _InFlight(tree=tree, works=works)

    def await_allreduce(self, tree):
        """Consume a previously issued Allreduce: wait for its work
        handles on the mesh, the identity otherwise. Never recorded — the
        payload was counted at issue time; this marks the critical-path
        join point."""
        if isinstance(tree, _InFlight):
            for work in tree.works:
                work.wait()
            return tree.tree
        return tree

    # ---- the column Allreduce: average weights across row teams ----

    def allmean_rows(self, x: torch.Tensor, *, calls_per_round: int = 1,
                     words_per_call: int | None = None) -> torch.Tensor:
        """Average the per-shard weight slab across the "rows" mesh axis
        (the per-τ-iterations FedAvg sync — Table 3's column payload):
        ``all_reduce(SUM)`` over the "rows" group, then ``/ p_r``.
        Mesh/timed only; the simulated engine's stacked form is
        ``allmean_teams``."""
        rec = _RECORDER.get()
        if rec is not None:
            words = words_per_call if words_per_call is not None else _tree_words(x)
            rec.add("allmean", "rows", words, calls_per_round, _tree_word_bytes(x))
            return x
        if not self.on_mesh:
            return x
        group = self._group("rows")
        if group is None:
            return x
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / self.groups.p_r

    def allmean_teams(self, xs: torch.Tensor, *, words_per_call: int,
                      calls_per_round: int = 1) -> torch.Tensor:
        """The p_r team iterates arrive stacked as ``xs`` (p_r, n); the
        mean over the leading axis *is* the collective. ``words_per_call``
        is the per-rank shard payload ⌈n/p_c⌉ — the stacked shape carries
        the global n, so the caller supplies it."""
        rec = _RECORDER.get()
        if rec is not None:
            rec.add("allmean", "rows", words_per_call, calls_per_round, _tree_word_bytes(xs))
        return torch.mean(xs, dim=0)


COUNTING = Collectives("counting")
MESH = Collectives("mesh")
TIMED = Collectives("timed")


def _block(out) -> None:
    """Wait for ``out``: synchronize the CUDA device if any leaf is on
    one (CPU results are ready when the call returns)."""
    if any(leaf.is_cuda for leaf in _tree_leaves(out)):
        torch.cuda.synchronize()


def time_phase(fn, *args, repeats: int = 5) -> float:
    """Median wall seconds of one call to a phase probe, waiting for its
    result (``torch.cuda.synchronize()`` on CUDA); one unmeasured warm-up
    call first. The §6.5 per-phase measurement primitive."""
    _block(fn(*args))
    walls = []
    for _ in range(int(repeats)):
        t0 = time.perf_counter()
        _block(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def time_dispatch(fn, *args, repeats: int = 5) -> float:
    """Median wall seconds to *dispatch* one call of a probe — the host
    returns once the work is enqueued, without waiting for it. This is
    what an issued collective costs the critical path while it is in
    flight; ``time_phase − time_dispatch`` is the hideable window. Each
    repeat still waits for the device afterwards (outside the timed
    region), so queued work never backs up into the next repeat."""
    _block(fn(*args))
    walls = []
    for _ in range(int(repeats)):
        t0 = time.perf_counter()
        out = fn(*args)
        walls.append(time.perf_counter() - t0)
        _block(out)
    return statistics.median(walls)
