"""The declarative experiment spec — the front door's input language.

An ``ExperimentSpec`` is everything needed to reproduce one run of the
(p_r, p_c, s, τ) family: the dataset (by registered name + seed), the
``ParallelSGDSchedule`` (the same knob object the engine executes), the
``MeshSpec`` (geometry + which execution backend realizes it), and the
``Machine`` (by name) the cost model plans against.

Specs JSON round-trip (``to_dict``/``from_dict``/``to_json``/
``from_json``) so a run is reproducible from a config file:

    spec = ExperimentSpec.from_json(Path("spec.json").read_text())
    report = repro_torch.api.run(spec)          # device=None: the CUDA device

Geometry lives in one place: ``MeshSpec`` is authoritative for
(p_r, p_c). The schedule's ``p_r`` must agree (it is a numerical knob —
row teams change the iterates); the schedule's ``p_c`` is
communication-only and is canonicalized from the mesh.

The wire form is the reference package's, word for word, so a spec file
reads the same in both packages and ``content_hash()`` is equal string
for string: the port's Gram backend ``"kernel"`` (the hand-written CUDA
kernel) is written as the reference's ``"pallas"`` and read back from
it, and the schedule's ``interpret`` flag (which the port carries but
never reads) is emitted as it was read. Checkpoint manifests and sweep
resume records key on that hash.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math

from repro_torch.core.engine import ParallelSGDSchedule
from repro_torch.core.objective import OBJECTIVES
from repro_torch.costmodel.machines import MACHINES
from repro_torch.sparse.partition import PARTITIONERS
from repro_torch.sparse.synthetic import dataset_stats

BACKENDS = ("simulated", "shard_map")

# the Gram backend's name on the wire: the reference's word for the
# hand-written kernel path is "pallas", the port's "kernel"
_GRAM_TO_WIRE = {"kernel": "pallas"}
_GRAM_FROM_WIRE = {"pallas": "kernel"}


@dataclasses.dataclass(frozen=True)
class StopPolicy:
    """When to stop *before* the schedule's round budget runs out.

    The schedule's ``rounds`` is the hard budget (the compiled loop
    shape); the policy ends the run early at round granularity — the
    paper's §7.5 time-to-loss protocol made first-class instead of
    being post-hoc arithmetic on a finished trace.

    target_loss  stop once a sampled full objective ≤ this (needs
                 ``schedule.loss_every > 0`` — the objective is only
                 observable on sampling boundaries).
    max_seconds  stop once cumulative solver wall time crosses this
                 (checked between chunks; the running chunk finishes).
    max_rounds   stop after this many rounds even if the schedule asks
                 for more (resume-friendly: restore, raise, continue).
    """

    target_loss: float | None = None
    max_seconds: float | None = None
    max_rounds: int | None = None

    def __post_init__(self):
        if self.max_seconds is not None and self.max_seconds < 0:
            raise ValueError(f"max_seconds={self.max_seconds} must be ≥ 0")
        if self.max_rounds is not None and self.max_rounds < 1:
            raise ValueError(f"max_rounds={self.max_rounds} must be ≥ 1")

    @property
    def trivial(self) -> bool:
        """True when no knob is set (run the full schedule)."""
        return (
            self.target_loss is None
            and self.max_seconds is None
            and self.max_rounds is None
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StopPolicy":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How a run survives failures — the knobs of the fault-tolerance
    plane (autosave cadence, retry budget, backoff), declared on the
    spec so a sweep point carries its own recovery contract.

    autosave_every  checkpoint the session every this many rounds
                    (0 = off). The *where* is runtime state, not spec
                    content: ``Session(spec, autosave_dir=...)`` or the
                    sweep's ``resume_dir`` supply the directory.
    max_retries     how many times a failed sweep point is retried
                    (each retry resumes from the point's last autosave
                    when one exists) before it is quarantined — i.e.
                    quarantine-after-N with N = 1 + max_retries failed
                    attempts.
    backoff_s       sleep before retry k: ``backoff_s · 2^(k-1)``
                    (0 = retry immediately).
    """

    autosave_every: int = 0
    max_retries: int = 2
    backoff_s: float = 0.0

    def __post_init__(self):
        if self.autosave_every < 0:
            raise ValueError(f"autosave_every={self.autosave_every} must be ≥ 0")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be ≥ 0")
        if not math.isfinite(self.backoff_s) or self.backoff_s < 0:
            raise ValueError(f"backoff_s={self.backoff_s} must be finite and ≥ 0")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPolicy":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """The spec's declared online data plane (the serving plane's
    input). One schedule round consumes exactly ``p_r · τ · b`` sample
    rows, so a stream plugs in by micro-batching arrivals into
    fixed-shape row blocks of that size (``Session.step_stream``).

    source          "" = no stream (pure offline run — the default, and
                    invisible on the wire so default hashes are
                    unchanged); "drift" = synthetic labeled stream with
                    one concept shift; "replay" = cycle the spec's
                    dataset rows through the online path
                    (``repro_torch.serve.make_stream_source``).
    rows_per_round  micro-batch size. 0 (default) derives it from the
                    schedule (p_r·τ·b); a nonzero value must equal that
                    product — one batch is one round by construction.
    width           active features per streamed example ("drift" only).
    seed            stream seed (independent of the dataset seed).
    drift_at        batch index of the concept shift (0 = never).
    queue_capacity  ingest queue bound (backpressure point).
    swap_every      serving freshness policy: hot-swap the served model
                    every this many rounds (0 = only the final swap).
    """

    source: str = ""
    rows_per_round: int = 0
    width: int = 16
    seed: int = 0
    drift_at: int = 0
    queue_capacity: int = 8
    swap_every: int = 4

    def __post_init__(self):
        if self.source not in ("", "drift", "replay"):
            raise ValueError(
                f"stream.source={self.source!r} not in ('', 'drift', 'replay')"
            )
        if self.rows_per_round < 0:
            raise ValueError(f"rows_per_round={self.rows_per_round} must be ≥ 0")
        if self.width < 1:
            raise ValueError(f"stream.width={self.width} must be ≥ 1")
        if self.queue_capacity < 1:
            raise ValueError(f"queue_capacity={self.queue_capacity} must be ≥ 1")
        if self.swap_every < 0:
            raise ValueError(f"swap_every={self.swap_every} must be ≥ 0")

    @property
    def enabled(self) -> bool:
        return bool(self.source)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StreamSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Where the computation runs.

    p_r × p_c   the paper's 2D processor mesh (row teams × column
                shards).
    backend     "simulated" — exact rank semantics on one device via
                the unified engine (repro_torch.core.engine);
                "shard_map" — real mesh execution, one process per mesh
                device (repro_torch.core.distributed), over an initialized
                default process group of p_r·p_c ranks.
    partitioner column partitioner for the shard_map layout (§6.5);
                ignored by the simulated backend (p_c is
                communication-only and never changes the numerics).
    """

    p_r: int = 1
    p_c: int = 1
    backend: str = "simulated"
    partitioner: str = "cyclic"

    def __post_init__(self):
        if self.p_r < 1 or self.p_c < 1:
            raise ValueError(f"mesh must be ≥ 1×1, got {self.p_r}×{self.p_c}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r} not in {BACKENDS}")
        if self.partitioner not in PARTITIONERS:
            raise ValueError(
                f"partitioner={self.partitioner!r} not in {tuple(PARTITIONERS)}"
            )

    @property
    def p(self) -> int:
        return self.p_r * self.p_c

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One declarative experiment: spec → plan → run → report.

    dataset      registered dataset name (repro_torch.sparse.synthetic); the
                 -sm variants materialize on one host.
    schedule     the (s, b, τ, η, rounds, loss_every, gram) knobs —
                 the exact object both backends execute.
    objective    registered convex loss (repro_torch.core.objective):
                 "logistic" (default) | "squared_hinge" |
                 "least_squares". Flows into the problem build on both
                 backends; the default reproduces pre-objective traces
                 bitwise.
    l2           ridge coefficient λ ≥ 0 (0 = unregularized; exact on
                 s > 1 via the decay-aware correction recurrence).
    mesh         geometry + backend (authoritative for p_r, p_c).
    machine      cost-model machine name (repro_torch.costmodel.MACHINES)
                 used by ``plan``.
    seed         dataset generation seed.
    autotune     let ``plan`` rewrite (s, b) via the closed-form optima
                 (Eq. 5–6) before running.
    row_multiple rows are padded to this multiple (None → s·b, the
                 paper's cyclic-sampling requirement). Pin it when
                 comparing schedules with different s·b so they see the
                 identical sample sequence.
    stop         round-granular early-stop policy (``StopPolicy``);
                 default: run the schedule's full round budget.
    comm_timing  run timed: each round blocks on completion
                 (``torch.cuda.synchronize``) and its wall seconds land
                 in the report's CommLedger — the §6.5 calibration
                 input (repro_torch.costmodel.calibrate). Serializes
                 per-round dispatch, so leave False for throughput runs.
    faults       fault-tolerance policy (``FaultPolicy``): autosave
                 cadence + sweep retry/quarantine budget. The default
                 (no autosave, 2 retries) serializes to nothing, so
                 default hashes are unchanged.
    stream       online data plane (``StreamSpec``): which stream
                 source feeds ``Session.step_stream`` and the serving
                 freshness policy. The default (no stream) serializes
                 to nothing — offline specs, hashes, and checkpoints
                 are untouched.
    name         optional label for reports/sweeps.
    """

    dataset: str
    schedule: ParallelSGDSchedule
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    machine: str = "perlmutter-cpu"
    seed: int = 0
    autotune: bool = False
    row_multiple: int | None = None
    stop: StopPolicy = dataclasses.field(default_factory=StopPolicy)
    objective: str = "logistic"
    l2: float = 0.0
    comm_timing: bool = False
    faults: FaultPolicy = dataclasses.field(default_factory=FaultPolicy)
    stream: StreamSpec = dataclasses.field(default_factory=StreamSpec)
    name: str = ""

    def __post_init__(self):
        dataset_stats(self.dataset)  # raises on unknown name
        if self.machine not in MACHINES:
            raise ValueError(f"machine={self.machine!r} not in {sorted(MACHINES)}")
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective={self.objective!r} not in {sorted(OBJECTIVES)}"
            )
        if not math.isfinite(self.l2) or self.l2 < 0.0:
            raise ValueError(f"l2={self.l2} must be finite and ≥ 0")
        if self.stop.target_loss is not None and not self.schedule.loss_every:
            raise ValueError(
                "stop.target_loss needs schedule.loss_every > 0: the objective is "
                "only observable on loss-sampling boundaries"
            )
        if self.schedule.p_r != self.mesh.p_r:
            raise ValueError(
                f"schedule.p_r={self.schedule.p_r} != mesh.p_r={self.mesh.p_r}: row "
                f"teams are a numerical knob and must agree"
            )
        if self.schedule.p_c not in (1, self.mesh.p_c):
            raise ValueError(
                f"schedule.p_c={self.schedule.p_c} != mesh.p_c={self.mesh.p_c}"
            )
        if self.schedule.p_c != self.mesh.p_c:
            # p_c is communication-only: canonicalize from the mesh so
            # one object describes the full run.
            object.__setattr__(
                self, "schedule", dataclasses.replace(self.schedule, p_c=self.mesh.p_c)
            )
        if self.stream.enabled and self.stream.rows_per_round:
            want = self.schedule.p_r * self.schedule.tau * self.schedule.b
            if self.stream.rows_per_round != want:
                raise ValueError(
                    f"stream.rows_per_round={self.stream.rows_per_round} != "
                    f"p_r·τ·b={want}: one micro-batch is one schedule round "
                    f"by construction (leave it 0 to derive it)"
                )

    def stream_rows_per_round(self) -> int:
        """Rows one schedule round consumes — the micro-batch size the
        stream plane must produce (p_r·τ·b unless pinned explicitly)."""
        return self.stream.rows_per_round or (
            self.schedule.p_r * self.schedule.tau * self.schedule.b
        )

    # ---- JSON round-tripping ----

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "dataset": self.dataset,
            "seed": self.seed,
            "machine": self.machine,
            "autotune": self.autotune,
            "row_multiple": self.row_multiple,
            "schedule": dataclasses.asdict(self.schedule),
            "mesh": self.mesh.to_dict(),
            "stop": self.stop.to_dict(),
        }
        gram = d["schedule"]["gram"]
        d["schedule"]["gram"] = _GRAM_TO_WIRE.get(gram, gram)
        # schedule.delay is emitted only when nonzero: a delay-0 spec
        # serializes (and content-hashes) exactly as it did before the
        # overlap knob existed, so pre-overlap checkpoints and sweep
        # resume dirs stay valid.
        if not self.schedule.delay:
            d["schedule"].pop("delay", None)
        # bm/precision likewise: the untiled fp32 default serializes
        # (and content-hashes) exactly as it did before the autotune +
        # precision knobs existed. bk stays on the wire (it predates
        # this layer); bk=None — the opt-in autotune sentinel — moves
        # the hash, which is correct: a tuned run is a different run.
        if self.schedule.bm is None:
            d["schedule"].pop("bm", None)
        if self.schedule.precision == "fp32":
            d["schedule"].pop("precision", None)
        # objective/l2 are emitted only when non-default: a
        # default-logistic spec serializes (and content-hashes) exactly
        # as it did before the objective layer existed, so pre-existing
        # checkpoints and sweep resume dirs stay valid — the default
        # run is bitwise-identical, and its hash says so.
        if self.objective != "logistic":
            d["objective"] = self.objective
        if self.l2:
            d["l2"] = self.l2
        # comm_timing likewise: emitted only when on, so default specs
        # (and their content hashes / resume dirs) are byte-identical to
        # every pre-ledger release.
        if self.comm_timing:
            d["comm_timing"] = True
        # faults likewise: a default policy is invisible on the wire —
        # pre-fault-tolerance JSON and hashes stay valid.
        if self.faults != FaultPolicy():
            d["faults"] = self.faults.to_dict()
        # stream likewise: offline specs serialize (and hash) exactly as
        # they did before the serving plane existed.
        if self.stream != StreamSpec():
            d["stream"] = self.stream.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        sched = dict(d.pop("schedule"))
        if "gram" in sched:
            sched["gram"] = _GRAM_FROM_WIRE.get(sched["gram"], sched["gram"])
        schedule = ParallelSGDSchedule(**sched)
        mesh = MeshSpec.from_dict(d.pop("mesh", {}))
        stop = StopPolicy.from_dict(d.pop("stop", {}))
        fault_policy = FaultPolicy.from_dict(d.pop("faults", {}))
        stream = StreamSpec.from_dict(d.pop("stream", {}))
        return cls(
            schedule=schedule,
            mesh=mesh,
            stop=stop,
            faults=fault_policy,
            stream=stream,
            **d,
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def content_hash(self) -> str:
        """Stable hash of the full spec content (every field, including
        ``name``). This keys session checkpoints and sweep resume
        records: a checkpoint written under one spec can only be resumed
        under a spec with the identical hash — anything else is a hard
        error, never a silent renumber."""
        payload = json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
