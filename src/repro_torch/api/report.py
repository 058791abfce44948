"""RunReport — the unified result object every backend returns.

One report shape regardless of how the spec executed (simulated engine
or shard_map device mesh): final weights, loss trace with the engine's
``loss_every`` semantics, measured solver wall time, the plan's
predicted cost breakdown, and the run's communication three ways —
**modeled** (Table 2–3 closed forms, ``costmodel.schedule_comm_volume``),
**counted** (the ``repro_torch.core.comm`` ledger: what the round bodies
actually issued), and **measured** (timed runs: host wall seconds per
round in the same ledger). Its JSON form is the reference package's.
"""

from __future__ import annotations

import dataclasses
import json
import statistics

import numpy as np

from repro_torch.api.plan import Plan
from repro_torch.api.plan import plan as plan_fn
from repro_torch.api.spec import ExperimentSpec, dataset_stats
from repro_torch.core.comm import CommLedger
from repro_torch.costmodel.calibrate import CalPoint
from repro_torch.costmodel.hockney import schedule_comm_volume
from repro_torch.costmodel.machines import MACHINES


def modeled_comm_words(spec: ExperimentSpec, rounds: int | None = None) -> dict[str, float]:
    """Per-rank communicated words implied by the schedule — the
    Table 2–3 closed form (``costmodel.schedule_comm_volume``): one
    (s²b² + sb)-word row-team Allreduce per bundle when columns are
    sharded, one ⌈n/p_c⌉-word column Allreduce per round when there is
    more than one row team.

    ``rounds`` overrides the schedule's round budget — the Session uses
    it to report the volume of the rounds actually completed (early
    stop, mid-run events)."""
    sched, mesh = spec.schedule, spec.mesh
    st_n = dataset_stats(spec.dataset).n
    r = sched.rounds if rounds is None else int(rounds)
    return schedule_comm_volume(
        st_n, mesh.p_r, mesh.p_c, sched.s, sched.b, sched.tau, rounds=r
    ).words_dict()


@dataclasses.dataclass
class RunReport:
    """What ``run(spec)`` returns, for any backend.

    ``wall_time_s`` splits as ``compile_time_s + solve_time_s``:
    the first session chunk (kernel build at first use, CUDA warm-up,
    and one chunk of rounds) versus the steady-state remainder — compare
    solve times across specs without the one-off start-up noise.
    """

    spec: ExperimentSpec          # the spec as executed (post-autotune)
    plan: Plan                    # predicted cost at that operating point
    backend: str                  # which executor ran it
    x: np.ndarray | None          # final weights (n,); None when the
                                  # report was rehydrated from JSON
    losses: np.ndarray            # full objective every loss_every rounds
    final_loss: float             # full objective at the final iterate
    wall_time_s: float            # measured solver wall (excl. build)
    comm_words: dict[str, float]  # modeled per-rank comm volume
    compile_time_s: float = 0.0   # first chunk (includes kernel build and warm-up)
    solve_time_s: float = 0.0     # steady state (wall − first chunk)
    rounds_completed: int | None = None  # rounds actually run (None: full budget)
    stop_reason: str | None = None  # StopPolicy verdict ("rounds" = budget)
    ledger: CommLedger | None = None  # counted (+ measured, when timed)
                                  # communication; None on reports
                                  # rehydrated from pre-ledger JSON

    def time_to_target(self, target: float) -> tuple[float, int, float, bool]:
        """(seconds, rounds, loss, hit) to reach ``target`` on this
        run's per-round loss trace: the wall time scaled by the first
        crossing round (the paper's §7.5 protocol). When the trace never
        crosses, returns the full wall/rounds/final loss with hit=False."""
        losses = np.asarray(self.losses)
        if not len(losses):
            raise ValueError("time_to_target needs a loss trace (schedule loss_every > 0)")
        rounds = len(losses)
        hit = np.nonzero(losses <= target)[0]
        if len(hit):
            r = int(hit[0]) + 1
            return self.wall_time_s * r / rounds, r, float(losses[hit[0]]), True
        return self.wall_time_s, rounds, float(losses[-1]), False

    def summary(self) -> str:
        sched = self.spec.schedule
        obj = ""
        if self.spec.objective != "logistic" or self.spec.l2:
            obj = f" obj={self.spec.objective}" + (
                f"+l2={self.spec.l2:g}" if self.spec.l2 else ""
            )
        trace = f", trace[{len(self.losses)}]" if len(self.losses) else ""
        stopped = (
            f" (stopped: {self.stop_reason} @ round {self.rounds_completed})"
            if self.stop_reason not in (None, "rounds")
            else ""
        )
        comm = f"modeled comm {self.comm_words['total_words']:.3g} words/rank"
        if self.ledger is not None:
            comm += f", counted {self.ledger.counted_words()['total_words']:.3g}"
            if self.ledger.seconds_per_round is not None:
                comm += f", measured {self.ledger.seconds_per_round:.3g} s/round"
            if self.ledger.exposed_comm_s is not None:
                comm += (
                    f", exposed {self.ledger.exposed_comm_s:.3g}"
                    f"/{self.ledger.total_comm_s:.3g} s"
                    f" (overlap-eff {self.ledger.overlap_efficiency:.2f}"
                )
                comm += (
                    f", delay D={self.ledger.delay})" if self.ledger.delay else ")"
                )
        return (
            f"{self.spec.name or self.spec.dataset} [{self.backend}]{obj} "
            f"s={sched.s} b={sched.b} τ={sched.tau} p_r×p_c="
            f"{self.spec.mesh.p_r}×{self.spec.mesh.p_c}: loss {self.final_loss:.4f} "
            f"in {self.wall_time_s:.2f}s{trace}{stopped}; {comm}"
        )

    def to_dict(self) -> dict:
        """JSON-serializable record (weights elided — they belong in a
        checkpoint, not a report). Round-trips through ``from_dict``;
        the ledger key is emitted only when a ledger exists, so default
        records stay readable by (and byte-compatible with) pre-ledger
        tooling."""
        d = {
            "spec": self.spec.to_dict(),
            "backend": self.backend,
            "final_loss": self.final_loss,
            "wall_time_s": self.wall_time_s,
            "compile_time_s": self.compile_time_s,
            "solve_time_s": self.solve_time_s,
            "rounds_completed": self.rounds_completed,
            "stop_reason": self.stop_reason,
            "losses": [float(v) for v in np.asarray(self.losses)],
            "comm_words": self.comm_words,
            "predicted": {
                "compute": self.plan.cost.compute,
                "latency": self.plan.cost.latency,
                "gram_bw": self.plan.cost.gram_bw,
                "sync_bw": self.plan.cost.sync_bw,
                "total": self.plan.cost.total,
                "regime": self.plan.regime,
            },
        }
        if self.ledger is not None:
            d["comm_ledger"] = self.ledger.to_dict()
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "RunReport":
        """Rehydrate a persisted report (sweep resume). The plan is
        recomputed from the spec (pure and deterministic); the weights
        are not stored in reports, so ``x`` is None. Pre-ledger JSON
        (no ``comm_ledger`` key) loads with ``ledger=None``."""
        spec = ExperimentSpec.from_dict(d["spec"])
        led = d.get("comm_ledger")
        return cls(
            spec=spec,
            plan=plan_fn(spec),
            backend=d["backend"],
            x=None,
            losses=np.asarray(d["losses"], np.float32),
            final_loss=float(d["final_loss"]),
            wall_time_s=float(d["wall_time_s"]),
            comm_words=dict(d["comm_words"]),
            compile_time_s=float(d.get("compile_time_s", 0.0)),
            solve_time_s=float(d.get("solve_time_s", 0.0)),
            rounds_completed=d.get("rounds_completed"),
            stop_reason=d.get("stop_reason"),
            ledger=CommLedger.from_dict(led) if led is not None else None,
        )

    def calibration_point(self):
        """This run as a §6.5 calibration point (``costmodel.CalPoint``)
        — or None when the run was not timed (no measured rounds in the
        ledger). Regressors come from the ledger's captured rates and
        the dataset statistics; the response is the median measured
        round wall."""
        if self.ledger is None or not self.ledger.round_seconds:
            return None
        machine = MACHINES[self.spec.machine]
        st = dataset_stats(self.spec.dataset)
        sched, mesh = self.spec.schedule, self.spec.mesh
        # per-rank flops per round: τ inner iterations of b rows at
        # 6z̄/p_c nnz-work + 2sb correction flops each (refine.py's
        # per-iteration compute term × τ)
        flops = sched.tau * sched.b * (6 * st.zbar / mesh.p_c + 2 * sched.s * sched.b)
        return CalPoint(
            phases_per_round=float(self.ledger.phases_per_round()),
            bytes_per_round=self.ledger.bytes_per_round(machine.word_bytes),
            flops_per_round=float(flops),
            seconds_per_round=statistics.median(self.ledger.round_seconds),
            label=self.spec.name or self.spec.dataset,
        )

    @classmethod
    def from_json(cls, text: str) -> "RunReport":
        return cls.from_dict(json.loads(text))
