"""§6.5 closing the loop: fit machine constants from measured ledgers.

The static ``machines.py`` presets are the paper's Table 7 — measured
once, on their hardware. A timed run (wall seconds per round appended
to the ``repro_torch.core.comm.CommLedger``) carries everything needed
to refit the Hockney constants for the machine actually underneath:

    per-round wall  ≈  α·phases + β·bytes + γ·flops

where phases (2⌈log₂ span⌉ per collective call), bytes, and flops per
round are known exactly from the ledger's captured rates and the
dataset statistics. ``calibrate`` solves the least-squares system over
a set of measured points (ideally a sweep over schedules, so the three
columns are linearly independent), clamps negative coefficients to
zero, and returns a ``Calibration`` whose ``machine()`` re-targets any
preset, so that configurations are ranked with machine-fitted constants
instead of presets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.costmodel.machines import Machine

__all__ = ["CalPoint", "Calibration", "calibrate"]


@dataclasses.dataclass(frozen=True)
class CalPoint:
    """One measured operating point: the per-round regressors (from the
    comm ledger + dataset stats) and the measured per-round seconds
    (median over the timed rounds). ``label`` is carried for fit
    diagnostics only."""

    phases_per_round: float
    bytes_per_round: float
    flops_per_round: float
    seconds_per_round: float
    label: str = ""

    def __post_init__(self):
        if self.seconds_per_round <= 0 or not math.isfinite(self.seconds_per_round):
            raise ValueError(
                f"seconds_per_round={self.seconds_per_round} must be finite and > 0"
            )


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted Hockney constants (zero = term not identifiable from the
    points given, e.g. a single-rank run has no comm columns).

    alpha    seconds per Allreduce phase.
    beta     seconds per byte on the wire.
    gamma    seconds per flop.
    rel_rms  relative RMS residual of the fit (‖Ax−t‖/‖t‖).
    points   how many measured points entered the fit.
    """

    alpha: float
    beta: float
    gamma: float
    rel_rms: float
    points: int

    def machine(self, base: Machine) -> Machine:
        """Re-target ``base`` with the fitted constants: flat (rank- and
        tier-independent) α/β/γ tables — the calibration measures one
        machine at one scale, so the fitted values apply at every span.
        Terms that did not fit (coefficient 0) keep the preset tables.
        """
        repl: dict = {"name": f"{base.name}+calibrated"}
        if self.alpha > 0:
            repl["alpha_intra"] = {1: self.alpha}
            repl["alpha_inter"] = {1: self.alpha}
        if self.beta > 0:
            repl["beta_intra"] = {1: self.beta}
            repl["beta_inter"] = {1: self.beta}
        if self.gamma > 0:
            # Machine stores γ as s/B tiers; γ_flop = γ_B·w/flops_per_word,
            # so invert to one flat tier reproducing the fitted s/flop.
            gamma_bytes = self.gamma * base.flops_per_word / base.word_bytes
            repl["gamma_tiers"] = ((1 << 62, gamma_bytes),)
        return dataclasses.replace(base, **repl)

    def summary(self) -> str:
        return (
            f"calibration over {self.points} point(s): α={self.alpha:.3g} s/phase, "
            f"β={self.beta:.3g} s/B, γ={self.gamma:.3g} s/flop "
            f"(rel. RMS {self.rel_rms:.2f})"
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls(**d)


def calibrate(points: Sequence[CalPoint]) -> Calibration:
    """Least-squares fit of (α, β, γ) to the measured points.

    Columns that are identically zero across every point (e.g. no
    collective spanned >1 rank) are excluded and fit to 0; negative
    coefficients are clamped to zero and the remaining columns refit —
    a two-pass non-negativity good enough for ranking (the validated
    property of the refined model is ranking fidelity, §6.5)."""
    points = list(points)
    if not points:
        raise ValueError("calibrate needs at least one measured point")
    a = np.array(
        [[p.phases_per_round, p.bytes_per_round, p.flops_per_round] for p in points],
        dtype=np.float64,
    )
    t = np.array([p.seconds_per_round for p in points], dtype=np.float64)

    active = [j for j in range(3) if np.any(a[:, j] != 0.0)]
    coef = np.zeros(3)
    for _ in range(3):  # drop-negative refit passes
        if not active:
            break
        sol, *_ = np.linalg.lstsq(a[:, active], t, rcond=None)
        coef[:] = 0.0
        coef[active] = sol
        neg = [j for j in active if coef[j] < 0.0]
        if not neg:
            break
        coef[neg] = 0.0
        active = [j for j in active if j not in neg]
    resid = a @ coef - t
    denom = float(np.linalg.norm(t))
    rel = float(np.linalg.norm(resid) / denom) if denom else 0.0
    return Calibration(
        alpha=float(coef[0]),
        beta=float(coef[1]),
        gamma=float(coef[2]),
        rel_rms=rel,
        points=len(points),
    )
