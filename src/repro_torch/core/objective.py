"""Pluggable convex objectives — the paper's §3 problem statement,
generalized to the regularized GLM / margin-loss family.

With Y = S·diag(y)·A the sampled rows and z = Y·x the margins, the
mini-batch gradient of

    f(x) = (1/m) Σ_i ℓ(z_i) + (λ/2)‖x‖²          (λ = l2, optional)

is  g = -(1/b)·Yᵀ·u(z) + λ·x  with  u(z) = -ℓ′(z),  so one SGD step is

    x ← (1 - ηλ)·x + (η/b)·Yᵀ·u(Y·x).

Everything the engine needs from the model is two pointwise maps —
``residual(z) = -ℓ′(z)`` and ``pointwise_loss(z) = ℓ(z)`` — plus the
decay scalar ``l2``. An ``Objective`` packages exactly that.

Registered losses (margins z = y·aᵀx, labels y ∈ {±1} folded into Y):

  logistic       ℓ(z) = log(1 + e^{-z});        u(z) = 1/(1 + e^{z})
  squared_hinge  ℓ(z) = max(0, 1 - z)²;         u(z) = 2·max(0, 1 - z)
  least_squares  ℓ(z) = ½(1 - z)²;              u(z) = 1 - z

L2 semantics in the s-step bundle (exact, not approximate): with
ρ = 1 - ηλ the unrolled recurrence is

    z_j = ρ^j·v_j + (η/b)·Σ_{l<j} ρ^{j-1-l}·G_{jl}·u_l
    x_s = ρ^s·x_0 + (η/b)·Yᵀ·[ρ^{s-1-l}·u_l]_l

which ``repro_torch.core.engine.inner_corrections`` implements by
carrying the ρ-rescaled residual vector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch


@dataclasses.dataclass(frozen=True)
class Objective:
    """A pointwise margin loss + optional L2 decay. Frozen and hashable.

    l2   the ridge coefficient λ in f(x) = (1/m)Σℓ + (λ/2)‖x‖².
         0.0 (default) means unregularized.
    """

    l2: float = 0.0
    name: ClassVar[str] = "abstract"

    def __post_init__(self):
        if not math.isfinite(self.l2) or self.l2 < 0.0:
            raise ValueError(f"l2={self.l2} must be finite and ≥ 0")

    # -- the two pointwise maps the engine consumes --

    def residual(self, z: torch.Tensor) -> torch.Tensor:
        """u(z) = -ℓ′(z): the batch update is x += (η/b)·Yᵀ·u(Yx)."""
        raise NotImplementedError

    def pointwise_loss(self, z: torch.Tensor) -> torch.Tensor:
        """ℓ(z) per sample (the L2 term is added by the problem-level
        loss, where ‖x‖² is available)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LogisticObjective(Objective):
    """ℓ(z) = log(1 + e^{-z}) — the paper's model, computed stably."""

    name: ClassVar[str] = "logistic"

    def residual(self, z: torch.Tensor) -> torch.Tensor:
        # u = 1/(1+exp(z)) in the two-branch form that is stable for
        # large |z|: whatever overflows does so in the branch that
        # ``where`` discards. Kept expression for expression as in the
        # JAX package.
        return torch.where(
            z >= 0, torch.exp(-z) / (1 + torch.exp(-z)), 1 / (1 + torch.exp(z))
        )

    def pointwise_loss(self, z: torch.Tensor) -> torch.Tensor:
        return torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device), -z)


@dataclasses.dataclass(frozen=True)
class SquaredHingeObjective(Objective):
    """ℓ(z) = max(0, 1 - z)² — the L2-SVM loss."""

    name: ClassVar[str] = "squared_hinge"

    def residual(self, z: torch.Tensor) -> torch.Tensor:
        return 2.0 * torch.clamp(1.0 - z, min=0.0)

    def pointwise_loss(self, z: torch.Tensor) -> torch.Tensor:
        return torch.square(torch.clamp(1.0 - z, min=0.0))


@dataclasses.dataclass(frozen=True)
class LeastSquaresObjective(Objective):
    """ℓ(z) = ½(1 - z)² — least-squares classification on ±1 labels."""

    name: ClassVar[str] = "least_squares"

    def residual(self, z: torch.Tensor) -> torch.Tensor:
        return 1.0 - z

    def pointwise_loss(self, z: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.square(1.0 - z)


OBJECTIVES: dict[str, type[Objective]] = {
    LogisticObjective.name: LogisticObjective,
    SquaredHingeObjective.name: SquaredHingeObjective,
    LeastSquaresObjective.name: LeastSquaresObjective,
}

LOGISTIC = LogisticObjective()


def get_objective(objective: str | Objective, l2: float = 0.0) -> Objective:
    """Resolve a registry name (+ l2) to an ``Objective`` instance.

    An already-constructed ``Objective`` passes through unchanged —
    except that asking for a *different* nonzero l2 at the same time is
    ambiguous and rejected.
    """
    if isinstance(objective, Objective):
        if l2 and objective.l2 != l2:
            raise ValueError(
                f"objective already carries l2={objective.l2}; conflicting l2={l2}"
            )
        return objective
    if objective not in OBJECTIVES:
        raise ValueError(
            f"objective={objective!r} not in registry {sorted(OBJECTIVES)}"
        )
    return OBJECTIVES[objective](l2=l2)
