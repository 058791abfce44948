"""Closed-form optima and regime analysis (paper §6.3-6.4).

s* (Eq. 5) and b* (Eq. 6) minimize the convex A·x + B/x + C collection
of Eq. (4) terms; one fixed-point sweep couples them. The bandwidth
balance (s-1)s·b²·τ·p_c ≈ 2n separates the Gram-BW and sync-BW regimes
(Table 5).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.costmodel.hockney import CostBreakdown, HybridConfig, hybrid_epoch_cost, _log2
from repro_torch.costmodel.machines import Machine


def s_star(b: int, tau: int, p_r: int, p_c: int, n: int, machine: Machine) -> float:
    """Eq. (5): s* = sqrt(B_s / A_s)."""
    p = p_r * p_c
    w = machine.word_bytes
    gamma = machine.gamma_flop(n * w / p_c)
    beta_row = machine.beta(p_c)
    beta_col = machine.beta(p_r)
    alpha_row, alpha_col = machine.alpha(p_c), machine.alpha(p_r)
    l_tilde_alpha = alpha_row * tau * _log2(p_c) + alpha_col * _log2(p_r)
    a_s = (2 * gamma / p + w * beta_row / 2) * b
    b_s = 2 * l_tilde_alpha / (b * tau) + n * w * beta_col / (b * tau * p_c)
    return math.sqrt(b_s / a_s) if a_s > 0 else float("inf")


def b_star(s: int, tau: int, p_r: int, p_c: int, n: int, machine: Machine) -> float:
    """Eq. (6)."""
    p = p_r * p_c
    w = machine.word_bytes
    gamma = machine.gamma_flop(n * w / p_c)
    beta_row = machine.beta(p_c)
    beta_col = machine.beta(p_r)
    alpha_row, alpha_col = machine.alpha(p_c), machine.alpha(p_r)
    l_tilde_alpha = alpha_row * tau * _log2(p_c) + alpha_col * _log2(p_r)
    num = 2 * l_tilde_alpha / tau + n * w * beta_col / (tau * p_c)
    den = (2 * gamma * s / p + (s - 1) * w * beta_row / 2) * s
    return math.sqrt(num / den) if den > 0 else float("inf")


def joint_sb_star(
    tau: int, p_r: int, p_c: int, n: int, machine: Machine, s0: int = 4, b0: int = 32
) -> tuple[float, float]:
    """One fixed-point iteration on (Eq. 5, Eq. 6), as the paper does."""
    s1 = s_star(b0, tau, p_r, p_c, n, machine)
    b1 = b_star(max(int(round(s1)), 1), tau, p_r, p_c, n, machine)
    return s1, b1


def bandwidth_balance(s: int, b: int, tau: int, p_c: int, n: int) -> float:
    """(s-1)·s·b²·τ·p_c / 2n — >1 means Gram-BW dominates, <1 sync-BW."""
    return (s - 1) * s * b * b * tau * p_c / (2 * n)


@dataclasses.dataclass(frozen=True)
class Regime:
    name: str  # compute | latency | gram_bw | sync_bw
    breakdown: CostBreakdown
    balance: float  # bandwidth balance ratio
    action: str


_ACTIONS = {
    "compute": "increase p; s, b secondary",
    "latency": "maximize s·b·τ; prefer large s, b",
    "gram_bw": "decrease s or b; FedAvg limit",
    "sync_bw": "increase τ or p_c",
}


def classify_regime(
    m: int, n: int, zbar: float, cfg: HybridConfig, machine: Machine
) -> Regime:
    """Table 5: the dominant Eq. (4) term names the operating regime."""
    cb = hybrid_epoch_cost(m, n, zbar, cfg, machine)
    name = cb.dominant
    return Regime(
        name=name,
        breakdown=cb,
        balance=bandwidth_balance(cfg.s, cfg.b, cfg.tau, cfg.p_c, n),
        action=_ACTIONS[name],
    )


def grid_search_config(
    m: int,
    n: int,
    zbar: float,
    p_r: int,
    p_c: int,
    machine: Machine,
    s_grid=(1, 2, 4, 8, 16, 32),
    b_grid=(8, 16, 32, 64, 128),
    tau_grid=(1, 5, 10, 20, 50),
) -> tuple[HybridConfig, CostBreakdown]:
    """Rank candidate (s, b, τ) at a fixed mesh by Eq. (4) — the model's
    selection-tool role (§6): ranking, not absolute runtime."""
    best = None
    for s in s_grid:
        for b in b_grid:
            for tau in tau_grid:
                if tau % s and tau >= s:
                    continue
                if tau < s:
                    continue
                cfg = HybridConfig(p_r=p_r, p_c=p_c, s=s, b=b, tau=tau)
                cb = hybrid_epoch_cost(m, n, zbar, cfg, machine)
                if best is None or cb.total < best[1].total:
                    best = (cfg, cb)
    assert best is not None
    return best
