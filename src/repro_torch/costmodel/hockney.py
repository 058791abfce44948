"""Closed-form α-β-γ cost model (paper §6, Tables 2-3, Eq. 4).

Eq. (4) per-epoch wall time of HybridSGD on a p_r × p_c mesh:

  T = (m/p)(6z̄ + 2sb)γ                                 [compute]
    + m · 2α(τ·log p_c + log p_r)/(sbτ)                  [latency]
    + m · (s-1)b·w·β/2                                   [Gram BW]
    + m · n·w·β/(sbτ·p_c)                                [sync BW]

The 1D baselines are exact limits: (p_r=1, p_c=p, τ→∞) → 1D s-step SGD;
(p_r=p, p_c=1, s=1) → FedAvg; additionally τ=1 → MB-SGD.

β is rank-aware (§6.5): the row-team (Gram) Allreduce spans p_c ranks,
the column (weight-sync) Allreduce spans p_r ranks.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.costmodel.machines import Machine


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """One point of the (p_r, p_c, s, b, τ) design space."""

    p_r: int
    p_c: int
    s: int
    b: int
    tau: int

    @property
    def p(self) -> int:
        return self.p_r * self.p_c


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Per-epoch seconds, decomposed as in Eq. (4).

    ``overlap_saved`` is the Gram-phase communication hidden behind
    compute by a delay-D schedule (0 for the synchronous D=0 form):
    per bundle the critical path pays max(comm, compute) instead of
    their sum, so the epoch saves min(gram_comm, D · compute). The
    decomposed terms keep their synchronous Eq. (4) values — ``total``
    subtracts the overlap, so dominant-term analysis still sees what
    the run pays on the wire."""

    compute: float
    latency: float
    gram_bw: float
    sync_bw: float
    overlap_saved: float = 0.0

    @property
    def total(self) -> float:
        return (
            self.compute + self.latency + self.gram_bw + self.sync_bw
            - self.overlap_saved
        )

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute,
            "latency": self.latency,
            "gram_bw": self.gram_bw,
            "sync_bw": self.sync_bw,
        }
        return max(terms, key=terms.get)


def _log2(q: int) -> float:
    return math.log2(q) if q > 1 else 0.0


def hybrid_epoch_cost(
    m: int,
    n: int,
    zbar: float,
    cfg: HybridConfig,
    machine: Machine,
    gamma: float | None = None,
    beta_row: float | None = None,
    beta_col: float | None = None,
    delay: int = 0,
    gram_word_bytes: int | None = None,
) -> CostBreakdown:
    """Eq. (4). γ defaults to the cache-aware value at the per-rank
    weight-slab working set (n·w/p_c); β defaults to the rank-aware
    values for each Allreduce's span.

    ``delay`` prices the DaSGD overlap pipeline: at D ≥ 1 each per-
    bundle (G, v) Allreduce (the row-team latency + Gram-bandwidth
    phases) has D bundle-computes to hide behind, so the critical path
    pays max(gram_comm, D·compute) in place of gram_comm + D·compute —
    equivalently ``overlap_saved = min(gram_comm, D·compute)`` per
    epoch. The synchronous column sync is never overlapped.

    ``gram_word_bytes`` prices the (G, v) wire format separately from
    the machine word (default: equal): a ``precision="bf16"`` schedule
    ships 2-byte Gram words, halving the β·bytes Gram term while the
    Table 2–3 *word* counts — and the sync term, whose weights stay
    fp32 — are untouched."""
    w = machine.word_bytes
    gw = w if gram_word_bytes is None else gram_word_bytes
    if gamma is None:
        gamma = machine.gamma_flop(n * w / cfg.p_c)
    if beta_row is None:  # row-team (Gram) Allreduce spans p_c ranks
        beta_row = machine.beta(cfg.p_c)
    if beta_col is None:  # column (weight) Allreduce spans p_r ranks
        beta_col = machine.beta(cfg.p_r)
    s, b, tau, p_r, p_c, p = cfg.s, cfg.b, cfg.tau, cfg.p_r, cfg.p_c, cfg.p

    compute = (m / p) * (6 * zbar + 2 * s * b) * gamma
    alpha_row = machine.alpha(p_c)
    alpha_col = machine.alpha(p_r)
    lat_row = m * 2 * alpha_row * _log2(p_c) / (s * b)
    lat_col = m * 2 * alpha_col * _log2(p_r) / (s * b * tau)
    latency = lat_row + lat_col
    gram_bw = m * ((s - 1) * b / 2) * gw * beta_row
    sync_bw = m * n * w * beta_col / (s * b * tau * p_c)
    overlap_saved = 0.0
    if delay >= 1 and p_c > 1:
        overlap_saved = min(lat_row + gram_bw, delay * compute)
    return CostBreakdown(
        compute=compute, latency=latency, gram_bw=gram_bw, sync_bw=sync_bw,
        overlap_saved=overlap_saved,
    )


def recommend_delay(
    m: int, n: int, zbar: float, cfg: HybridConfig, machine: Machine
) -> int:
    """The smallest staleness D whose overlap window covers the Gram-
    phase communication: ⌈gram_comm / compute⌉ per bundle (both scale
    with the same m/(sbτ) call count, so the epoch ratio is the bundle
    ratio), clamped to the schedule's legal range [1, τ/s]. Returns 0
    when p_c = 1 — no row-team Allreduce exists, so staleness buys
    nothing and D=0 keeps the exact synchronous iterates."""
    if cfg.p_c <= 1:
        return 0
    cb = hybrid_epoch_cost(m, n, zbar, cfg, machine)
    lat_row = m * 2 * machine.alpha(cfg.p_c) * _log2(cfg.p_c) / (cfg.s * cfg.b)
    gram_comm = lat_row + cb.gram_bw
    if cb.compute <= 0.0:
        return 1
    d = math.ceil(gram_comm / cb.compute)
    return max(1, min(d, cfg.tau // cfg.s))


def sstep_epoch_cost(m: int, n: int, zbar: float, s: int, b: int, p: int, machine: Machine) -> CostBreakdown:
    """1D s-step SGD limit (p_r=1, p_c=p, τ→∞): column Allreduce
    vanishes."""
    cfg = HybridConfig(p_r=1, p_c=p, s=s, b=b, tau=1)
    cb = hybrid_epoch_cost(m, n, zbar, cfg, machine)
    # remove the column-sync contributions (τ→∞ limit)
    lat = m * 2 * machine.alpha(p) * _log2(p) / (s * b)
    return CostBreakdown(compute=cb.compute, latency=lat, gram_bw=cb.gram_bw, sync_bw=0.0)


def fedavg_epoch_cost(m: int, n: int, zbar: float, b: int, tau: int, p: int, machine: Machine) -> CostBreakdown:
    """FedAvg limit (p_r=p, p_c=1, s=1): row (Gram) Allreduce vanishes."""
    w = machine.word_bytes
    gamma = machine.gamma_flop(n * w)
    compute = (m / p) * (6 * zbar + 2 * b) * gamma
    latency = m * 2 * machine.alpha(p) * _log2(p) / (b * tau)
    sync_bw = m * n * w * machine.beta(p) / (b * tau)
    return CostBreakdown(compute=compute, latency=latency, gram_bw=0.0, sync_bw=sync_bw)


def mbsgd_epoch_cost(m: int, n: int, zbar: float, b: int, p: int, machine: Machine) -> CostBreakdown:
    """Synchronous mini-batch SGD = FedAvg with τ=1."""
    return fedavg_epoch_cost(m, n, zbar, b, 1, p, machine)


# ---- Tables 2–3: communicated words per rank (closed form) ----


@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Closed-form per-rank communication of a schedule, in words and
    calls — the quantity the ``repro_torch.core.comm`` ledger counts and the
    β/α terms of Eq. 4 charge for.

    gram_*   the row-team (G, v) Allreduce over the p_c column shards:
             one call per s-bundle, s²b² + sb words on the wire (the
             dense (sb, sb) Gram block + residual; ``gram_words_min``
             is Table 3's strictly-lower-triangular information content
             s(s-1)b²/2 + sb — the wire payload's lower bound).
    sync_*   the column weight Allreduce over the p_r row teams: one
             call per round, the ⌈n/p_c⌉-word balanced weight shard.

    A collective spanning a single rank moves nothing: its calls and
    words are zero here, matching the ledger's counted totals.
    """

    gram_calls: int
    gram_words: float
    gram_words_min: float
    gram_span: int
    sync_calls: int
    sync_words: float
    sync_span: int

    @property
    def total_words(self) -> float:
        return self.gram_words + self.sync_words

    def words_dict(self) -> dict[str, float]:
        """The modeled-volume dict reports carry ({gram,sync,total})."""
        return {
            "gram_words": self.gram_words,
            "sync_words": self.sync_words,
            "total_words": self.total_words,
        }


def schedule_comm_volume(
    n: int, p_r: int, p_c: int, s: int, b: int, tau: int, rounds: int = 1
) -> CommVolume:
    """Tables 2–3 as word counts: per-rank communication of ``rounds``
    outer rounds of the (p_r, p_c, s, b, τ) schedule.

    The four named corners are limits of this one form:
      MB-SGD   (p_r=1, s=1, τ=1)   gram only (when p_c > 1)
      s-step   (p_r=1, τ=s)        gram only (one bundle per round)
      FedAvg   (s=1, p_c=1)        sync only
      Hybrid   general             both
    """
    bundles = rounds * (tau // s)
    sb = s * b
    gram_active = p_c > 1
    sync_active = p_r > 1
    gram_calls = bundles if gram_active else 0
    gram_words = float(bundles * (sb * sb + sb)) if gram_active else 0.0
    gram_words_min = (
        float(bundles * (s * (s - 1) * b * b // 2 + sb)) if gram_active else 0.0
    )
    sync_calls = rounds if sync_active else 0
    sync_words = float(rounds * math.ceil(n / p_c)) if sync_active else 0.0
    return CommVolume(
        gram_calls=gram_calls,
        gram_words=gram_words,
        gram_words_min=gram_words_min,
        gram_span=p_c,
        sync_calls=sync_calls,
        sync_words=sync_words,
        sync_span=p_r,
    )


# ---- Table 3: per-sample costs (amortized over the comm period) ----


def per_sample_costs(
    solver: str,
    m: int,
    n: int,
    zbar: float,
    p: int,
    s: int,
    b: int,
    tau: int,
    machine: Machine,
    p_r: int = 1,
    p_c: int = 1,
) -> dict[str, float]:
    """Latency / bandwidth / compute per sample (paper Table 3), in
    seconds. ``solver`` ∈ {sgd, mbsgd, fedavg, sstep1d, hybrid}."""
    w = machine.word_bytes
    a = machine.alpha(p)
    bt = machine.beta(p)
    g = machine.gamma_flop(n * w / max(p_c, 1))
    L2 = _log2
    if solver == "sgd":
        return {"latency": 2 * L2(p) * a, "bandwidth": w * bt, "compute": 4 * zbar * g}
    if solver == "mbsgd":
        return {
            "latency": 2 * L2(p) * a / b,
            "bandwidth": w * bt,
            "compute": (4 * zbar + 2 * n / b) * g,
        }
    if solver == "fedavg":
        return {
            "latency": 2 * L2(p) * a / (tau * b),
            "bandwidth": n * w * bt / (tau * b),
            "compute": (4 * zbar + 2 * n / b) * g,
        }
    if solver == "sstep1d":
        return {
            "latency": 2 * L2(p) * a / (s * b),
            "bandwidth": (s - 1) * b * w * bt / 2,
            "compute": (6 * zbar + 2 * s * b) * g,
        }
    if solver == "hybrid":
        a_row, a_col = machine.alpha(p_c), machine.alpha(p_r)
        b_row, b_col = machine.beta(p_c), machine.beta(p_r)
        return {
            "latency": 2 * (a_row * tau * L2(p_c) + a_col * L2(p_r)) / (s * b * tau),
            "bandwidth": ((s - 1) * b / 2) * w * b_row + n * w * b_col / (s * b * tau * p_c),
            "compute": (6 * zbar + 2 * s * b) * g,
        }
    raise ValueError(f"unknown solver {solver!r}")
