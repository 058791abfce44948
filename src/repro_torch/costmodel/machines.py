"""Machine models: measured Perlmutter CPU (paper Table 7) and TPU v5e.

All cost-model formulas take a ``Machine`` so the paper's measured
constants reproduce its tables bit-for-bit, and the same formalism
retargets to the TPU pod geometry (DESIGN.md §2). The presets are model
inputs a user selects, the same data as the JAX package's; none of them
describes the GPU this package runs on (``calibrate`` fits one from
measured rounds).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Machine:
    """α(q): s per Allreduce *phase* over q ranks; β(q): s/B rank-aware
    Allreduce bandwidth; γ(W): s/B memory-access cost at working-set W
    bytes. ``ranks_per_domain`` is the paper's R (per-node rank count ↦
    per-pod device count on TPU); ``l_cap`` the per-core fast-memory
    capacity (L2 ↦ VMEM slab budget)."""

    name: str
    ranks_per_domain: int  # R
    l_cap: int  # bytes
    word_bytes: int
    flops_per_word: float  # γ_flop = flops_per_word⁻¹… see gamma_flop()
    peak_flops: float  # per rank (s⁻¹) — used for roofline-style checks
    alpha_intra: dict[int, float]  # ranks -> s
    alpha_inter: dict[int, float]
    beta_intra: dict[int, float]  # ranks -> s/B
    beta_inter: dict[int, float]
    gamma_tiers: tuple[tuple[int, float], ...]  # (max W bytes, s/B)

    # ---- parameter lookups (rank-aware β, cache-aware γ: §6.5) ----

    def _interp(self, table: dict[int, float], q: int) -> float:
        ks = sorted(table)
        if q <= ks[0]:
            return table[ks[0]]
        if q >= ks[-1]:
            return table[ks[-1]]
        # log-log interpolation between measured points
        lo = max(k for k in ks if k <= q)
        hi = min(k for k in ks if k >= q)
        if lo == hi:
            return table[lo]
        t = (math.log2(q) - math.log2(lo)) / (math.log2(hi) - math.log2(lo))
        return math.exp((1 - t) * math.log(table[lo]) + t * math.log(table[hi]))

    def alpha(self, q: int) -> float:
        """Per-phase latency of an Allreduce over q ranks."""
        if q <= 1:
            return 0.0
        if q <= self.ranks_per_domain:
            return self._interp(self.alpha_intra, q)
        return self._interp(self.alpha_inter, q)

    def beta(self, q: int) -> float:
        """Rank-aware Allreduce s/B over q ranks (§6.5): step at the
        domain boundary (node ↦ pod)."""
        if q <= 1:
            return self.beta_intra[min(self.beta_intra)]
        if q <= self.ranks_per_domain:
            return self._interp(self.beta_intra, q)
        return self._interp(self.beta_inter, q)

    def gamma_bytes(self, working_set: float) -> float:
        """Cache-aware γ(W) in s/B (§6.5)."""
        for cap, g in self.gamma_tiers:
            if working_set <= cap:
                return g
        return self.gamma_tiers[-1][1]

    def gamma_flop(self, working_set: float) -> float:
        """s/flop at working-set W: γ_B(W) · bytes-moved-per-flop."""
        return self.gamma_bytes(working_set) * self.word_bytes / self.flops_per_word

    def allreduce_time(self, q: int, words: int) -> float:
        """Hockney: 2⌈log₂ q⌉ α + W β (reduce-scatter + all-gather)."""
        if q <= 1:
            return 0.0
        return 2 * math.ceil(math.log2(q)) * self.alpha(q) + words * self.word_bytes * self.beta(q)


# Paper Table 7 — measured on Perlmutter CPU (2×EPYC 7763, Slingshot-11,
# 64 ranks/node). α is the total 8-byte Allreduce time.
PERLMUTTER = Machine(
    name="perlmutter-cpu",
    ranks_per_domain=64,
    l_cap=1 << 20,  # 1 MB L2/core
    word_bytes=8,  # FP64 (paper §7)
    flops_per_word=1.0,
    peak_flops=39.2e9,  # 2.45 GHz × 16 flops/cycle AVX2 FMA (per core)
    alpha_intra={8: 3.41e-6, 32: 3.39e-6, 64: 4.22e-6},
    alpha_inter={
        64: 3.64e-6, 128: 8.36e-6, 256: 12.56e-6, 512: 14.46e-6,
        1024: 23.23e-6, 2048: 43.22e-6, 4096: 92.71e-6, 8192: 57.13e-6,
        16384: 84.92e-6,
    },
    beta_intra={1: 5.34e-11, 8: 5.90e-10, 32: 1.50e-9, 64: 2.67e-9},
    beta_inter={
        64: 2.66e-9, 128: 3.14e-9, 256: 3.33e-9, 512: 3.73e-9,
        1024: 4.14e-9, 2048: 5.15e-9, 4096: 5.37e-9, 8192: 6.10e-9,
        16384: 6.65e-9,
    },
    gamma_tiers=(
        (16 << 10, 4.0e-12),  # L1
        (1 << 20, 1.25e-11),  # L2
        (32 << 20, 1.5e-11),  # L3
        (1 << 62, 2.6e-11),  # DRAM
    ),
)

# TPU v5e pod (DESIGN.md §2). Domain = one pod (256 chips, ICI);
# crossing the pod boundary (DCI) mirrors the paper's node-boundary β
# step (~an order of magnitude).   β_ICI: ring all-reduce moves 2(q-1)/q
# ≈ 2 bytes/byte over 50 GB/s links → ~4e-11 s/B effective; DCI ~10×.
# γ tiers: VMEM-resident vs HBM-streamed (819 GB/s).
TPU_V5E = Machine(
    name="tpu-v5e",
    ranks_per_domain=256,  # chips per pod
    l_cap=64 << 20,  # usable VMEM slab budget (half of 128 MiB)
    word_bytes=2,  # bf16
    flops_per_word=2.0,
    peak_flops=197e12,
    alpha_intra={2: 1e-6, 256: 1e-6},
    alpha_inter={512: 5e-6, 4096: 10e-6},
    beta_intra={1: 1.0 / 819e9, 2: 4.0e-11, 256: 4.0e-11},
    beta_inter={512: 4.0e-10, 4096: 6.0e-10},
    gamma_tiers=(
        (64 << 20, 1.0 / (3 * 819e9)),  # VMEM-resident (≈3× HBM bw proxy)
        (1 << 62, 1.0 / 819e9),  # HBM
    ),
)

MACHINES = {m.name: m for m in (PERLMUTTER, TPU_V5E)}
