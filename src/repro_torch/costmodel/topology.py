"""Topology-respecting mesh rule (paper Eq. 7).

    p_c* = max(⌈n·w / L_cap⌉, min(R, p)),   p_r* = p / p_c*

Keep the *frequent* row-team (Gram) Allreduce inside the fast
communication domain (node ↦ pod): the measured β(q) is a step function
at the domain boundary q = R, so sliding p_c up to R monotonically cuts
the sync-BW term while staying on fast transport. The cache term raises
p_c above R only when the per-rank weight slab n·w/p_c would spill
L_cap at p_c = R. Only two machine constants (R, L_cap) are needed —
no α-β-γ calibration.
"""

from __future__ import annotations

import math

from repro_torch.costmodel.machines import Machine


def topology_rule(p: int, n: int, machine: Machine) -> tuple[int, int]:
    """Return (p_r*, p_c*). p must be a power of two (meshes here are);
    p_c* is rounded up to the nearest power-of-two divisor of p."""
    if p & (p - 1):
        raise ValueError(f"p={p} must be a power of two")
    w = machine.word_bytes
    cache_term = math.ceil(n * w / machine.l_cap)
    p_c = max(cache_term, min(machine.ranks_per_domain, p))
    # round UP to a power-of-two divisor of p (≤ p)
    p_c = min(1 << math.ceil(math.log2(max(p_c, 1))), p)
    return p // p_c, p_c


def cache_term_binding(n: int, machine: Machine) -> bool:
    """True when the cache term (not R) sets p_c* (paper: non-binding on
    every LIBSVM dataset since n·w ≤ R·L_cap)."""
    return n * machine.word_bytes > machine.ranks_per_domain * machine.l_cap
