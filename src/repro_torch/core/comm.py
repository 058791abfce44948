"""The communication seam of the round body — thin for now.

The round body issues its two collectives through this object: the
per-bundle row-team (G, v) Allreduce and the per-round p_r-team
average. On the simulated one-device engine the first is the identity
(each simulated rank already holds the full reduction) and the second
is the mean over the stacked team axis. The keyword names match the
JAX package's ``repro.core.comm.Collectives`` so that the ledger, rate
capture and the mesh/timed kinds can later fill these bodies without
touching a call site.
"""

from __future__ import annotations

import dataclasses

import torch

COLLECTIVE_KINDS = ("counting",)


@dataclasses.dataclass(frozen=True)
class Collectives:
    """The collective ops a round body issues, by kind."""

    kind: str = "counting"

    def __post_init__(self):
        if self.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {COLLECTIVE_KINDS}")

    def allreduce_cols(self, tree, *, calls_per_round: int = 1,
                       words_per_call: int | None = None):
        """Sum ``tree`` across column shards (the per-bundle (G, v)
        Allreduce). Identity on the simulated engine."""
        del calls_per_round, words_per_call
        return tree

    def allmean_teams(self, xs: torch.Tensor, *, words_per_call: int,
                      calls_per_round: int = 1) -> torch.Tensor:
        """The p_r team iterates arrive stacked as ``xs`` (p_r, n); the
        mean over the leading axis *is* the collective."""
        del words_per_call, calls_per_round
        return torch.mean(xs, dim=0)


COUNTING = Collectives("counting")
