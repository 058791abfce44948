"""Micro-batch → engine row-shards: the host-side glue between the
streaming data plane and the two executors.

A micro-batch arrives as one (rows, width) ELL block with global column
ids. One schedule round consumes ``p_r · τ · b`` rows (τ/s bundles of
s·b rows per team), so the batch reshapes into the executors' layouts:

* simulated — a per-round ``TeamProblem`` ``(p_r, τ·b, width)`` on the
  session's device: the engine's cyclic bundle slicing
  ``(k₀·s·b) mod m_local`` with ``m_local = τ·b`` walks the fresh rows
  exactly once per round, for *any* round index — streaming reuses the
  offline round body verbatim.
* shard_map — ``(p_r, p_c, τ·b, width)`` host blocks with column ids
  locally renumbered per the session's ``ColumnPartition`` (the same
  renumbering ``build_2d_problem`` applies to the resident dataset),
  padded to the shared ``width``; each rank moves only its own block to
  its device.

Shapes are fixed by the first batch; the session enforces the row count.
Both layouts are element for element the reference package's
(``repro.serve.ingest``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.teams import TeamProblem
from repro_torch.sparse.partition import ColumnPartition

__all__ = ["ColumnLocalizer", "stream_team_problem", "stream_shard_arrays"]


def stream_team_problem(batch, p_r: int, n: int, objective, device=None) -> TeamProblem:
    """One micro-batch as a p_r-team problem (simulated backend), on
    ``device`` (None: the CUDA device).

    Rows split contiguously across teams (row block i → team i), labels
    folded in (diag(y)·A), every row valid. ``m`` is the batch's true
    row count — only the loss probe reads it, and streaming sessions
    probe the resident holdout problem instead."""
    device = resolve_device(device)
    rows = batch.rows
    if rows % p_r:
        raise ValueError(f"batch rows={rows} not divisible by p_r={p_r}")
    rows_local = rows // p_r
    idx = np.ascontiguousarray(batch.indices.reshape(p_r, rows_local, batch.width), np.int32)
    val = np.ascontiguousarray(batch.ya_values().reshape(p_r, rows_local, batch.width), np.float32)
    return TeamProblem(
        indices=torch.from_numpy(idx).to(device),
        values=torch.from_numpy(val).to(device),
        rows_valid=torch.ones((p_r, rows_local), dtype=torch.bool, device=device),
        p=p_r,
        m=rows,
        n=n,
        objective=objective,
    )


@dataclasses.dataclass
class ColumnLocalizer:
    """Global → (shard, local id) maps for one ``ColumnPartition``,
    built once per session and applied per micro-batch (vectorized
    lookups — no per-batch repartitioning)."""

    owner: np.ndarray  # (n,) int32 — shard owning each global column
    local: np.ndarray  # (n,) int32 — column's id inside its shard
    p_c: int

    @classmethod
    def from_partition(cls, cp: ColumnPartition) -> "ColumnLocalizer":
        n = int(cp.order.shape[0])
        owner = np.empty(n, np.int32)
        local = np.empty(n, np.int32)
        for j in range(cp.p):
            cols = cp.rank_cols(j)
            owner[cols] = j
            local[cols] = np.arange(len(cols), dtype=np.int32)
        return cls(owner=owner, local=local, p_c=cp.p)


def stream_shard_arrays(
    batch, loc: ColumnLocalizer, p_r: int, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """One micro-batch as host (indices, values) of shape
    ``(p_r, p_c, rows_local, width)`` with shard-local column ids —
    the operand layout ``HybridDriver.advance_stream`` takes.

    ``width`` is the fixed per-shard ELL width (the batch width is an
    upper bound on any shard's per-row count, so reusing it keeps one
    static shape for every batch); overflow is impossible by
    construction, padding is id 0 + value 0. Each row's entries that fall
    in shard j keep their order, left-aligned; a padded slot (value 0)
    goes to no shard.
    """
    rows = batch.rows
    if rows % p_r:
        raise ValueError(f"batch rows={rows} not divisible by p_r={p_r}")
    rows_local = rows // p_r
    p_c = loc.p_c
    pad = batch.values == 0.0
    # padded slots (value 0) stay inert on every shard: shard 0, id 0
    owner = np.where(pad, 0, loc.owner[batch.indices])  # (rows, width)
    local = np.where(pad, 0, loc.local[batch.indices])
    ya = batch.ya_values()

    idx = np.zeros((p_r, p_c, rows_local, width), np.int32)
    val = np.zeros((p_r, p_c, rows_local, width), np.float32)
    team, row = np.divmod(np.arange(rows), rows_local)
    for j in range(p_c):
        sel = (owner == j) & ~pad
        # the slot of each selected entry: its rank among the row's entries
        # in shard j (a running count along the row)
        slot = np.cumsum(sel, axis=1) - 1
        r, w = np.nonzero(sel)
        idx[team[r], j, row[r], slot[r, w]] = local[r, w]
        val[team[r], j, row[r], slot[r, w]] = ya[r, w]
    return idx, val
