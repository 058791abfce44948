"""HybridSGD over a real 2D process mesh (``torch.distributed``).

This is the production distribution of the paper's algorithm. The mesh
axes are ("rows", "cols") = (p_r, p_c), and the execution is SPMD: p_r·p_c
processes run the same code, and rank r is mesh device
(i, j) = (r // p_c, r % p_c). Rank (i, j) holds, on its device,

  the ELL block of diag(y)·A for row team i and column shard j (columns
  renumbered locally in partition order), and its n_loc-word shard of the
  weight vector.

Per s-bundle (the paper's row-team Allreduce): the rank computes its
partial (G, v) with the engine's shared bundle primitive
(``repro_torch.core.engine.bundle_gram_v`` — on CUDA tensors the
hand-written ``ell_gram`` kernel on the column-local bundle, ids < n_loc)
and sums it over the "cols" group: exactly the (s²b² + sb)-word payload
of Table 3. The corrections (``inner_corrections`` — the ``sstep_inner``
kernel where the simulated engine launches it) and the weight update
Yᵀu are local under column partitioning.
Per τ inner iterations (the paper's column Allreduce): x_loc ← the mean
over the "rows" group (n/p_c words per rank).

Both collectives go through ``repro_torch.core.comm`` (the mesh — or,
for calibration, timed — collectives, bound to the rank's process
groups): ``hybrid_comm_ledger`` captures the round body's spans and
payloads into a ``CommLedger`` on meta tensors, and ``HybridDriver``
commits rounds (and, timed, per-round wall seconds) into it as it
advances.

The caller creates the default process group (``torchrun``, or
``torch.distributed.init_process_group`` with a ``file://`` store);
``make_process_mesh`` checks it and builds the "rows" and "cols"
subgroups. Nothing here picks the backend: gloo with CPU tensors for
tests, NCCL with one rank a card, or gloo with CUDA tensors for several
ranks sharing one card — the caller's choice.

The execution knobs arrive as one ``ParallelSGDSchedule`` — the object
the simulated engine consumes — so the two paths cannot drift on
plumbing. Numerics match ``repro_torch.core.engine.run_parallel_sgd`` (the
simulated version is the oracle) to float32 reduction order: the partial
(G, v) sums are taken per shard, then summed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.core.comm import MESH, Collectives, CommLedger, capture_rates
from repro_torch.core.engine import (
    ParallelSGDSchedule,
    bundle_gram_v,
    check_delay,
    delayed_bundle_scan,
    inner_corrections,
    unwire_gv,
    wire_gv,
)
from repro_torch.core.engine import _decay, _integer_pow
from repro_torch.core.objective import LOGISTIC, Objective, get_objective
from repro_torch.kernels.sstep_inner import eta_over_b
from repro_torch.sparse.csr import CSRMatrix, row_chunks
from repro_torch.sparse.ell import EllBlock, ell_matvec, ell_rmatvec
from repro_torch.sparse.partition import ColumnPartition, partition_columns, partition_rows

__all__ = [
    "Hybrid2DProblem",
    "HybridDriver",
    "ProcessMesh",
    "RankZeroWriteError",
    "build_2d_problem",
    "gather_x",
    "hybrid_comm_ledger",
    "make_hybrid_step",
    "make_process_mesh",
    "on_rank0",
    "run_hybrid_distributed",
    "scatter_x",
]


@dataclasses.dataclass
class Hybrid2DProblem:
    """Host layout of the HybridSGD problem on the p_r × p_c mesh.

    indices/values: (p_r, p_c, rows_local, width) CPU tensors — ELL
    blocks, column ids local to each column shard (int32; values in the
    build dtype) — or, with ``block = (i, j)``, that one mesh device's
    (rows_local, width) block: what a rank builds for itself. ``width``
    is the widest row of any block either way. Each rank moves its own
    (i, j) block to its device.
    col_sizes: (p_c,) true (unpadded) columns per shard; shards pad to
    n_loc = max(col_sizes).
    """

    indices: torch.Tensor
    values: torch.Tensor
    col_sizes: torch.Tensor
    p_r: int
    p_c: int
    m: int
    n: int
    n_loc: int
    objective: Objective = LOGISTIC
    block: tuple[int, int] | None = None

    @property
    def rows_local(self) -> int:
        return int(self.indices.shape[-2])

    @property
    def width(self) -> int:
        return int(self.indices.shape[-1])

    def rank_block(self, i: int, j: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Mesh device (i, j)'s (rows_local, width) ELL indices and values;
        raises for any other block of a one-block layout."""
        if self.block is None:
            return self.indices[i, j], self.values[i, j]
        if tuple(self.block) != (i, j):
            raise ValueError(f"this layout holds only block {tuple(self.block)}, not ({i}, {j})")
        return self.indices, self.values


# nonzeros the host build handles at once: its int64 temporaries stay near
# 0.5 GB whatever the dataset's size
BUILD_CHUNK = 1 << 24


def _layout_width(a: CSRMatrix, cp: ColumnPartition) -> int:
    """The widest row of any block of the layout — the most nonzeros one
    row has in one column shard (1 for an empty matrix) — from per-row
    counts a shard, one ``bincount`` over each chunk of nonzeros, without
    laying any block out."""
    if cp.p == 1:
        return max(int(a.nnz_per_row.max()) if a.m and a.nnz else 1, 1)
    owner = np.empty(a.n, dtype=np.int64)
    for j in range(cp.p):
        owner[cp.rank_cols(j)] = j
    width = 1
    for r0, r1 in row_chunks(a.indptr, BUILD_CHUNK):
        lo, hi = int(a.indptr[r0]), int(a.indptr[r1])
        if hi > lo:
            key = np.repeat(np.arange(r1 - r0, dtype=np.int64) * cp.p, np.diff(a.indptr[r0 : r1 + 1]))
            key += owner[a.indices[lo:hi]]
            width = max(width, int(np.bincount(key).max()))
    return width


def _fill_block(idx: np.ndarray, val: np.ndarray, a: CSRMatrix, y: np.ndarray,
                r0: int, r1: int, cols: np.ndarray) -> None:
    """Block (rows [r0, r1), columns ``cols``) of diag(y)·A into the zeroed
    (rows_local, width) ELL arrays: row r's entries in column shard order
    renumbered 0..len(cols)-1 in the order given, in their CSR order, pads
    (0, 0) after them — ``row_block(r0, r1).select_columns(cols)`` of
    ``a.scale_rows(y)``, element for element. Each value is the float64
    product ``data·y`` cast once to ``val``'s dtype. Rows go in chunks of
    about ``BUILD_CHUNK`` nonzeros; a chunk whose rows are all full is a
    reshape."""
    width = idx.shape[1]
    local = np.full(a.n, -1, dtype=np.int64)
    local[cols] = np.arange(len(cols), dtype=np.int64)
    blk = a.row_block(r0, r1)
    for c0, c1 in row_chunks(blk.indptr, BUILD_CHUNK):
        lo, hi = int(blk.indptr[c0]), int(blk.indptr[c1])
        ids = local[blk.indices[lo:hi]]
        keep = ids >= 0
        rows = np.repeat(np.arange(c0, c1, dtype=np.int64), np.diff(blk.indptr[c0 : c1 + 1]))[keep]
        ids, data = ids[keep], blk.data[lo:hi][keep]
        if len(ids) == (c1 - c0) * width:  # every row full: rows of the ELL block as they are
            idx[c0:c1] = ids.reshape(c1 - c0, width)
            val[c0:c1] = data.reshape(c1 - c0, width) * y[r0 + c0 : r0 + c1, None]
            continue
        counts = np.bincount(rows - c0, minlength=c1 - c0)
        first = np.zeros(c1 - c0, dtype=np.int64)
        np.cumsum(counts[:-1], out=first[1:])
        slots = np.arange(len(ids), dtype=np.int64) - np.repeat(first, counts)
        idx[rows, slots] = ids
        val[rows, slots] = data * y[r0 + rows]


def build_2d_problem(
    a: CSRMatrix,
    y: np.ndarray,
    p_r: int,
    p_c: int,
    partitioner: str,
    row_multiple: int = 1,
    dtype: torch.dtype = torch.float32,
    objective: str | Objective = LOGISTIC,
    block: tuple[int, int] | None = None,
) -> tuple[Hybrid2DProblem, ColumnPartition]:
    """Partition (A, y) onto the p_r × p_c mesh, on the host. Row bounds
    match ``repro_torch.core.teams.stack_row_teams`` so simulated and
    distributed sample sequences agree; ``objective`` is the shared convex
    loss. The layout is deterministic in its inputs.

    ``block = (i, j)`` lays out mesh device (i, j)'s block alone (a rank
    builds its own): bitwise the whole layout's ``[i, j]``, with the same
    ``rows_local``, ``width``, ``n_loc``, ``col_sizes`` and partition.
    None lays out every block."""
    obj = get_objective(objective)
    y = np.asarray(y, dtype=np.float64)
    cp = partition_columns(a, p_c, partitioner)
    rb = partition_rows(a.m, p_r)
    rows_local = max(int(rb[i + 1] - rb[i]) for i in range(p_r))
    rows_local = -(-rows_local // row_multiple) * row_multiple
    n_loc = int(cp.n_local.max())
    width = _layout_width(a, cp)
    # the values straight in float32; another dtype is cast from float64 at
    # the end, one rounding either way
    val_dtype = np.float32 if dtype == torch.float32 else np.float64
    if block is None:
        owned = [(i, j) for i in range(p_r) for j in range(p_c)]
        idx = np.zeros((p_r, p_c, rows_local, width), dtype=np.int32)
        val = np.zeros((p_r, p_c, rows_local, width), dtype=val_dtype)
        views = {ij: (idx[ij], val[ij]) for ij in owned}
    else:
        block = (int(block[0]), int(block[1]))
        if not (0 <= block[0] < p_r and 0 <= block[1] < p_c):
            raise ValueError(f"block {block} is not on the {p_r}×{p_c} mesh")
        owned = [block]
        idx = np.zeros((rows_local, width), dtype=np.int32)
        val = np.zeros((rows_local, width), dtype=val_dtype)
        views = {block: (idx, val)}
    for i, j in owned:
        _fill_block(*views[(i, j)], a, y, int(rb[i]), int(rb[i + 1]), cp.rank_cols(j))
    prob = Hybrid2DProblem(
        indices=torch.from_numpy(idx),
        values=torch.from_numpy(val).to(dtype),
        col_sizes=torch.from_numpy(np.asarray(cp.n_local, np.int32)),
        p_r=p_r,
        p_c=p_c,
        m=a.m,
        n=a.n,
        n_loc=n_loc,
        objective=obj,
        block=block,
    )
    return prob, cp


def scatter_x(x: np.ndarray, cp: ColumnPartition, n_loc: int) -> np.ndarray:
    """Global (n,) weights → padded sharded layout (p_c · n_loc,)."""
    out = np.zeros(cp.p * n_loc, dtype=x.dtype)
    for j in range(cp.p):
        cols = cp.rank_cols(j)
        out[j * n_loc : j * n_loc + len(cols)] = x[cols]
    return out


def gather_x(x_pad: np.ndarray, cp: ColumnPartition, n_loc: int, n: int) -> np.ndarray:
    """Inverse of scatter_x."""
    out = np.zeros(n, dtype=x_pad.dtype)
    for j in range(cp.p):
        cols = cp.rank_cols(j)
        out[cols] = x_pad[j * n_loc : j * n_loc + len(cols)]
    return out


# ---- the process mesh ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place on the p_r × p_c mesh of the default process
    group, and the subgroups its collectives run over.

    cols   the ranks of this rank's row team (i, 0..p_c-1): the (G, v)
           sum; None when p_c = 1 (the sum is then the identity).
    rows   the ranks of this rank's column shard (0..p_r-1, j): the
           weight average; None when p_r = 1.
    """

    p_r: int
    p_c: int
    rank: int
    cols: object = dataclasses.field(default=None, compare=False, repr=False)
    rows: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def row(self) -> int:
        return self.rank // self.p_c

    @property
    def col(self) -> int:
        return self.rank % self.p_c

    @property
    def shape(self) -> dict[str, int]:
        return {"rows": self.p_r, "cols": self.p_c}

    def group(self, axis: str):
        if axis not in ("rows", "cols"):
            raise ValueError(f"mesh axis {axis!r} not in ('rows', 'cols')")
        return self.cols if axis == "cols" else self.rows


# new_group must run on every rank in one order, once per group: meshes are
# kept per (default group, p_r, p_c), so a process that builds many sessions
# on one mesh creates its subgroups once.
_MESHES: dict = {}


def make_process_mesh(p_r: int, p_c: int) -> ProcessMesh:
    """The ("rows", "cols") mesh over the default process group, whose
    world size must be p_r·p_c. Raises, saying how to start one, when
    there is no group or its size differs. Collective: every rank calls it
    with the same (p_r, p_c)."""
    need = p_r * p_c
    how = (
        f"start {need} processes — torchrun --nproc_per_node={need} ..., or "
        f"torch.distributed.init_process_group(backend, init_method='file://...', "
        f"rank=r, world_size={need}) in each — or use backend='simulated'"
    )
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"backend='shard_map' runs one process per mesh device: a {p_r}×{p_c} mesh "
            f"needs an initialized default process group of {need} ranks, and none "
            f"exists; {how}"
        )
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"backend='shard_map' needs {need} devices (ranks) for a {p_r}×{p_c} mesh but "
            f"the default process group has {world}; {how}"
        )
    key = (dist.group.WORLD, p_r, p_c)
    mesh = _MESHES.get(key)
    if mesh is None:
        rank = dist.get_rank()
        cols = rows = None
        if p_c > 1:
            for i in range(p_r):
                g = dist.new_group([i * p_c + j for j in range(p_c)])
                if rank // p_c == i:
                    cols = g
        if p_r > 1:
            for j in range(p_c):
                g = dist.new_group([i * p_c + j for i in range(p_r)])
                if rank % p_c == j:
                    rows = g
        mesh = ProcessMesh(p_r=p_r, p_c=p_c, rank=rank, cols=cols, rows=rows)
        _MESHES[key] = mesh
    return mesh


class RankZeroWriteError(RuntimeError):
    """Raised on every other rank when rank 0's write failed (rank 0
    raises the write's own error)."""


def on_rank0(write, device: torch.device) -> None:
    """Run ``write()`` on rank 0 of the default process group alone, then
    hold every rank at a barrier that carries its outcome (a one-word
    all-reduce on ``device``, the same call on gloo and NCCL): 1 if the
    write raised. Every rank raises when it did — rank 0 its own error, the
    others ``RankZeroWriteError`` — so all ranks fail, and retry, together
    instead of pairing their next collectives with a rank that unwound.
    How a mesh run writes a checkpoint or a resume record that every rank
    may read next."""
    failed = torch.zeros(1, device=device)
    error = None
    if dist.get_rank() == 0:
        try:
            write()
        except BaseException as err:
            error = err
            failed.fill_(1.0)
    dist.all_reduce(failed)
    if error is not None:
        raise error
    if failed.item():
        raise RankZeroWriteError("rank 0 failed to write a file every rank waits for; see its error")


# ---- the round body --------------------------------------------------------


def _build_round_fn(prob: Hybrid2DProblem, sched: ParallelSGDSchedule,
                    comm: Collectives = MESH, geometry: tuple[int, int] | None = None):
    """The per-rank round body: τ inner s-step iterations + the column
    average, all communication issued through the ``comm`` collectives.
    Shared by ``make_hybrid_step`` (which runs it) and
    ``hybrid_comm_ledger`` (which captures it on meta tensors) — one
    function, so the ledger cannot drift from the executed collectives.

    ``round_fn(idx_blk, val_blk, x_loc, round_idx)`` takes this rank's
    (rows_local, width) ELL block, its (n_loc,) weight shard and the
    global round index (a host integer) and returns the new shard.
    ``geometry`` is the Gram kernel's tuned (tile, ks), or None."""
    s, b = sched.s, sched.b
    sb = s * b
    n_loc = prob.n_loc
    bundles = sched.tau // s
    objective = prob.objective
    lam = objective.l2
    eta = np.float32(sched.eta)
    scale = eta_over_b(eta, b)
    rho_s = float(_integer_pow(_decay(eta, lam), s)) if lam != 0.0 else None

    def round_fn(idx_blk, val_blk, x_loc, round_idx: int):
        m_local = idx_blk.shape[0]

        def slice_bundle(t):
            k0 = round_idx * bundles + t
            # cyclic rows [start, start + sb); clamped like a dynamic slice
            start = min((k0 * sb) % m_local, max(m_local - sb, 0))
            return idx_blk[start : start + sb], val_blk[start : start + sb]

        if sched.delay:
            # the (G, v) sum of bundle t is issued at t and awaited at t + D:
            # the D bundle-computes in between run while it is in flight
            x_loc = delayed_bundle_scan(
                x_loc, slice_bundle=slice_bundle, bundles=bundles, n=n_loc,
                sched=sched, eta=eta, objective=objective, comm=comm, geometry=geometry,
            )
            return comm.allmean_rows(x_loc)

        for t in range(bundles):
            bi, bv = slice_bundle(t)
            # the local partial (G, v) — even at s = 1, where the mesh sums
            # the full block (no SpMV special case) — then the row-team
            # Allreduce (bf16 words under the precision knob; the
            # corrections run on the fp32 upcast)
            g_part, v_part = bundle_gram_v(
                bi, bv, x_loc, n_loc, gram=sched.gram, bk=sched.bk, bm=sched.bm,
                precision=sched.precision, geometry=geometry,
            )
            g, v = comm.allreduce_cols(
                wire_gv((g_part, v_part), sched.precision), calls_per_round=bundles
            )
            g, v = unwire_gv((g, v), sched.precision)
            u = inner_corrections(g, v, s, b, eta, objective)
            # Yᵀu stays local under column partitioning
            upd = scale * ell_rmatvec(EllBlock(indices=bi, values=bv, n=n_loc), u).to(x_loc.dtype)
            # L2: the decay is elementwise, so each shard decays its own
            # slice (padded slots stay zero: ρ·0 + 0)
            x_loc = x_loc + upd if lam == 0.0 else rho_s * x_loc + upd
        # column Allreduce: the FedAvg average across row teams (n/p_c
        # words); the result is the same on every rank of the shard
        return comm.allmean_rows(x_loc)

    return round_fn


def hybrid_comm_ledger(prob: Hybrid2DProblem, sched: ParallelSGDSchedule,
                       comm: Collectives = MESH) -> CommLedger:
    """Per-rank ``CommLedger`` of the mesh execution: the *same* round
    body ``make_hybrid_step`` runs, run once on ``device="meta"`` tensors
    with the comm recorder installed (no data, no process group). Every
    collective the step will issue records its span and per-rank payload
    from the per-shard shapes."""
    round_fn = _build_round_fn(prob, sched, comm)
    block = (prob.rows_local, prob.width)
    rates = capture_rates(
        round_fn,
        torch.empty(block, dtype=prob.indices.dtype, device="meta"),
        torch.empty(block, dtype=prob.values.dtype, device="meta"),
        torch.empty((prob.n_loc,), dtype=torch.float32, device="meta"),
        0,
        spans={"cols": prob.p_c, "rows": prob.p_r},
    )
    return CommLedger(rates=rates, delay=sched.delay)


def make_hybrid_step(mesh: ProcessMesh, prob: Hybrid2DProblem,
                     sched: ParallelSGDSchedule, *, comm: Collectives = MESH,
                     geometry: tuple[int, int] | None = None):
    """Return this rank's round callable ``(idx_blk, val_blk, x_loc,
    round_idx) → x_loc``: one HybridSGD round (τ inner s-step iterations
    + the column average) with ``comm`` bound to ``mesh``'s groups.

    ``sched`` is the ``ParallelSGDSchedule`` the simulated engine
    consumes; its ``gram`` selects the bundle backend (``"kernel"`` — the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors —
    ``"blocked"`` or ``"dense"``). There is no compilation step: each call
    launches its kernels and collectives as the Python loop reaches them."""
    if sched.tau % sched.s:
        raise ValueError(f"tau={sched.tau} must be divisible by s={sched.s}")
    if mesh.shape != {"rows": prob.p_r, "cols": prob.p_c}:
        raise ValueError(
            f"mesh {mesh.shape} does not match problem layout {prob.p_r}×{prob.p_c}"
        )
    if sched.eta <= 0:
        raise ValueError(f"eta={sched.eta} must be > 0 to run the solver")
    check_delay(sched)
    if not comm.on_mesh:
        raise ValueError(
            f"make_hybrid_step needs mesh collectives (mesh/timed), got {comm.kind!r}"
        )
    return _build_round_fn(prob, sched, comm.bind(mesh), geometry)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class HybridDriver:
    """Round-incremental mesh executor for this rank.

    Holds the rank's device-resident state (its ELL block and weight
    shard) between calls, so drivers above it — the
    ``repro_torch.api.Session`` lifecycle — can advance the computation
    ``k`` rounds at a time, probe the objective, checkpoint, and go on.

    The round counter is part of the carry: ``advance(k)`` runs global
    rounds ``rounds_done .. rounds_done+k-1``, so chunked execution
    reproduces the uninterrupted loop's sample sequence exactly.

    The driver owns the run's ``CommLedger``: the collectives of the
    round body are captured once at construction (``hybrid_comm_ledger``
    on the round body the step executes) and committed per advanced
    round. With ``comm=TIMED`` each round waits for the device and its
    wall seconds land in the ledger — the §6.5 calibration input.

    ``device=None`` means ``cuda:(rank % device_count)`` (or an error
    without CUDA), as ``repro_torch.resolve_device`` rules. The rank holds
    nothing of the problem but its block: ``loss`` too is computed from
    the blocks. ``geometry`` is the Gram kernel's tuned (tile, ks) for
    this rank's column-local bundles (None: the kernel's default).
    """

    def __init__(
        self,
        mesh: ProcessMesh,
        prob: Hybrid2DProblem,
        cp: ColumnPartition,
        x0: np.ndarray,
        sched: ParallelSGDSchedule,
        rounds_done: int = 0,
        comm: Collectives = MESH,
        device=None,
        geometry: tuple[int, int] | None = None,
    ):
        self.mesh = mesh
        self.geometry = geometry
        self.prob = prob
        self.cp = cp
        self._localizer = None  # built at the first streamed batch
        self.sched = sched
        self.rounds_done = int(rounds_done)
        self.comm = comm.bind(mesh)
        self.device = resolve_device(device)
        self.ledger = hybrid_comm_ledger(prob, sched, comm)
        self.ledger.rounds = self.rounds_done
        self._step = make_hybrid_step(mesh, prob, sched, comm=comm, geometry=geometry)
        i, j = mesh.row, mesh.col
        idx, val = prob.rank_block(i, j)
        self._idx = idx.to(self.device).contiguous()
        self._val = val.to(self.device).contiguous()
        # the real (unpadded) rows of this rank's row team: the loss masks
        # the pads (a zero row has margin 0 and a nonzero loss)
        rb = partition_rows(prob.m, prob.p_r)
        self._rows_real = int(rb[i + 1] - rb[i])
        self.set_x(x0)

    def _shard(self, x_pad: np.ndarray) -> torch.Tensor:
        n_loc, j = self.prob.n_loc, self.mesh.col
        return torch.from_numpy(np.ascontiguousarray(x_pad[j * n_loc : (j + 1) * n_loc])).to(self.device)

    def _run_round(self, idx, val) -> None:
        t0 = time.perf_counter() if self.comm.timed else 0.0
        self._x_loc = self._step(idx, val, self._x_loc, self.rounds_done)
        if self.comm.timed:
            _sync(self._x_loc)
            self.ledger.add_round_seconds(time.perf_counter() - t0)
        self.rounds_done += 1
        self.ledger.rounds = self.rounds_done

    def advance(self, k: int) -> None:
        """Run ``k`` rounds; the weights stay on the device. Timed
        collectives wait per round and record wall seconds."""
        for _ in range(int(k)):
            self._run_round(self._idx, self._val)

    def advance_stream(self, indices: np.ndarray, values: np.ndarray) -> None:
        """Run ONE round over streamed data instead of the resident
        blocks: ``(p_r, p_c, rows_local, width)`` ELL shards with
        shard-local column ids; this rank takes its (i, j) block. The round
        body slices bundles modulo the operand's row count, so with
        ``rows_local = τ·b`` the τ/s bundles walk the fresh rows exactly
        once at *any* round index."""
        i, j = self.mesh.row, self.mesh.col
        idx = torch.as_tensor(np.ascontiguousarray(indices[i, j]), dtype=torch.int32).to(self.device)
        val = torch.as_tensor(np.ascontiguousarray(values[i, j]), dtype=torch.float32).to(self.device)
        self._run_round(idx, val)

    def advance_batch(self, batch) -> None:
        """Run ONE round over a micro-batch (global column ids): the
        batch becomes column-local shards of this driver's partition
        (``repro_torch.serve.ingest``), then ``advance_stream``."""
        from repro_torch.serve.ingest import ColumnLocalizer, stream_shard_arrays  # the serve package imports this module

        if self._localizer is None:
            self._localizer = ColumnLocalizer.from_partition(self.cp)
        self.advance_stream(*stream_shard_arrays(batch, self._localizer, self.prob.p_r, batch.width))

    def sync(self) -> None:
        """Wait until all dispatched rounds complete — no host copy."""
        _sync(self._x_loc)

    def phase_probes(self) -> dict:
        """Per-phase probes over this driver's real payload shapes — the
        §6.5 phase split, measured *outside* the training step.

        Returns ``{phase: (fn, args, calls_per_round)}``:

          bundle_compute  this rank's local partial (G, v) over an
                          (s·b, width) ELL bundle of its block (Eq. 4's γ
                          term);
          allreduce_gv    the (s²b² + sb)-word sum over the "cols" group
                          (Table 3's row-team payload), in the wire dtype;
          param_avg       the n_loc-word mean over the "rows" group.

        Probes run on zero-filled payloads of the true shapes (comm cost
        is shape-dependent, data-independent). The comm probes are
        collectives: every rank times them together."""
        sched, prob = self.sched, self.prob
        sb = sched.s * sched.b
        bundles = sched.tau // sched.s
        reps = -(-sb // prob.rows_local)
        bi = self._idx.repeat(reps, 1)[:sb].contiguous()
        bv = self._val.repeat(reps, 1)[:sb].contiguous()
        x_loc = torch.zeros((prob.n_loc,), dtype=torch.float32, device=self.device)

        def compute(i, v, x):
            return bundle_gram_v(i, v, x, prob.n_loc, gram=sched.gram, bk=sched.bk,
                                 bm=sched.bm, precision=sched.precision, geometry=self.geometry)

        # the probed sum carries the wire dtype: a bf16 schedule's
        # allreduce_gv reflects the halved payload
        gv_dt = torch.bfloat16 if sched.precision == "bf16" else torch.float32
        g0 = torch.zeros((sb, sb), dtype=gv_dt, device=self.device)
        v0 = torch.zeros((sb,), dtype=gv_dt, device=self.device)
        xp = torch.zeros((prob.n_loc,), dtype=torch.float32, device=self.device)
        return {
            "bundle_compute": (compute, (bi, bv, x_loc), bundles),
            "allreduce_gv": (lambda g, v: self.comm.allreduce_cols((g, v)), (g0, v0), bundles),
            "param_avg": (lambda x: self.comm.allmean_rows(x), (xp,), 1),
        }

    def gather(self) -> np.ndarray:
        """Current global weights (n,) on the host, the same bits on
        every rank: the shard in place in a zero (p_c·n_loc,) buffer,
        summed over the "cols" group (x + 0 = x: exact). Collective."""
        n_loc, j = self.prob.n_loc, self.mesh.col
        buf = torch.zeros((self.prob.p_c * n_loc,), dtype=self._x_loc.dtype, device=self.device)
        buf[j * n_loc : (j + 1) * n_loc] = self._x_loc
        if self.mesh.cols is not None:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.mesh.cols)
        return gather_x(buf.cpu().numpy(), self.cp, n_loc, self.prob.n)

    def write(self, fn) -> None:
        """Write a file every rank may read next: rank 0 alone runs
        ``fn``, every rank waits for it and fails with it (``on_rank0``)."""
        on_rank0(fn, self.device)

    def agreed_max(self, value: float) -> float:
        """The largest of the ranks' ``value``s, on every rank (one
        all-reduce): how ranks reach one verdict on a host reading."""
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def set_x(self, x: np.ndarray) -> None:
        """Replace the weights (checkpoint restore). Padded layout slots
        never receive updates (no row references them), so a
        gather → set_x round trip is lossless."""
        x = np.asarray(x, dtype=np.float32)
        self._x_loc = self._shard(scatter_x(x, self.cp, self.prob.n_loc))

    def loss(self) -> float:
        """Full global objective f(x) = (1/m)Σℓ(margin) + (λ/2)‖x‖² at the
        current iterate, from the blocks: the rank's partial margins
        Y_ij·x_j, summed over the "cols" group, give its row team's
        margins; the ranks of column shard 0 contribute their team's loss
        sum, those of row team 0 their shard's ‖x_j‖², and one all-reduce
        over the default group adds both. Every rank gets the same value.
        Collective."""
        prob, mesh = self.prob, self.mesh
        margin = ell_matvec(EllBlock(indices=self._idx, values=self._val, n=prob.n_loc), self._x_loc)
        if mesh.cols is not None:
            dist.all_reduce(margin, op=dist.ReduceOp.SUM, group=mesh.cols)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum = prob.objective.pointwise_loss(margin[: self._rows_real]).sum() if mesh.col == 0 else zero
        sq_norm = torch.sum(self._x_loc * self._x_loc) if mesh.row == 0 else zero
        terms = torch.stack([loss_sum, sq_norm])
        dist.all_reduce(terms, op=dist.ReduceOp.SUM)
        f = terms[0] / prob.m
        if prob.objective.l2:
            f = f + 0.5 * prob.objective.l2 * terms[1]
        return float(f)


def run_hybrid_distributed(
    mesh: ProcessMesh,
    prob: Hybrid2DProblem,
    cp: ColumnPartition,
    x0: np.ndarray,
    sched: ParallelSGDSchedule,
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Driver: place this rank's block once, run ``sched.rounds`` rounds,
    gather x — a thin loop over ``HybridDriver``, one ``advance`` per
    loss-sampling chunk. Returns ``(x, losses)``, the contract of the
    simulated engine's ``run_parallel_sgd``: the full global objective is
    sampled every ``sched.loss_every`` rounds (empty trace when 0), from
    the blocks (``HybridDriver.loss``). Collective: every rank of the mesh
    calls it."""
    driver = HybridDriver(mesh, prob, cp, x0, sched, device=device)
    losses = []
    chunk = sched.loss_every if sched.loss_every else sched.rounds
    while driver.rounds_done < sched.rounds:
        driver.advance(min(chunk, sched.rounds - driver.rounds_done))
        if sched.loss_every and driver.rounds_done % sched.loss_every == 0:
            losses.append(driver.loss())
    return driver.gather(), np.asarray(losses, dtype=np.float32)
