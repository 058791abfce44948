"""Roofline models on an NVIDIA H100: the language-model dry run's terms
and the bundle (G, v) build's bounds — the reference's roofline module.

Three models live here:

* the **dry-run terms** (``RooflineTerms``, ``extrapolate_depth``,
  ``model_flops_per_step``, ``CollectiveStats``, ``count_collectives``): per
  (arch × shape × mesh), from one rank's counts of the real step
  (``launch/dryrun.py``),

    compute term    = FLOPs a rank / PEAK_FLOPS_BF16
    memory term     = HBM bytes a rank / HBM_BW
    collective term = collective bytes a rank / LINK_BW

  ``model_flops_per_step`` is 6·N·D (train) or 2·N·D (inference) with N the
  active parameters less the input embedding, as the reference counts it;
  its ratio to the counted FLOPs is the useful share. The reference reads
  its collectives from XLA's HLO text; the port has no HLO, and
  ``count_collectives`` counts the collectives a step issues instead.
* the **panel model** (``panel_vmem_bytes``, ``panel_flops``,
  ``panel_hbm_bytes``, ``PanelRoofline``, ``panel_roofline``): the
  reference's count of a (bk, bm) panel walk — the plain
  ``ell_gram_and_v_blocked`` walks exactly these panels. The counts do not
  depend on the chip and equal the reference's for equal arguments; the
  rates and the fit check are the H100's. The CPU autotuner prices its
  (bk, bm) candidates with it.
* the **probe bound** (``probe_bound``): the least time the card could
  take for the function the CUDA kernel computes, whatever its design —
  the bytes it must move (the ELL bundle's ids and values, each distinct
  gathered x entry, G and v, each once) over the memory rate, against
  the operations it must do (a multiply-add per pair of nonzeros of rows
  i > j that share a column id, one per nonzero for v) over the fp32
  rate. The card's autotuner cross-checks its (tile, ks) timings with it,
  and ``chip_smoke.py`` reports it as each Gram row's ``bound_ms``.

Rates: the H100 SXM's published peaks (NVIDIA's H100 data sheet) — 80 GB
HBM3 at 3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores (the Gram
kernel is fp32 FMA in both modes: a bf16 product is exact in fp32), 989
TFLOP/s bf16 dense on the tensor cores (the bf16 panel of the plain walk
is a matmul; the dry run's compute term). The collective term uses the
**inter-node** rate, one ConnectX-7 NDR InfiniBand link a GPU, 400 Gb/s =
50 GB/s (``LINK_BW``): the production meshes (16, 16) and (2, 16, 16) span
32 and 64 eight-GPU HGX nodes, so both mesh axes cross nodes. NVLink 4's
900 GB/s a GPU (both directions) is ``NVLINK_BW``, the rate inside a node.
The Gram fit check is the kernel's dynamic shared memory a block,
``SMEM_LIMIT``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ell_gram import SMEM_LIMIT

# NVIDIA H100 SXM, published peaks (one card)
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9  # HBM3 capacity
PEAK_FLOPS_FP32 = 67e12  # FMA units, no tensor cores
PEAK_FLOPS_BF16 = 989e12  # tensor cores, dense
SMEM_BYTES = SMEM_LIMIT  # dynamic shared memory a block may use (sm_90)
LINK_BW = 400e9 / 8  # B/s a GPU between nodes: one ConnectX-7 NDR link, 400 Gb/s
NVLINK_BW = 900e9  # B/s a GPU inside a node, NVLink 4, both directions

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


# ---- the dry run's collectives ----


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]
    in_while_body: bool  # the reference's flag; an eager step has no loop body

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


# the collective ops a step can issue: DTensor's functional ones, its own
# all-to-all (``_dtensor::shard_dim_alltoall``: a Shard(i) → Shard(j)
# redistribute on a CUDA mesh, whose all-to-all runs inside the op where no
# dispatch mode sees it; a CPU mesh gathers and chunks instead) and the c10d
# ones (moe_ep's all_to_all and gathers, the plain all-gather that
# launch/mesh.py installs on gloo), by op name
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
# bookkeeping ops of the same namespaces: no data moves between ranks
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_", "mesh_get_process_group"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class _CollectiveCounter(TorchDispatchMode):
    def __init__(self, stats: CollectiveStats, log: list | None):
        super().__init__()
        self.stats, self.log = stats, log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            # DTensor runs first and issues its collectives, which come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._opname
            if name not in _NOT_COLLECTIVES:
                kind = _KIND_OF.get(name)
                if kind is None:
                    raise ValueError(f"count_collectives does not know the collective {func}")
                # the output buffer's bytes, as the reference reads an HLO
                # collective's result shape: the functional ops (and
                # DTensor's all-to-all) return it, the c10d ones write it
                # into their first argument
                nbytes = _nbytes(args[0] if func.namespace == "c10d" else out)
                self.stats.bytes_by_kind[kind] += nbytes
                self.stats.count_by_kind[kind] += 1
                if self.log is not None:
                    self.log.append((kind, nbytes))
        return out


@contextlib.contextmanager
def count_collectives(log: list | None = None):
    """Counts the collectives this process issues inside the block, by kind,
    with the bytes of each one's output buffer on this rank (the reference
    counts an HLO collective's result shape the same way): yields the
    ``CollectiveStats``, filled as the block runs. ``log``, if given, gets
    one (kind, bytes) a collective, in order. Sees DTensor's functional
    collectives, its all-to-all and ``torch.distributed``'s own calls, on
    real and fake tensors alike; a collective it does not know raises
    ``ValueError``."""
    stats = CollectiveStats({k: 0 for k in COLLECTIVE_KINDS}, {k: 0 for k in COLLECTIVE_KINDS}, False)
    with _CollectiveCounter(stats, log):
        yield stats


# ---- the dry run's terms ----


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops: float  # a rank, full depth
    hbm_bytes: float
    collective_bytes: float
    collective_breakdown: dict[str, int]
    model_flops: float  # 6·N_active·D (global) / ranks
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_per_dev": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "collectives": self.collective_breakdown,
        }


def extrapolate_depth(v1: float, v2: float, n_periods: int) -> float:
    """cost(P) = base + P·per_period, measured at P=1 and P=2."""
    per = max(v2 - v1, 0.0)
    base = max(v1 - per, 0.0)
    return base + n_periods * per


def model_flops_per_step(cfg, shape, kind: str) -> float:
    """6·N_active·D global model FLOPs for the step (3 matmul passes
    fwd+bwd for train; 2·N·D for inference forward)."""
    n_active = cfg.active_param_count() - cfg.vocab_size * cfg.d_model * (
        0 if cfg.tie_embeddings else 1
    )  # lm_head counted once below; embedding lookup is a gather
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: 1 token/seq
    return 2.0 * n_active * tokens


# ---- the panel model (the plain walk's count) ----
#
# The plain walk takes ⌈n/bk⌉ column panels; per panel it expands the
# (sb, w) ELL block into a (sb, bk) dense panel (one-hot contraction,
# 2·sb·w·bk FLOPs), accumulates G += P·Pᵀ (2·sb²·bk) and v += P·x_blk
# (2·sb·bk). The ELL block is re-read once per panel.


def panel_vmem_bytes(
    rows: int, width: int, bk: int, bm: int | None = None, compute_bytes: int = 4
) -> int:
    """On-chip working set of one panel step: the (bm, bk) expanded panel
    tile at compute precision plus the resident ELL block (indices +
    values), G, v, and x panel (all f32/i32). (The reference's name: the
    count is the same, the fit check is against shared memory.)"""
    bm = rows if bm is None or bm > rows else bm
    panel = bm * bk * compute_bytes
    resident = rows * width * (4 + 4) + rows * rows * 4 + rows * 4 + bk * 4
    return panel + resident


def panel_flops(rows: int, width: int, n: int, bk: int) -> float:
    """Total FLOPs of one (G, v) bundle build at panel width bk."""
    n_panels = -(-n // bk)
    per_panel = 2 * rows * width * bk + 2 * rows * rows * bk + 2 * rows * bk
    return float(n_panels * per_panel)


def panel_hbm_bytes(
    rows: int, width: int, n: int, bk: int, compute_bytes: int = 4
) -> float:
    """Memory traffic of one bundle build: the ELL block re-streamed once
    per panel, x streamed once, G and v written once."""
    n_panels = -(-n // bk)
    ell = n_panels * rows * width * (4 + 4)  # int32 indices + f32 values
    x = n_panels * bk * 4
    out = rows * rows * 4 + rows * 4
    return float(ell + x + out)


@dataclasses.dataclass(frozen=True)
class PanelRoofline:
    """Attainable-time bound for one (rows, width, n, bk, bm) panel
    configuration — what the CPU autotuner cross-checks measured time
    against (a measurement below the bound is a timer glitch)."""

    rows: int
    width: int
    n: int
    bk: int
    bm: int | None
    flops: float
    hbm_bytes: float
    vmem_bytes: int
    peak_flops: float = PEAK_FLOPS_FP32
    hbm_bw: float = HBM_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def attainable_s(self) -> float:
        """Roofline lower bound on the bundle build (max of the terms)."""
        return max(self.compute_s, self.memory_s)

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def fits_vmem(self) -> bool:
        """The working set fits one block's shared memory on the card."""
        return self.vmem_bytes <= SMEM_BYTES


def panel_roofline(
    rows: int,
    width: int,
    n: int,
    bk: int,
    bm: int | None = None,
    precision: str = "fp32",
) -> PanelRoofline:
    """The attainable-time justification for one (bk, bm) candidate:
    bf16 panels at the tensor cores' bf16 peak with 2-byte tiles, fp32
    at the fp32 peak with 4-byte tiles."""
    cb = 2 if precision == "bf16" else 4
    peak = PEAK_FLOPS_BF16 if precision == "bf16" else PEAK_FLOPS_FP32
    return PanelRoofline(
        rows=rows,
        width=width,
        n=n,
        bk=bk,
        bm=bm,
        flops=panel_flops(rows, width, n, bk),
        hbm_bytes=panel_hbm_bytes(rows, width, n, bk, cb),
        vmem_bytes=panel_vmem_bytes(rows, width, bk, bm, cb),
        peak_flops=peak,
    )


# ---- the probe bound (the function's own count) ----


@dataclasses.dataclass(frozen=True)
class ProbeBound:
    """The least time of one (G, v) build of a given bundle on the card:
    ``bytes`` moved once over ``HBM_BW`` against ``operations`` (a
    multiply-add counts two) over ``PEAK_FLOPS_FP32``."""

    bytes: float
    operations: float
    pairs: float  # multiply-adds G needs: shared column ids of rows i > j

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def compute_s(self) -> float:
        return self.operations / PEAK_FLOPS_FP32

    @property
    def attainable_s(self) -> float:
        return max(self.memory_s, self.compute_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.compute_s > self.memory_s else "bytes"


def matching_pairs(indices, values) -> float:
    """Σ_{i>j} of the nonzero entries of rows i and j that share a column
    id: the multiply-adds G needs on this bundle (numpy arrays)."""
    indices, values = np.asarray(indices), np.asarray(values)
    nz = values != 0
    rows = np.broadcast_to(np.arange(indices.shape[0])[:, None], indices.shape)[nz].astype(np.int64)
    cols = indices[nz].astype(np.int64)
    per_col = np.unique(cols, return_counts=True)[1].astype(np.float64)
    per_cell = np.unique(rows * (int(cols.max(initial=0)) + 1) + cols, return_counts=True)[1].astype(np.float64)
    return float(((per_col ** 2).sum() - (per_cell ** 2).sum()) / 2)


def probe_bound(indices, values) -> ProbeBound:
    """The bound of one (G, v) build of the (sb, w) ELL bundle
    (``indices``, ``values``; numpy arrays or tensors, read on the host):
    bytes = ids + values + each distinct gathered x entry + G + v, 4 bytes
    each; operations = 2 per matching pair + 2 per nonzero."""
    indices = indices.cpu().numpy() if hasattr(indices, "cpu") else np.asarray(indices)
    values = values.cpu().numpy() if hasattr(values, "cpu") else np.asarray(values)
    sb = indices.shape[0]
    nbytes = indices.size * 8 + np.unique(indices).size * 4 + sb * sb * 4 + sb * 4
    pairs = matching_pairs(indices, values)
    ops = 2.0 * pairs + 2.0 * float(np.count_nonzero(values))
    return ProbeBound(bytes=float(nbytes), operations=ops, pairs=pairs)
