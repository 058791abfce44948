"""Logical → physical sharding for the model zoo, on ``torch.distributed``.

Activations and parameters are annotated with *logical* dims; the rules
table maps them to mesh dims (single-pod ("data", "model") or multi-pod
("pod", "data", "model")) — the reference's tables, copied as data.
Annotations are no-ops when no mesh is active, or on a plain tensor
(single-device runs).

The reference's GSPMD becomes DTensor: parameters are ``DTensor``s on a
``DeviceMesh`` with named dims (one process a mesh device), a spec's
per-dim axis tuples become ``Shard``/``Replicate`` placements
(``placements``), and ``shard`` — the counterpart of
``with_sharding_constraint`` — redistributes a DTensor to the rule's
placements. DTensor propagates placements through every other op, and
redistributes where an op needs it, as GSPMD does.

The active mesh is this module's own context (the reference's
``compat.set_mesh`` / ``use_mesh`` / ``get_abstract_mesh`` /
``manual_axes``): ``manual(axes)`` marks dims as manual, as an enclosing
``shard_map`` does — inside the hybrid-2D pod region (``optim/hybrid2d.py``)
the "pod" dim is manual, every DTensor lives on the ("data", "model")
sub-mesh (``auto_mesh``), and no rule places anything on "pod".

The paper's mesh semantics: "data" (+ "pod") is the FedAvg/row-team axis
p_r — batch-parallel, τ-deferrable; "model" is the column axis p_c — exact
parameter sharding, the n/p_c role.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# The active profile is set by the model entry points (forward /
# decode_step) from cfg.sharding_profile; "dp" folds the model axis
# into the batch dims and disables TP rules.
_PROFILE = "tp"


def set_profile(profile: str) -> None:
    global _PROFILE
    _PROFILE = profile


RULES_DP: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data", "model"),
    "cache_seq": ("model",),  # decode caches may still seq-shard
    "vocab": ("model",),  # vocab-parallel head survives under dp
    "d_inner": (),
    None: (),
}


def _rules() -> dict[str, tuple[str, ...]]:
    return RULES_DP if _PROFILE == "dp" else RULES


# logical dim -> tuple of mesh axes (joined if several exist)
RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),  # unsharded by default
    "act_seq": ("model",),  # sequence-parallel residual stream (Megatron-SP)
    "cache_seq": ("model",),  # KV-cache seq dim: sequence-parallel reads
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "embed": (),  # d_model replicated on the model axis
    "embed_fsdp": ("data",),  # FSDP: weight-stationary dim over data
    "experts": ("model",),
    "d_inner": ("model",),  # mamba channel parallelism
    "lora": (),
    None: (),
}


# ---------------------------------------------------------------- the active mesh


class _Ambient:
    """The active mesh and the dims an enclosing region made manual."""

    def __init__(self):
        self.mesh: DeviceMesh | None = None
        self.manual: frozenset[str] = frozenset()


_ambient = _Ambient()


class _SetMeshHandle:
    """Applies at once (as ``jax.sharding.set_mesh``); as a context
    manager it restores the previous mesh on exit."""

    def __init__(self, mesh, prev):
        self._mesh, self._prev = mesh, prev

    def __enter__(self):
        return self._mesh

    def __exit__(self, *exc):
        _ambient.mesh = self._prev
        return False


def set_mesh(mesh: DeviceMesh | None) -> _SetMeshHandle:
    """Make ``mesh`` the active mesh (None: none)."""
    prev = _ambient.mesh
    _ambient.mesh = mesh
    return _SetMeshHandle(mesh, prev)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None):
    """Scoped active mesh — always restores on exit."""
    handle = set_mesh(mesh)
    try:
        yield mesh
    finally:
        handle.__exit__(None, None, None)


def get_abstract_mesh() -> DeviceMesh | None:
    """The active mesh, or None."""
    return _ambient.mesh


def manual_axes(mesh=None) -> frozenset[str]:
    """Mesh dims made manual by an enclosing region (``manual``)."""
    return _ambient.manual


@contextlib.contextmanager
def manual(axes):
    """Mark ``axes`` manual inside the block, as the reference's
    ``shard_map(..., axis_names=axes)`` does: no rule places anything on
    them, and ``auto_mesh`` leaves them out."""
    prev = _ambient.manual
    _ambient.manual = prev | frozenset(axes)
    try:
        yield
    finally:
        _ambient.manual = prev


def _active_axes() -> frozenset[str]:
    """Mesh dims usable by a rule here: the active mesh's, less the
    manual ones."""
    mesh = get_abstract_mesh()
    if mesh is None:
        return frozenset()
    return frozenset(mesh.mesh_dim_names) - manual_axes()


def auto_mesh(mesh: DeviceMesh | None = None) -> DeviceMesh | None:
    """``mesh`` (default: the active one) restricted to its non-manual dims
    — the mesh this process's DTensors live on. None without a mesh or
    when every dim is manual."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    names = tuple(a for a in mesh.mesh_dim_names if a not in manual_axes())
    if not names:
        return None
    return mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]


def mesh_sizes(mesh) -> dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` or of a mapping of the same
    (a mesh shape needs no processes, e.g. the production (16, 16))."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def like(t: torch.Tensor, ref):
    """``t`` (a plain tensor every rank holds whole: a RoPE table, a mask,
    token ids) as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor; else ``t`` as it is. DTensor refuses an op that mixes the two
    kinds, forward and backward."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim, run_check=False)
    return t


# ---------------------------------------------------------------- specs


def spec_for(*dims: str | None, axes: frozenset[str] | None = None) -> tuple:
    """The reference's ``PartitionSpec`` entries for logical dims, filtered
    to the active mesh: per dim None, an axis name, or a tuple of them."""
    active = _active_axes() if axes is None else axes
    rules = _rules()
    entries = []
    for dim in dims:
        axs = tuple(a for a in rules.get(dim, ()) if a in active)
        if not axs:
            entries.append(None)
        elif len(axs) == 1:
            entries.append(axs[0])
        else:
            entries.append(axs)
    return tuple(entries)


def placements(spec: tuple, mesh: DeviceMesh) -> list:
    """DTensor placements on ``mesh`` for a spec (per tensor dim: None, an
    axis name or a tuple of them): ``Shard(i)`` on each mesh dim that
    tensor dim i names, ``Replicate`` on the rest. A tensor dim split over
    several mesh dims is split in mesh order (the major index first), as
    the rules name them; axes absent from ``mesh`` are ignored, and so are
    dims of size 1 (a split in one part is the whole tensor: ``Replicate``
    lets DTensor reshape it freely)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axs = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        axs = tuple(a for a in axs if a in names)
        if list(axs) != sorted(axs, key=names.index):
            raise ValueError(f"spec entry {entry!r} splits dim {i} out of the mesh order {names}")
        for a in axs:
            if mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(i)
    return out


def shard(x, *dims: str | None):
    """Counterpart of ``with_sharding_constraint`` on logical dims:
    redistributes a DTensor to the rule's placements (never changing its
    values). A no-op on a plain tensor, without an active mesh, or where a
    dim is not divisible by its axes: trailing axes are dropped until it
    divides (the reference's greedy prefix)."""
    if not isinstance(x, DTensor):
        return x
    active = _active_axes()
    if not active:
        return x
    mesh = x.device_mesh
    sizes = mesh_sizes(mesh)
    rules = _rules()
    entries: list = []
    used: set[str] = set()
    for dim, size in zip(dims, x.shape):
        axs = tuple(a for a in rules.get(dim, ()) if a in active and a in sizes and a not in used)
        # greedy prefix: drop trailing axes until the dim divides
        while axs:
            total = 1
            for a in axs:
                total *= sizes[a]
            if size % total == 0:
                break
            axs = axs[:-1]
        if axs:
            used.update(axs)
            entries.append(axs)
        else:
            entries.append(None)
    want = placements(tuple(entries), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_region(fn, *inputs):
    """``fn`` on this rank's blocks, for a computation DTensor's sharding
    propagation cannot partition (an einsum whose batch dims are split over
    two mesh dims, a padded convolution, a scan): the counterpart of a
    manual region. ``inputs`` are (tensor, logical dims) pairs: each is laid
    out by the rules (``shard``) and taken local. A mesh dim along which some
    input is split partitions the work, so an input replicated along it
    gets a partial-sum gradient there. ``fn``'s result is laid out as the
    first input, which must be split along every such dim. Without a
    DTensor among the inputs ``fn`` runs on them as they are."""
    ref = next((t for t, _ in inputs if isinstance(t, DTensor)), None)
    if ref is None:
        return fn(*(t for t, _ in inputs))
    laid = [shard(like(t, ref), *dims) for t, dims in inputs]
    laid = [t.redistribute(t.device_mesh, [Replicate() if isinstance(q, Partial) else q for q in t.placements])
            if any(isinstance(q, Partial) for q in t.placements) else t for t in laid]
    split = {i for t in laid for i, q in enumerate(t.placements) if isinstance(q, Shard)}
    out_pl = laid[0].placements
    if any(not isinstance(out_pl[i], Shard) for i in split):
        raise ValueError(f"the region's first input {out_pl} is not split along every split mesh dim {sorted(split)}")
    local = [t.to_local(grad_placements=[Partial() if i in split and isinstance(q, Replicate) else q
                                         for i, q in enumerate(t.placements)]) for t in laid]
    return DTensor.from_local(fn(*local), ref.device_mesh, out_pl, run_check=False)
