"""Production mesh builders, over the default process group.

Single-pod: (16, 16) = ("data", "model") — 256 devices.
Multi-pod:  (2, 16, 16) = ("pod", "data", "model") — 512 devices.

One process a mesh device (SPMD): the caller starts the processes and the
default process group (``torchrun``, or ``init_process_group`` with a
``file://`` store); a mesh is a ``DeviceMesh`` with named dims over it.
Functions, not module constants, so importing never touches process-group
state. The axis semantics implement the paper's mesh: "model" is the
frequent/exact axis (p_c), "pod" is the τ-deferred FedAvg axis (p_r).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import _resolve_process_group
from torch.distributed.device_mesh import DeviceMesh

from repro_torch._device import resolve_device

# new_group runs on every rank in one order, once a group: meshes are kept
# per (default group, device type, shape, axes)
_MESHES: dict = {}


def _all_gather_into_tensor(input, group_size, group_name):
    group = group_name if isinstance(group_name, dist.ProcessGroup) else _resolve_process_group(group_name)
    out = input.new_empty((group_size * input.shape[0],) + tuple(input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(), group=group)
    return out


_PLAIN_ALL_GATHER: list = []


def plain_all_gather_needed(backend: str) -> bool:
    """Whether a mesh over a default group of ``backend`` must gather through
    the plain c10d all-gather: only gloo's. DTensor gathers shards through the
    functional all-gather, which gloo runs as a coalesced all-gather that
    crashes the process (SIGSEGV) on CUDA tensors (torch 2.11); gloo's plain
    all-gather of CUDA tensors works. NCCL runs the functional all-gather
    itself, asynchronously on its stream as DTensor expects: the model mesh
    held every oracle with it on four H100s, one card a rank. The fake
    backend of the dry run moves nothing."""
    return "gloo" in str(backend).lower()


def _use_plain_all_gather() -> None:
    """Replace the functional all-gather's kernel for CPU and CUDA tensors by
    the plain c10d one (once a process: a gloo mesh's, ``plain_all_gather_needed``)."""
    if not _PLAIN_ALL_GATHER:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        for key in ("CPU", "CUDA"):
            lib.impl("all_gather_into_tensor", _all_gather_into_tensor, key)
        _PLAIN_ALL_GATHER.append(lib)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group, whose world size must be the product of
    ``shape`` (rank r at the row-major position r). ``device`` gives the
    device type (None: CUDA, or an error; "cpu" for gloo on the host).
    Raises, saying how to start one, when there is no group or its size
    differs. Collective: every rank calls it with the same arguments."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    need = math.prod(shape)
    how = (
        f"start {need} processes — torchrun --nproc-per-node={need} ..., or "
        f"torch.distributed.init_process_group(backend, init_method='file://...', "
        f"rank=r, world_size={need}) in each"
    )
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {'×'.join(map(str, shape))} {axes} mesh runs one process per mesh device: it "
            f"needs an initialized default process group of {need} ranks, and none exists; {how}"
        )
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"a {'×'.join(map(str, shape))} {axes} mesh needs {need} devices (ranks) but the "
            f"default process group has {world}; {how}"
        )
    device_type = resolve_device(device).type
    if plain_all_gather_needed(dist.get_backend()):
        _use_plain_all_gather()
    key = (dist.group.WORLD, device_type, shape, axes)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)
        _MESHES[key] = mesh
    return mesh


def device_count_needed(*, multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
