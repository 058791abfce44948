"""Hybrid 2D training — the paper's HybridSGD mesh semantics applied to
NN training.

Axis mapping (the paper → this trainer):

  row teams p_r   → the "pod" mesh dim: each pod is a FedAvg group. Each
                    pod trains its own replica on its share of the batch
                    with NO cross-pod communication for τ steps.
  column axis p_c → the "model" (+ FSDP "data") dims: exact sharded
                    compute inside the pod (DTensor placements,
                    ``models/sharding.py``); its collectives stay inside
                    the pod's processes — the topology rule (Eq. 7).
  τ sync          → ``make_sync_step``: the parameter mean over the pods —
                    one n/p_c-sized payload a rank over the slow axis,
                    amortized 1/τ, exactly the paper's column Allreduce.

The s-step Gram identity is exact only for the convex core; here the
row-team inner solver is plain local SGD (the FedAvg limit), the NN
analogue.

One process a mesh device, so the "pod" dim is the process dimension: a
rank holds only its own pod's replica, as DTensors on the pod's ("data",
"model") sub-mesh (``pod_mesh``), and its optimizer state. The step runs
with "pod" manual (``sharding.manual``), as the reference's ``shard_map``
over "pod" does. The reference's stacked tree (a leading ``n_pods`` dim)
is what ``gather_pods`` builds and ``unstack_for_pod`` takes apart, for
tests and checkpoints; ``stack_for_pods`` is the reference's. On a
single-pod mesh this is standard 2D data × model training.

The schedule knobs are the engine's ParallelSGDSchedule
(repro_torch.core.engine): p_r ↦ n_pods and τ ↦ the pod-sync period.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch._tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.core.engine import ParallelSGDSchedule
from repro_torch.models.init import gather_params
from repro_torch.models.sharding import manual, use_mesh
from repro_torch.optim.sgd import Optimizer


def _pod_axis(mesh) -> tuple[str | None, int]:
    if "pod" in mesh.mesh_dim_names:
        return "pod", mesh.size(mesh.mesh_dim_names.index("pod"))
    return None, 1


def pod_index(mesh: DeviceMesh) -> int:
    """This rank's pod (0 on a mesh without a "pod" dim)."""
    return mesh.get_local_rank("pod") if "pod" in mesh.mesh_dim_names else 0


def pod_mesh(mesh: DeviceMesh) -> DeviceMesh | None:
    """The sub-mesh a pod's replica lives on: ``mesh`` less its "pod" dim
    (None when "pod" is its only dim)."""
    names = tuple(a for a in mesh.mesh_dim_names if a != "pod")
    if not names:
        return None
    return mesh if len(names) == mesh.ndim else mesh[names]


def stack_for_pods(params: Any, n_pods: int) -> Any:
    """Give every pod its own replica: a leading n_pods dim (the
    reference's stacked layout)."""
    return tree_map(lambda p: torch.stack([p] * n_pods), params)


def unstack_for_pod(stacked: Any, mesh: DeviceMesh) -> Any:
    """This rank's pod's slice of a stacked tree."""
    p = pod_index(mesh)
    return tree_map(lambda t: t[p], stacked)


def gather_pods(tree: Any, mesh: DeviceMesh) -> Any:
    """Every pod's tree (this rank's is ``tree``: DTensors or plain
    tensors) → the stacked tree of full tensors (a leading n_pods dim),
    the same on every rank. Collective: every rank calls it."""
    full = gather_params(tree)
    pod_name, n_pods = _pod_axis(mesh)
    if pod_name is None:
        return tree_map(lambda t: t[None], full)
    group = mesh.get_group("pod")

    def stack(t):
        out = t.new_empty((n_pods,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t.detach().contiguous().reshape((1,) + tuple(t.shape)), group=group)
        return out

    return tree_map(stack, full)


def _value_and_grad(loss_fn, params, *batch):
    """(loss, gradients); each gradient laid out as its parameter (a partial
    sum over the batch shards is reduced here, the data-parallel gradient
    all-reduce), so the optimizer's state and the new parameters keep the
    parameters' placements."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_replace_leaves(params, live), *batch)
    # a leaf the loss does not read gets a zero gradient, as JAX gives it
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) and g.placements != p.placements
             else g for g, p in zip(grads, leaves)]
    loss = loss.detach()
    return (loss.full_tensor() if isinstance(loss, DTensor) else loss), tree_replace_leaves(params, grads)


def make_hybrid_train_step(
    mesh: DeviceMesh,
    loss_fn: Callable[..., torch.Tensor],  # loss_fn(params, *batch) -> scalar
    opt: Optimizer,
):
    """Returns train_step((params, opt_state), batch) → ((params,
    opt_state), loss): this rank's pod's replica and optimizer state (on
    ``pod_mesh(mesh)``) in and out. ``batch`` holds the global batch on
    every rank; pod p takes the p-th contiguous block of its leading dim.
    The loss is the mean over the pods of each pod's loss."""
    pod_name, n_pods = _pod_axis(mesh)

    if pod_name is None:
        # single pod: one synchronous step over the mesh's data/model dims
        def train_step(state, batch):
            params, opt_state = state
            with use_mesh(mesh):
                loss, grads = _value_and_grad(loss_fn, params, *batch)
                new_params, new_state = opt.update(grads, opt_state, params)
            return (new_params, new_state), loss

        return train_step

    group, p = mesh.get_group("pod"), pod_index(mesh)

    def train_step(state, batch):
        params, opt_state = state
        with use_mesh(mesh), manual({"pod"}):
            mine = tuple(b.reshape((n_pods, b.shape[0] // n_pods) + tuple(b.shape[1:]))[p] for b in batch)
            loss, grads = _value_and_grad(loss_fn, params, *mine)
            new_params, new_state = opt.update(grads, opt_state, params)
        losses = loss.new_empty((n_pods,))
        dist.all_gather_into_tensor(losses, loss.reshape(1), group=group)
        return (new_params, new_state), torch.mean(losses)

    return train_step


def make_sync_step(mesh: DeviceMesh):
    """The τ-deferred column Allreduce: each parameter averaged across
    its pod replicas — an all-reduce of each local shard over the "pod"
    group, so every pod ends with the same bits. The optimizer state is
    not averaged (the reference's trainer syncs parameters only)."""
    pod_name, n_pods = _pod_axis(mesh)
    if pod_name is None:
        return lambda params: params
    group = mesh.get_group("pod")

    @torch.no_grad()
    def mean(t):
        local = (t.to_local() if isinstance(t, DTensor) else t).clone()
        dist.all_reduce(local, group=group)
        local = local / n_pods
        return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False) if isinstance(t, DTensor) else local

    return lambda params: tree_map(mean, params)


def HybridSchedule(tau: int = 10, s: int = 1) -> ParallelSGDSchedule:
    """Deprecated constructor preserving the old (tau, s) signature.

    The NN trainer shares the engine's schedule object: p_r ↦ n_pods,
    b ↦ per-pod batch, s ↦ gradient-accumulation microsteps (the inexact
    NN analogue of the s-step bundle), τ ↦ the pod-sync period. New code
    should build ParallelSGDSchedule directly."""
    return ParallelSGDSchedule(s=s, tau=tau)
