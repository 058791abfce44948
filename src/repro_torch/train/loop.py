"""Training loop driver for the decoder zoo (``launch/train.py``).

Wires: config → params → the train step (loss, gradients, the
optimizer's update) → the Markov token stream → losses → checkpoints —
the reference's ``repro.train.loop.train``. With a mesh (a ``DeviceMesh``
over the processes, ``launch/mesh.py``) it runs the hybrid-2D schedule
(``optim/hybrid2d.py``): each pod steps its own replica, sharded over its
("data", "model") sub-mesh, on its contiguous block of the global batch,
and the parameters are averaged across the pods every τ steps.
``launch/steps.py`` holds the microbatched train step with remat, and the
prefill and serve steps.

The step is plain autograd over the parameter tree: ``lm_loss`` is
differentiated with ``torch.autograd.grad`` and the optimizer's
``update`` returns the new tree. Matmuls run in float32 without TF32
(PyTorch's default for ``torch.backends.cuda.matmul.allow_tf32``; the
loop never turns it on).

Resume: a run restored from its checkpoint at step k skips the stream's
first k batches, so resumed and uninterrupted runs see the same batches
(the reference restarts its stream at batch 0). On a mesh the checkpoint
holds the reference's stacked layout (a leading n_pods dim on every leaf
of the parameters and the optimizer state): rank 0 writes it, behind a
barrier that fails every rank when the write fails.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map, tree_replace_leaves
from repro_torch.core.distributed import on_rank0
from repro_torch.core.engine import ParallelSGDSchedule
from repro_torch.models.config import ArchConfig
from repro_torch.models.init import distribute_params, init_params, param_pspecs
from repro_torch.models.sharding import mesh_sizes
from repro_torch.models.transformer import lm_loss
from repro_torch.optim.hybrid2d import gather_pods, make_hybrid_train_step, make_sync_step, pod_mesh, unstack_for_pod
from repro_torch.optim.sgd import Optimizer, adamw
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.data import MarkovTextStream


@dataclasses.dataclass
class TrainReport:
    losses: list[float]
    steps: int
    tokens_per_s: float


def make_train_step(cfg: ArchConfig, opt: Optimizer):
    """``step(state, (tokens, targets)) → (state, loss)`` with ``state`` =
    (params, opt_state): one forward, one backward, one update."""

    def step(state, batch_):
        params, opt_state = state
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        live = tree_replace_leaves(params, leaves)
        loss = lm_loss(cfg, live, *batch_)
        # a leaf the loss does not read (musicgen's prefix projection without a
        # prefix) gets a zero gradient, as JAX gives it
        grads = tree_replace_leaves(params, list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
        params, opt_state = opt.update(grads, opt_state, params)
        return (params, opt_state), loss.detach()

    return step


def _restore_on_mesh(path: Path, state, mesh: DeviceMesh):
    """Restore a stacked checkpoint (the reference's layout) into this
    rank's pod's state: its slice of each leaf, placed as ``state``'s
    leaf in its place. Returns (state, step) or (None, 0) if absent."""
    n_pods = mesh_sizes(mesh).get("pod", 1)

    def template(t):  # the stacked leaf's shape and dtype, no memory
        dtype = np.float32 if t.dtype == torch.bfloat16 else torch.empty((), dtype=t.dtype).numpy().dtype
        return np.broadcast_to(np.zeros((), dtype), (n_pods,) + tuple(t.shape))

    restored, step = restore_checkpoint(path, tree_map(template, state))
    if restored is None:
        return None, 0

    def place(arr, t):
        mine = torch.from_numpy(np.array(arr)).to(t.dtype)
        if isinstance(t, DTensor):
            return distribute_tensor(mine, t.device_mesh, t.placements, src_data_rank=None)
        return mine.to(t.device)

    return tree_map(place, unstack_for_pod(restored, mesh), state), step


def train(
    cfg: ArchConfig,
    steps: int = 100,
    batch: int = 8,
    seq_len: int = 128,
    tau: int = 10,
    mesh=None,
    opt: Optimizer | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    log_every: int = 10,
    seed: int = 0,
    dtype=torch.float32,
    schedule: ParallelSGDSchedule | None = None,
    device=None,
    params: dict | None = None,
) -> TrainReport:
    """Train ``cfg`` on the synthetic Markov stream on ``device`` (None:
    the CUDA device, or an error).

    ``params`` (a full tree, on ``device`` or the host) replaces the
    seeded initialization, e.g. weights carried from the reference
    (``params_from_numpy``). ``mesh`` (a ``DeviceMesh`` of ``device``'s
    type, ``launch/mesh.py``) runs the hybrid-2D schedule with every pod
    starting from the same parameters: ``batch`` is the global batch,
    split contiguously across the pods, and the parameters are averaged
    across the pods every τ steps. ``schedule`` is the engine's knob
    object: its p_r must be 1 or the mesh's pods, and its τ replaces
    ``tau``. The loss of every ``log_every``-th step (and the last) is
    kept: on a mesh the mean over the pods of each pod's loss."""
    device = resolve_device(device)
    opt = opt or adamw(3e-4)
    n_pods = 1
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh (launch/mesh.py), not {type(mesh).__name__}")
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh is of {mesh.device_type!r} devices but the run's device is {device}")
        n_pods = mesh_sizes(mesh).get("pod", 1)
    if schedule is not None:
        if schedule.p_r not in (1, n_pods):
            raise ValueError(f"schedule.p_r={schedule.p_r} but the run has {n_pods} pod{'s' * (n_pods > 1)}")
        tau = schedule.tau
    if params is None:
        params = init_params(cfg, dtype=dtype, device=device if mesh is None else "cpu", seed=seed)

    if mesh is None:
        step_fn, sync_fn = make_train_step(cfg, opt), None
    else:
        sub = pod_mesh(mesh)
        params = (tree_map(lambda t: t.to(device), params) if sub is None
                  else distribute_params(params, param_pspecs(cfg, params, sub), sub))
        step_fn = make_hybrid_train_step(mesh, lambda p, tok, tgt: lm_loss(cfg, p, tok, tgt), opt)
        sync_fn = make_sync_step(mesh)
    # the state alone holds the parameters and moments: a local name left on
    # the first ones would keep them on the device for the whole run
    state = (params, opt.init(params))
    del params
    stream = MarkovTextStream(cfg.vocab_size, seed=seed)
    it = stream.batches(batch, seq_len)

    step0 = 0
    ckpt = Path(checkpoint_dir) / "ckpt" if checkpoint_dir else None
    if ckpt is not None:
        restored, step0 = restore_checkpoint(ckpt, state) if mesh is None else _restore_on_mesh(ckpt, state, mesh)
        if restored is not None:
            state = restored
            for _ in range(step0):  # the batches the checkpointed run took
                next(it)

    losses: list[float] = []
    t0 = time.perf_counter()
    for step in range(step0, steps):
        tokens, targets = next(it)
        state, loss = step_fn(state, (torch.from_numpy(tokens).to(device), torch.from_numpy(targets).to(device)))
        if n_pods > 1 and tau and (step + 1) % tau == 0:
            state = (sync_fn(state[0]), state[1])
        if (step + 1) % log_every == 0 or step == steps - 1:
            losses.append(float(loss))
        if ckpt is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
            if mesh is None:
                save_checkpoint(ckpt, state, step + 1)
            else:
                stacked = gather_pods(state, mesh)
                on_rank0(lambda: save_checkpoint(ckpt, stacked, step + 1), device)
                del stacked
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    tokens_per_s = (steps - step0) * batch * seq_len / elapsed
    return TrainReport(losses=losses, steps=steps, tokens_per_s=tokens_per_s)
