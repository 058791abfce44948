"""Training loop driver for the decoder zoo (``launch/train.py``).

Wires: config → params → the train step (loss, gradients, the
optimizer's update) → the Markov token stream → losses → checkpoints, on
one device — the reference's ``repro.train.loop.train`` without a mesh.
The multi-pod hybrid-2D path (pod-local steps, a τ-sync; the reference's
``mesh=`` branch with ``optim/hybrid2d.py``) is not in the port yet
(ROADMAP.md Queue 1 item 13c). ``launch/steps.py`` holds the microbatched
train step with remat, and the prefill and serve steps.

The step is plain autograd over the parameter tree: ``lm_loss`` is
differentiated with ``torch.autograd.grad`` and the optimizer's
``update`` returns the new tree. Matmuls run in float32 without TF32
(PyTorch's default for ``torch.backends.cuda.matmul.allow_tf32``; the
loop never turns it on).

Resume: a run restored from its checkpoint at step k skips the stream's
first k batches, so resumed and uninterrupted runs see the same batches
(the reference restarts its stream at batch 0).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_replace_leaves
from repro_torch.core.engine import ParallelSGDSchedule
from repro_torch.models.config import ArchConfig
from repro_torch.models.init import init_params
from repro_torch.models.transformer import lm_loss
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

    ``params`` (a tree on ``device``) replaces the seeded initialization,
    e.g. weights carried from the reference (``params_from_numpy``).
    ``schedule`` is the engine's knob object: on one device its p_r must
    be 1; its τ (and ``tau``) is the sync cadence of a multi-pod run —
    one device has no parameter average to schedule. ``mesh`` raises
    ``NotImplementedError``.
    The loss of every ``log_every``-th step (and the last) is kept."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...) runs the hybrid-2D pod schedule (optim/hybrid2d.py, "
            "models/sharding.py), which is not in the port yet (ROADMAP.md Queue 1 item 13c)"
        )
    device = resolve_device(device)
    opt = opt or adamw(3e-4)
    if params is None:
        params = init_params(cfg, dtype=dtype, device=device, seed=seed)
    if schedule is not None and schedule.p_r != 1:
        raise ValueError(f"schedule.p_r={schedule.p_r} but the run has 1 pod")

    step_fn = make_train_step(cfg, opt)
    # the state alone holds the parameters and moments: a local name left on
    # the first ones would keep them on the device for the whole run
    state = (params, opt.init(params))
    del params
    stream = MarkovTextStream(cfg.vocab_size, seed=seed)
    it = stream.batches(batch, seq_len)

    step0 = 0
    if checkpoint_dir:
        restored, step0 = restore_checkpoint(Path(checkpoint_dir) / "ckpt", state)
        if restored is not None:
            state = restored
            for _ in range(step0):  # the batches the checkpointed run took
                next(it)

    losses: list[float] = []
    t0 = time.perf_counter()
    for step in range(step0, steps):
        tokens, targets = next(it)
        state, loss = step_fn(state, (torch.from_numpy(tokens).to(device), torch.from_numpy(targets).to(device)))
        if (step + 1) % log_every == 0 or step == steps - 1:
            losses.append(float(loss))
        if checkpoint_dir and checkpoint_every and (step + 1) % checkpoint_every == 0:
            save_checkpoint(Path(checkpoint_dir) / "ckpt", state, step + 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    tokens_per_s = (steps - step0) * batch * seq_len / elapsed
    return TrainReport(losses=losses, steps=steps, tokens_per_s=tokens_per_s)
