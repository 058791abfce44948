"""Step functions for the decoder zoo, the reference's
``repro.launch.steps``: ``train_step`` (M gradient accumulation
microbatches, one optimizer update), ``prefill_step``, ``serve_step`` and
the pod sync.

On a mesh (a ``DeviceMesh``, ``launch/mesh.py``) the train step is what
the reference's code does under ``jit``: synchronous data parallelism over
pod × data, the parameters DTensors on the whole mesh (``param_pspecs``),
the batch split over the (pod, data) dims by the model's annotations. Its
docstring says the step is wrapped in the hybrid-2D pod-local form; its
code never imports ``hybrid2d``, and the port follows the code (the
pod-local form is ``optim/hybrid2d.py``, what ``train(mesh=...)`` runs).
``make_pod_sync_step`` is then the mean over "pod" of parameters every
pod already holds: the identity in value, as the reference's ``pmean``.
"""

from __future__ import annotations

import torch

import contextlib

from torch.distributed.tensor import DTensor

from repro_torch._tree import tree_paths, tree_replace_leaves
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import mesh_sizes, placements, use_mesh
from repro_torch.models.transformer import decode_step, forward, lm_loss
from repro_torch.optim.hybrid2d import make_sync_step
from repro_torch.optim.sgd import Optimizer, sgd


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def data_parallel_size(mesh=None) -> int:
    """The (pod × data) shards a batch is split over: 1 without a mesh."""
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def make_train_step(cfg: ArchConfig, mesh=None, opt: Optimizer | None = None,
                    microbatch_per_shard: int = 1, grad_dtype=torch.float32, param_specs=None):
    """Returns train_step(params, opt_state, tokens, targets[, prefix])
    → (params, opt_state, loss).

    The batch is split into M = max(B // (dp · microbatch_per_shard), 1)
    consecutive microbatches (B a multiple of M; dp = pod × data, so each
    microbatch puts ``microbatch_per_shard`` sequences on each data shard);
    each runs ``lm_loss`` with ``remat=True`` (activations recomputed a
    period at a time in the backward pass) and its gradients are summed into
    accumulators of ``grad_dtype`` — float32-stored leaves (``A_log``,
    ``router``) keep float32 ones whatever it is. The mean gradient goes
    through one ``opt.update``; the loss returned is the mean of the
    microbatches'. On a mesh, ``params`` are DTensors on it and the batch
    is the global one on every rank; ``param_specs`` (``param_pspecs``'
    tree) lays the accumulators out as the parameters."""
    opt = opt or sgd(3e-3)
    dp = data_parallel_size(mesh)

    def acc_dtype(p):
        return grad_dtype if p.dtype == torch.bfloat16 else torch.float32

    def train_step(params, opt_state, tokens, targets, prefix_emb=None):
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            return _step(params, opt_state, tokens, targets, prefix_emb)

    def _step(params, opt_state, tokens, targets, prefix_emb):
        B = tokens.shape[0]
        M = max(B // (dp * microbatch_per_shard), 1)
        parts = [t.reshape(M, B // M, *t.shape[1:]) for t in (tokens, targets)]
        if prefix_emb is not None:
            parts.append(prefix_emb.reshape(M, B // M, *prefix_emb.shape[1:]))
        paths = tree_paths(params)
        leaves = [leaf for _, leaf in paths]

        def constrain(accs):
            if param_specs is None:
                return accs
            return [a.redistribute(mesh, placements(_at(param_specs, path), mesh)) if isinstance(a, DTensor) else a
                    for a, (path, _) in zip(accs, paths)]

        # zeros_like: a DTensor parameter's accumulator has its placements
        g_acc = constrain([torch.zeros_like(p, dtype=acc_dtype(p)) for p in leaves])
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for micro in zip(*parts):
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = lm_loss(cfg, tree_replace_leaves(params, live), micro[0], micro[1],
                           prefix_emb=micro[2] if len(micro) > 2 else None, remat=True)
            # a leaf the loss does not read gets a zero gradient, as JAX gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
            for a, g in zip(g_acc, grads):
                a.add_(g)  # in the accumulator's dtype, as the reference's jnp.add promotes
            g_acc = constrain(g_acc)
            loss = loss.detach()
            loss_acc = loss_acc + (loss.full_tensor() if isinstance(loss, DTensor) else loss)
        g = tree_replace_leaves(params, [a / M for a in g_acc])
        new_params, new_state = opt.update(g, opt_state, params)
        return new_params, new_state, loss_acc / M

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, tokens[, prefix]) → last-position logits
    (B, 1, V), without autograd."""

    @torch.no_grad()
    def prefill_step(params, tokens, prefix_emb=None):
        return forward(cfg, params, tokens, prefix_emb, last_only=True)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens) → (logits, cache): one new token
    against the cache, without autograd."""

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens)

    return serve_step


def make_pod_sync_step(mesh=None):
    """The paper's τ-deferred average across the "pod" axis: the mean of
    each parameter's local shard over the "pod" group (``params`` DTensors
    on ``mesh``). The identity without a mesh or on a single-pod mesh, as
    the reference's is."""
    if mesh is None:
        return lambda params: params
    return make_sync_step(mesh)
