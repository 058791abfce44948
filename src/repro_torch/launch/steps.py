"""Step functions for the decoder zoo, the reference's
``repro.launch.steps`` on one device: ``train_step`` (M gradient
accumulation microbatches, one optimizer update), ``prefill_step`` and
``serve_step``.

The reference wraps the train step in the hybrid-2D pod-local form on a
multi-pod mesh and lowers the τ-deferred pod sync as its own step. The
port has no model mesh yet (``models/sharding.py``, ``optim/hybrid2d.py``:
ROADMAP.md Queue 1 item 13c), so every step here runs on one device:
``data_parallel_size`` is 1 and ``make_pod_sync_step`` is the identity.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_replace_leaves
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import decode_step, forward, lm_loss
from repro_torch.optim.sgd import Optimizer, sgd

_MESH_WAITS = ("a model mesh (models/sharding.py, optim/hybrid2d.py) is not in the port yet "
               "(ROADMAP.md Queue 1 item 13c)")


def data_parallel_size(mesh=None) -> int:
    """The (pod × data) shards a batch is split over: 1 without a mesh."""
    if mesh is not None:
        raise NotImplementedError(_MESH_WAITS)
    return 1


def make_train_step(cfg: ArchConfig, mesh=None, opt: Optimizer | None = None,
                    microbatch_per_shard: int = 1, grad_dtype=torch.float32):
    """Returns train_step(params, opt_state, tokens, targets[, prefix])
    → (params, opt_state, loss).

    The batch is split into M = max(B // microbatch_per_shard, 1)
    consecutive microbatches (B a multiple of M); each runs ``lm_loss``
    with ``remat=True`` (activations recomputed a period at a time in the
    backward pass) and its gradients are summed into accumulators of
    ``grad_dtype`` — float32-stored leaves (``A_log``, ``router``) keep
    float32 ones whatever it is. The mean gradient goes through one
    ``opt.update``; the loss returned is the mean of the microbatches'."""
    opt = opt or sgd(3e-3)
    dp = data_parallel_size(mesh)

    def acc_dtype(p):
        return grad_dtype if p.dtype == torch.bfloat16 else torch.float32

    def train_step(params, opt_state, tokens, targets, prefix_emb=None):
        B = tokens.shape[0]
        M = max(B // (dp * microbatch_per_shard), 1)
        parts = [t.reshape(M, B // M, *t.shape[1:]) for t in (tokens, targets)]
        if prefix_emb is not None:
            parts.append(prefix_emb.reshape(M, B // M, *prefix_emb.shape[1:]))
        leaves = tree_leaves(params)
        g_acc = [torch.zeros(p.shape, dtype=acc_dtype(p), device=p.device) for p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for micro in zip(*parts):
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = lm_loss(cfg, tree_replace_leaves(params, live), micro[0], micro[1],
                           prefix_emb=micro[2] if len(micro) > 2 else None, remat=True)
            # a leaf the loss does not read gets a zero gradient, as JAX gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
            for a, g in zip(g_acc, grads):
                a.add_(g)  # in the accumulator's dtype, as the reference's jnp.add promotes
            loss_acc = loss_acc + loss.detach()
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
    """The paper's τ-deferred average across the "pod" axis: the identity
    without a mesh, as the reference's is on a single-pod mesh."""
    if mesh is not None:
        raise NotImplementedError(_MESH_WAITS)
    return lambda params: params
