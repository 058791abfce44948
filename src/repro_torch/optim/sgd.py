"""Optimizers as functions over a tree of tensors — the reference's
``repro.optim.sgd`` with its math and state layout.

``Optimizer(init, update)``: ``init(params) → state``,
``update(grads, state, params) → (new_params, new_state)``. Trees are the
nested dicts and tuples of ``repro_torch.models.init``; every update runs
under ``torch.no_grad`` and returns new tensors (the inputs are not
changed). State layouts: ``sgd`` none (``()``), ``momentum`` a velocity
tree of the parameters' dtype, ``adamw`` ``{"mu", "nu", "t"}`` with
float32 moments and an int32 step, the bias correction as the reference
writes it and the decay ``wd·p`` inside the step. (``torch.optim`` keeps
other state and orders decay and step otherwise, so it is not used.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch._tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params) -> (new_params, new_state)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params):
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params):
        vel = tree_map(lambda v, g: beta * v + g.to(v.dtype), state, grads)
        new = tree_map(lambda p, v: p - lr * v, params, vel)
        return new, vel

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.0) -> Optimizer:
    def init(params):
        # zeros_like: a DTensor parameter gets moments with its placements
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(grads, state, params):
        t = state["t"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)), state["nu"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)  # a Python base: no host-to-device copy (a sync on a card)
        bc2 = 1 - torch.pow(b2, tf)

        def step(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return (p - lr * (upd + wd * p.to(torch.float32))).to(p.dtype)

        new = tree_map(step, params, mu, nu)
        return new, {"mu": mu, "nu": nu, "t": t}

    return Optimizer(init, update)

