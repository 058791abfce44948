"""Optimizers and the paper's hybrid 2D trainer for NN training."""

from repro_torch.optim.hybrid2d import HybridSchedule, make_hybrid_train_step, make_sync_step, stack_for_pods
from repro_torch.optim.sgd import Optimizer, adamw, momentum, sgd

__all__ = [
    "Optimizer",
    "adamw",
    "momentum",
    "sgd",
    "HybridSchedule",
    "make_hybrid_train_step",
    "make_sync_step",
    "stack_for_pods",
]
