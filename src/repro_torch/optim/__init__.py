"""Optimizers for the NN trainer (``sgd``, ``momentum``, ``adamw``).

The paper's hybrid 2D trainer for NN training (``optim/hybrid2d.py``)
is not in the port yet (ROADMAP.md Queue 1 item 13c).
"""

from repro_torch.optim.sgd import Optimizer, adamw, momentum, sgd

__all__ = ["Optimizer", "adamw", "momentum", "sgd"]
