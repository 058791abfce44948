"""PyTorch/CUDA port of the HybridSGD reproduction (``repro``).

Same sub-package layout and names as the JAX package so a reader finds
each counterpart; PyTorch idiom inside (plain dataclasses of tensors,
explicit devices, Python loops of kernel launches). Importing this
package imports ``torch`` and ``numpy`` only.

Device rule: every constructor that places data takes ``device=None``,
which means the CUDA device and raises when there is none; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
