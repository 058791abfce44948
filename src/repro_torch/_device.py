"""The port's one device rule."""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device — and raises if there is none. In a
    process of an initialized ``torch.distributed`` group (a rank of the
    2D mesh) that is ``cuda:(rank % device_count)``: one rank a card, or
    several ranks sharing one. Anything else is passed to ``torch.device``
    unchanged. There is no "CUDA if available, else CPU" anywhere in the
    port: a caller that wants the CPU says ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means the CUDA device, but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dist.is_available() and dist.is_initialized():
            return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        return torch.device("cuda")
    return torch.device(device)
