"""The s-step inner correction loop (paper Algorithm 3, lines 9–14).

After the Gram Allreduce, every rank runs s sequential corrections:

    z_j = v_j + (η/b) · G[j·b:(j+1)b, :] · u
    u_j = 1 / (1 + exp(z_j))        (u accumulates block by block)

The loop is a chain of s dependent b-row mat-vecs: expressed as tensor
ops it is s round trips through device memory and several launches
each. Two versions of the same function live here:

* ``sstep_inner`` — the wrapper. For CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/sstep_inner.cu`` (one launch for
  the whole bundle, u kept in shared memory; built at first use) or
  raises; it never falls back. For CPU tensors it runs the plain
  version below.
* ``sstep_inner_ref`` — the plain PyTorch loop, the oracle.

Both hardcode the logistic residual and have no L2 decay; the engine's
``inner_corrections`` covers the other objectives and λ > 0.

``precision="bf16"`` is the reference's ``compute_dtype=bfloat16``: the
G row panel and u are rounded to bf16 for the dot only, the products
are summed in float32, and z, the residual and the stored u stay
float32. The plain version rounds its operands with
``.to(torch.bfloat16).float()`` and takes a float32 mat-vec (a product
of two bf16 values is exact in float32), so the kernel and its plain
version differ only in the order of the sums. The engine never runs
this mode: under its bf16 schedule it unwires (G, v) to float32 and
runs the float32 corrections, as the reference does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_gram import PRECISIONS, bf16_round, check_precision

# u lives in dynamic shared memory; stay under the 48 KB that needs no opt-in
MAX_SB = 48 * 1024 // 4

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load_library("sstep_inner")
        lib.sstep_inner_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.sstep_inner_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def eta_over_b(eta, b: int) -> float:
    """η/b formed in float32, as the engine forms it."""
    return float(np.float32(eta) / np.float32(b))


def sstep_inner_ref(g: torch.Tensor, v: torch.Tensor, s: int, b: int, eta: float,
                    *, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch oracle — the same loop the engine runs at the
    logistic default; under "bf16" the dot's operands are rounded to
    bf16 (see the module note)."""
    from repro_torch.core.objective import LOGISTIC

    check_precision(precision)
    operand = bf16_round if precision == "bf16" else (lambda t: t)
    scale = eta_over_b(eta, b)
    u = torch.zeros(s * b, dtype=v.dtype, device=v.device)
    for j in range(s):
        zj = v[j * b : (j + 1) * b] + scale * (operand(g[j * b : (j + 1) * b]) @ operand(u))
        u[j * b : (j + 1) * b] = LOGISTIC.residual(zj)
    return u


def sstep_inner(
    g: torch.Tensor,  # (sb, sb) strictly-lower Gram
    v: torch.Tensor,  # (sb,)
    s: int,
    b: int,
    eta: float,
    *,
    precision: str = "fp32",
) -> torch.Tensor:
    """u (sb,) such that u_j = residual(v_j + (η/b) Σ_{l<j} G_{jl} u_l),
    logistic residual.

    CUDA tensors: one launch of the Hopper kernel on the current
    stream, no synchronisation; a failed build or launch raises. CPU
    tensors: the plain ``sstep_inner_ref``. s, b and η are runtime
    arguments of the kernel. Each kernel launch adds one to
    ``sstep_inner.launches[precision]``."""
    check_precision(precision)
    s, b = int(s), int(b)
    sb = s * b
    if s < 1 or b < 1:
        raise ValueError(f"s={s} and b={b} must be positive")
    if g.shape != (sb, sb) or v.shape != (sb,):
        raise ValueError(
            f"expected G ({sb}, {sb}) and v ({sb},), got {tuple(g.shape)} and {tuple(v.shape)}"
        )
    if g.device != v.device:
        raise ValueError(f"G and v must share a device, got {g.device} and {v.device}")
    if not g.is_cuda:
        return sstep_inner_ref(g.to(torch.float32), v.to(torch.float32), s, b, eta,
                               precision=precision)
    if g.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 G and v, got {g.dtype}, {v.dtype}")
    if not (g.is_contiguous() and v.is_contiguous()):
        raise ValueError("G and v must be contiguous")
    if sb > MAX_SB:
        raise ValueError(f"s·b={sb} exceeds the kernel's shared-memory bound {MAX_SB}")

    lib = _lib()
    u = torch.empty((sb,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.sstep_inner_launch(
            g.data_ptr(), v.data_ptr(), u.data_ptr(), s, b, eta_over_b(eta, b),
            int(precision == "bf16"), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sstep_inner kernel launch failed: CUDA error {rc} (s={s}, b={b}, {precision})"
        )
    sstep_inner.launches[precision] += 1
    return u


sstep_inner.launches = dict.fromkeys(PRECISIONS, 0)
