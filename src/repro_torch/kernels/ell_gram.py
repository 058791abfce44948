"""The s-bundle primitive (G, v) = (tril(Y·Yᵀ, −1), Y·x) straight from
ELL rows — paper Algorithm 3 lines 5–8 (the sparse syrk + SpMV hot
spot) — without ever materializing the dense (sb × n) bundle.

Two versions of the same function live here:

* ``ell_gram_and_v`` — the wrapper. For CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/ell_gram.cu`` (built at first use)
  or raises; it never falls back. For CPU tensors it runs the plain
  version below.
* ``ell_gram_and_v_blocked`` — the plain PyTorch version, which walks
  ⌈n/bk⌉ column panels: it scatters the bundle's entries that fall in
  panel k into a dense (sb, bk) tile (``bm`` rows at a time; duplicate
  column ids add), accumulates ``G += P·Pᵀ`` and ``v += P·x_k``, and
  masks to the strict lower triangle after the last panel. It repeats
  the kernel's arithmetic panel by panel and is the oracle for it; it
  is not a yardstick of speed.

The CUDA kernel does not walk panels (see its header note), so ``bk``
and ``bm`` have no effect on it; they only define the plain version's
walk. Any ``bk``/``bm`` gives the same result up to summation order.

Pads are (idx 0, val 0) and contribute nothing. Accumulation is
float32 (float64 inputs stay float64 in the plain version; the kernel
takes float32 only).

Oracle: ``repro_torch.kernels.ref.ell_gram_and_v_ref`` (dense scatter).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load_library("ell_gram")
        lib.ell_gram_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ell_gram_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_precision(precision: str) -> None:
    """The kernels' ``precision`` knob: only "fp32" exists so far."""
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' (bf16 panel and dots, fp32 accumulate) is not ported "
            "yet — ROADMAP Queue 2, the bf16 mode of each kernel"
        )
    if precision != "fp32":
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")


def _prep_panels(values: torch.Tensor, x: torch.Tensor, n: int, bk: int):
    """Accumulation dtype + x zero-padded to whole panels."""
    acc = torch.float64 if values.dtype == torch.float64 else torch.float32
    n_pad = -(-n // bk) * bk
    x = x.to(acc)
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    return acc, x, n_pad // bk


def _panel_rows(indices, values, k: int, bk: int, dtype) -> torch.Tensor:
    """Scatter one row chunk's entries of panel k: (rows, bk) in
    ``dtype``. Entries outside [k·bk, (k+1)·bk) are added as zeros at a
    clamped lane, so no data-dependent shape arises."""
    local = indices.long() - k * bk  # (rows, w)
    inside = (local >= 0) & (local < bk)
    vals = torch.where(inside, values.to(dtype), torch.zeros((), dtype=dtype, device=values.device))
    panel = torch.zeros((indices.shape[0], bk), dtype=dtype, device=values.device)
    return panel.scatter_add_(1, local.clamp(0, bk - 1), vals)


def panel_from_ell(indices, values, k: int, bk: int, acc_dtype, bm: int | None = None):
    """Expand the ELL bundle's column panel k into a dense (sb, bk)
    tile, ``bm`` rows at a time (None = all rows at once; rows are
    independent, so any ``bm`` gives the same tile)."""
    sb = indices.shape[0]
    if bm is None or bm >= sb:
        return _panel_rows(indices, values, k, bk, acc_dtype)
    return torch.cat(
        [
            _panel_rows(indices[r : r + bm], values[r : r + bm], k, bk, acc_dtype)
            for r in range(0, sb, bm)
        ],
        dim=0,
    )


def ell_gram_and_v_blocked(
    indices: torch.Tensor,
    values: torch.Tensor,
    x: torch.Tensor,
    *,
    n: int,
    bk: int = 512,
    bm: int | None = None,
    precision: str = "fp32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch panel streaming — the kernel's plain version (see
    the module note). Runs on whatever device the tensors are on."""
    check_precision(precision)
    sb, _ = values.shape
    acc, x, n_panels = _prep_panels(values, x, n, bk)
    g = torch.zeros((sb, sb), dtype=acc, device=values.device)
    v = torch.zeros((sb,), dtype=acc, device=values.device)
    for k in range(n_panels):
        panel = panel_from_ell(indices, values, k, bk, acc, bm)
        xblk = x[k * bk : (k + 1) * bk]
        g = g + panel @ panel.T
        v = v + panel @ xblk
    return torch.tril(g, diagonal=-1), v


def ell_gram_and_v(
    indices: torch.Tensor,  # (sb, w) int32
    values: torch.Tensor,  # (sb, w) float32
    x: torch.Tensor,  # (n,) float32
    *,
    n: int,
    bk: int = 512,
    bm: int | None = None,
    precision: str = "fp32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, v) = (tril(Y Yᵀ, -1), Y·x) for the ELL bundle Y.

    CUDA tensors: one launch of the Hopper kernel on the current
    stream, no synchronisation; ``bk``/``bm`` are ignored (the kernel's
    result does not depend on them) and every column id must lie in
    [0, n) — that is not checked on the device. A failed build or
    launch raises. CPU tensors: the plain ``ell_gram_and_v_blocked``.
    Each kernel launch adds one to ``ell_gram_and_v.launches``."""
    check_precision(precision)
    if not (indices.device == values.device == x.device):
        raise ValueError(
            f"indices, values, x must share a device, got {indices.device}, "
            f"{values.device}, {x.device}"
        )
    if not values.is_cuda:
        return ell_gram_and_v_blocked(indices, values, x, n=n, bk=bk, bm=bm)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if values.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernel takes float32 values and x, got {values.dtype}, {x.dtype}"
        )
    if values.dim() != 2 or indices.shape != values.shape:
        raise ValueError(
            f"indices {tuple(indices.shape)} and values {tuple(values.shape)} must "
            f"be the same (sb, w)"
        )
    if x.shape != (n,):
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    sb, w = values.shape
    if sb < 1 or w < 1:
        raise ValueError(f"empty bundle (sb={sb}, w={w})")
    if not (indices.is_contiguous() and values.is_contiguous() and x.is_contiguous()):
        raise ValueError("indices, values and x must be contiguous")

    lib = _lib()
    g = torch.empty((sb, sb), dtype=torch.float32, device=values.device)
    v = torch.empty((sb,), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        rc = lib.ell_gram_launch(
            indices.data_ptr(), values.data_ptr(), x.data_ptr(), g.data_ptr(),
            v.data_ptr(), sb, w, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ell_gram kernel launch failed: CUDA error {rc} (sb={sb}, w={w})")
    ell_gram_and_v.launches += 1
    return g, v


ell_gram_and_v.launches = 0
