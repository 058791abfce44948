"""Plain-torch oracles for the kernels (allclose-tested): the reference's
``repro.kernels.ref``, the blocked-layout BSR products included."""

from __future__ import annotations

import torch


def bsr_matmat_ref(tiles: torch.Tensor, block_cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X via a dense gather-einsum on the blocked layout
    (``sparse/bsr.py``): tiles (n_brows, max_blocks, bm, bn), block_cols
    (n_brows, max_blocks), X (n_bcols·bn, k)."""
    n_brows, max_blocks, bm, bn = tiles.shape
    k = x.shape[1]
    x_blocked = x.reshape(-1, bn, k)
    gathered = x_blocked[block_cols.long()]  # (nbr, maxb, bn, k)
    y = torch.einsum("rjab,rjbk->rak", tiles, gathered)
    return y.reshape(n_brows * bm, k)


def bsr_matvec_ref(tiles: torch.Tensor, block_cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return bsr_matmat_ref(tiles, block_cols, x[:, None])[:, 0]


def gram_tril_ref(y: torch.Tensor) -> torch.Tensor:
    """G = tril(Y Yᵀ, -1), float32 accumulation."""
    y = y.to(torch.float32)
    return torch.tril(y @ y.T, diagonal=-1)


def gram_and_v_ref(y: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    y = y.to(torch.float32)
    return torch.tril(y @ y.T, diagonal=-1), y @ x.to(torch.float32)


def densify_bundle_ref(indices: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter the (sb, w) ELL bundle into a dense (sb, n) matrix.
    Duplicate column ids within a row add."""
    sb = values.shape[0]
    dense = torch.zeros((sb, n), dtype=values.dtype, device=values.device)
    return dense.scatter_add_(1, indices.long(), values)


def ell_gram_and_v_ref(
    indices: torch.Tensor, values: torch.Tensor, x: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(tril(YYᵀ,-1), Y·x) via the dense scatter — the bundle oracle."""
    dense = densify_bundle_ref(indices, values.to(torch.float32), n)
    return gram_and_v_ref(dense, x.to(torch.float32))
