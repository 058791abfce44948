"""Block-sparse (BSR) tiles: the reference's ``repro.sparse.bsr`` layout.

The matrix is re-blocked into dense (bm × bn) tiles; only tiles holding a
nonzero are kept, and each block-row is padded to the largest tile count of
any block-row (ELL of tiles), so the layout has a static shape. The
reference drove a TPU kernel with it, since removed; what is ported is the
layout, its dense round trip and the plain matvec oracle
(``bsr_matvec_ref``; ``kernels/ref.py`` holds the blocked-layout oracles).
Tile shape defaults to (8, 128), the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.csr import CSRMatrix


@dataclasses.dataclass
class BsrMatrix:
    """ELL-of-tiles block-sparse matrix.

    tiles:      (n_block_rows, max_blocks, bm, bn) dense tile data
    block_cols: (n_block_rows, max_blocks) int32 — block-column index of
                each tile; padded entries point at block 0 with zero data.
    nblocks:    (n_block_rows,) int32 — valid tile count per block row.
    shape:      padded dense shape (rows = n_block_rows*bm, cols =
                n_block_cols*bn); logical_shape is the original (m, n).
    """

    tiles: torch.Tensor
    block_cols: torch.Tensor
    nblocks: torch.Tensor
    shape: tuple[int, int]
    logical_shape: tuple[int, int]

    @property
    def bm(self) -> int:
        return int(self.tiles.shape[2])

    @property
    def bn(self) -> int:
        return int(self.tiles.shape[3])

    @property
    def n_block_rows(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def max_blocks(self) -> int:
        return int(self.tiles.shape[1])

    @property
    def density(self) -> float:
        """Fraction of tiles stored vs a fully dense tiling."""
        total = self.n_block_rows * (self.shape[1] // self.bn)
        return float(self.nblocks.sum().item()) / max(total, 1)


def bsr_from_csr(a: CSRMatrix, bm: int = 8, bn: int = 128, dtype=torch.float32, device=None) -> BsrMatrix:
    """The BSR layout of ``a``, its tensors on ``device`` (None: the CUDA
    device or an error). Tiles are built in float64 on the host and cast to
    ``dtype``, as the reference builds them."""
    device = resolve_device(device)
    m_pad = -(-a.m // bm) * bm
    n_pad = -(-a.n // bn) * bn
    n_brows, n_bcols = m_pad // bm, n_pad // bn
    # bucket nonzeros by (block_row, block_col)
    row_ids = np.repeat(np.arange(a.m), a.nnz_per_row)
    br = row_ids // bm
    bc = a.indices // bn
    key = br.astype(np.int64) * n_bcols + bc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts = np.unique(key_s, return_index=True)
    starts = np.append(starts, len(key_s))

    per_row_blocks: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n_brows)]
    for u_i, k in enumerate(uniq):
        blk_r, blk_c = int(k // n_bcols), int(k % n_bcols)
        sel = order[starts[u_i] : starts[u_i + 1]]
        tile = np.zeros((bm, bn), dtype=np.float64)
        tile[row_ids[sel] - blk_r * bm, a.indices[sel] - blk_c * bn] = a.data[sel]
        per_row_blocks[blk_r].append((blk_c, tile))

    max_blocks = max((len(b) for b in per_row_blocks), default=0) or 1
    tiles = np.zeros((n_brows, max_blocks, bm, bn), dtype=np.float64)
    block_cols = np.zeros((n_brows, max_blocks), dtype=np.int32)
    nblocks = np.zeros(n_brows, dtype=np.int32)
    for r, blks in enumerate(per_row_blocks):
        nblocks[r] = len(blks)
        for j, (c, tile) in enumerate(blks):
            tiles[r, j] = tile
            block_cols[r, j] = c
    return BsrMatrix(
        tiles=torch.from_numpy(tiles).to(device=device, dtype=dtype),
        block_cols=torch.from_numpy(block_cols).to(device),
        nblocks=torch.from_numpy(nblocks).to(device),
        shape=(m_pad, n_pad),
        logical_shape=(a.m, a.n),
    )


def bsr_to_dense(bsr: BsrMatrix) -> np.ndarray:
    """The logical (m, n) dense matrix, on the host."""
    tiles = bsr.tiles.cpu().numpy()
    out = np.zeros(bsr.shape, dtype=tiles.dtype)
    bcols = bsr.block_cols.cpu().numpy()
    nb = bsr.nblocks.cpu().numpy()
    for r in range(bsr.n_block_rows):
        for j in range(int(nb[r])):
            c = int(bcols[r, j])
            out[r * bsr.bm : (r + 1) * bsr.bm, c * bsr.bn : (c + 1) * bsr.bn] += tiles[r, j]
    return out[: bsr.logical_shape[0], : bsr.logical_shape[1]]


def bsr_matvec_ref(bsr: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain oracle: y = A @ x on the padded shape, truncated to m."""
    n_pad = bsr.shape[1]
    x_pad = torch.zeros(n_pad, dtype=x.dtype, device=x.device)
    x_pad[: x.shape[0]] = x
    x_blocks = x_pad.reshape(-1, bsr.bn)  # (n_bcols, bn)
    gathered = x_blocks[bsr.block_cols.long()]  # (nbr, maxb, bn)
    valid = (torch.arange(bsr.max_blocks, device=x.device)[None, :] < bsr.nblocks[:, None]).to(x.dtype)
    y_blocks = torch.einsum("rjab,rjb->ra", bsr.tiles * valid[:, :, None, None], gathered)
    return y_blocks.reshape(-1)[: bsr.logical_shape[0]]
