"""Sparse-matrix substrate: host CSR (numpy), device ELL (torch),
row partitioner, synthetic datasets."""

from repro_torch.sparse.bsr import BsrMatrix, bsr_from_csr, bsr_matvec_ref
from repro_torch.sparse.csr import CSRMatrix, csr_from_dense, csr_matvec, csr_rmatvec
from repro_torch.sparse.ell import (
    EllBlock,
    ell_from_csr,
    ell_matmat,
    ell_matvec,
    ell_rmatmat,
    ell_rmatvec,
    ell_row_slice,
)
from repro_torch.sparse.partition import (
    ColumnPartition,
    partition_2d,
    partition_columns,
    partition_rows,
    partition_stats,
)
from repro_torch.sparse.synthetic import (
    DATASET_STATS,
    SM_STATS,
    SyntheticDataset,
    dataset_stats,
    make_dataset,
    make_skewed_csr,
)

__all__ = [
    "BsrMatrix",
    "bsr_from_csr",
    "bsr_matvec_ref",
    "CSRMatrix",
    "csr_from_dense",
    "csr_matvec",
    "csr_rmatvec",
    "EllBlock",
    "ell_from_csr",
    "ell_matvec",
    "ell_matmat",
    "ell_rmatvec",
    "ell_rmatmat",
    "ell_row_slice",
    "ColumnPartition",
    "partition_columns",
    "partition_rows",
    "partition_2d",
    "partition_stats",
    "DATASET_STATS",
    "SM_STATS",
    "SyntheticDataset",
    "dataset_stats",
    "make_dataset",
    "make_skewed_csr",
]
