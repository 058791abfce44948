"""The BSR layout of the port (``repro_torch.sparse.bsr``) and the blocked
oracles of ``repro_torch.kernels.ref`` against the reference's
``repro.sparse.bsr`` and ``repro.kernels.ref``, on the cases of the
reference's ``tests/test_sparse_formats.py::test_bsr_roundtrip_and_matvec``:
the tiles, block columns and counts equal, the dense round trip exact, the
matvec within the reference's 2e-3 of A·x and 1e-5 of the reference's."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels.ref import bsr_matmat_ref as j_matmat
from repro.kernels.ref import bsr_matvec_ref as j_kmatvec
from repro.sparse.bsr import bsr_from_csr as j_from_csr
from repro.sparse.bsr import bsr_matvec_ref as j_matvec
from repro.sparse.bsr import bsr_to_dense as j_to_dense
from repro.sparse.csr import csr_from_dense as j_csr
from repro_torch.kernels.ref import bsr_matmat_ref, bsr_matvec_ref as k_matvec
from repro_torch.sparse import BsrMatrix, bsr_from_csr, bsr_matvec_ref, csr_from_dense
from repro_torch.sparse.bsr import bsr_to_dense


def random_dense(rng, m, n, density):
    return (rng.random((m, n)) < density) * rng.standard_normal((m, n))


def _pair(a, bm, bn):
    return j_from_csr(j_csr(a), bm=bm, bn=bn), bsr_from_csr(csr_from_dense(a), bm=bm, bn=bn, device="cpu")


@settings(max_examples=15, deadline=None)
@given(
    m=st.integers(2, 50),
    n=st.integers(2, 300),
    density=st.floats(0.01, 0.4),
    bm=st.sampled_from([4, 8]),
    bn=st.sampled_from([16, 128]),
    seed=st.integers(0, 2**16),
)
def test_bsr_roundtrip_and_matvec_match_the_reference(m, n, density, bm, bn, seed):
    rng = np.random.default_rng(seed)
    a = random_dense(rng, m, n, density)
    ref, bsr = _pair(a, bm, bn)
    np.testing.assert_array_equal(bsr.tiles.numpy(), np.asarray(ref.tiles))
    np.testing.assert_array_equal(bsr.block_cols.numpy(), np.asarray(ref.block_cols))
    np.testing.assert_array_equal(bsr.nblocks.numpy(), np.asarray(ref.nblocks))
    assert (bsr.shape, bsr.logical_shape, bsr.bm, bsr.bn, bsr.n_block_rows, bsr.max_blocks) == \
        (ref.shape, ref.logical_shape, ref.bm, ref.bn, ref.n_block_rows, ref.max_blocks)
    assert bsr.density == pytest.approx(ref.density)
    np.testing.assert_array_equal(bsr_to_dense(bsr), j_to_dense(ref))
    np.testing.assert_allclose(bsr_to_dense(bsr), a, atol=1e-6)
    x = rng.standard_normal(n).astype(np.float32)
    y = bsr_matvec_ref(bsr, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, a @ x, atol=2e-3)
    np.testing.assert_allclose(y, np.asarray(j_matvec(ref, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,bm,bn,k", [(17, 40, 8, 16, 3), (64, 300, 4, 128, 5), (5, 7, 8, 16, 1)])
def test_the_blocked_oracles_match_the_references(m, n, bm, bn, k):
    """``kernels.ref.bsr_matmat_ref`` / ``bsr_matvec_ref`` on the padded
    blocked layout: the reference's values, and A·X on the logical rows."""
    rng = np.random.default_rng(m * n + k)
    a = random_dense(rng, m, n, 0.2)
    ref, bsr = _pair(a, bm, bn)
    x = rng.standard_normal((bsr.shape[1], k)).astype(np.float32)
    got = bsr_matmat_ref(bsr.tiles, bsr.block_cols, torch.from_numpy(x)).numpy()
    want = np.asarray(j_matmat(ref.tiles, ref.block_cols, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:m], a @ x[:n], atol=2e-3)
    v = k_matvec(bsr.tiles, bsr.block_cols, torch.from_numpy(x[:, 0])).numpy()
    np.testing.assert_allclose(v, np.asarray(j_kmatvec(ref.tiles, ref.block_cols, jnp.asarray(x[:, 0]))),
                               rtol=1e-5, atol=1e-5)


def test_an_empty_matrix_keeps_one_padded_tile():
    bsr = bsr_from_csr(csr_from_dense(np.zeros((3, 5))), bm=4, bn=16, device="cpu")
    assert isinstance(bsr, BsrMatrix) and bsr.max_blocks == 1 and int(bsr.nblocks.sum()) == 0
    assert bsr.density == 0.0 and not bsr_to_dense(bsr).any()
