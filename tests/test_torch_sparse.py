"""Port vs reference, sparse substrate and problem layer: the same
numpy inputs go through ``repro`` (JAX, CPU) and ``repro_torch``
(``device="cpu"``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import problem as jproblem
from repro.core import teams as jteams
from repro.sparse import csr as jcsr
from repro.sparse import ell as jell
from repro.sparse import partition as jpartition
from repro.sparse import synthetic as jsyn
from repro_torch.core import problem as tproblem
from repro_torch.core import teams as tteams
from repro_torch.sparse import csr as tcsr
from repro_torch.sparse import ell as tell
from repro_torch.sparse import partition as tpartition
from repro_torch.sparse import synthetic as tsyn


def dataclasses_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_csr(a, b):
    assert a.shape == b.shape
    for field in ("indptr", "indices", "data"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        assert np.array_equal(x, y), field


def _to_ref_csr(a):
    return jcsr.CSRMatrix(indptr=a.indptr, indices=a.indices, data=a.data, shape=a.shape)


@pytest.mark.parametrize(
    "m,n,zbar,alpha,seed,dense",
    [(200, 300, 12, 0.8, 3, False), (64, 257, 9, 0.0, 8, False),
     (50, 1000, 20, 1.0, 11, False), (16, 24, 24, 0.0, 5, True)],
)
def test_make_skewed_csr_bit_identical(m, n, zbar, alpha, seed, dense):
    """Same seed ⇒ the same arrays, bit for bit (both sides draw from
    numpy's default_rng in the same order)."""
    _same_csr(
        tsyn.make_skewed_csr(m, n, zbar, alpha, seed=seed, dense=dense),
        jsyn.make_skewed_csr(m, n, zbar, alpha, seed=seed, dense=dense),
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_make_dataset_bit_identical(seed):
    got, want = tsyn.make_dataset("rcv1-sm", seed=seed), jsyn.make_dataset("rcv1-sm", seed=seed)
    _same_csr(got.A, want.A)
    assert np.array_equal(got.y, want.y)
    assert np.array_equal(got.x_true, want.x_true)
    assert dataclasses_equal(got.stats, want.stats)


def test_dataset_registry_matches_reference():
    for name in list(jsyn.SM_STATS) + list(jsyn.DATASET_STATS):
        assert dataclasses_equal(tsyn.dataset_stats(name), jsyn.dataset_stats(name))
    with pytest.raises(KeyError):
        tsyn.dataset_stats("no-such-dataset")


def test_csr_helpers_match_reference():
    """row_block / scale_rows / to_dense / matvec / rmatvec /
    csr_from_dense / partition_rows: identical numpy results."""
    rng = np.random.default_rng(4)
    a = tsyn.make_skewed_csr(90, 140, 7, 0.5, seed=2)
    ra = _to_ref_csr(a)
    y = rng.standard_normal(90)
    x = rng.standard_normal(140)
    _same_csr(a.row_block(10, 55), ra.row_block(10, 55))
    _same_csr(a.scale_rows(y), ra.scale_rows(y))
    assert np.array_equal(a.to_dense(), ra.to_dense())
    assert np.array_equal(tcsr.csr_matvec(a, x), jcsr.csr_matvec(ra, x))
    assert np.array_equal(tcsr.csr_rmatvec(a, y), jcsr.csr_rmatvec(ra, y))
    _same_csr(tcsr.csr_from_dense(a.to_dense()), jcsr.csr_from_dense(ra.to_dense()))
    for m, p in [(90, 4), (7, 3), (2048, 8)]:
        assert np.array_equal(tpartition.partition_rows(m, p), jpartition.partition_rows(m, p))


@pytest.mark.parametrize("seed,width", [(1, None), (2, None), (3, 40)])
def test_ell_from_csr_and_products(seed, width):
    """ELL layout equal to the reference's; the four products within
    rtol 1e-6 / atol 1e-6 (float32 sums in another order)."""
    rng = np.random.default_rng(seed)
    a = tsyn.make_skewed_csr(120, 200, 9, 0.7, seed=seed)
    te = tell.ell_from_csr(a, width=width, device="cpu")
    je = jell.ell_from_csr(_to_ref_csr(a), width=width)
    assert te.values.dtype == torch.float32 and te.indices.dtype == torch.int32
    assert te.n == je.n and te.rows == je.rows and te.width == je.width
    assert np.array_equal(te.indices.numpy(), np.asarray(je.indices))
    assert np.array_equal(te.values.numpy(), np.asarray(je.values))

    x = rng.standard_normal(200).astype(np.float32)
    xm = rng.standard_normal((200, 3)).astype(np.float32)
    u = rng.standard_normal(120).astype(np.float32)
    um = rng.standard_normal((120, 3)).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tell.ell_matvec(te, torch.from_numpy(x)).numpy(),
        np.asarray(jell.ell_matvec(je, jnp.asarray(x))), **tol)
    np.testing.assert_allclose(
        tell.ell_matmat(te, torch.from_numpy(xm)).numpy(),
        np.asarray(jell.ell_matmat(je, jnp.asarray(xm))), **tol)
    np.testing.assert_allclose(
        tell.ell_rmatvec(te, torch.from_numpy(u)).numpy(),
        np.asarray(jell.ell_rmatvec(je, jnp.asarray(u))), **tol)
    np.testing.assert_allclose(
        tell.ell_rmatmat(te, torch.from_numpy(um)).numpy(),
        np.asarray(jell.ell_rmatmat(je, jnp.asarray(um))), **tol)
    ts, js = tell.ell_row_slice(te, 8, 40), jell.ell_row_slice(je, 8, 40)
    assert np.array_equal(ts.values.numpy(), np.asarray(js.values))


def test_ell_from_csr_rejects_narrow_width():
    a = tsyn.make_skewed_csr(20, 50, 9, 0.0, seed=1)
    with pytest.raises(ValueError, match="ELL width"):
        tell.ell_from_csr(a, width=1, device="cpu")


def test_ell_rmatvec_is_run_to_run_deterministic():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 17, size=(64, 9)).astype(np.int32))
    val = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    ell = tell.EllBlock(indices=idx, values=val, n=17)
    first = tell.ell_rmatvec(ell, u)
    for _ in range(3):
        assert torch.equal(tell.ell_rmatvec(ell, u), first)


@pytest.mark.parametrize("p,row_multiple", [(1, 32), (2, 64), (3, 16)])
def test_stack_row_teams_equals_reference(p, row_multiple):
    rng = np.random.default_rng(p)
    a = tsyn.make_skewed_csr(250, 180, 8, 0.6, seed=5)
    y = np.where(rng.random(250) < 0.5, 1.0, -1.0)
    tt = tteams.stack_row_teams(a, y, p, row_multiple=row_multiple, device="cpu",
                                objective="squared_hinge")
    jt = jteams.stack_row_teams(_to_ref_csr(a), y, p, row_multiple=row_multiple,
                                objective="squared_hinge")
    assert tt.values.dtype == torch.float32 and tt.indices.dtype == torch.int32
    assert (tt.p, tt.m, tt.n, tt.rows_local) == (jt.p, jt.m, jt.n, jt.rows_local)
    assert tt.objective.name == jt.objective.name
    assert np.array_equal(tt.indices.numpy(), np.asarray(jt.indices))
    assert np.array_equal(tt.values.numpy(), np.asarray(jt.values))
    assert np.array_equal(tt.rows_valid.numpy(), np.asarray(jt.rows_valid))

    tg, jg = tteams.global_problem(tt), jteams.global_problem(jt)
    assert (tg.m, tg.n, tg.padded_m) == (jg.m, jg.n, jg.padded_m)
    assert np.array_equal(tg.ya.indices.numpy(), np.asarray(jg.ya.indices))
    assert np.array_equal(tg.ya.values.numpy(), np.asarray(jg.ya.values))
    assert np.array_equal(tg.rows_valid.numpy(), np.asarray(jg.rows_valid))
    te = tt.team_ell(p - 1)
    assert np.array_equal(te.values.numpy(), np.asarray(jt.team_ell(p - 1).values))


@pytest.mark.parametrize("row_multiple,ell_width", [(1, None), (64, None), (48, 30)])
def test_make_problem_equals_reference(row_multiple, ell_width):
    rng = np.random.default_rng(9)
    a = tsyn.make_skewed_csr(100, 90, 6, 0.4, seed=6)
    y = np.where(rng.random(100) < 0.5, 1.0, -1.0)
    tp = tproblem.make_problem(a, y, row_multiple=row_multiple, ell_width=ell_width, device="cpu")
    jp = jproblem.make_problem(_to_ref_csr(a), y, row_multiple=row_multiple, ell_width=ell_width)
    assert tp.ya.values.dtype == torch.float32
    assert (tp.m, tp.n, tp.padded_m) == (jp.m, jp.n, jp.padded_m)
    assert tproblem.pad_rows_to(a, row_multiple) == jproblem.pad_rows_to(_to_ref_csr(a), row_multiple)
    assert np.array_equal(tp.ya.indices.numpy(), np.asarray(jp.ya.indices))
    assert np.array_equal(tp.ya.values.numpy(), np.asarray(jp.ya.values))
    assert np.array_equal(tp.rows_valid.numpy(), np.asarray(jp.rows_valid))


def test_from_numpy_carries_reference_state_across():
    """The carry-across constructors take the reference's fields as
    numpy arrays and return float32 / int32 tensors equal to them."""
    rng = np.random.default_rng(12)
    a = jsyn.make_skewed_csr(96, 70, 5, 0.3, seed=4)
    y = np.where(rng.random(96) < 0.5, 1.0, -1.0)
    jt = jteams.stack_row_teams(a, y, 3, row_multiple=8, objective="least_squares")
    tt = tteams.team_problem_from_numpy(
        np.asarray(jt.indices), np.asarray(jt.values), np.asarray(jt.rows_valid),
        p=jt.p, m=jt.m, n=jt.n, objective=jt.objective.name, l2=0.25, device="cpu")
    assert tt.values.dtype == torch.float32 and tt.indices.dtype == torch.int32
    assert tt.rows_valid.dtype == torch.bool
    assert tt.objective.name == "least_squares" and tt.objective.l2 == 0.25
    assert np.array_equal(tt.values.numpy(), np.asarray(jt.values))
    with pytest.raises(ValueError):
        tteams.team_problem_from_numpy(
            np.asarray(jt.indices), np.asarray(jt.values), np.asarray(jt.rows_valid),
            p=2, m=jt.m, n=jt.n, device="cpu")

    jp = jproblem.make_problem(a, y, row_multiple=32)
    tp = tproblem.problem_from_numpy(
        np.asarray(jp.ya.indices), np.asarray(jp.ya.values), np.asarray(jp.rows_valid),
        m=jp.m, n=jp.n, objective="logistic", device="cpu")
    assert tp.ya.values.dtype == torch.float32 and tp.padded_m == jp.padded_m
    assert np.array_equal(tp.ya.indices.numpy(), np.asarray(jp.ya.indices))
