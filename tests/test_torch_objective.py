"""Port vs reference, objectives and the problem-level loss."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import objective as jobj
from repro.core import problem as jproblem
from repro.sparse import synthetic as jsyn
from repro_torch.core import objective as tobj
from repro_torch.core import problem as tproblem

NAMES = ["logistic", "squared_hinge", "least_squares"]

# margins incl. the overflow branches of the logistic residual
Z_GRID = np.concatenate([
    np.linspace(-8.0, 8.0, 65),
    np.array([-100.0, -50.0, -20.0, 0.0, 20.0, 50.0, 100.0]),
]).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_residual_matches_reference(name):
    """rtol 1e-6 / atol 1e-7: the same float32 expression evaluated by
    two exp implementations."""
    got = tobj.get_objective(name).residual(torch.from_numpy(Z_GRID)).numpy()
    want = np.asarray(jobj.get_objective(name).residual(jnp.asarray(Z_GRID)))
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_pointwise_loss_matches_reference(name):
    got = tobj.get_objective(name).pointwise_loss(torch.from_numpy(Z_GRID)).numpy()
    want = np.asarray(jobj.get_objective(name).pointwise_loss(jnp.asarray(Z_GRID)))
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_registry_and_validation_match_reference():
    assert sorted(tobj.OBJECTIVES) == sorted(jobj.OBJECTIVES)
    assert tobj.LOGISTIC.name == "logistic" and tobj.LOGISTIC.l2 == 0.0
    obj = tobj.get_objective("squared_hinge", l2=0.1)
    assert tobj.get_objective(obj) is obj
    assert hash(obj) == hash(tobj.SquaredHingeObjective(l2=0.1))
    with pytest.raises(ValueError):
        tobj.get_objective(obj, l2=0.2)
    with pytest.raises(ValueError):
        tobj.get_objective("hinge")
    for bad in (-1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            tobj.LogisticObjective(l2=bad)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("l2", [0.0, 0.05])
def test_problem_loss_matches_reference(name, l2):
    """Full objective with and without L2, padded rows masked out;
    rtol 1e-5: a float32 sum over a few hundred samples."""
    rng = np.random.default_rng(5)
    a = jsyn.make_skewed_csr(150, 80, 7, 0.5, seed=2)
    y = np.where(rng.random(150) < 0.5, 1.0, -1.0)
    x = rng.standard_normal(80).astype(np.float32)
    jp = jproblem.make_problem(a, y, row_multiple=64, objective=jobj.get_objective(name, l2))
    tp = tproblem.problem_from_numpy(
        np.asarray(jp.ya.indices), np.asarray(jp.ya.values), np.asarray(jp.rows_valid),
        m=jp.m, n=jp.n, objective=name, l2=l2, device="cpu")
    assert tp.padded_m == 192 and int(tp.rows_valid.sum()) == 150
    got = tproblem.problem_loss(tp, torch.from_numpy(x))
    want = jproblem.problem_loss(jp, jnp.asarray(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
