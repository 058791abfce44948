"""Port vs reference, the two kernel modules. The JAX Pallas kernels
run in interpret mode (their default), as the reference's own tests run
them; the port's wrappers get CPU tensors and therefore run their plain
PyTorch versions (the CUDA kernels themselves are held against these
plain versions on the GPU by ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core import objective as jobj
from repro.kernels import ell_gram as jgram
from repro.kernels import ref as jref
from repro.kernels.sstep_inner import sstep_inner as j_sstep_inner
from repro.kernels.sstep_inner import sstep_inner_ref as j_sstep_inner_ref
from repro.sparse import synthetic as jsyn
from repro_torch.core import engine as tengine
from repro_torch.core import objective as tobj
from repro_torch.core import problem as tproblem
from repro_torch.core.sgd import batch_rows, run_sgd
from repro_torch.kernels import ell_gram as tgram
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref
from repro_torch.sparse.ell import ell_rmatvec

# (G, v): rtol = atol = 1e-3, the reference's own kernel tolerance —
# float32 sums over the columns taken in different orders.
GV_TOL = dict(rtol=1e-3, atol=1e-3)
# u: rtol = atol = 1e-5, the reference's own — exp implementations and
# the order of the short dot products differ.
U_TOL = dict(rtol=1e-5, atol=1e-5)


def _bundle(sb, n, width, seed):
    rng = np.random.default_rng(seed)
    width = min(width, n)
    idx = rng.integers(0, n, size=(sb, width)).astype(np.int32)  # duplicates included
    val = rng.standard_normal((sb, width)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return idx, val, x


@pytest.mark.parametrize(
    "sb,n,width,bk,bm,seed",
    [
        (8, 10, 1, 128, None, 0),
        (8, 37, 24, 128, None, 1),  # width > n/2: many duplicate ids
        (32, 300, 9, 128, None, 2),
        (32, 1000, 17, 256, 16, 3),  # a row-tiled expansion
        (64, 1999, 24, 512, None, 4),  # n not a multiple of bk
        (64, 777, 5, 256, 32, 5),
        (32, 512, 12, 512, None, 6),  # exactly one panel
        (8, 2000, 3, 128, None, 7),
    ],
)
def test_ell_gram_sweep(sb, n, width, bk, bm, seed):
    """Random bundles, four ways: the reference's Pallas kernel
    (interpret) and dense oracle, the port's plain blocked version,
    its wrapper on CPU tensors, and its dense oracle."""
    idx, val, x = _bundle(sb, n, width, seed)
    jg, jv = jgram.ell_gram_and_v(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x),
                                  n=n, bk=bk, bm=bm)
    og, ov = jref.ell_gram_and_v_ref(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x), n)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    launches = tgram.ell_gram_and_v.launches
    for g, v in (
        tgram.ell_gram_and_v_blocked(ti, tv, tx, n=n, bk=bk, bm=bm),
        tgram.ell_gram_and_v(ti, tv, tx, n=n, bk=bk, bm=bm),
        tref.ell_gram_and_v_ref(ti, tv, tx, n),
    ):
        assert g.dtype == torch.float32 and g.shape == (sb, sb) and v.shape == (sb,)
        for want_g, want_v in ((jg, jv), (og, ov)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GV_TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(want_v), **GV_TOL)
    # a CPU tensor never counts as a kernel launch
    assert tgram.ell_gram_and_v.launches == launches


def test_ell_gram_is_strictly_lower():
    idx, val, x = _bundle(32, 300, 9, 2)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    for g, _ in (
        tgram.ell_gram_and_v(ti, tv, tx, n=300, bk=128),
        tref.ell_gram_and_v_ref(ti, tv, tx, 300),
    ):
        assert np.all(np.triu(g.numpy()) == 0.0)


def test_ell_gram_bm_gives_identical_panels():
    idx, val, _ = _bundle(32, 400, 11, 3)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    whole = tgram.panel_from_ell(ti, tv, 1, 128, torch.float32)
    tiled = tgram.panel_from_ell(ti, tv, 1, 128, torch.float32, bm=8)
    assert torch.equal(whole, tiled)
    want = np.asarray(jgram.panel_from_ell(jnp.asarray(idx), jnp.asarray(val), 1, 128, jnp.float32))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_reject_what_is_not_ported():
    idx, val, x = _bundle(8, 20, 3, 0)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    with pytest.raises(NotImplementedError, match="bf16"):
        tgram.ell_gram_and_v(ti, tv, tx, n=20, precision="bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        tgram.ell_gram_and_v_blocked(ti, tv, tx, n=20, precision="bf16")
    with pytest.raises(ValueError):
        tgram.ell_gram_and_v(ti, tv, tx, n=20, precision="fp16")
    g = torch.zeros(8, 8)
    with pytest.raises(NotImplementedError, match="bf16"):
        sstep_inner(g, torch.zeros(8), 2, 4, 0.1, precision="bf16")
    with pytest.raises(ValueError):
        sstep_inner(g, torch.zeros(8), 2, 8, 0.1)  # shapes do not match s·b


def test_densify_oracle_matches_csr():
    """The oracle's densify == the CSR dense expansion, and duplicate
    column ids add (they do not overwrite)."""
    a = jsyn.make_skewed_csr(64, 257, 9, 0.5, seed=8)
    prob = tproblem.make_problem(a, np.ones(64), row_multiple=64, device="cpu")
    dense = tref.densify_bundle_ref(prob.ya.indices, prob.ya.values, 257).numpy()
    np.testing.assert_allclose(dense[:64], a.to_dense().astype(np.float32), rtol=1e-6, atol=1e-6)

    idx = torch.tensor([[2, 2, 5]], dtype=torch.int32)
    val = torch.tensor([[1.5, 2.0, -1.0]])
    want = np.asarray(jref.densify_bundle_ref(jnp.asarray(idx.numpy()), jnp.asarray(val.numpy()), 6))
    np.testing.assert_array_equal(tref.densify_bundle_ref(idx, val, 6).numpy(), want)
    assert want[0, 2] == 3.5


def test_gram_oracles_match_reference():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((24, 50)).astype(np.float32)
    x = rng.standard_normal(50).astype(np.float32)
    g, v = tref.gram_and_v_ref(torch.from_numpy(y), torch.from_numpy(x))
    jg, jv = jref.gram_and_v_ref(jnp.asarray(y), jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tref.gram_tril_ref(torch.from_numpy(y)).numpy(), np.asarray(jref.gram_tril_ref(jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)


def _gram_inputs(s, b, seed):
    rng = np.random.default_rng(seed)
    sb = s * b
    y = rng.standard_normal((sb, 200)).astype(np.float32)
    return np.tril(y @ y.T, -1).astype(np.float32), rng.standard_normal(sb).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("b,eta,seed", [(4, 0.01, 0), (8, 0.3, 1), (16, 1.0, 2)])
def test_sstep_inner_kernel_sweep(s, b, eta, seed):
    """Correction loop: the reference's Pallas kernel (interpret) and
    its jnp oracle vs the port's plain loop and its wrapper on CPU."""
    g, v = _gram_inputs(s, b, seed)
    want_kernel = np.asarray(j_sstep_inner(jnp.asarray(g), jnp.asarray(v), s, b, eta))
    want_ref = np.asarray(j_sstep_inner_ref(jnp.asarray(g), jnp.asarray(v), s, b, eta))
    tg, tv = torch.from_numpy(g), torch.from_numpy(v)
    launches = sstep_inner.launches
    for got in (sstep_inner_ref(tg, tv, s, b, eta), sstep_inner(tg, tv, s, b, eta)):
        assert got.dtype == torch.float32 and got.shape == (s * b,)
        np.testing.assert_allclose(got.numpy(), want_kernel, **U_TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **U_TOL)
    assert sstep_inner.launches == launches


def test_sstep_inner_kernel_in_solver_context():
    """End to end inside the port: u from the correction loop on the
    (G, v) of the bundle primitive reproduces s plain SGD steps."""
    rng = np.random.default_rng(3)
    a = jsyn.make_skewed_csr(128, 300, 10, 0.8, seed=9)
    y = np.where(rng.random(128) < 0.5, 1.0, -1.0)
    s, b, eta = 4, 8, 0.1
    prob = tproblem.make_problem(a, y, row_multiple=s * b, device="cpu")
    x = torch.from_numpy(rng.standard_normal(300).astype(np.float32))

    bundle = batch_rows(prob.ya, 0, s * b)
    g, v = tgram.ell_gram_and_v(bundle.indices, bundle.values, x, n=300, bk=128)
    u = sstep_inner(g, v, s, b, eta)
    x_new = x + (eta / b) * ell_rmatvec(bundle, u)

    x_ref, _ = run_sgd(prob, x, b, eta, s)  # oracle: s plain SGD steps
    np.testing.assert_allclose(x_new.numpy(), x_ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "name,l2",
    [("logistic", 0.0), ("logistic", 0.1), ("squared_hinge", 0.0),
     ("squared_hinge", 0.05), ("least_squares", 0.0), ("least_squares", 0.2)],
)
def test_inner_corrections_match_reference(name, l2):
    """Both branches (λ = 0 loop, ρ-decay recurrence) under every
    objective vs the reference's ``inner_corrections``; at the logistic
    default also equal to ``sstep_inner_ref``. rtol = atol = 1e-5; the
    Gram is scaled down so the unbounded residuals stay O(1)."""
    s, b, eta = 4, 8, 0.3
    g, v = _gram_inputs(s, b, 11)
    g = (g / 200.0).astype(np.float32)
    want = np.asarray(jengine.inner_corrections(
        jnp.asarray(g), jnp.asarray(v), s, b, jnp.float32(eta), jobj.get_objective(name, l2)))
    tg, tv = torch.from_numpy(g), torch.from_numpy(v)
    obj = tobj.get_objective(name, l2)
    got = tengine.inner_corrections(tg, tv, s, b, eta, obj)
    np.testing.assert_allclose(got.numpy(), want, **U_TOL)
    np.testing.assert_allclose(
        tengine.inner_corrections_loop(tg, tv, s, b, eta, obj).numpy(), want, **U_TOL)
    if name == "logistic" and l2 == 0.0:
        assert torch.equal(got, sstep_inner_ref(tg, tv, s, b, eta))
