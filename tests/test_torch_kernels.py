"""Port vs reference, the two kernel modules. The JAX Pallas kernels
run in interpret mode (their default), as the reference's own tests run
them; the port's wrappers get CPU tensors and therefore run their plain
PyTorch versions (the CUDA kernels themselves are held against these
plain versions on the GPU by ``chip_smoke.py``)."""

import functools
import importlib.util
import pathlib

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
from repro_torch.kernels.sstep_inner import MAX_CONSUMERS, MAX_SB, inner_geometry, sstep_inner, sstep_inner_ref
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
    launches = dict(tgram.ell_gram_and_v.launches)
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
    """A precision the reference has not ("fp16") and shapes that do not
    fit are refused by every wrapper and plain version; both modes of
    the reference ("fp32", "bf16") run. The corrections kernel's launch
    geometry refuses what the kernel cannot launch."""
    idx, val, x = _bundle(8, 20, 3, 0)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    for fn in (tgram.ell_gram_and_v, tgram.ell_gram_and_v_blocked):
        with pytest.raises(ValueError, match="precision"):
            fn(ti, tv, tx, n=20, precision="fp16")
        for precision in ("fp32", "bf16"):
            g, v = fn(ti, tv, tx, n=20, precision=precision)
            assert g.dtype == v.dtype == torch.float32
    g = torch.zeros(8, 8)
    for fn in (sstep_inner, sstep_inner_ref):
        with pytest.raises(ValueError, match="precision"):
            fn(g, torch.zeros(8), 2, 4, 0.1, precision="fp16")
        assert fn(g, torch.zeros(8), 2, 4, 0.1, precision="bf16").shape == (8,)
    with pytest.raises(ValueError):
        sstep_inner(g, torch.zeros(8), 2, 8, 0.1)  # shapes do not match s·b
    # the CUDA kernel's launch geometry: s·b above its shared-memory bound,
    # an empty bundle, and consumer block sizes it cannot launch
    with pytest.raises(ValueError, match="shared-memory bound"):
        inner_geometry(2, MAX_SB // 2 + 1)
    for s, b in ((0, 8), (2, 0)):
        with pytest.raises(ValueError, match="positive"):
            inner_geometry(s, b)
    for threads in (0, 48, MAX_CONSUMERS + 32):
        with pytest.raises(ValueError, match="threads"):
            inner_geometry(4, 32, threads=threads)


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
    launches = dict(sstep_inner.launches)
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


# ---- the CUDA Gram kernel's launch geometry and edge cases ------------------


@functools.cache
def _load_chip_smoke():
    """``chip_smoke.py`` at the repo root, for its edge-case bundles (it
    imports torch and numpy only; nothing runs on import)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("w", [1, 111, 129, 164, 540, 2000, 13100])
@pytest.mark.parametrize("sb", [8, 128, 512, 1024])
def test_gram_geometry_covers_every_width(sb, w):
    """Tiles cover sb rows and chunks cover w entries, each chunk no
    wider than MAX_CHUNK, in the fewest chunks that fit; a table has a
    power of two of slots, at least twice a chunk (four times up to
    TABLE_SLOTS) and less than eight times; the shared memory is the kernel's layout and fits an
    sm_90 block; few blocks get small tiles."""
    geo = tgram.gram_geometry(sb, w)
    assert (geo.tiles - 1) * geo.tile < sb <= geo.tiles * geo.tile
    assert geo.tile == (16 if geo.tiles * (geo.tiles + 1) // 2 >= tgram.FILL_BLOCKS else 8)
    n_chunks = -(-w // geo.chunk)
    assert n_chunks >= -(-w // tgram.MAX_CHUNK) and geo.chunk <= min(w, tgram.MAX_CHUNK)
    assert (n_chunks - 1) * geo.chunk < w <= n_chunks * geo.chunk
    assert geo.cap == 1 << geo.cap_log2 and geo.cap >= 8 and 2 * geo.chunk <= geo.cap
    assert 4 * geo.chunk <= geo.cap or geo.cap >= tgram.TABLE_SLOTS
    assert geo.cap == 8 or geo.cap < 8 * geo.chunk
    assert geo.threads == geo.tile ** 2 * geo.ks == 512  # the kernel's __launch_bounds__
    layout = 2 * geo.tile * (geo.cap + 4) + 4 * geo.tile * geo.chunk + 2 * geo.tile + geo.ks * geo.tile ** 2
    assert geo.smem_bytes == 4 * layout <= tgram.SMEM_LIMIT == 232_448
    if n_chunks > -(-w // tgram.MAX_CHUNK):  # one chunk fewer would not fit
        wider = -(-w // (n_chunks - 1))
        cap = max(1 << (2 * wider - 1).bit_length(), min(tgram.TABLE_SLOTS, 1 << (4 * wider - 1).bit_length()))
        assert 4 * (layout - 2 * geo.tile * (geo.cap - cap) + 4 * geo.tile * (wider - geo.chunk)) > tgram.SMEM_LIMIT


def test_gram_geometry_refuses_an_empty_bundle():
    for sb, w in ((0, 111), (128, 0)):
        with pytest.raises(ValueError, match="empty"):
            tgram.gram_geometry(sb, w)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 111, 2000), (8, tgram.MAX_CHUNK + 88, 2000)], ids=["one-chunk", "two-chunks"])
@pytest.mark.parametrize("kind", ["all_pads", "col0_beside_pads", "shuffled", "id_thrice"])
def test_ell_gram_edge_cases_match_reference(kind, shape, precision):
    """``chip_smoke.py``'s edge-case bundles (all-pad rows, a real column
    0 beside pads, ids in random order, an id three times in every row),
    at one chunk a row and at two: the plain version (and the wrapper on
    CPU tensors) against the reference's Pallas kernel (interpret) in the
    same mode at GV_TOL — at 2e-2 in bf16 where a row repeats an id: the
    reference rounds each of its entries to bf16 and then their sum, the
    plain version the sum alone — and against the dense fp32 oracles, at
    GV_TOL in fp32 and at 2e-2 in bf16."""
    sb, w, n = shape
    smoke = _load_chip_smoke()
    assert kind in smoke.EDGE_KINDS
    idx, val, x = smoke.edge_bundle(kind, sb, w, n, seed=7)
    ji, jv, jx = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x)
    jg, jv_ = jgram.ell_gram_and_v(ji, jv, jx, n=n, bk=512, precision=precision)
    oracles = [jref.ell_gram_and_v_ref(ji, jv, jx, n)]
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    oracles.append(tref.ell_gram_and_v_ref(ti, tv, tx, n))
    bf16_tol = dict(rtol=2e-2, atol=2e-2)
    tol = bf16_tol if precision == "bf16" and kind == "id_thrice" else GV_TOL
    oracle_tol = GV_TOL if precision == "fp32" else bf16_tol
    for g, v in (tgram.ell_gram_and_v_blocked(ti, tv, tx, n=n, precision=precision),
                 tgram.ell_gram_and_v(ti, tv, tx, n=n, precision=precision)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **tol)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv_), **tol)
        for og, ov in oracles:
            np.testing.assert_allclose(g.numpy(), np.asarray(og), **oracle_tol)
            np.testing.assert_allclose(v.numpy(), np.asarray(ov), **oracle_tol)
        if kind == "all_pads":  # pads add nothing, exactly
            assert not g[0::2].any() and not g[:, 0::2].any() and not v[0::2].any()
    assert float(np.abs(np.asarray(jg)).max()) > 0  # the rows do share columns
