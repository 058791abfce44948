"""The delay-D pipeline and bf16 precision: ``repro_torch`` against
``repro`` on the same numpy data — the engine at D ≥ 1 on every corner,
the bf16 engine against the reference's Pallas path (interpret mode),
chunked ≡ monolithic inside the port, and the bf16 plain versions of
both kernels against the reference's bf16 kernels."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core import objective as jobj
from repro.core import teams as jteams
from repro.kernels import ell_gram as jgram
from repro.kernels.sstep_inner import sstep_inner as j_sstep_inner
from repro.sparse import synthetic as jsyn
from repro_torch.core import engine as tengine
from repro_torch.core import teams as tteams
from repro_torch.kernels import ell_gram as tgram
from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref

# the port's engine tolerance (tests/test_torch_engine.py): float32 sums in
# another order over a few dozen steps. bf16 needs no more: both sides
# round the same operands (measured gap ≤ 3e-8 on these problems).
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 plain versions against the reference's bf16 kernels on rows with
# unique column ids: the products of bf16 values are exact in float32, so
# only the order of the float32 sums differs.
BF16_TOL = dict(rtol=1e-6, atol=1e-6)
# rows with duplicate ids: the reference rounds each per-column sum to bf16,
# the float32 result does not round at all — about 8 mantissa bits.
BF16_DUP_TOL = dict(rtol=2e-2, atol=2e-2)

M, N = 256, 300
# corner → (p_r, constructor); 32-row bundles everywhere. τ/s bundles a
# round: mb_sgd 1, sstep 1, fedavg 4, hybrid 2.
CORNERS = {
    "mb_sgd": (1, lambda S, **kw: S.mb_sgd(8, 0.2, 16, loss_every=8, **kw)),
    "sstep": (1, lambda S, **kw: S.sstep(4, 8, 0.2, 16, loss_every=8, **kw)),
    "fedavg": (2, lambda S, **kw: S.fedavg(2, 8, 0.2, 4, 4, loss_every=2, **kw)),
    "hybrid": (2, lambda S, **kw: S.hybrid(2, 4, 8, 0.2, 8, 4, loss_every=2, **kw)),
}


def HYBRID_D2(S, **kw):
    """The hybrid corner with τ = 16: four bundles a round."""
    return S.hybrid(2, 4, 8, 0.2, 16, 4, loss_every=2, **kw)


def _both_problems(p, l2=0.0, seed=3):
    rng = np.random.default_rng(seed)
    a = jsyn.make_skewed_csr(M, N, 10, 0.8, seed=seed)
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0)
    x0 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    jt = jteams.stack_row_teams(a, y, p, row_multiple=32, objective=jobj.get_objective("logistic", l2))
    tt = tteams.team_problem_from_numpy(
        np.asarray(jt.indices), np.asarray(jt.values), np.asarray(jt.rows_valid),
        p=jt.p, m=jt.m, n=jt.n, objective="logistic", l2=l2, device="cpu")
    return jt, tt, x0


def _run_both(jt, tt, x0, jsched, tsched):
    jx, jl = jengine.run_parallel_sgd(jt, jnp.asarray(x0), jsched)
    tx, tl = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), tsched)
    assert tx.dtype == torch.float32 and tl.shape == np.asarray(jl).shape and tl.shape[0] > 0
    assert not np.allclose(tx.numpy(), x0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **X_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)
    return tx, tl


# ---- the engine at D ≥ 1 -------------------------------------------------


@pytest.mark.parametrize("l2", [0.0, 0.05])
@pytest.mark.parametrize("delay", [1, 2])
@pytest.mark.parametrize("corner", list(CORNERS))
def test_delayed_engine_matches_reference(corner, delay, l2):
    """Every corner at D = 1 and 2, with and without L2. Where D exceeds
    the corner's τ/s bundles a round (mb_sgd and sstep have one), both
    engines refuse the schedule at the solver entry."""
    p, make = CORNERS[corner]
    jt, tt, x0 = _both_problems(p, l2)
    jsched = make(jengine.ParallelSGDSchedule, gram="blocked", bk=128, delay=delay)
    tsched = make(tengine.ParallelSGDSchedule, bk=128, delay=delay)
    if delay > tsched.tau // tsched.s:
        for engine, sched, x in ((jengine, jsched, jnp.asarray(x0)), (tengine, tsched, torch.from_numpy(x0))):
            with pytest.raises(ValueError, match="τ/s"):
                engine.run_parallel_sgd(jt if engine is jengine else tt, x, sched)
        return
    tx, _ = _run_both(jt, tt, x0, jsched, tsched)
    sync, _ = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), dataclasses.replace(tsched, delay=0))
    if tsched.tau // tsched.s > 1:
        # staleness is live: the delayed iterate is not the synchronous one
        assert float((tx - sync).abs().max()) > 1e-4
    else:
        # one bundle a round: it drains before the average, computed at the
        # iterate the synchronous step uses
        np.testing.assert_allclose(tx.numpy(), sync.numpy(), **X_TOL)


def test_delay_equal_to_bundles_drains_everything():
    """D = τ/s: no bundle is consumed inside the loop, the drain applies
    all of them before the team average."""
    jt, tt, x0 = _both_problems(2)
    _run_both(jt, tt, x0, HYBRID_D2(jengine.ParallelSGDSchedule, gram="blocked", bk=128, delay=4),
              HYBRID_D2(tengine.ParallelSGDSchedule, bk=128, delay=4))


# ---- bf16 ----------------------------------------------------------------


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("corner", ["hybrid", "fedavg"])
def test_bf16_engine_matches_reference_pallas(corner, delay):
    """bf16 on the hybrid (s = 4) and the s = 1 corner, synchronous and
    at D = 2: the reference's Pallas kernel (interpret mode) against the
    port's ``gram="kernel"`` (its plain version on CPU tensors)."""
    p, make = (2, HYBRID_D2) if corner == "hybrid" else CORNERS[corner]
    jt, tt, x0 = _both_problems(p)
    tx, _ = _run_both(
        jt, tt, x0,
        make(jengine.ParallelSGDSchedule, gram="pallas", bk=128, delay=delay, precision="bf16"),
        make(tengine.ParallelSGDSchedule, gram="kernel", bk=128, delay=delay, precision="bf16"))
    fp32, _ = tengine.run_parallel_sgd(
        tt, torch.from_numpy(x0), make(tengine.ParallelSGDSchedule, bk=128, delay=delay))
    # the reference's documented bf16 tolerance, and the rounding is live
    assert 0.0 < float((tx - fp32).abs().max()) < 1e-3


def test_bf16_every_gram_backend_matches_reference():
    """The port's blocked and dense backends under bf16, as the
    reference's: the dense oracle ignores the precision (fp32 (G, v)),
    the (G, v) wire cast still applies."""
    jt, tt, x0 = _both_problems(2)
    for gram in ("blocked", "dense"):
        _run_both(jt, tt, x0,
                  HYBRID_D2(jengine.ParallelSGDSchedule, gram=gram, bk=128, precision="bf16", delay=1),
                  HYBRID_D2(tengine.ParallelSGDSchedule, gram=gram, bk=128, precision="bf16", delay=1))


def test_wire_cast_round_trip():
    g, v = torch.tensor([[0.0, 0.0], [1.0 + 2**-10, 0.0]]), torch.tensor([3.0, -1.0 / 3.0])
    assert tengine.wire_gv((g, v), "fp32") == (g, v)
    wg, wv = tengine.wire_gv((g, v), "bf16")
    assert wg.dtype == wv.dtype == torch.bfloat16
    ug, uv = tengine.unwire_gv((wg, wv), "bf16")
    assert ug.dtype == uv.dtype == torch.float32
    want = jengine.unwire_gv(jengine.wire_gv((jnp.asarray(g.numpy()), jnp.asarray(v.numpy())), "bf16"), "bf16")
    np.testing.assert_array_equal(ug.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(want[1]))
    assert float(ug[1, 0]) == 1.0  # 1 + 2⁻¹⁰ is below bf16's resolution


# ---- chunked ≡ monolithic --------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize(
    "kw", [dict(delay=2), dict(precision="bf16"), dict(delay=2, precision="bf16"),
           dict(delay=1, precision="bf16")], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_chunked_equals_monolithic_exactly(kw, k):
    """run_engine_chunk over offsets 0, k, 2k … is the monolithic run bit
    for bit at D ≥ 1 and under bf16 (the FIFO drains inside each round)."""
    _, tt, x0 = _both_problems(2, 0.05)
    sched = HYBRID_D2(tengine.ParallelSGDSchedule, **kw)
    x_mono, _ = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), sched)
    x = torch.from_numpy(x0)
    for r0 in range(0, sched.rounds, k):
        x = tengine.run_engine_chunk(tt, x, r0, min(k, sched.rounds - r0), sched)
    assert torch.equal(x, x_mono)


def test_chunk_entry_validates_delay():
    _, tt, x0 = _both_problems(2)
    with pytest.raises(ValueError, match="τ/s"):
        tengine.run_engine_chunk(tt, torch.from_numpy(x0), 0, 1,
                                 CORNERS["hybrid"][1](tengine.ParallelSGDSchedule, delay=3))


# ---- the kernels' bf16 plain versions ---------------------------------------


def _unique_bundle(sb, n, width, seed):
    """Rows with distinct column ids (as every registered dataset has),
    a padded tail of (0, 0) entries on every other row."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=width, replace=False) for _ in range(sb)]).astype(np.int32)
    val = rng.standard_normal((sb, width)).astype(np.float32)
    idx[::2, width - width // 4 :] = 0
    val[::2, width - width // 4 :] = 0.0
    return idx, val, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize(
    "sb,n,width,bk,bm,seed",
    [(8, 40, 4, 128, None, 0), (32, 300, 9, 128, None, 1), (32, 1000, 17, 256, 16, 2),
     (64, 1999, 24, 512, None, 3), (64, 777, 5, 256, 32, 4), (128, 3000, 40, 512, None, 5)],
)
def test_ell_gram_bf16_matches_reference(sb, n, width, bk, bm, seed):
    """Unique-id rows: the port's bf16 plain version (and its wrapper on
    CPU tensors) against the reference's bf16 Pallas kernel and blocked
    twin at 1e-6; and bf16 deviates from fp32 by a small nonzero amount."""
    idx, val, x = _unique_bundle(sb, n, width, seed)
    ji, jv, jx = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x)
    want = [jgram.ell_gram_and_v(ji, jv, jx, n=n, bk=bk, bm=bm, precision="bf16"),
            jgram.ell_gram_and_v_blocked(ji, jv, jx, n=n, bk=bk, bm=bm, precision="bf16")]
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    launches = dict(tgram.ell_gram_and_v.launches)
    got = [tgram.ell_gram_and_v_blocked(ti, tv, tx, n=n, bk=bk, bm=bm, precision="bf16"),
           tgram.ell_gram_and_v(ti, tv, tx, n=n, bk=bk, bm=bm, precision="bf16")]
    assert tgram.ell_gram_and_v.launches == launches  # CPU tensors launch nothing
    for g, v in got:
        assert g.dtype == v.dtype == torch.float32
        for wg, wv in want:
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), **BF16_TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(wv), **BF16_TOL)
    g32, v32 = tgram.ell_gram_and_v(ti, tv, tx, n=n, bk=bk, bm=bm)
    g16, v16 = got[1]
    if float(g32.abs().max()) > 0:
        rel = float((g16 - g32).abs().max() / g32.abs().max())
        assert 0.0 < rel < 2e-2, rel
    rel_v = float((v16 - v32).abs().max() / v32.abs().max())
    assert 0.0 < rel_v < 2e-2, rel_v


@pytest.mark.parametrize("sb,n,width,seed", [(8, 37, 24, 0), (32, 300, 12, 1), (64, 500, 30, 2)])
def test_ell_gram_bf16_on_duplicate_ids(sb, n, width, seed):
    """Rows that repeat column ids (width close to n): the bf16 result
    lies within 2e-2 of the float32 one, and within 2e-2 of the
    reference's bf16 kernel."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(sb, width)).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # a duplicate in every row
    val = (rng.standard_normal((sb, width)) / np.sqrt(width)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    g16, v16 = tgram.ell_gram_and_v(ti, tv, tx, n=n, bk=128, precision="bf16")
    for precision, tol in (("fp32", BF16_DUP_TOL), ("bf16", BF16_DUP_TOL)):
        wg, wv = jgram.ell_gram_and_v(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x), n=n,
                                      bk=128, precision=precision)
        np.testing.assert_allclose(g16.numpy(), np.asarray(wg), **tol)
        np.testing.assert_allclose(v16.numpy(), np.asarray(wv), **tol)


def _gram_inputs(s, b, seed):
    rng = np.random.default_rng(seed)
    sb = s * b
    y = rng.standard_normal((sb, 200)).astype(np.float32) / np.sqrt(200)
    return np.tril(y @ y.T, -1).astype(np.float32), rng.standard_normal(sb).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("b,eta,seed", [(4, 0.1, 0), (16, 1.0, 1)])
def test_sstep_inner_bf16_matches_reference(s, b, eta, seed):
    """The correction loop's bf16 mode: the port's plain version and its
    wrapper on CPU against the reference's Pallas kernel (interpret) at
    1e-6; bf16 deviates from fp32 by a small nonzero amount once there
    is a dot to round (s > 1)."""
    g, v = _gram_inputs(s, b, seed)
    want = np.asarray(j_sstep_inner(jnp.asarray(g), jnp.asarray(v), s, b, eta, precision="bf16"))
    tg, tv = torch.from_numpy(g), torch.from_numpy(v)
    launches = dict(sstep_inner.launches)
    got = [sstep_inner_ref(tg, tv, s, b, eta, precision="bf16"),
           sstep_inner(tg, tv, s, b, eta, precision="bf16")]
    assert sstep_inner.launches == launches
    for u in got:
        assert u.dtype == torch.float32 and u.shape == (s * b,)
        np.testing.assert_allclose(u.numpy(), want, **BF16_TOL)
    du = float((got[1] - sstep_inner(tg, tv, s, b, eta)).abs().max())
    if s > 1:
        assert 0.0 < du < 1e-2, du
    else:
        assert du == 0.0  # one block: nothing enters a dot
