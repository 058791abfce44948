"""The ported slice as a whole: ``repro_torch.core.engine`` against
``repro.core.engine`` on the same numpy data — final iterate *and*
loss trace at the four corners, under the three objectives, with and
without L2 — plus the port's own structural invariants."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core import objective as jobj
from repro.core import teams as jteams
from repro.sparse import synthetic as jsyn
from repro_torch.core import engine as tengine
from repro_torch.core import teams as tteams
from repro_torch.core.fedavg import run_fedavg
from repro_torch.core.hybrid import run_hybrid_sgd
from repro_torch.core.problem import make_problem
from repro_torch.core.sgd import run_sgd, sgd_step
from repro_torch.core.sstep import run_sstep_sgd, sstep_bundle

# iterates: rtol 1e-4 / atol 1e-5 — float32 reductions taken in another
# order over a few dozen steps; losses: rtol 1e-5 on an O(1) mean.
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)

M, N = 256, 300
NAMES = ["logistic", "squared_hinge", "least_squares"]
# corner → (p_r, constructor arguments); 32-row bundles everywhere
CORNERS = {
    "mb_sgd": (1, lambda S, **kw: S.mb_sgd(8, 0.2, 16, loss_every=8, **kw)),
    "sstep": (1, lambda S, **kw: S.sstep(4, 8, 0.2, 16, loss_every=8, **kw)),
    "fedavg": (2, lambda S, **kw: S.fedavg(2, 8, 0.2, 4, 4, loss_every=2, **kw)),
    "hybrid": (2, lambda S, **kw: S.hybrid(2, 4, 8, 0.2, 8, 4, loss_every=2, **kw)),
}


def _data(seed=3):
    rng = np.random.default_rng(seed)
    a = jsyn.make_skewed_csr(M, N, 10, 0.8, seed=seed)
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0)
    x0 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return a, y, x0


def _both_problems(p, name, l2):
    """The reference's stacked teams, and the port's made from the
    reference's arrays by the carry-across constructor."""
    a, y, x0 = _data()
    jt = jteams.stack_row_teams(a, y, p, row_multiple=32, objective=jobj.get_objective(name, l2))
    tt = tteams.team_problem_from_numpy(
        np.asarray(jt.indices), np.asarray(jt.values), np.asarray(jt.rows_valid),
        p=jt.p, m=jt.m, n=jt.n, objective=name, l2=l2, device="cpu")
    return jt, tt, x0


def _compare(jt, tt, x0, jsched, tsched):
    jx, jl = jengine.run_parallel_sgd(jt, jnp.asarray(x0), jsched)
    tx, tl = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), tsched)
    assert tx.dtype == torch.float32 and tl.dtype == torch.float32
    assert tl.shape == np.asarray(jl).shape and tl.shape[0] > 0
    assert not np.allclose(tx.numpy(), x0)  # the run moved the iterate
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **X_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)


@pytest.mark.parametrize("l2", [0.0, 0.05])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("corner", list(CORNERS))
def test_engine_matches_reference(corner, name, l2):
    """Four corners × three objectives × L2 on/off. The reference runs
    its plain-jnp blocked Gram (its Pallas path is covered below), the
    port its default ``gram="kernel"`` (on CPU tensors: the plain
    version)."""
    p, make = CORNERS[corner]
    jt, tt, x0 = _both_problems(p, name, l2)
    _compare(jt, tt, x0, make(jengine.ParallelSGDSchedule, gram="blocked", bk=128),
             make(tengine.ParallelSGDSchedule, bk=128))


@pytest.mark.parametrize("gram", ["kernel", "blocked", "dense"])
def test_engine_gram_backends_match_reference_pallas(gram):
    """Every port backend vs the reference's Pallas kernel path
    (interpret mode), hybrid corner with p_r = 2, s > 1."""
    jt, tt, x0 = _both_problems(2, "logistic", 0.0)
    make = CORNERS["hybrid"][1]
    _compare(jt, tt, x0, make(jengine.ParallelSGDSchedule, gram="pallas", bk=128),
             make(tengine.ParallelSGDSchedule, gram=gram, bk=128, bm=16))


def test_port_builds_the_same_problem_itself():
    """Parity does not rest on the carry-across path alone: the port's
    own ``stack_row_teams`` gives the same run."""
    a, y, x0 = _data()
    jt, tt, _ = _both_problems(2, "logistic", 0.0)
    own = tteams.stack_row_teams(a, y, 2, row_multiple=32, device="cpu")
    sched = CORNERS["hybrid"][1](tengine.ParallelSGDSchedule)
    x1, l1 = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), sched)
    x2, l2 = tengine.run_parallel_sgd(own, torch.from_numpy(x0), sched)
    assert torch.equal(x1, x2) and torch.equal(l1, l2)


@pytest.mark.parametrize("corner,k", [("hybrid", 1), ("hybrid", 2), ("fedavg", 2), ("sstep", 1)])
@pytest.mark.parametrize("l2", [0.0, 0.05])
def test_chunked_equals_monolithic_exactly(corner, k, l2):
    """run_engine_chunk over offsets 0, k, 2k … is the monolithic run,
    bit for bit (same ops in the same order on the CPU), and agrees
    with the reference's chunked entry."""
    p, make = CORNERS[corner]
    jt, tt, x0 = _both_problems(p, "logistic", l2)
    sched = make(tengine.ParallelSGDSchedule)
    x_mono, losses = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), sched)
    x = torch.from_numpy(x0)
    for r0 in range(0, sched.rounds, k):
        x = tengine.run_engine_chunk(tt, x, r0, k, sched)
    assert torch.equal(x, x_mono)
    gp = tteams.global_problem(tt)
    assert torch.equal(tengine.engine_loss(gp, x), losses[-1])

    jsched = make(jengine.ParallelSGDSchedule, gram="blocked")
    jx = jnp.asarray(x0)
    for r0 in range(0, jsched.rounds, k):
        jx = jengine.run_engine_chunk(jt, jx, r0, k, jsched)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **X_TOL)


@pytest.mark.parametrize("name,l2", [("logistic", 0.0), ("logistic", 0.05), ("squared_hinge", 0.0)])
def test_sstep_is_sgd_inside_the_port(name, l2):
    """The s-step corner is an algebraic identity of mini-batch SGD on
    the same sample sequence: gap ≤ 1e-5."""
    _, tt, x0 = _both_problems(1, name, l2)
    S = tengine.ParallelSGDSchedule
    x_sgd, _ = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), S.mb_sgd(8, 0.2, 32))
    for gram in ("kernel", "dense"):
        x_ss, _ = tengine.run_parallel_sgd(tt, torch.from_numpy(x0), S.sstep(4, 8, 0.2, 32, gram=gram))
        assert float((x_ss - x_sgd).abs().max()) <= 1e-5


def test_corner_identities_and_wrappers():
    """hybrid(p_r=1) ≡ s-step, hybrid(s=1) ≡ FedAvg, and the thin
    wrappers are the configured engine calls."""
    a, y, x0 = _data()
    x0 = torch.from_numpy(x0)
    prob = make_problem(a, y, row_multiple=32, device="cpu")
    tp1 = tengine.single_team(prob)
    tp2 = tteams.stack_row_teams(a, y, 2, row_multiple=32, device="cpu")
    S = tengine.ParallelSGDSchedule

    x_ss, l_ss = run_sstep_sgd(prob, x0, 4, 8, 0.2, 16, loss_every=8)
    x_h1, l_h1 = run_hybrid_sgd(tp1, x0, 4, 8, 0.2, 4, 4, loss_every=2)
    assert torch.equal(x_ss, x_h1) and torch.equal(l_ss, l_h1)

    x_fa, _ = run_fedavg(tp2, x0, 8, 0.2, 4, 4)
    x_h2, _ = run_hybrid_sgd(tp2, x0, 1, 8, 0.2, 4, 4)
    assert torch.equal(x_fa, x_h2)

    x_sgd, l_sgd = run_sgd(prob, x0, 8, 0.2, 4, loss_every=2)
    x_eng, l_eng = tengine.run_parallel_sgd(tp1, x0, S.mb_sgd(8, 0.2, 4, loss_every=2))
    assert torch.equal(x_sgd, x_eng) and torch.equal(l_sgd, l_eng)
    x_step = x0
    for k in range(4):
        x_step = sgd_step(prob.ya, x_step, k, 8, 0.2)
    np.testing.assert_allclose(x_step.numpy(), x_sgd.numpy(), rtol=1e-6, atol=1e-7)
    x_bundle = sstep_bundle(prob.ya, x0, 0, 4, 8, 0.2)
    np.testing.assert_allclose(x_bundle.numpy(), x_sgd.numpy(), rtol=1e-5, atol=1e-6)

    with pytest.raises(ValueError):
        run_sgd(prob, x0, 7, 0.2, 4)
    with pytest.raises(ValueError):
        run_sstep_sgd(prob, x0, 4, 8, 0.2, 6)
    with pytest.raises(ValueError):
        run_hybrid_sgd(tp2, x0, 3, 8, 0.2, 4, 4)
    with pytest.raises(ValueError):
        run_fedavg(tp2, x0, 7, 0.2, 4, 4)


def test_loss_trace_sampling():
    _, tt, x0 = _both_problems(2, "logistic", 0.0)
    S = tengine.ParallelSGDSchedule
    x0 = torch.from_numpy(x0)
    _, none = tengine.run_parallel_sgd(tt, x0, S.hybrid(2, 4, 8, 0.2, 8, 4))
    assert none.shape == (0,) and none.dtype == torch.float32
    _, every = tengine.run_parallel_sgd(tt, x0, S.hybrid(2, 4, 8, 0.2, 8, 4, loss_every=1))
    _, second = tengine.run_parallel_sgd(tt, x0, S.hybrid(2, 4, 8, 0.2, 8, 4, loss_every=2))
    assert every.shape == (4,) and torch.equal(every[1::2], second)


SCHEDULE_ERRORS = [
    dict(p_r=0), dict(s=0), dict(b=0), dict(tau=0), dict(rounds=0), dict(p_c=0),
    dict(bk=0), dict(bm=0), dict(precision="fp16"), dict(loss_every=-1), dict(delay=-1),
    dict(eta=-0.1), dict(rounds=4, loss_every=3), dict(gram="pallas"),
]


@pytest.mark.parametrize("kw", SCHEDULE_ERRORS, ids=lambda kw: "-".join(kw))
def test_schedule_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        tengine.ParallelSGDSchedule(**kw)
    if kw != dict(gram="pallas"):  # the one renamed value: "pallas" → "kernel"
        with pytest.raises(ValueError):
            jengine.ParallelSGDSchedule(**kw)


def test_schedule_corner_constructors_match_reference():
    T, J = tengine.ParallelSGDSchedule, jengine.ParallelSGDSchedule
    pairs = [
        (T.mb_sgd(8, 0.1, 12, loss_every=4), J.mb_sgd(8, 0.1, 12, loss_every=4)),
        (T.sstep(4, 8, 0.1, 16, loss_every=8), J.sstep(4, 8, 0.1, 16, loss_every=8)),
        (T.fedavg(3, 8, 0.1, 5, 6, loss_every=2), J.fedavg(3, 8, 0.1, 5, 6, loss_every=2)),
        (T.hybrid(2, 4, 8, 0.1, 8, 6, loss_every=3, p_c=2), J.hybrid(2, 4, 8, 0.1, 8, 6, loss_every=3, p_c=2)),
    ]
    for t, j in pairs:
        want = dataclasses.asdict(j)
        want.pop("interpret")  # no meaning in the port
        assert want.pop("gram") == "pallas" and t.gram == "kernel"
        got = dataclasses.asdict(t)
        got.pop("gram")
        assert got == want
    assert tengine.GRAM_METHODS == ("kernel", "blocked", "dense")
    for bad in (lambda: T.sstep(4, 8, 0.1, 10), lambda: T.sstep(4, 8, 0.1, 16, loss_every=6)):
        with pytest.raises(ValueError):
            bad()


def test_solver_entry_validation():
    """Every check of the reference's ``run_parallel_sgd`` entry."""
    _, tt, x0 = _both_problems(2, "logistic", 0.0)
    x0 = torch.from_numpy(x0)
    S = tengine.ParallelSGDSchedule
    run = tengine.run_parallel_sgd
    with pytest.raises(ValueError, match="eta"):
        run(tt, x0, S.hybrid(2, 4, 8, 0.0, 8, 2))
    with pytest.raises(ValueError, match="eta"):
        tengine.run_engine_chunk(tt, x0, 0, 1, S.hybrid(2, 4, 8, 0.0, 8, 2))
    with pytest.raises(ValueError, match="divisible by s"):
        run(tt, x0, S.hybrid(2, 4, 8, 0.1, 6, 2))
    with pytest.raises(ValueError, match="delay"):
        run(tt, x0, S.hybrid(2, 4, 8, 0.1, 8, 2, delay=3))
    with pytest.raises(ValueError, match="delay"):
        tengine.check_delay(S.hybrid(2, 4, 8, 0.1, 8, 2, delay=3))
    with pytest.raises(ValueError, match="teams"):
        run(tt, x0, S.hybrid(4, 4, 8, 0.1, 8, 2))
    with pytest.raises(ValueError, match="local rows"):
        run(tt, x0, S.hybrid(2, 4, 12, 0.1, 8, 2))
    with pytest.raises(ValueError):
        tengine.bundle_gram_v(tt.indices[0], tt.values[0], x0, tt.n, gram="pallas")

