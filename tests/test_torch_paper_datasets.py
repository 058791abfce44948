"""The paper's other datasets in the port against the reference: the host
build (``make_dataset``, ``make_skewed_csr``, ``stack_row_teams``) bitwise,
and ``run(spec)`` on news20-sm, epsilon-sm and url-sm at every corner,
every objective and D = 2 bf16.

The port removes repeated column ids with one stable sort and pads the row
teams with array indexing; the reference does both one row at a time.
Both must give the same arrays, bit for bit. Runs go through the
reference's ``run(spec)`` with its plain panel walk (``gram="blocked"``:
interpret-mode Pallas is slow at url-sm's width, and the dense oracle
skips the bf16 rounding) and the port's ``run(spec, device="cpu")`` (the
kernels' plain versions), at the tolerances of
``tests/test_torch_api.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as J
import repro.core.teams as jteams
import repro.sparse.synthetic as jsyn
import repro_torch.api as T
import repro_torch.core.teams as tteams
import repro_torch.sparse.synthetic as tsyn
from repro.core.engine import ParallelSGDSchedule as JS
from repro_torch.core.engine import ParallelSGDSchedule as TS
from repro_torch.core.engine import run_parallel_sgd
from repro_torch.core.teams import TeamProblem
from repro_torch.sparse.partition import partition_rows

PAPER_SM = ("news20-sm", "epsilon-sm", "url-sm")
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# the panel width of both plain walks: url-sm's 131,072 columns in 16 panels
BK = 8192


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _same_csr(got, want) -> None:
    assert got.shape == want.shape
    for field in ("indptr", "indices", "data"):
        _same(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(tsyn.SM_STATS) + ["news20"])
def test_make_dataset_is_bitwise_the_references(name, seed):
    got, want = tsyn.make_dataset(name, seed=seed), jsyn.make_dataset(name, seed=seed)
    _same_csr(got.A, want.A)
    _same(got.y, want.y)
    _same(got.x_true, want.x_true)
    assert got.stats == tsyn.dataset_stats(name) and got.A.m == got.stats.m


@pytest.mark.parametrize("chunk", [None, 97])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_skewed_csr_with_repeated_ids_is_bitwise_the_references(seed, chunk, monkeypatch):
    """48 rows of ~40 Zipf-skewed draws from 50 columns: most draws repeat
    an id. ``chunk`` 97 sorts the rows in many passes of a few rows."""
    if chunk is not None:
        monkeypatch.setattr(tsyn, "DEDUPE_CHUNK", chunk)
    m, n, zbar, alpha = 48, 50, 40, 1.0
    got = tsyn.make_skewed_csr(m, n, zbar, alpha, seed=seed)
    _same_csr(got, jsyn.make_skewed_csr(m, n, zbar, alpha, seed=seed))
    drawn = np.clip(np.random.default_rng(seed).poisson(zbar, size=m), 1, min(4 * zbar, n)).sum()
    assert got.nnz < drawn / 2  # the repeats were there to remove
    for r in range(m):  # each row's ids ascending and distinct
        assert np.all(np.diff(got.indices[got.indptr[r] : got.indptr[r + 1]]) > 0)


@pytest.mark.parametrize("chunk", [None, 1000])
@pytest.mark.parametrize("p", [1, 3, 4])
@pytest.mark.parametrize("name", PAPER_SM)
def test_stack_row_teams_is_bitwise_the_references(name, p, chunk, monkeypatch):
    """``chunk`` 1000 places the rows in many passes (epsilon-sm's 512-wide
    rows one or two at a time)."""
    if chunk is not None:
        monkeypatch.setattr(tteams, "PAD_CHUNK", chunk)
    ds = tsyn.make_dataset(name, seed=0)
    got = tteams.stack_row_teams(ds.A, ds.y, p, row_multiple=32, device="cpu")
    want = jteams.stack_row_teams(ds.A, ds.y, p, row_multiple=32)
    assert got.values.dtype == torch.float32 and got.indices.dtype == torch.int32
    _same(got.indices.numpy(), np.asarray(want.indices))
    _same(got.values.numpy(), np.asarray(want.values))
    _same(got.rows_valid.numpy(), np.asarray(want.rows_valid))
    assert (got.p, got.m, got.n) == (want.p, want.m, want.n)


def _stack_row_by_row(a, y, p: int, row_multiple: int) -> TeamProblem:
    """The row teams as the row loop built them: diag(y)·A in float64,
    one row at a time into float64 blocks, cast to float32 at the end."""
    ya = a.scale_rows(np.asarray(y, dtype=np.float64))
    rb = partition_rows(a.m, p)
    blocks = [ya.row_block(int(rb[i]), int(rb[i + 1])) for i in range(p)]
    width = max(max((int(blk.nnz_per_row.max()) if blk.m and blk.nnz else 1) for blk in blocks), 1)
    rows_local = -(-max(int(rb[i + 1] - rb[i]) for i in range(p)) // row_multiple) * row_multiple
    idx = np.zeros((p, rows_local, width), dtype=np.int32)
    val = np.zeros((p, rows_local, width), dtype=np.float64)
    valid = np.zeros((p, rows_local), dtype=bool)
    for i, blk in enumerate(blocks):
        for r in range(blk.m):
            lo, hi = int(blk.indptr[r]), int(blk.indptr[r + 1])
            idx[i, r, : hi - lo] = blk.indices[lo:hi]
            val[i, r, : hi - lo] = blk.data[lo:hi]
        valid[i, : blk.m] = True
    return TeamProblem(indices=torch.from_numpy(idx), values=torch.from_numpy(val).to(torch.float32),
                       rows_valid=torch.from_numpy(valid), p=p, m=a.m, n=a.n)


@pytest.mark.parametrize("name", PAPER_SM)
def test_the_stacked_teams_run_as_the_row_loops_did(name):
    """4 rounds of the engine on the CPU from the array-indexed teams and
    from the row loop's: the same x and losses, bit for bit."""
    ds = tsyn.make_dataset(name, seed=0)
    sched = TS.hybrid(p_r=4, s=2, b=8, eta=1.0, tau=8, rounds=4, loss_every=1, bk=BK)
    x0 = torch.zeros(ds.A.n, dtype=torch.float32)
    x_new, loss_new = run_parallel_sgd(tteams.stack_row_teams(ds.A, ds.y, 4, row_multiple=16, device="cpu"), x0, sched)
    x_old, loss_old = run_parallel_sgd(_stack_row_by_row(ds.A, ds.y, 4, row_multiple=16), x0, sched)
    assert float(x_new.abs().max()) > 1e-3
    assert torch.equal(x_new, x_old) and torch.equal(loss_new, loss_old)


# the corners at logistic λ = 0, the hybrid point under each objective with
# its λ, and the hybrid point at D = 2 in bf16 (η = 1, so that x grows and
# the bf16 rounding moves it by far more than the packages differ); one
# loss sample a run (each costs the reference a compile)
RUN_CASES = {
    "mb_sgd": (lambda S: S.mb_sgd(8, 0.05, 4, loss_every=4, gram="blocked", bk=BK), (1, 1), "logistic", 0.0),
    "sstep": (lambda S: S.sstep(4, 8, 0.05, 8, loss_every=8, gram="blocked", bk=BK), (1, 2), "logistic", 0.0),
    "fedavg": (lambda S: S.fedavg(2, 8, 0.05, 4, 2, loss_every=2, gram="blocked", bk=BK), (2, 1), "logistic", 0.0),
    "hybrid": (lambda S: S.hybrid(2, 2, 8, 0.05, 8, rounds=1, loss_every=1, gram="blocked", bk=BK), (2, 2),
               "logistic", 0.0),
    "hybrid_logistic_l2": (lambda S: S.hybrid(2, 2, 8, 0.05, 8, rounds=1, loss_every=1, gram="blocked", bk=BK),
                           (2, 2), "logistic", 1e-4),
    "hybrid_squared_hinge": (lambda S: S.hybrid(2, 2, 8, 0.05, 8, rounds=1, loss_every=1, gram="blocked", bk=BK),
                             (2, 2), "squared_hinge", 1e-3),
    "hybrid_least_squares": (lambda S: S.hybrid(2, 2, 8, 0.05, 8, rounds=1, loss_every=1, gram="blocked", bk=BK),
                             (2, 2), "least_squares", 1e-4),
    "hybrid_delay2_bf16": (lambda S: S.hybrid(2, 2, 8, 1.0, 8, rounds=1, loss_every=1, gram="blocked", bk=BK,
                                              delay=2, precision="bf16"), (2, 2), "logistic", 0.0),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
@pytest.mark.parametrize("dataset", PAPER_SM)
def test_run_matches_the_reference_on_the_paper_datasets(dataset, case):
    make, (p_r, p_c), objective, l2 = RUN_CASES[case]
    j = J.ExperimentSpec(dataset=dataset, schedule=make(JS), mesh=J.MeshSpec(p_r=p_r, p_c=p_c),
                         objective=objective, l2=l2)
    # the port's default Gram ("pallas" on the wire, the kernel's plain
    # version on the CPU) at the same panel width
    wire = j.to_dict()
    wire["schedule"]["gram"] = "pallas"
    t = T.ExperimentSpec.from_dict(wire)
    assert t.schedule.gram == "kernel" and t.objective == objective and t.l2 == l2
    want = J.run(j)
    got = T.run(t, device="cpu")
    assert got.x.dtype == np.float32 and got.x.shape == want.x.shape
    assert len(got.losses) == len(want.losses) > 0
    assert np.abs(got.x).max() > 1e-4  # x moved away from x0 = 0
    np.testing.assert_allclose(got.x, want.x, **X_TOL)
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
    np.testing.assert_allclose(got.final_loss, want.final_loss, **LOSS_TOL)
    if t.schedule.precision == "bf16":
        # the rounding is live: the fp32 run of the same spec lands ≥ 100×
        # further from the port's bf16 x than the reference's bf16 x does
        fp32 = dataclasses.replace(t, schedule=dataclasses.replace(t.schedule, precision="fp32"))
        gap = np.abs(T.run(fp32, device="cpu").x - got.x).max()
        assert gap > 100 * np.abs(got.x - want.x).max() and gap > 0
    assert got.rounds_completed == want.rounds_completed and got.stop_reason == want.stop_reason
    assert got.comm_words == want.comm_words
