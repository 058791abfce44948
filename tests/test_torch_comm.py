"""The comm plane and the cost model: ``repro_torch`` against ``repro``.

The port's ``engine_comm_ledger`` (captured by running the round body
on meta tensors) against the reference's (captured under
``jax.eval_shape``) at every corner × precision × delay, the two JSON
forms loading each other, counted words against the Table 2–3 closed
forms, the ledger's derived quantities, the phase probes, and every
cost-model function on a grid of inputs."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import engine as jengine
from repro import costmodel as jcm
from repro.costmodel import hockney as jhockney
from repro.core import teams as jteams
from repro.sparse import synthetic as jsyn
from repro_torch import costmodel as tcm
from repro_torch.costmodel import hockney as thockney
from repro_torch.core import comm as tcomm
from repro_torch.core import engine as tengine
from repro_torch.core import teams as tteams

N = 4736
# corner → constructor (p_c set per case); each corner's τ/s allows D = 2
CORNERS = {
    "mb_sgd": lambda S, **kw: S.hybrid(1, 1, 8, 0.05, 2, 3, **kw),
    "sstep": lambda S, **kw: S.hybrid(1, 4, 8, 0.05, 8, 3, **kw),
    "fedavg": lambda S, **kw: S.fedavg(4, 8, 0.05, 4, 3, **kw),
    "hybrid": lambda S, **kw: S.hybrid(2, 2, 4, 0.05, 8, 3, **kw),
}


def _ledgers(make, **kw):
    return (tengine.engine_comm_ledger(make(tengine.ParallelSGDSchedule, **kw), N),
            jengine.engine_comm_ledger(make(jengine.ParallelSGDSchedule, **kw), N))


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("corner", list(CORNERS))
def test_engine_ledger_matches_reference(corner, precision, delay):
    """``to_dict`` equal to the reference's, key for key, and each side's
    ``from_dict`` loads the other's JSON."""
    t, j = _ledgers(CORNERS[corner], p_c=2, precision=precision, delay=delay)
    for led in (t, j):
        led.add_rounds(3)
        led.add_round_seconds(0.25)
    td, jd = t.to_dict(), j.to_dict()
    assert td == jd
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert tcomm.CommLedger.from_dict(json.loads(json.dumps(jd))).to_dict() == jd
    assert jcomm.CommLedger.from_dict(json.loads(json.dumps(td))).to_dict() == td
    gram = [r for r in t.rates if r.axis == "cols"]
    assert len(gram) == 1 and gram[0].word_bytes == (2 if precision == "bf16" else 4)


@pytest.mark.parametrize("p_c", [1, 2, 4])
@pytest.mark.parametrize("p_r,s,b,tau", [(1, 1, 4, 1), (1, 4, 8, 4), (4, 1, 8, 5), (2, 2, 4, 8),
                                         (4, 4, 32, 32), (2, 8, 2, 16)])
def test_counted_words_are_the_closed_form(p_r, s, b, tau, p_c):
    sched = tengine.ParallelSGDSchedule.hybrid(p_r, s, b, 0.05, tau, 3, p_c=p_c)
    led = tengine.engine_comm_ledger(sched, 97)
    cv = tcm.schedule_comm_volume(97, p_r, p_c, s, b, tau, rounds=3)
    assert led.counted_words(rounds=3) == cv.words_dict()
    assert led.counted_calls(rounds=3) == {"gram_calls": cv.gram_calls, "sync_calls": cv.sync_calls}
    assert cv.gram_words_min <= cv.gram_words
    assert dataclasses.asdict(cv) == dataclasses.asdict(jcm.schedule_comm_volume(97, p_r, p_c, s, b, tau, rounds=3))


def test_bf16_halves_gram_bytes_not_words():
    base = CORNERS["hybrid"]
    led32, _ = _ledgers(base, p_c=2)
    led16, _ = _ledgers(base, p_c=2, precision="bf16")
    led32.add_rounds(3)
    led16.add_rounds(3)
    cv = tcm.schedule_comm_volume(N, 2, 2, 2, 4, 8, rounds=3)
    assert led32.counted_words() == led16.counted_words() == cv.words_dict()
    b32, b16 = led32.counted_bytes(), led16.counted_bytes()
    assert b16["gram_bytes"] == b32["gram_bytes"] / 2 > 0
    assert b16["sync_bytes"] == b32["sync_bytes"] > 0  # weights stay fp32
    assert led16.bytes_per_round() == led32.bytes_per_round() - led32.counted_bytes(1)["gram_bytes"] / 2
    assert led16.bytes_per_round(8) == led32.bytes_per_round(8)
    # fp32 ledgers carry neither word_bytes nor counted_bytes
    assert "word_bytes" not in json.dumps(led32.to_dict())
    assert "counted_bytes" not in led32.to_dict() and "counted_bytes" in led16.to_dict()


def test_counted_volume_invariant_in_delay():
    """Overlap hides seconds, never bytes."""
    make = CORNERS["hybrid"]
    words = []
    for delay in (0, 1, 2):
        led, _ = _ledgers(make, p_c=4, delay=delay)
        assert led.delay == delay
        words.append(led.counted_words(rounds=3))
    assert words[0] == words[1] == words[2]


def test_capture_with_a_real_problem_and_its_device():
    """The capture on a real (CPU) problem records the stand-in's rates,
    runs no arithmetic on the problem, and leaves it where it was; the
    s = 1 corner accounts the full (G, v) payload."""
    rng = np.random.default_rng(0)
    a = jsyn.make_skewed_csr(64, 40, 6, 0.8, seed=3)
    y = np.where(rng.random(64) < 0.5, 1.0, -1.0)
    tp = tteams.stack_row_teams(a, y, 2, row_multiple=4, device="cpu")
    for make in (lambda S: S.hybrid(2, 1, 4, 0.05, 4, 2, p_c=2), lambda S: S.hybrid(2, 2, 4, 0.05, 8, 2, p_c=2)):
        sched = make(tengine.ParallelSGDSchedule)
        led = tengine.engine_comm_ledger(sched, 40, tp=tp)
        assert led.rates == tengine.engine_comm_ledger(sched, 40).rates
        jtp = jteams.stack_row_teams(a, y, 2, row_multiple=4)
        assert led.to_dict() == jengine.engine_comm_ledger(make(jengine.ParallelSGDSchedule), 40, tp=jtp).to_dict()
        sb = sched.s * sched.b
        assert led.rates[0].words_per_call == sb * sb + sb
    assert tp.values.device.type == "cpu"


def test_recording_is_scoped_to_the_capture():
    """Outside ``capture_rates`` the collectives record nothing and are the
    identity / the team mean."""
    g, v = torch.ones(4, 4), torch.ones(4)
    assert tcomm.COUNTING.allreduce_cols((g, v)) == (g, v)
    assert tcomm.COUNTING.await_allreduce((g, v)) == (g, v)
    xs = torch.tensor([[1.0, 2.0], [3.0, 6.0]])
    assert torch.equal(tcomm.COUNTING.allmean_teams(xs, words_per_call=2), torch.tensor([2.0, 4.0]))

    def body():
        tcomm.COUNTING.issue_allreduce_cols((g, v.to(torch.bfloat16)), calls_per_round=3)
        tcomm.COUNTING.allreduce_cols((g, v.to(torch.bfloat16)), calls_per_round=3)  # same site again
        tcomm.COUNTING.allmean_teams(xs, words_per_call=7)

    rates = tcomm.capture_rates(body, spans={"cols": 2, "rows": 4})
    assert rates == (tcomm.CommRate("allreduce", "cols", 2, 20, 3, 4),
                     tcomm.CommRate("allmean", "rows", 4, 7, 1, 4))
    # the mesh kinds exist; any other name is refused
    assert tcomm.Collectives("mesh") == tcomm.MESH and tcomm.TIMED.timed
    with pytest.raises(ValueError, match="kind"):
        tcomm.Collectives("ring")


def _phase_ledger(delay, gv=4.0, compute=1.5, pa=2.0, rounds=2):
    return dict(
        rates=(("allreduce", "cols", 4, 272, 4),), rounds=rounds,
        phase_seconds={"bundle_compute": compute, "allreduce_gv": gv, "param_avg": pa}, delay=delay)


@pytest.mark.parametrize("delay", [0, 1, 9])
def test_exposed_comm_matches_reference(delay):
    fields = _phase_ledger(delay)
    t = tcomm.CommLedger(**{**fields, "rates": tuple(tcomm.CommRate(*r) for r in fields["rates"])})
    j = jcomm.CommLedger(**{**fields, "rates": tuple(jcomm.CommRate(*r) for r in fields["rates"])})
    for name in ("total_comm_s", "exposed_comm_s", "overlap_efficiency", "seconds_per_round"):
        assert getattr(t, name) == getattr(j, name)
    assert t.phases_per_round() == j.phases_per_round() == 4 * 2 * 2  # 4 calls × 2⌈log₂ 4⌉
    assert t.to_dict() == j.to_dict()
    assert tcomm.CommLedger.from_dict(json.loads(json.dumps(j.to_dict()))) == t
    assert jcomm.CommLedger.from_dict(json.loads(json.dumps(t.to_dict()))).to_dict() == j.to_dict()
    snap = t.snapshot()
    t.add_rounds(1)
    assert snap.rounds == 2 and t.rounds == 3
    bare = tcomm.CommLedger(delay=delay)
    assert bare.total_comm_s is None and bare.exposed_comm_s is None and bare.overlap_efficiency is None


def test_phase_probes_and_timers():
    """The probes compute what the reference's compute on the same data;
    the timers return positive medians on the CPU."""
    rng = np.random.default_rng(1)
    a = jsyn.make_skewed_csr(64, 120, 6, 0.8, seed=4)
    y = np.where(rng.random(64) < 0.5, 1.0, -1.0)
    jtp = jteams.stack_row_teams(a, y, 2, row_multiple=8)
    ttp = tteams.team_problem_from_numpy(
        np.asarray(jtp.indices), np.asarray(jtp.values), np.asarray(jtp.rows_valid),
        p=2, m=jtp.m, n=jtp.n, device="cpu")
    for precision in ("fp32", "bf16"):
        make = lambda S, **kw: S.hybrid(2, 8, 8, 0.05, 16, 2, bk=128, precision=precision, **kw)  # noqa: E731
        tprobes = tengine.engine_phase_probes(ttp, make(tengine.ParallelSGDSchedule))
        jprobes = jengine.engine_phase_probes(jtp, make(jengine.ParallelSGDSchedule, gram="blocked"))
        assert list(tprobes) == list(jprobes) == ["bundle_compute", "allreduce_gv", "param_avg"]
        for phase, (fn, args, calls) in tprobes.items():
            jfn, jargs, jcalls = jprobes[phase]
            assert calls == jcalls
            got, want = fn(*args), jfn(*jargs)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            for g_, w_ in zip(got, want):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)
    fn, args, _ = tprobes["bundle_compute"]
    assert tcomm.time_phase(fn, *args, repeats=3) > 0.0
    assert tcomm.time_dispatch(fn, *args, repeats=3) > 0.0


# ---- the cost model ----------------------------------------------------------

MACHINE_NAMES = ["perlmutter-cpu", "tpu-v5e"]
CFGS = [(1, 4, 4, 16, 1), (2, 4, 2, 8, 8), (8, 1, 1, 8, 8), (4, 16, 8, 32, 40), (64, 64, 16, 32, 64)]
DATA = [(20_000, 47_000, 50.0), (677_399, 47_236, 73.6), (2_396_130, 3_231_961, 115.6)]


def _same(got, want):
    """Equal field for field: dataclasses (of the two packages) by their
    dict form, floats exactly."""
    if dataclasses.is_dataclass(got):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got == want


def test_machine_presets_are_the_references():
    assert list(tcm.MACHINES) == list(jcm.MACHINES) == MACHINE_NAMES
    for name in MACHINE_NAMES:
        t, j = tcm.MACHINES[name], jcm.MACHINES[name]
        _same(t, j)
        for q in (1, 2, 3, 8, 64, 100, 256, 300, 4096, 20000):
            assert t.alpha(q) == j.alpha(q) and t.beta(q) == j.beta(q)
            assert t.allreduce_time(q, 1000) == j.allreduce_time(q, 1000)
        for ws in (1e3, 1e5, 2e6, 1e8, 1e12):
            assert t.gamma_bytes(ws) == j.gamma_bytes(ws) and t.gamma_flop(ws) == j.gamma_flop(ws)


@pytest.mark.parametrize("machine", MACHINE_NAMES)
@pytest.mark.parametrize("data", DATA, ids=["small", "rcv1", "url"])
def test_epoch_costs_match_reference(data, machine):
    m, n, zbar = data
    tmach, jmach = tcm.MACHINES[machine], jcm.MACHINES[machine]
    for p_r, p_c, s, b, tau in CFGS:
        tc, jc = tcm.HybridConfig(p_r, p_c, s, b, tau), jcm.HybridConfig(p_r, p_c, s, b, tau)
        for delay in (0, 1, 3):
            for gwb in (None, 2, 4):
                t = tcm.hybrid_epoch_cost(m, n, zbar, tc, tmach, delay=delay, gram_word_bytes=gwb)
                j = jcm.hybrid_epoch_cost(m, n, zbar, jc, jmach, delay=delay, gram_word_bytes=gwb)
                _same(t, j)
                assert t.total == j.total and t.dominant == j.dominant
        assert thockney.recommend_delay(m, n, zbar, tc, tmach) == jhockney.recommend_delay(m, n, zbar, jc, jmach)
        p = p_r * p_c
        _same(tcm.sstep_epoch_cost(m, n, zbar, s, b, p, tmach), jcm.sstep_epoch_cost(m, n, zbar, s, b, p, jmach))
        _same(tcm.fedavg_epoch_cost(m, n, zbar, b, tau, p, tmach), jcm.fedavg_epoch_cost(m, n, zbar, b, tau, p, jmach))
        _same(tcm.mbsgd_epoch_cost(m, n, zbar, b, p, tmach), jcm.mbsgd_epoch_cost(m, n, zbar, b, p, jmach))
        for solver in ("sgd", "mbsgd", "fedavg", "sstep1d", "hybrid"):
            _same(tcm.per_sample_costs(solver, m, n, zbar, p, s, b, tau, tmach, p_r=p_r, p_c=p_c),
                  jcm.per_sample_costs(solver, m, n, zbar, p, s, b, tau, jmach, p_r=p_r, p_c=p_c))
        _same(tcm.classify_regime(m, n, zbar, tc, tmach), jcm.classify_regime(m, n, zbar, jc, jmach))
    with pytest.raises(ValueError, match="solver"):
        tcm.per_sample_costs("nope", m, n, zbar, 4, 2, 8, 8, tmach)


@pytest.mark.parametrize("machine", MACHINE_NAMES)
def test_optima_and_topology_match_reference(machine):
    tmach, jmach = tcm.MACHINES[machine], jcm.MACHINES[machine]
    for m, n, zbar in DATA:
        for p_r, p_c, s, b, tau in CFGS:
            assert tcm.s_star(b, tau, p_r, p_c, n, tmach) == jcm.s_star(b, tau, p_r, p_c, n, jmach)
            assert tcm.b_star(s, tau, p_r, p_c, n, tmach) == jcm.b_star(s, tau, p_r, p_c, n, jmach)
            assert tcm.joint_sb_star(tau, p_r, p_c, n, tmach) == jcm.joint_sb_star(tau, p_r, p_c, n, jmach)
            assert tcm.bandwidth_balance(s, b, tau, p_c, n) == jcm.bandwidth_balance(s, b, tau, p_c, n)
        for p_r, p_c in ((1, 8), (4, 4), (16, 2)):
            tbest, jbest = tcm.grid_search_config(m, n, zbar, p_r, p_c, tmach), jcm.grid_search_config(m, n, zbar, p_r, p_c, jmach)
            _same(tbest[0], jbest[0])
            _same(tbest[1], jbest[1])
        for p in (1, 2, 64, 256, 1024, 65536):
            assert tcm.topology_rule(p, n, tmach) == jcm.topology_rule(p, n, jmach)
        assert tcm.cache_term_binding(n, tmach) == jcm.cache_term_binding(n, jmach)
    with pytest.raises(ValueError, match="power of two"):
        tcm.topology_rule(12, 1000, tmach)


@pytest.mark.parametrize("machine", MACHINE_NAMES)
def test_refined_model_matches_reference(machine):
    tmach, jmach = tcm.MACHINES[machine], jcm.MACHINES[machine]
    profs = [("cyclic", 1.02, 5_905), ("block", 1.9, 7_100), ("nnz-greedy", 1.1, 23_000)]
    tprofs = [tcm.PartitionerProfile(*p) for p in profs]
    jprofs = [jcm.PartitionerProfile(*p) for p in profs]
    for n, zbar in ((47_236, 73.6), (3_231_961, 115.6)):
        for p_r, p_c, s, b, tau in CFGS:
            for tp, jp in zip(tprofs, jprofs):
                t = tcm.predict_hybrid_iter(n, zbar, tp, p_r, p_c, s, b, tau, tmach)
                j = jcm.predict_hybrid_iter(n, zbar, jp, p_r, p_c, s, b, tau, jmach)
                _same(t, j)
                assert t.total == j.total
            assert (tcm.predict_fedavg_iter(n, zbar, b, tau, p_r * p_c, tmach, kappa=1.3)
                    == jcm.predict_fedavg_iter(n, zbar, b, tau, p_r * p_c, jmach, kappa=1.3))
            tr = tcm.rank_partitioners(n, zbar, tprofs, p_r, p_c, s, b, tau, tmach)
            jr = jcm.rank_partitioners(n, zbar, jprofs, p_r, p_c, s, b, tau, jmach)
            assert [name for name, _ in tr] == [name for name, _ in jr]
            for (_, tb), (_, jb) in zip(tr, jr):
                _same(tb, jb)


def test_calibration_matches_reference():
    """The least-squares fit, its non-negativity passes, the dead-column
    rule and the machine re-target, on planted and on noisy points."""
    rng = np.random.default_rng(7)
    alpha, beta, gamma = 2e-6, 3e-10, 5e-12
    rows = rng.uniform(1, 100, size=(6, 3)) * np.array([10, 1e6, 1e8])
    secs = rows @ np.array([alpha, beta, gamma])
    cases = [
        [(r[0], r[1], r[2], t) for r, t in zip(rows, secs)],
        [(r[0], r[1], r[2], t * (1 + 0.1 * rng.standard_normal())) for r, t in zip(rows, secs)],
        [(0.0, 0.0, r[2], t) for r, t in zip(rows, secs)],  # no comm columns
        [(r[0], r[1], 0.0, 1e-3 + 0.0 * t) for r, t in zip(rows, secs)],
    ]
    for pts in cases:
        t = tcm.calibrate([tcm.CalPoint(*p, label="x") for p in pts])
        j = jcm.calibrate([jcm.CalPoint(*p, label="x") for p in pts])
        assert t.to_dict() == j.to_dict() and t.summary() == j.summary()
        assert tcm.Calibration.from_dict(j.to_dict()) == t
        for name in MACHINE_NAMES:
            _same(t.machine(tcm.MACHINES[name]), j.machine(jcm.MACHINES[name]))
    c = tcm.calibrate([tcm.CalPoint(*p) for p in cases[0]])
    assert math.isclose(c.alpha, alpha, rel_tol=1e-6) and math.isclose(c.gamma, gamma, rel_tol=1e-6)
    with pytest.raises(ValueError):
        tcm.calibrate([])
    with pytest.raises(ValueError):
        tcm.CalPoint(1.0, 1.0, 1.0, 0.0)
