"""The port's run lifecycle (``repro_torch.api.Session``, checkpoints,
sweep, fault seam), modelled on the reference's tests/test_session.py
and tests/chaos/.

On the CPU the port is deterministic (the Yᵀu scatter-add is a serial
``index_add_``), so the structural invariants are held **bitwise**:
chunked ≡ monolithic, session ≡ ``run_parallel_sgd``, save/restore and
unchanged-mesh or p_c-changing elastic restores ≡ uninterrupted, a
retried sweep point ≡ a clean run. Behaviour the port shares with the
reference (replanning, stop policies, corruption handling, quarantine)
is held to the reference's. Checkpoints cross between the packages in
both directions. Subprocess SIGKILL tests stay in the reference's
suite; the in-process soft kill covers the same resume path here.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core.engine import ParallelSGDSchedule as JS
from repro_torch.core import faults
from repro_torch.core.engine import ParallelSGDSchedule as TS
from repro_torch.core.engine import run_parallel_sgd
from repro_torch.core.faults import FaultEvent, FaultPlan, TransientIOError, WorkerKilled, install
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train.checkpoint import (
    CheckpointCorruptError,
    SpecMismatchError,
    discard_session_checkpoint,
    load_session_checkpoint,
    save_session_checkpoint,
)

DATASET = "rcv1-sm"
CPU = "cpu"
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def spec_(p_r=2, p_c=2, rounds=6, api=T, **kw) -> "T.ExperimentSpec":
    S = TS if api is T else JS
    sched = kw.pop("schedule", None) or S.hybrid(p_r, 2, 8, 0.05, 8, rounds=rounds, loss_every=2)
    return api.ExperimentSpec(dataset=DATASET, schedule=sched, mesh=api.MeshSpec(p_r=p_r, p_c=p_c),
                              **kw)


def session(spec, **kw):
    return T.Session(spec, device=CPU, **kw)


def run(spec, **kw):
    return T.run(spec, device=CPU, **kw)


def assert_same_run(rep, want):
    np.testing.assert_array_equal(rep.x, want.x)
    np.testing.assert_array_equal(rep.losses, want.losses)


# ---------------- chunked ≡ monolithic, session ≡ engine ----------------


def test_run_is_bitwise_the_monolithic_engine():
    spec = spec_()
    rep = run(spec)
    bundle = T.build_problem(spec, device=CPU)
    x, losses = run_parallel_sgd(bundle.team, torch.zeros(bundle.dataset.A.n), spec.schedule)
    np.testing.assert_array_equal(rep.x, x.numpy())
    np.testing.assert_array_equal(rep.losses, losses.numpy())
    assert rep.backend == "simulated" and rep.stop_reason == "rounds" and rep.wall_time_s > 0
    assert rep.wall_time_s == pytest.approx(rep.compile_time_s + rep.solve_time_s, abs=1e-9)


@pytest.mark.parametrize("steps", [[1] * 6, [5, 1], [3, 3], [2, 4]], ids=["ones", "5+1", "3+3", "2+4"])
def test_any_chunking_is_bitwise_the_whole_run(steps):
    spec = spec_()
    full = run(spec)
    sess = session(spec)
    events = [sess.step_rounds(k) for k in steps]
    assert sess.done and events[-1].stop == "rounds"
    np.testing.assert_array_equal(events[-1].x, full.x)
    np.testing.assert_array_equal(np.asarray(sess.losses, np.float32), full.losses)
    if steps == [1] * 6:  # loss samples on exactly the loss_every boundaries
        assert [e.loss is not None for e in events] == [(i + 1) % 2 == 0 for i in range(6)]


def test_round_event_is_a_host_snapshot():
    sess = session(spec_())
    ev = sess.step_rounds(2)
    assert isinstance(ev.x, np.ndarray) and ev.x.dtype == np.float32
    assert ev.comm_words == T.modeled_comm_words(sess.spec, rounds=2)
    assert ev.ledger.rounds == 2 and ev.ledger is not sess.ledger
    ev.x[:] = 7.0  # the event owns its copy
    assert not np.array_equal(sess.current_x(), ev.x)


# ---------------- checkpoint / resume ----------------


@pytest.mark.parametrize("at", [2, 3, 5])
def test_save_restore_midrun_is_bitwise(tmp_path, at):
    spec = spec_()
    full = run(spec)
    sess = session(spec)
    sess.step_rounds(at)
    sess.save(tmp_path / "ck")
    resumed = T.Session.restore(tmp_path / "ck", device=CPU)
    assert resumed.rounds_done == at and resumed.spec == spec
    rep = resumed.run()
    assert_same_run(rep, full)
    assert rep.rounds_completed == 6


def test_restore_under_another_spec_names_the_first_differing_field(tmp_path):
    spec = spec_()
    sess = session(spec)
    sess.step_rounds(2)
    sess.save(tmp_path / "ck")
    for other, field in ((dataclasses.replace(spec, seed=1), "seed"),
                         (dataclasses.replace(spec, name="renamed"), "name"),
                         (dataclasses.replace(spec, schedule=dataclasses.replace(spec.schedule, eta=0.1)),
                          "schedule.eta")):
        with pytest.raises(SpecMismatchError, match=field) as err:
            T.Session.restore(tmp_path / "ck", spec=other, device=CPU)
        assert spec.content_hash() in str(err.value) and other.content_hash() in str(err.value)
    assert T.Session.restore(tmp_path / "ck", spec=spec, device=CPU).rounds_done == 2
    ck = load_session_checkpoint(tmp_path / "ck")
    assert ck.spec_hash == spec.content_hash() and ck.rounds_done == 2
    with pytest.raises(FileNotFoundError):
        load_session_checkpoint(tmp_path / "absent")


def _write_ck(base, spec, rounds=2):
    save_session_checkpoint(
        base, spec_dict=spec.to_dict(), spec_hash=spec.content_hash(), rounds_done=rounds,
        x=np.arange(8, dtype=np.float32), losses=np.asarray([0.7, 0.6], np.float32),
        wall_time_s=1.0, compile_time_s=0.5,
    )


def _truncate_npz(base):
    npz = base.with_suffix(".npz")
    npz.write_bytes(npz.read_bytes()[:-64])


def _edit_manifest(base):
    manifest = base.with_suffix(".json")
    meta = json.loads(manifest.read_text())
    meta["rounds_done"] = 9
    manifest.write_text(json.dumps(meta))


def _garble_manifest(base):
    base.with_suffix(".json").write_text("{not json")


def _drop_manifest(base):
    base.with_suffix(".json").unlink()


def _swap_payload(base):
    other = base.with_name("other")
    spec = spec_()
    save_session_checkpoint(other, spec_dict=spec.to_dict(), spec_hash=spec.content_hash(),
                            rounds_done=4, x=np.ones(8, np.float32),
                            losses=np.asarray([0.5], np.float32), wall_time_s=0, compile_time_s=0)
    base.with_suffix(".npz").write_bytes(other.with_suffix(".npz").read_bytes())


def _wrong_format(base):
    from repro_torch.train.checkpoint import _manifest_digest

    manifest = base.with_suffix(".json")
    meta = json.loads(manifest.read_text())
    meta["format"] = "something-else"
    meta["manifest_sha256"] = _manifest_digest(meta)
    manifest.write_text(json.dumps(meta))


@pytest.mark.parametrize("damage", [_truncate_npz, _edit_manifest, _garble_manifest, _drop_manifest,
                                    _swap_payload, _wrong_format],
                         ids=["truncated_npz", "edited_manifest", "garbled_manifest",
                              "missing_manifest", "swapped_payload", "wrong_format"])
def test_corrupt_checkpoints_raise_typed_errors(tmp_path, damage):
    base = tmp_path / "ck"
    _write_ck(base, spec_())
    damage(base)
    with pytest.raises(CheckpointCorruptError):
        load_session_checkpoint(base)
    with pytest.raises(CheckpointCorruptError):
        T.Session.restore(base, device=CPU)


def test_commit_fault_leaves_no_partial_state_and_truncation_is_caught(tmp_path):
    base = tmp_path / "ck"
    spec = spec_()
    with install(FaultPlan(events=[FaultEvent(kind="io_error", site="commit", at=2)])):
        with pytest.raises(TransientIOError):
            _write_ck(base, spec)
    assert list(tmp_path.iterdir()) == []
    _write_ck(base, spec)
    with install(FaultPlan(events=[FaultEvent(kind="io_error", site="commit", at=4)])):
        with pytest.raises(TransientIOError):
            _write_ck(base, spec, rounds=4)
    assert load_session_checkpoint(base).rounds_done == 2
    with install(FaultPlan(events=[FaultEvent(kind="ckpt_truncate", site="save", at=2)])) as inj:
        _write_ck(base, spec)
    assert inj.fired == [("ckpt_truncate", "save", 2)]
    with pytest.raises(CheckpointCorruptError):
        load_session_checkpoint(base)
    base.with_suffix(".tmp.npz").write_bytes(b"stale")
    discard_session_checkpoint(base)
    assert list(tmp_path.iterdir()) == []


# ---------------- checkpoints cross between the packages ----------------


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    jspec = spec_(api=J)
    want = J.run(jspec)
    jsess = J.Session(jspec)
    jsess.step_rounds(2)
    jsess.save(tmp_path / "ck")
    ck = load_session_checkpoint(tmp_path / "ck")
    tspec = T.ExperimentSpec.from_dict(ck.spec_dict)
    assert ck.spec_hash == jspec.content_hash() == tspec.content_hash()
    resumed = T.Session.restore(tmp_path / "ck", spec=tspec, device=CPU)
    assert resumed.rounds_done == 2
    rep = resumed.run()
    np.testing.assert_allclose(rep.x, want.x, **X_TOL)
    np.testing.assert_allclose(rep.losses, want.losses, **LOSS_TOL)
    np.testing.assert_array_equal(rep.losses[:1], want.losses[:1])  # the prefix came from the file


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    from repro.train.checkpoint import load_session_checkpoint as jload

    tspec = spec_()
    want = run(tspec)
    sess = session(tspec)
    sess.step_rounds(2)
    sess.save(tmp_path / "ck")
    ck = jload(tmp_path / "ck")
    jspec = J.ExperimentSpec.from_dict(ck.spec_dict)
    assert ck.spec_hash == tspec.content_hash() == jspec.content_hash()
    resumed = J.Session.restore(tmp_path / "ck", spec=jspec)
    assert resumed.rounds_done == 2
    rep = resumed.run()
    np.testing.assert_allclose(rep.x, want.x, **X_TOL)
    np.testing.assert_allclose(rep.losses, want.losses, **LOSS_TOL)


# ---------------- elastic restore ----------------


def test_unchanged_mesh_elastic_restore_is_bitwise(tmp_path):
    spec = spec_(p_r=4, p_c=1, rounds=8)
    full = run(spec)
    half = session(spec)
    half.step_rounds(5)
    half.save(tmp_path / "ck")
    assert_same_run(T.Session.restore_elastic(tmp_path / "ck", mesh=spec.mesh, device=CPU).run(), full)


def test_p_c_shrink_elastic_restore_is_bitwise(tmp_path):
    spec = spec_(p_r=2, p_c=4)
    full = run(spec)
    half = session(spec)
    half.step_rounds(3)
    half.save(tmp_path / "ck")
    rep = T.Session.restore_elastic(tmp_path / "ck", mesh=T.MeshSpec(p_r=2, p_c=2), device=CPU).run()
    assert rep.spec.mesh.p_c == 2
    assert_same_run(rep, full)


@pytest.mark.parametrize("devices", [2, 8], ids=["shrink", "grow"])
def test_p_r_change_replans_as_the_reference_does(tmp_path, devices):
    """Shrink 4 → 2 or grow 4 → 8 devices mid-run: both packages pick the
    same new mesh from the same checkpoint and continue from its round
    with its loss prefix; the re-teamed runs agree with each other."""
    jspec = spec_(p_r=4, p_c=1, rounds=8, api=J)
    jsess = J.Session(jspec)
    jsess.step_rounds(4)
    jsess.save(tmp_path / "ck")
    want = J.Session.restore_elastic(tmp_path / "ck", devices=devices)
    got = T.Session.restore_elastic(tmp_path / "ck", devices=devices, device=CPU)
    assert got.spec.to_json() == want.spec.to_json() and got.spec.mesh.p == devices
    assert got.rounds_done == want.rounds_done == 4
    assert got.losses == want.losses and len(got.losses) == 2
    rep, jrep = got.run(), want.run()
    assert rep.rounds_completed == jrep.rounds_completed == 8
    np.testing.assert_allclose(rep.x, jrep.x, **X_TOL)
    np.testing.assert_allclose(rep.final_loss, jrep.final_loss, **LOSS_TOL)


def test_restore_elastic_needs_exactly_one_target(tmp_path):
    sess = session(spec_())
    sess.step_rounds(2)
    sess.save(tmp_path / "ck")
    with pytest.raises(ValueError, match="exactly one"):
        T.Session.restore_elastic(tmp_path / "ck", device=CPU)
    with pytest.raises(ValueError, match="exactly one"):
        T.Session.restore_elastic(tmp_path / "ck", devices=2, mesh=T.MeshSpec(), device=CPU)


# ---------------- StopPolicy ----------------


def _losses():
    return run(spec_()).losses


@pytest.mark.parametrize("which", [0, -1], ids=["first_sample", "final_sample"])
def test_stop_target_loss(which):
    target = float(_losses()[which])
    rep = run(spec_(stop=T.StopPolicy(target_loss=target)))
    assert rep.stop_reason == "target_loss"
    assert rep.rounds_completed == (2 if which == 0 else 6)
    assert rep.losses[-1] <= target


def test_step_spanning_boundaries_stops_at_the_first_crossing():
    target = float(_losses()[0])
    sess = session(spec_(stop=T.StopPolicy(target_loss=target)))
    ev = sess.step_rounds(6)
    assert ev.stop == "target_loss" and ev.rounds_done == 2 and sess.done


def test_stop_max_rounds_max_seconds_and_refusal():
    rep = run(spec_(stop=T.StopPolicy(max_rounds=3)))
    assert rep.stop_reason == "max_rounds" and rep.rounds_completed == 3 and len(rep.losses) == 1
    rep = run(spec_(stop=T.StopPolicy(max_seconds=0.0)))
    assert rep.stop_reason == "max_seconds" and rep.rounds_completed == 2
    sess = session(spec_(stop=T.StopPolicy(max_rounds=2)))
    sess.step_rounds(2)
    with pytest.raises(RuntimeError, match="finished"):
        sess.step_rounds(1)


def test_stop_policies_end_where_the_reference_ends():
    for stop in (dict(max_rounds=3), dict(target_loss=0.69295)):
        want = J.run(spec_(api=J, stop=J.StopPolicy(**stop)))
        got = run(spec_(stop=T.StopPolicy(**stop)))
        assert (got.stop_reason, got.rounds_completed) == (want.stop_reason, want.rounds_completed)


# ---------------- autosave, timed comm, tracing ----------------


def test_autosave_cadence(tmp_path):
    spec = spec_(faults=T.FaultPolicy(autosave_every=2))
    sess = session(spec, autosave_dir=tmp_path)
    base = T.autosave_base(tmp_path, spec)
    assert sess.autosave_path == base
    sess.step_rounds(1)
    assert not base.with_suffix(".npz").exists()
    sess.step_rounds(2)  # crosses round 2
    assert load_session_checkpoint(base).rounds_done == 2
    sess.step_rounds(3)  # crosses 4 and 6
    ck = load_session_checkpoint(base)
    assert ck.rounds_done == 6 and ck.spec_hash == spec.content_hash()
    np.testing.assert_array_equal(ck.x, sess.current_x())
    with pytest.raises(ValueError, match="autosave_dir"):
        session(spec).autosave_path


def test_timed_comm_fills_the_ledger_and_keeps_the_iterates():
    spec = spec_()
    timed = run(dataclasses.replace(spec, comm_timing=True))
    assert_same_run(timed, run(spec))
    led = timed.ledger
    assert len(led.round_seconds) == 6 and led.seconds_per_round > 0
    assert set(led.phase_seconds) == {"bundle_compute", "allreduce_gv", "param_avg"}
    assert timed.calibration_point() is not None
    back = T.RunReport.from_json(timed.to_json())
    assert back.ledger == led and back.spec == timed.spec


def test_traced_session_records_compile_and_round_spans():
    spec = dataclasses.replace(spec_(), comm_timing=True, schedule=dataclasses.replace(
        spec_().schedule, delay=1))
    with obs_trace.install() as rec:
        rep = run(spec)
    cats = rec.by_category()
    assert len(cats["compile"]) == 1 and len(cats["round"]) == 2  # chunks of 2 rounds
    assert {"bundle_compute", "allreduce_gv_issue", "allreduce_gv_await", "param_avg"} <= set(cats)
    assert rep.compile_time_s > 0


# ---------------- sweep: resume, retry, quarantine ----------------


def _counts():
    snap = obs_metrics.registry().snapshot()
    return {k: v["value"] for k, v in snap.items() if k.startswith("sweep.")}


def _delta(before):
    after = _counts()
    return {k: after[k] - before.get(k, 0.0) for k in after if after[k] != before.get(k, 0.0)}


def test_sweep_resume_skips_finished_points(tmp_path):
    specs = [spec_(name=f"pt{i}", seed=i) for i in range(2)]
    before = _counts()
    first = T.sweep(specs, resume_dir=tmp_path, max_points=1, device=CPU)
    assert first.resumed == [False] and len(first.skipped) == 1
    second = T.sweep(specs, resume_dir=tmp_path, device=CPU)
    assert second.resumed == [True, False] and not second.skipped
    assert second.reports[0].wall_time_s == first.reports[0].wall_time_s
    np.testing.assert_array_equal(second.reports[0].losses, first.reports[0].losses)
    third = T.sweep(specs, resume_dir=tmp_path, device=CPU)
    assert third.resumed == [True, True] and third.attempts == [0, 0]
    assert _delta(before) == {"sweep.points_total": 2.0, "sweep.points_skipped_total": 1.0,
                              "sweep.points_resumed_total": 3.0}
    table = third.time_to_loss_table(target=1.0)
    assert "pt0" in table and "pt1" in table
    # the resume records are the reference's: its sweep resumes them too
    jspecs = [spec_(api=J, name=f"pt{i}", seed=i) for i in range(2)]
    assert J.sweep(jspecs, resume_dir=tmp_path).resumed == [True, True]


def test_sweep_without_resume_dir_runs_everything():
    result = T.sweep([spec_(name=f"pt{i}") for i in range(2)], device=CPU)
    assert result.resumed == [False, False]
    json.dumps(result.to_dict())


def _fault_spec(name, **kw):
    return spec_(p_c=1, name=name, **kw)


def test_transient_fault_retries_and_matches_a_clean_run(tmp_path):
    spec = _fault_spec("transient", faults=T.FaultPolicy(autosave_every=2, max_retries=2))
    clean = run(_fault_spec("transient"))
    before = _counts()
    with install(FaultPlan(events=[FaultEvent(kind="io_error", site="round", at=4)])) as inj:
        report = T.sweep([spec], resume_dir=tmp_path, device=CPU)
    assert report.attempts == [2] and report.quarantined == []
    assert inj.fired == [("io_error", "round", 4)]
    assert_same_run(report.reports[0], clean)
    assert not T.autosave_base(tmp_path, spec).with_suffix(".npz").exists()
    assert _delta(before)["sweep.retries_total"] == 1.0


def test_persistent_fault_quarantines_and_the_sweep_completes(tmp_path):
    doomed = _fault_spec("doomed", faults=T.FaultPolicy(max_retries=2))
    fine = _fault_spec("fine")
    before = _counts()
    with install(FaultPlan(events=[FaultEvent(kind="io_error", site="point", at=0, times=99)])) as inj:
        report = T.sweep([doomed, fine], resume_dir=tmp_path, device=CPU)
    assert [r.spec.name for r in report.reports] == ["fine"]
    (q,) = report.quarantined
    assert (q.name, q.attempts, q.spec_hash) == ("doomed", 3, doomed.content_hash())
    assert "TransientIOError" in q.error and inj.fired == [("io_error", "point", 0)] * 3
    assert json.loads(report.to_json())["quarantined"] == [q.to_dict()]
    assert _delta(before)["sweep.quarantined_total"] == 1.0


def test_retry_resumes_from_the_autosave_round(tmp_path):
    spec = _fault_spec("resume-probe", faults=T.FaultPolicy(autosave_every=1, max_retries=0))
    with install(FaultPlan(events=[FaultEvent(kind="io_error", site="round", at=3)])):
        report = T.sweep([spec], resume_dir=tmp_path, device=CPU)
    assert report.quarantined[0].rounds_done == 3
    assert T.Session.restore(T.autosave_base(tmp_path, spec), spec=spec, device=CPU).rounds_done == 3
    again = T.sweep([spec], resume_dir=tmp_path, device=CPU)
    assert again.attempts == [1] and again.reports[0].rounds_completed == 6
    assert_same_run(again.reports[0], run(_fault_spec("resume-probe")))


def test_soft_kill_then_resume_is_bitwise(tmp_path):
    spec = _fault_spec("chaos-soft-kill", faults=T.FaultPolicy(autosave_every=2))
    clean = session(spec).run()
    victim = session(spec, autosave_dir=tmp_path)
    with install(FaultPlan(events=[FaultEvent(kind="kill", site="round", at=4)])) as inj:
        with pytest.raises(WorkerKilled):
            victim.run()
    assert inj.fired == [("kill", "round", 4)] and victim.rounds_done == 4
    rep = T.Session.restore(T.autosave_base(tmp_path, spec), spec=spec, device=CPU).run()
    assert_same_run(rep, clean)


def test_fault_plans_are_the_references():
    from repro.core import faults as jfaults

    for seed in (42, "c5e2c76d6dea3480"):
        got = faults.FaultPlan.from_seed(seed, rounds=20, kinds=("stall", "io_error", "kill"))
        want = jfaults.FaultPlan.from_seed(seed, rounds=20, kinds=("stall", "io_error", "kill"))
        assert [dataclasses.asdict(e) for e in got.events] == [dataclasses.asdict(e) for e in want.events]
    assert faults.active() is None
    faults.poke("round", 1)  # inert without a plan


def test_cached_dataset_is_read_only():
    from repro_torch.api.run import _cached_dataset

    spec = spec_(name="aliasing")
    first = run(spec)
    ds = _cached_dataset(spec.dataset, seed=spec.seed)
    for arr in (ds.A.indptr, ds.A.indices, ds.A.data, ds.y, ds.x_true):
        assert not arr.flags.writeable
        with pytest.raises(ValueError):
            arr[...] = 0
    assert_same_run(run(spec), first)
