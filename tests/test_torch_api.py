"""The port's front door against the reference's: ``repro_torch.api``
(spec, plan, report, run) and ``repro.api`` on the same inputs.

Specs must be interchangeable on the wire: the same JSON text and the
same ``content_hash()`` in both packages (checkpoints and sweep resume
records key on it), for every spec file in ``examples/specs/`` and for
constructed specs that switch on each emit-only-when-non-default field.
Plans and modeled comm are pure functions of the spec and must be equal.
Runs go through the reference's ``run(spec)`` (its default Gram is the
Pallas kernel in interpret mode) and the port's
``run(spec, device="cpu")`` (the kernels' plain versions) at the
tolerances of tests/test_torch_engine.py.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.api as J
import repro_torch.api as T
from repro.core.engine import ParallelSGDSchedule as JS
from repro_torch.core.engine import ParallelSGDSchedule as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATASET = "rcv1-sm"

# bf16 is held at these too: both packages round the same operands, as
# tests/test_torch_overlap_precision.py holds the bf16 engine
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _spec_files():
    out = []
    for path in sorted((ROOT / "examples" / "specs").glob("*.json")):
        blob = json.loads(path.read_text())
        for i, d in enumerate(blob if isinstance(blob, list) else [blob]):
            out.append(pytest.param(d, id=f"{path.stem}[{i}]"))
    return out


@pytest.mark.parametrize("wire", _spec_files())
def test_spec_files_read_and_hash_as_in_the_reference(wire):
    j = J.ExperimentSpec.from_dict(wire)
    t = T.ExperimentSpec.from_dict(wire)
    assert t.to_json() == j.to_json()
    assert t.to_dict() == j.to_dict()
    assert t.content_hash() == j.content_hash()
    assert T.ExperimentSpec.from_json(t.to_json()) == t
    if wire["schedule"].get("gram", "pallas") == "pallas":
        assert t.schedule.gram == "kernel"


def _pair(sched_kw=None, **kw):
    """The same spec built with each package's classes: the reference's
    "pallas" Gram is the port's "kernel"."""
    sched_kw = {**dict(p_r=2, s=2, b=8, eta=0.05, tau=8, rounds=4, loss_every=2), **(sched_kw or {})}
    out = []
    for api, S in ((J, JS), (T, TS)):
        skw = dict(sched_kw)
        if S is TS and skw.get("gram", "pallas") == "pallas":
            skw["gram"] = "kernel"
        mesh = kw.get("mesh", {"p_r": skw["p_r"], "p_c": 2})
        extra = {k: v for k, v in kw.items() if k not in ("mesh", "stop", "faults", "stream")}
        for name, cls in (("stop", api.StopPolicy), ("faults", api.FaultPolicy),
                          ("stream", api.StreamSpec)):
            if name in kw:
                extra[name] = cls(**kw[name])
        out.append(api.ExperimentSpec(dataset=extra.pop("dataset", DATASET),
                                      schedule=S.hybrid(**skw), mesh=api.MeshSpec(**mesh), **extra))
    return tuple(out)


CONSTRUCTED = {
    "defaults": {},
    "delay": dict(sched_kw=dict(delay=2)),
    "bf16": dict(sched_kw=dict(precision="bf16")),
    "bm": dict(sched_kw=dict(bm=8)),
    "bk_none": dict(sched_kw=dict(bk=None)),
    "objective_l2": dict(objective="least_squares", l2=0.01),
    "comm_timing": dict(comm_timing=True),
    "fault_policy": dict(faults=dict(autosave_every=2, max_retries=1, backoff_s=0.5)),
    "stream": dict(stream=dict(source="drift", seed=3, drift_at=2)),
    "gram_blocked": dict(sched_kw=dict(gram="blocked")),
    "gram_dense_interpret_off": dict(sched_kw=dict(gram="dense", interpret=False)),
    "stop_named_autotune": dict(stop=dict(target_loss=0.6, max_rounds=3), name="pt", seed=3,
                                autotune=True, row_multiple=32, machine="tpu-v5e"),
    "shard_map_mesh": dict(mesh=dict(p_r=2, p_c=4, backend="shard_map", partitioner="nnz")),
}


@pytest.mark.parametrize("case", list(CONSTRUCTED))
def test_constructed_specs_serialize_and_hash_as_in_the_reference(case):
    j, t = _pair(**CONSTRUCTED[case])
    assert t.to_json() == j.to_json()
    assert t.content_hash() == j.content_hash()
    # each package reads the other's text back to an equal spec
    assert T.ExperimentSpec.from_json(j.to_json()) == t
    assert J.ExperimentSpec.from_json(t.to_json()) == j
    assert T.ExperimentSpec.from_json(t.to_json()).content_hash() == j.content_hash()


def test_default_spec_hides_every_optional_field_as_the_reference_does():
    j, t = _pair()
    d = t.to_dict()
    for key in ("comm_timing", "faults", "stream", "objective", "l2"):
        assert key not in d
    for key in ("delay", "bm", "precision"):
        assert key not in d["schedule"]
    assert d["schedule"]["gram"] == "pallas" and d["schedule"]["interpret"] is True
    assert list(d["schedule"]) == list(j.to_dict()["schedule"])  # the key order too


# the reference's rejection cases (tests/test_api.py), each built with
# one package's classes: (api, schedule class) -> construction
REJECTIONS = {
    "p_r_mismatch": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=S.hybrid(2, 2, 8, 0.05, 8, rounds=1), mesh=A.MeshSpec(p_r=4)),
    "p_c_conflict": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=dataclasses.replace(S.hybrid(2, 2, 8, 0.05, 8, rounds=1), p_c=2),
        mesh=A.MeshSpec(p_r=2, p_c=4)),
    "unknown_dataset": lambda A, S: A.ExperimentSpec(
        dataset="no-such-data", schedule=S.mb_sgd(8, 0.05, 4)),
    "unknown_machine": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=S.mb_sgd(8, 0.05, 4), machine="no-such-machine"),
    "unknown_backend": lambda A, S: A.MeshSpec(backend="no-such-backend"),
    "unknown_partitioner": lambda A, S: A.MeshSpec(partitioner="no-such-partitioner"),
    "mesh_p_r_zero": lambda A, S: A.MeshSpec(p_r=0),
    "mesh_p_c_negative": lambda A, S: A.MeshSpec(p_c=-1),
    "unknown_gram": lambda A, S: S(gram="no-such-gram"),
    "max_seconds_negative": lambda A, S: A.StopPolicy(max_seconds=-1.0),
    "max_rounds_zero": lambda A, S: A.StopPolicy(max_rounds=0),
    "target_loss_without_loss_every": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=S.hybrid(1, 2, 8, 0.05, 8, rounds=4),
        stop=A.StopPolicy(target_loss=0.5)),
    "unknown_objective": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=S.mb_sgd(8, 0.05, 4), objective="no-such-loss"),
    "negative_l2": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=S.mb_sgd(8, 0.05, 4), l2=-1.0),
    "fault_policy_negative": lambda A, S: A.FaultPolicy(max_retries=-1),
    "stream_source": lambda A, S: A.StreamSpec(source="no-such-stream"),
    "stream_rows_mismatch": lambda A, S: A.ExperimentSpec(
        dataset=DATASET, schedule=S.hybrid(2, 2, 8, 0.05, 8, rounds=1), mesh=A.MeshSpec(p_r=2),
        stream=A.StreamSpec(source="drift", rows_per_round=7)),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejections_match_the_reference(case):
    with pytest.raises(Exception) as want:
        REJECTIONS[case](J, JS)
    with pytest.raises(Exception) as got:
        REJECTIONS[case](T, TS)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, (ValueError, KeyError))


def _plan_fields(pl):
    return dict(
        spec=pl.spec.to_dict(), cost=dataclasses.asdict(pl.cost), regime=pl.regime,
        balance=pl.balance, autotuned=pl.autotuned, s_star=pl.s_star, b_star=pl.b_star,
        calibrated=pl.calibrated, recommended_delay=pl.recommended_delay,
        tuned_panel=pl.tuned_panel, summary=pl.summary(),
    )


PLAN_CASES = {
    "hybrid": {},
    "autotune": dict(autotune=True),
    "autotune_tpu": dict(autotune=True, machine="tpu-v5e", mesh=dict(p_r=2, p_c=8)),
    "delay_bf16": dict(sched_kw=dict(delay=2, precision="bf16")),
    "full_url_autotune": dict(dataset="url", autotune=True, mesh=dict(p_r=4, p_c=64),
                              sched_kw=dict(p_r=4, s=4, b=32, tau=16, rounds=1, loss_every=0)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_equals_the_reference(case):
    j, t = _pair(**PLAN_CASES[case])
    assert _plan_fields(T.plan(t)) == _plan_fields(J.plan(j))


def test_plan_with_a_calibration_equals_the_reference():
    j, t = _pair(autotune=True)
    kw = dict(alpha=2e-6, beta=3e-10, gamma=4e-11, rel_rms=0.1, points=3)
    assert (_plan_fields(T.plan(t, calibration=T.Calibration(**kw)))
            == _plan_fields(J.plan(j, calibration=J.Calibration(**kw))))


@pytest.mark.parametrize("devices", [1, 2, 4, 6, 8])
def test_replan_mesh_equals_the_reference(devices):
    j, t = _pair(sched_kw=dict(p_r=4, s=2, b=4), mesh=dict(p_r=4, p_c=1))
    assert _plan_fields(T.replan_mesh(t, devices)) == _plan_fields(J.replan_mesh(j, devices))


@pytest.mark.parametrize("rounds", [None, 0, 3])
@pytest.mark.parametrize("case", ["defaults", "shard_map_mesh", "stop_named_autotune"])
def test_modeled_comm_words_equal(case, rounds):
    j, t = _pair(**CONSTRUCTED[case])
    assert T.modeled_comm_words(t, rounds=rounds) == J.modeled_comm_words(j, rounds=rounds)


# the four corners, D = 2 and bf16, as specs on rcv1-sm. The bf16 case takes
# η = 1 so that x grows (max|x| ≈ 0.09) and bf16 rounding moves it
# (≈ 1.4e-6 from fp32) by far more than the packages differ (≈ 4e-9).
RUN_CASES = {
    "mb_sgd": (lambda S: S.mb_sgd(8, 0.05, 8, loss_every=4), (1, 1)),
    "sstep": (lambda S: S.sstep(4, 8, 0.05, 16, loss_every=8), (1, 2)),
    "fedavg": (lambda S: S.fedavg(2, 8, 0.05, 4, 4, loss_every=2), (2, 1)),
    "hybrid": (lambda S: S.hybrid(2, 2, 8, 0.05, 8, rounds=4, loss_every=2), (2, 2)),
    "hybrid_delay2": (lambda S: S.hybrid(2, 2, 8, 0.05, 8, rounds=4, loss_every=2, delay=2), (2, 2)),
    "hybrid_bf16": (lambda S: S.hybrid(2, 2, 8, 1.0, 8, rounds=4, loss_every=2, precision="bf16"),
                    (2, 2)),
}


def _run_pair(case):
    make, (p_r, p_c) = RUN_CASES[case]
    j = J.ExperimentSpec(dataset=DATASET, schedule=make(JS), mesh=J.MeshSpec(p_r=p_r, p_c=p_c))
    t = T.ExperimentSpec.from_json(j.to_json())
    assert t.content_hash() == j.content_hash()
    return j, t


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_matches_the_reference(case):
    j, t = _run_pair(case)
    want = J.run(j)
    got = T.run(t, device="cpu")
    assert got.x.dtype == np.float32 and got.x.shape == want.x.shape
    assert len(got.losses) == len(want.losses) > 0
    assert np.abs(got.x).max() > 1e-3  # x moved away from x0 = 0
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
    assert got.ledger.to_dict() == {**want.ledger.to_dict()}
    assert got.spec.to_json() == want.spec.to_json()


def test_reports_read_in_both_packages():
    """A report's JSON from either package rehydrates in the other (the
    sweep resume records)."""
    j, t = _run_pair("hybrid")
    got = T.run(t, device="cpu")
    back = J.RunReport.from_json(got.to_json())
    assert back.spec == j and back.x is None
    assert back.to_json() == got.to_json()
    want = J.run(j)
    assert T.RunReport.from_json(want.to_json()).to_json() == want.to_json()


def test_run_decaying_tau_matches_the_reference():
    sched_j = JS.hybrid(2, 2, 8, 0.05, 4, rounds=5, loss_every=1)
    j = J.ExperimentSpec(dataset=DATASET, schedule=sched_j, mesh=J.MeshSpec(p_r=2, p_c=1),
                         row_multiple=32, name="decay")
    t = T.ExperimentSpec.from_json(j.to_json())
    want = J.run_decaying_tau(j, stages=3, growth=2)
    got = T.run_decaying_tau(t, stages=3, growth=2, device="cpu")
    assert [r.spec.to_json() for r in got] == [r.spec.to_json() for r in want]
    assert [r.spec.schedule.tau for r in got] == [4, 8, 16]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.x, w.x, **X_TOL)
        np.testing.assert_allclose(g.losses, w.losses, **LOSS_TOL)


def test_unported_branches_raise_naming_their_roadmap_item(tmp_path, monkeypatch):
    _, t = _pair()
    # the mesh backend is ported: it builds the mesh layout, and without a
    # process group it refuses to run, saying how to start one
    mesh = dataclasses.replace(t, mesh=T.MeshSpec(p_r=2, p_c=2, backend="shard_map"))
    built = T.build_problem(mesh, device="cpu")
    assert built.team is None and built.prob2d.indices.shape[:2] == (2, 2)
    with pytest.raises(RuntimeError, match="process group"):
        T.Session(mesh, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        T.run(mesh, device="cpu")
    # the panel autotuner (item 9) is ported: bk=None plans (reading the
    # tuner's cache only) and the session resolves it before it builds
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    _, auto = _pair(sched_kw=dict(bk=None))
    assert "bk=auto (tuned at build)" in T.plan(auto, device="cpu").summary()
    resolved = T.Session(auto, device="cpu").spec.schedule
    assert isinstance(resolved.bk, int) and resolved.bk > 0
    # the streaming door (item 11) is ported: a stream spec builds and
    # steps its declared source, an offline session has no stream to step
    j_stream, stream = _pair(**CONSTRUCTED["stream"])
    from repro.serve import make_stream_source as j_make_stream_source
    from repro_torch.serve import make_stream_source

    ev = T.Session(stream, device="cpu").step_stream(make_stream_source(stream), 1)
    want = J.Session(j_stream).step_stream(j_make_stream_source(j_stream), 1)
    assert ev.rounds_done == want.rounds_done == 1
    np.testing.assert_allclose(ev.x, want.x, **X_TOL)
    with pytest.raises(ValueError, match="no stream"):
        make_stream_source(t)
    # the pytree half of the checkpoint module is ported (item 13's first
    # path), and the trainer's mesh (item 13c): it takes a DeviceMesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.train import checkpoint, train

    assert callable(checkpoint.save_checkpoint) and callable(checkpoint.restore_checkpoint)
    with pytest.raises(TypeError, match="DeviceMesh"):
        train(reduced(get_config("qwen2.5-3b")), steps=1, mesh=object(), device="cpu")


def test_api_exports_match_the_reference():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert T.BACKENDS == J.BACKENDS
