"""Stream chaos on the port, modelled on the reference's
tests/chaos/test_stream_chaos.py (its 3 tests, one for one): a serving
worker dies mid-stream, a fresh session resumes from the autosave, and the
finished weights are **bitwise** the uninterrupted run's — no micro-batch
was duplicated and none was dropped across the kill.

Exactly-once is structural: the round counter IS the stream position,
sources replay batch k purely from (seed, k), and ``step_stream`` refuses
any batch whose index disagrees with the counter. So if the resumed
trajectory lands bitwise on the clean one, the resumed session consumed
precisely batches kill_at..N-1.

The simulated victim is SIGKILLed in a subprocess (nothing runs after the
kill); the seeded sweep uses the in-process kill (``WorkerKilled``), which
takes the same autosave/resume path. On the 2 × 2 mesh (four gloo ranks on
CPU tensors, the launcher of tests/test_torch_distributed.py) every rank
is killed at the same round, every rank restores; the mesh's clean stream
is also held within 1e-5 of the simulated stream at p_r = 2 (the mesh's
tolerance against the simulated engine in tests/test_torch_distributed.py).
"""

import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import ExperimentSpec, FaultPolicy, MeshSpec, Session, StreamSpec, autosave_base
from repro_torch.core.engine import ParallelSGDSchedule
from repro_torch.core.faults import FaultEvent, FaultPlan, WorkerKilled, install
from repro_torch.serve import ModelStore, PredictionService, make_stream_source
from repro_torch.train.checkpoint import CheckpointCorruptError
from test_torch_distributed import launch

ROOT = Path(__file__).resolve().parents[1]
SIGKILLED = -int(signal.SIGKILL)
MESH_TOL = 1e-5  # max |Δx| and |Δloss|, mesh against the simulated engine
ROUNDS = 8


def chaos_spec(backend="simulated", p_c=1, stream_seed=3):
    return ExperimentSpec(
        dataset="rcv1-sm",
        schedule=ParallelSGDSchedule.hybrid(2, 2, 4, 0.2, 8, rounds=ROUNDS, loss_every=2),
        mesh=MeshSpec(p_r=2, p_c=p_c, backend=backend),
        stream=StreamSpec(source="drift", seed=stream_seed, drift_at=3),
        faults=FaultPolicy(autosave_every=1),
        name="chaos-stream",
    )


def clean_run(spec):
    sess = Session(spec, device="cpu")
    while not sess.done:
        sess.step_stream(make_stream_source(spec))
    return sess


def resume(spec, tmp, kill_at):
    sess = Session.restore(autosave_base(tmp, spec), spec=spec, device="cpu")
    assert sess.rounds_done == kill_at
    # re-attach the stream AT the restored round: the source replays batch
    # kill_at onward — the victim's consumed prefix is never re-trained
    while not sess.done:
        sess.step_stream(make_stream_source(spec))
    return sess


def assert_bitwise(sess, clean):
    assert sess.rounds_done == ROUNDS
    assert np.array_equal(sess.current_x(), clean.current_x()), "resumed weights diverged"
    assert sess.losses == clean.losses, "resumed loss trace diverged"


_VICTIM = """
from repro_torch.api import ExperimentSpec, Session
from repro_torch.core.faults import FaultEvent, FaultPlan, install
from repro_torch.serve import make_stream_source
spec = ExperimentSpec.from_json({spec!r})
plan = FaultPlan(events=[FaultEvent(kind="kill", site="round", at={kill_at})])
sess = Session(spec, autosave_dir={tmp!r}, device="cpu")
with install(plan, hard_kill=True):
    while not sess.done:
        sess.step_stream(make_stream_source(spec))
print("UNREACHABLE")  # SIGKILL means this line never runs
"""

_MESH_BODY = """
from repro_torch.api import autosave_base
from repro_torch.core.faults import FaultEvent, FaultPlan, WorkerKilled, install
from repro_torch.serve import make_stream_source
spec = ExperimentSpec.from_json({spec!r})


def stream_to_end(sess):
    while not sess.done:
        sess.step_stream(make_stream_source(spec))
    return sess


clean = stream_to_end(Session(spec, device="cpu"))
arrays["clean.x"], arrays["clean.losses"] = clean.current_x(), np.asarray(clean.losses, np.float32)
victim = Session(spec, device="cpu", autosave_dir=out / "auto")
try:
    with install(FaultPlan(events=[FaultEvent(kind="kill", site="round", at={kill_at})])):
        stream_to_end(victim)
    info["killed"] = False
except WorkerKilled:
    info["killed"] = True
resumed = Session.restore(autosave_base(out / "auto", spec), spec=spec, device="cpu")
info["resumed_at"] = resumed.rounds_done
stream_to_end(resumed)
arrays["resumed.x"] = resumed.current_x()
arrays["resumed.losses"] = np.asarray(resumed.losses, np.float32)
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The 2 × 2 mesh's clean, killed and resumed stream runs (4 ranks)."""
    body = _MESH_BODY.format(spec=chaos_spec("shard_map", p_c=2).to_json(), kill_at=4)
    return launch(tmp_path_factory.mktemp("stream_mesh"), 4, body)


@pytest.mark.parametrize("backend", ["simulated", "shard_map"])
def test_kill_mid_stream_resumes_with_no_dup_no_drop(backend, tmp_path, request):
    kill_at = 4
    if backend == "shard_map":
        runs = request.getfixturevalue("mesh_runs")
        for arrays, info in runs:
            assert info == {"killed": True, "resumed_at": kill_at}
            assert np.array_equal(arrays["resumed.x"], arrays["clean.x"])
            assert np.array_equal(arrays["resumed.losses"], arrays["clean.losses"])
            assert np.array_equal(arrays["clean.x"], runs[0][0]["clean.x"])  # every rank, same bits
        return
    spec = chaos_spec()
    code = textwrap.dedent(_VICTIM.format(spec=spec.to_json(), tmp=str(tmp_path), kill_at=kill_at))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == SIGKILLED, proc.stderr[-4000:]
    assert "UNREACHABLE" not in proc.stdout
    assert_bitwise(resume(spec, tmp_path, kill_at), clean_run(spec))


def test_mesh_stream_matches_the_simulated_stream(mesh_runs):
    """The 2 × 2 gloo stream run against the simulated stream at p_r = 2:
    x and the loss trace within 1e-5."""
    spec = chaos_spec("shard_map", p_c=2)
    sim = clean_run(dataclasses.replace(spec, mesh=MeshSpec(p_r=2, p_c=2)))
    arrays = mesh_runs[0][0]
    assert np.abs(sim.current_x()).max() > 1e-3
    assert np.abs(arrays["clean.x"] - sim.current_x()).max() < MESH_TOL
    assert len(arrays["clean.losses"]) == len(sim.losses) == ROUNDS // 2
    assert np.abs(arrays["clean.losses"] - np.asarray(sim.losses, np.float32)).max() < MESH_TOL


@pytest.mark.parametrize("stream_seed", [0, 1, 2])
def test_seeded_stream_kill_sweep(stream_seed, tmp_path):
    """The same kill against different stream seeds — any bookkeeping bug
    that depends on what the data happens to be shows up here."""
    spec = chaos_spec(stream_seed=stream_seed)
    kill_at = 5
    victim = Session(spec, device="cpu", autosave_dir=tmp_path)
    with pytest.raises(WorkerKilled):
        with install(FaultPlan(events=[FaultEvent(kind="kill", site="round", at=kill_at)])):
            while not victim.done:
                victim.step_stream(make_stream_source(spec))
    assert_bitwise(resume(spec, tmp_path, kill_at), clean_run(spec))


def test_hot_swap_never_serves_a_torn_model(tmp_path):
    """A checkpoint torn mid-write must be REJECTED by the swap — the
    service keeps answering from the previous version."""
    spec = chaos_spec()
    sess = Session(spec, device="cpu")
    sess.step_stream(make_stream_source(spec), 4)
    store = ModelStore(device="cpu")
    store.publish(sess.current_x(), rounds_done=4)
    good = tmp_path / "good"
    sess.save(good)
    npz = good.with_suffix(".npz")
    npz.write_bytes(npz.read_bytes()[:-32])  # torn tail
    with PredictionService(store) as svc:
        with pytest.raises(CheckpointCorruptError):
            store.swap_from_checkpoint(good)
        res = svc.predict([[0, 1]], [[1.0, 1.0]])
        assert res.model_version == 1  # still the pre-swap model
        assert store.failed_swaps == 1
