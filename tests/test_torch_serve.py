"""The port's serving plane (``repro_torch.serve``: hot-swap store, batched
prediction service, ``Session.step_stream``, the online controller) and
its two CLIs, modelled on the reference's tests/test_serve.py — its 29
tests one for one, on the CPU (``device="cpu"``) — plus parity with the
live reference: stream sessions and controller runs against the
reference's on the same spec, checkpoints crossing between the packages,
and the serve and sweep CLIs' output against the reference CLIs'.

On the CPU the port is deterministic (the Yᵀu scatter is a serial
``index_add_``), so the structural invariants are held **bitwise** inside
the port: same seed → same weights, chunked ≡ whole, resumed ≡
uninterrupted, the controller ≡ a bare session. Against the reference,
iterates and losses are held at the engine tolerances below.
"""

import contextlib
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as J
import repro.serve as JV
from repro.launch import serve as j_serve_cli
from repro.launch import sweep as j_sweep_cli
from repro.train.checkpoint import load_model_weights as j_load_model_weights
from repro_torch.api import ExperimentSpec, FaultPolicy, MeshSpec, Session, StreamSpec
from repro_torch.core.engine import ParallelSGDSchedule
from repro_torch.launch import serve as t_serve_cli
from repro_torch.launch import sweep as t_sweep_cli
from repro_torch.serve import (
    DriftStream,
    ModelStore,
    OnlineController,
    PredictionService,
    StreamDesyncError,
    StreamFeed,
    make_stream_source,
    serve_http,
)
from repro_torch.train.checkpoint import CheckpointCorruptError, load_model_weights

ROOT = Path(__file__).resolve().parents[1]
SERVE_DRIFT = ROOT / "examples" / "specs" / "serve_drift.json"
CPU = "cpu"
# the engine tolerances of tests/test_torch_session.py: float32 sums in
# another order (iterates), the same for the sampled losses
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def sched(rounds=8, loss_every=4, eta=0.2):
    return ParallelSGDSchedule.hybrid(
        p_r=2, s=2, b=4, eta=eta, tau=8, rounds=rounds, loss_every=loss_every
    )


MESH = MeshSpec(p_r=2, p_c=1, backend="simulated")


def stream_spec(rounds=8, loss_every=4, **stream_kw):
    stream_kw.setdefault("source", "drift")
    stream_kw.setdefault("seed", 3)
    return ExperimentSpec(
        dataset="rcv1-sm",
        schedule=sched(rounds, loss_every),
        mesh=MESH,
        stream=StreamSpec(**stream_kw),
    )


def session(spec, **kw):
    return Session(spec, device=CPU, **kw)


def store_():
    return ModelStore(device=CPU)


def run_stream(sess, spec, k=None):
    while not sess.done:
        sess.step_stream(make_stream_source(spec), k)
    return sess


# ---------------- StreamSpec (spec layer) ----------------


def test_stream_spec_roundtrip():
    spec = stream_spec(drift_at=5, width=8, swap_every=2)
    again = ExperimentSpec.from_dict(spec.to_dict())
    assert again == spec
    assert again.stream.drift_at == 5
    assert ExperimentSpec.from_json(spec.to_json()) == spec


def test_default_spec_has_no_stream_on_the_wire():
    """Offline specs serialize (and content-hash) exactly as before the
    serving plane existed."""
    spec = ExperimentSpec(dataset="rcv1-sm", schedule=sched(), mesh=MESH)
    d = spec.to_dict()
    assert "stream" not in d
    assert ExperimentSpec.from_dict(d) == spec
    assert spec.content_hash() == dataclasses.replace(spec, stream=StreamSpec()).content_hash()
    assert spec.content_hash() != stream_spec().content_hash()


def test_stream_spec_validation():
    with pytest.raises(ValueError, match="source"):
        StreamSpec(source="firehose")
    with pytest.raises(ValueError, match="queue_capacity"):
        StreamSpec(queue_capacity=0)
    with pytest.raises(ValueError, match="rows_per_round"):
        stream_spec(rows_per_round=63)
    ok = stream_spec(rows_per_round=64)  # p_r·τ·b = 2·8·4
    assert ok.stream_rows_per_round() == 64
    assert stream_spec().stream_rows_per_round() == 64  # derived


def test_make_stream_source_follows_the_spec():
    src = make_stream_source(stream_spec(drift_at=7))
    assert isinstance(src, DriftStream)
    assert src.rows == 64 and src.drift_at == 7
    from repro_torch.serve import ReplayStream

    rep = make_stream_source(stream_spec(source="replay"))
    assert isinstance(rep, ReplayStream)
    with pytest.raises(ValueError, match="no stream"):
        make_stream_source(ExperimentSpec(dataset="rcv1-sm", schedule=sched(), mesh=MESH))
    # the same source as the reference's for the same spec
    j = J.ExperimentSpec.from_json(stream_spec(drift_at=7).to_json())
    assert dataclasses.asdict(src) == dataclasses.asdict(JV.make_stream_source(j))


# ---------------- checkpoint → weights door ----------------


def test_load_model_weights_roundtrip(tmp_path):
    spec = stream_spec()
    sess = session(spec)
    sess.step_stream(make_stream_source(spec), 4)
    path = tmp_path / "ck"
    sess.save(path)
    x, meta = load_model_weights(path)
    assert np.array_equal(x, sess.current_x())
    assert meta["rounds_done"] == 4
    assert meta["spec_hash"] == spec.content_hash()


def _corrupt(path):
    npz = path.with_suffix(".npz")
    blob = bytearray(npz.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    npz.write_bytes(bytes(blob))


def test_load_model_weights_rejects_corruption(tmp_path):
    spec = stream_spec()
    sess = session(spec)
    sess.step_stream(make_stream_source(spec), 2)
    path = tmp_path / "ck"
    sess.save(path)
    _corrupt(path)
    with pytest.raises(CheckpointCorruptError):
        load_model_weights(path)


# ---------------- ModelStore ----------------


def test_store_publish_and_snapshot_immutability():
    store = store_()
    x = np.arange(5, dtype=np.float32)
    snap = store.publish(x, rounds_done=3)
    x[0] = 99.0  # publisher's buffer — must not reach the served model
    assert snap.x[0] == 0.0
    with pytest.raises(ValueError):
        snap.x[1] = 7.0  # the host view of served weights is read-only
    assert store.version == 1 and snap.rounds_done == 3
    # a device tensor (a session's carry, updated in place by the next
    # round) is copied too: the served weights are private
    carry = torch.ones(5)
    snap2 = store.publish(carry)
    carry.add_(1.0)
    assert snap2.weights.data_ptr() != carry.data_ptr()
    assert np.array_equal(snap2.x, np.ones(5, np.float32)) and store.version == 2


def test_store_empty_raises():
    store = store_()
    with pytest.raises(RuntimeError, match="empty"):
        store.snapshot()
    assert store.version == 0


def test_store_swap_from_checkpoint(tmp_path):
    spec = stream_spec()
    sess = session(spec)
    sess.step_stream(make_stream_source(spec), 4)
    path = tmp_path / "ck"
    sess.save(path)
    store = store_()
    store.publish(np.zeros(sess.current_x().shape[0], np.float32))
    snap = store.swap_from_checkpoint(path)
    assert snap.version == 2
    assert np.array_equal(snap.x, sess.current_x())
    assert snap.weights.device.type == "cpu"
    assert snap.rounds_done == 4 and snap.spec_hash == spec.content_hash()


def test_corrupt_swap_keeps_the_old_model_serving(tmp_path):
    spec = stream_spec()
    sess = session(spec)
    sess.step_stream(make_stream_source(spec), 2)
    path = tmp_path / "ck"
    sess.save(path)
    _corrupt(path)
    store = store_()
    old = store.publish(np.ones(4, np.float32), rounds_done=1)
    with pytest.raises(CheckpointCorruptError):
        store.swap_from_checkpoint(path)
    assert store.snapshot() is old  # untouched — never a torn install
    assert store.failed_swaps == 1 and store.version == 1


def test_store_predict_pins_one_version():
    store = store_()
    store.publish(np.array([1.0, 2.0, -1.0], np.float32))
    idx = np.array([[0, 1], [2, 2]], np.int32)
    val = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    margins, version = store.predict(idx, val)
    assert version == 1 and margins.dtype == np.float32
    np.testing.assert_allclose(margins, [3.0, -1.0])
    # the reference store's margins on the same weights and rows
    jstore = JV.ModelStore()
    jstore.publish(np.array([1.0, 2.0, -1.0], np.float32))
    assert np.array_equal(margins, jstore.predict(idx, val)[0])


# ---------------- PredictionService ----------------


def test_service_batches_and_answers():
    store = store_()
    store.publish(np.array([2.0, -3.0], np.float32))
    with PredictionService(store, max_wait_s=0.01) as svc:
        res = svc.predict([[0, 1]], [[1.0, 0.5]])
        np.testing.assert_allclose(res.margins, [0.5])
        assert res.labels.tolist() == [1.0]
        assert res.model_version == 1
        # a single flat row is promoted to a batch of one
        res2 = svc.predict([0, 0], [1.0, 1.0])
        np.testing.assert_allclose(res2.margins, [4.0])
        st = svc.stats()
        assert st["rows_served"] == 2 and st["errors"] == 0


def test_service_coalesces_concurrent_requests():
    store = store_()
    store.publish(np.ones(8, np.float32))
    results = []
    with PredictionService(store, max_wait_s=0.05) as svc:
        def ask(i):
            results.append(svc.predict([[i % 8]], [[1.0]]))

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = svc.stats()
    assert len(results) == 6
    assert all(r.margins.shape == (1,) for r in results)
    assert st["batches"] < 6  # at least some coalescing happened


def test_service_survives_a_swap_mid_traffic():
    """Predictions keep answering while the model hot-swaps, and every
    answer is computed by exactly one version (never a mix)."""
    store = store_()
    store.publish(np.full(4, 1.0, np.float32))
    with PredictionService(store, max_wait_s=0.001) as svc:
        seen = set()
        for i in range(50):
            if i == 25:
                store.publish(np.full(4, 2.0, np.float32))
            res = svc.predict([[0, 1, 2, 3]], [[1.0, 1.0, 1.0, 1.0]])
            want = 4.0 if res.model_version == 1 else 8.0
            np.testing.assert_allclose(res.margins, [want])
            seen.add(res.model_version)
    assert seen == {1, 2}


def test_service_propagates_errors():
    store = store_()  # empty: predict must fail loudly
    with PredictionService(store) as svc:
        with pytest.raises(RuntimeError, match="empty"):
            svc.predict([[0]], [[1.0]])
        assert svc.stats()["errors"] == 1


def test_http_front():
    store = store_()
    store.publish(np.array([1.0, -1.0, 0.5], np.float32))
    with PredictionService(store) as svc:
        server, _ = serve_http(svc, port=0)
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
                health = json.loads(r.read())
            assert health["ok"] and health["model_version"] == 1

            body = json.dumps(
                {"rows": [{"idx": [0, 2], "val": [1.0, 2.0]}, {"idx": [1], "val": [1.0]}]}
            ).encode()
            req = urllib.request.Request(
                f"{base}/predict", data=body, headers={"Content-Type": "application/json"}
            )
            with urllib.request.urlopen(req, timeout=10) as r:
                out = json.loads(r.read())
            np.testing.assert_allclose(out["margins"], [2.0, -1.0])
            assert out["labels"] == [1.0, -1.0]
            assert out["model_version"] == 1

            with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
                stats = json.loads(r.read())
            assert stats["service"]["rows_served"] == 2
            assert stats["store"]["version"] == 1
            # HTTP answers are bitwise the in-process answers
            res = svc.predict([[0, 2], [1, 0]], [[1.0, 2.0], [1.0, 0.0]])
            assert out["margins"] == res.margins.tolist()

            bad = urllib.request.Request(f"{base}/predict", data=b"{}")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad, timeout=10)
            assert e.value.code == 400
        finally:
            server.shutdown()


# ids the model cannot gather are refused on the host: on a card an
# out-of-range gather would be a device-side assert that fails every later
# CUDA call of the process (training included), so it must never launch
@pytest.mark.parametrize("bad_id", [3, 7, -4, 2**31 - 1])
def test_out_of_range_ids_are_refused_on_the_host(bad_id):
    x = np.array([1.0, -1.0, 0.5], np.float32)
    store = store_()
    store.publish(x)
    with pytest.raises(ValueError, match="feature ids"):
        store.predict([[0, bad_id]], [[1.0, 1.0]])
    # [-n, n) is what a numpy gather accepts: negatives count from the end
    m, _ = store.predict([[-3, -1]], [[1.0, 2.0]])
    np.testing.assert_array_equal(m, np.einsum("bw,bw->b", x[[[-3, -1]]], [[1.0, 2.0]]))
    with PredictionService(store, max_wait_s=0.05) as svc:
        # a bad request fails alone: a good one coalesced beside it is answered
        good = []
        t = threading.Thread(target=lambda: good.append(svc.predict([[0, 2]], [[1.0, 2.0]])))
        t.start()
        with pytest.raises(ValueError, match="feature ids"):
            svc.predict([[bad_id]], [[1.0]])
        t.join()
        np.testing.assert_allclose(good[0].margins, [2.0])
        assert svc.stats()["errors"] == 0
        server, _ = serve_http(svc, port=0)
        host, port = server.server_address[:2]
        try:
            def post(rows):
                req = urllib.request.Request(
                    f"http://{host}:{port}/predict",
                    data=json.dumps({"rows": rows}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=10) as r:
                    return json.loads(r.read())

            with pytest.raises(urllib.error.HTTPError) as e:
                post([{"idx": [0, bad_id], "val": [1.0, 1.0]}])
            assert e.value.code == 400
            assert "feature ids" in json.loads(e.value.read())["error"]
            # the service goes on answering
            out = post([{"idx": [0, 2], "val": [1.0, 2.0]}])
            np.testing.assert_allclose(out["margins"], [2.0])
            assert out["model_version"] == 1
        finally:
            server.shutdown()


# ---------------- Session.step_stream ----------------


def test_step_stream_is_deterministic():
    spec = stream_spec(rounds=8)
    runs = [run_stream(session(spec), spec) for _ in range(2)]
    assert np.array_equal(runs[0].current_x(), runs[1].current_x())  # bitwise
    assert runs[0].losses == runs[1].losses


def test_step_stream_chunking_never_changes_the_trace():
    spec = stream_spec(rounds=8)
    a = run_stream(session(spec), spec)  # default chunks
    b = session(spec)
    src = make_stream_source(spec)
    while not b.done:
        b.step_stream(src, 1)  # one round at a time, one shared source
    assert np.array_equal(a.current_x(), b.current_x())
    assert a.losses == b.losses


def test_step_stream_through_a_feed_matches_bare_source():
    spec = stream_spec(rounds=6, loss_every=3)
    a = run_stream(session(spec), spec)
    b = session(spec)
    with StreamFeed(make_stream_source(spec), capacity=4) as feed:
        while not b.done:
            b.step_stream(feed, 1)
    assert np.array_equal(a.current_x(), b.current_x())


def test_resume_mid_stream_is_bitwise(tmp_path):
    spec = dataclasses.replace(stream_spec(rounds=12), faults=FaultPolicy(autosave_every=4))
    ref = run_stream(session(spec), spec)
    interrupted = session(spec, autosave_dir=tmp_path)
    interrupted.step_stream(make_stream_source(spec), 7)  # autosave hit at 4
    resumed = Session.restore(interrupted.autosave_path, spec=spec, autosave_dir=tmp_path,
                              device=CPU)
    assert resumed.rounds_done == 4  # last durable boundary
    run_stream(resumed, spec)  # the source re-attaches at the restored round
    assert np.array_equal(ref.current_x(), resumed.current_x())
    assert ref.losses == resumed.losses


def test_step_stream_desync_raises():
    spec = stream_spec(rounds=8)
    sess = session(spec)
    src = make_stream_source(spec)

    class OffByOne:
        def micro_batches(self, start=0):
            return src.micro_batches(start + 1)

    with pytest.raises(StreamDesyncError, match="duplicated, dropped"):
        sess.step_stream(OffByOne(), 1)


def test_step_stream_rejects_wrong_batch_size():
    spec = stream_spec(rounds=8)
    sess = session(spec)
    wrong = DriftStream(n=4736, rows=32, seed=3)  # a round needs 64
    with pytest.raises(ValueError, match="p_r·τ·b"):
        sess.step_stream(wrong, 1)


def test_step_stream_honors_budget_and_stop():
    spec = stream_spec(rounds=6, loss_every=3)
    sess = session(spec)
    ev = sess.step_stream(make_stream_source(spec), 100)  # capped at budget
    assert ev.rounds_done == 6 and ev.stop == "rounds"
    assert sess.done
    with pytest.raises(RuntimeError, match="finished"):
        sess.step_stream(make_stream_source(spec), 1)


def test_step_stream_samples_loss_on_boundaries():
    spec = stream_spec(rounds=8, loss_every=4)
    sess = session(spec)
    src = make_stream_source(spec)
    ev1 = sess.step_stream(src)  # default: to the next boundary
    assert sess.rounds_done == 4 and ev1.loss is not None
    assert len(sess.losses) == 1
    sess.step_stream(src)
    assert len(sess.losses) == 2


def test_offline_sessions_never_touch_the_stream_plane():
    """A stream-less spec steps through step_rounds exactly as before —
    and asking it for a stream is a loud error."""
    spec = ExperimentSpec(dataset="rcv1-sm", schedule=sched(rounds=4), mesh=MESH)
    sess = session(spec)
    ev = sess.step_rounds(4)
    assert ev.rounds_done == 4
    with pytest.raises(ValueError, match="no stream"):
        make_stream_source(spec)


# ---------------- OnlineController ----------------


def test_controller_end_to_end_with_service(tmp_path):
    spec = stream_spec(rounds=12, swap_every=4, drift_at=6)
    store = store_()
    with PredictionService(store) as svc:
        ctrl = OnlineController(session(spec), make_stream_source(spec), store, service=svc,
                                swap_dir=tmp_path)
        assert store.version == 1  # serving from round 0
        src = make_stream_source(spec)
        for _ in range(3):
            ctrl.run(4)
            b = src.batch(ctrl.session.rounds_done)
            res = svc.predict(b.indices, b.values)
            assert res.margins.shape == (64,)
        m = ctrl.metrics()
    assert m.rounds_done == 12
    assert m.swaps >= 3
    assert m.failed_swaps == 0
    assert m.staleness_rounds == 0  # final swap caught the store up
    assert m.predictions_served == 3 * 64
    assert ctrl.swap_rounds and all(
        (tmp_path / f"swap-{r}").with_suffix(".npz").exists() for r in ctrl.swap_rounds
    )


def test_controller_swap_cadence_follows_the_spec(tmp_path):
    spec = stream_spec(rounds=8, swap_every=2)
    ctrl = OnlineController(session(spec), make_stream_source(spec), store_(), swap_dir=tmp_path)
    ctrl.run()
    assert ctrl.swap_rounds == [2, 4, 6, 8]


def test_controller_matches_bare_session_bitwise(tmp_path):
    """The controller's swap machinery (save/load every k rounds) never
    perturbs training: same weights as a bare step_stream loop."""
    spec = stream_spec(rounds=8, swap_every=2)
    bare = run_stream(session(spec), spec)
    ctrl = OnlineController(session(spec), make_stream_source(spec), store_(), swap_dir=tmp_path)
    ctrl.run()
    assert np.array_equal(bare.current_x(), ctrl.session.current_x())
    assert np.array_equal(ctrl.store.snapshot().x, bare.current_x())


def test_controller_recovers_from_drift(tmp_path):
    """Accuracy against the *current* concept collapses at the drift and
    recovers without a restart."""
    spec = ExperimentSpec(
        dataset="rcv1-sm",
        schedule=sched(rounds=120, loss_every=0),
        mesh=MESH,
        stream=StreamSpec(source="drift", seed=3, drift_at=60, swap_every=8),
    )
    src = make_stream_source(spec)
    post_twin = dataclasses.replace(src, drift_at=1)  # always-new-concept probe
    ctrl = OnlineController(session(spec), src, store_(), swap_dir=tmp_path)

    def acc_new(r):
        vals = []
        for k in range(4):
            b = post_twin.batch(50_000 + 10 * r + k)
            m = np.einsum("rw,rw->r", ctrl.session.current_x()[b.indices], b.values)
            vals.append(np.mean(np.where(m >= 0, 1.0, -1.0) == b.y))
        return float(np.mean(vals))

    ctrl.run(60)
    at_drift = acc_new(60)  # the old model scored against the new concept
    ctrl.run(60)
    recovered = acc_new(120)
    assert at_drift < 0.5  # the flip inverted every learned margin
    assert recovered > 0.55  # adapted online, same process, no restart
    assert ctrl.metrics().failed_swaps == 0


# ---------------- parity with the live reference ----------------


def _pair(spec):
    """The same spec in both packages (through the shared wire form)."""
    j = J.ExperimentSpec.from_json(spec.to_json())
    assert j.content_hash() == spec.content_hash()
    return j


def _j_stream_run(j, k=None):
    sess = J.Session(j)
    while not sess.done:
        sess.step_stream(JV.make_stream_source(j), k)
    return sess


def test_step_stream_matches_the_reference_on_serve_drift():
    """examples/specs/serve_drift.json (48 rounds, the concept flips at
    batch 24) through both packages' ``step_stream``."""
    t = ExperimentSpec.from_json(SERVE_DRIFT.read_text())
    want = _j_stream_run(_pair(t))
    got = run_stream(session(t), t)
    assert got.rounds_done == want.rounds_done == 48
    assert np.abs(got.current_x()).max() > 1e-3  # x moved away from x0 = 0
    np.testing.assert_allclose(got.current_x(), want.current_x(), **X_TOL)
    assert len(got.losses) == len(want.losses) == 6
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
    assert got.stop_reason == want.stop_reason
    assert got.ledger.to_dict() == want.ledger.to_dict()


def test_replay_stream_matches_the_reference():
    spec = stream_spec(rounds=6, loss_every=3, source="replay")
    want = _j_stream_run(_pair(spec))
    got = run_stream(session(spec), spec)
    np.testing.assert_allclose(got.current_x(), want.current_x(), **X_TOL)
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)


def test_bf16_delayed_stream_matches_the_reference():
    """D = 2 in bf16 at η = 1 on a replay stream: within the engine
    tolerances of the reference's bf16 stream, and the rounding is live —
    the fp32 stream of the same spec lands ≥ 100× further from the port's
    bf16 x. (Replay rows hold distinct ids; on drift rows, which repeat
    ids, the two packages round a repeated id's products differently:
    see the next test.)"""
    base = stream_spec(rounds=6, loss_every=3, source="replay")
    sch = dataclasses.replace(base.schedule, eta=1.0, delay=2, precision="bf16")
    spec = dataclasses.replace(base, schedule=sch)
    want = _j_stream_run(_pair(spec))
    got = run_stream(session(spec), spec)
    np.testing.assert_allclose(got.current_x(), want.current_x(), **X_TOL)
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
    fp32 = dataclasses.replace(spec, schedule=dataclasses.replace(sch, precision="fp32"))
    gap = np.abs(run_stream(session(fp32), fp32).current_x() - got.current_x()).max()
    assert gap > 100 * np.abs(got.current_x() - want.current_x()).max() and gap > 0


def test_bf16_stream_on_repeated_ids_keeps_the_bf16_limit():
    """Drift rows repeat column ids (Zipf draws with replacement). There the
    two packages' bf16 Gram paths round differently (the reference's panel
    rounds each product of a repeated id, the port the per-column sum —
    ROADMAP Queue 3), so the bf16 runs differ by a bf16 rounding, not by
    float32 noise: held at the reference's bf16 limit (1e-3, bf16 against
    fp32) and nearer each other than to the fp32 run. In fp32 the same
    stream meets the engine tolerances."""
    base = stream_spec(rounds=6, loss_every=3)
    runs = {}
    for prec in ("bf16", "fp32"):
        sch = dataclasses.replace(base.schedule, eta=1.0, delay=2, precision=prec)
        spec = dataclasses.replace(base, schedule=sch)
        runs[prec] = (run_stream(session(spec), spec).current_x(), _j_stream_run(_pair(spec)).current_x())
    np.testing.assert_allclose(runs["fp32"][0], runs["fp32"][1], **X_TOL)
    gap = np.abs(runs["bf16"][0] - runs["bf16"][1]).max()
    assert 0 < gap < 1e-3 and gap < np.abs(runs["bf16"][0] - runs["fp32"][0]).max()


def test_controller_run_matches_the_reference(tmp_path):
    """Swap rounds, versions and the served weights of an
    ``OnlineController`` run equal the reference controller's."""
    spec = stream_spec(rounds=10, loss_every=5, swap_every=3, drift_at=4)
    j = _pair(spec)
    jctrl = JV.OnlineController(J.Session(j), JV.make_stream_source(j), JV.ModelStore(),
                                swap_dir=tmp_path / "j")
    jm = jctrl.run()
    tctrl = OnlineController(session(spec), make_stream_source(spec), store_(),
                             swap_dir=tmp_path / "t")
    tm = tctrl.run()
    assert tctrl.swap_rounds == jctrl.swap_rounds == [3, 6, 9, 10]
    keys = ("rounds_done", "staleness_rounds", "model_version", "swaps", "failed_swaps")
    assert {k: getattr(tm, k) for k in keys} == {k: getattr(jm, k) for k in keys}
    np.testing.assert_allclose(tctrl.store.snapshot().x, jctrl.store.snapshot().x, **X_TOL)
    np.testing.assert_allclose(tm.last_loss, jm.last_loss, **LOSS_TOL)


def test_swap_checkpoints_cross_between_the_packages(tmp_path):
    """Each package's ``ModelStore.swap_from_checkpoint`` loads the
    other's stream-session checkpoint, bit for bit."""
    spec = stream_spec(rounds=8)
    j = _pair(spec)
    tsess = session(spec)
    tsess.step_stream(make_stream_source(spec), 3)
    tsess.save(tmp_path / "t")
    jsess = J.Session(j)
    jsess.step_stream(JV.make_stream_source(j), 3)
    jsess.save(tmp_path / "j")

    jstore = JV.ModelStore()
    snap = jstore.swap_from_checkpoint(tmp_path / "t")
    assert np.array_equal(snap.x, tsess.current_x()) and snap.rounds_done == 3
    assert snap.spec_hash == spec.content_hash()
    tstore = store_()
    snap = tstore.swap_from_checkpoint(tmp_path / "j")
    assert np.array_equal(snap.x, jsess.current_x()) and snap.rounds_done == 3
    assert snap.spec_hash == spec.content_hash()
    x, meta = j_load_model_weights(tmp_path / "t")
    assert np.array_equal(x, load_model_weights(tmp_path / "t")[0]) and meta["rounds_done"] == 3


def _cli(main, argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_serve_cli_writes_the_reference_payload(tmp_path):
    """``python -m repro_torch.launch.serve --spec serve_drift.json
    --rounds 16 --device cpu --out …``: the reference CLI's lines and
    payload keys, and the same counts."""
    argv = ["--spec", str(SERVE_DRIFT), "--rounds", "16"]
    t_lines = _cli(t_serve_cli.main, argv + ["--device", "cpu", "--out", str(tmp_path / "t.json")])
    j_lines = _cli(j_serve_cli.main, argv + ["--out", str(tmp_path / "j.json")])
    got, want = (json.loads((tmp_path / f"{w}.json").read_text()) for w in "tj")

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(got) == keys(want)
    exact = ("rounds_done", "staleness_rounds", "model_version", "swaps", "failed_swaps",
             "predictions_served")
    assert {k: got["metrics"][k] for k in exact} == {k: want["metrics"][k] for k in exact}
    assert got["metrics"]["failed_swaps"] == 0 and got["metrics"]["staleness_rounds"] == 0
    # every line but the walls: [start], [swap ], [probe] (accuracies), [done ] counts
    assert [ln for ln in t_lines if not ln.startswith(("[done ]", "[out  ]"))] == \
           [ln for ln in j_lines if not ln.startswith(("[done ]", "[out  ]"))]
    assert sum(ln.startswith("[swap ]") for ln in t_lines) == 4


def _strip_walls(d):
    if isinstance(d, dict):
        return {k: _strip_walls(v) for k, v in d.items()
                if not k.endswith(("time_s", "_seconds")) and k not in ("losses", "final_loss")}
    if isinstance(d, list):
        return [_strip_walls(v) for v in d]
    return d


def test_sweep_cli_records_match_the_reference(tmp_path):
    """``--plan-only`` records are the reference CLI's, byte for byte; a
    two-point run's records equal apart from walls, with the losses at the
    engine tolerance."""
    specs = ROOT / "examples" / "specs"
    for name in ("rcv1_hybrid.json", "resume_sweep.json", "url_sweep.json"):
        args = ["--spec", str(specs / name), "--plan-only"]
        _cli(t_sweep_cli.main, args + ["--out", str(tmp_path / "tp.json")])
        _cli(j_sweep_cli.main, args + ["--out", str(tmp_path / "jp.json")])
        assert (tmp_path / "tp.json").read_text() == (tmp_path / "jp.json").read_text(), name

    args = ["--spec", str(specs / "resume_sweep.json")]
    t_lines = _cli(t_sweep_cli.main, args + ["--device", "cpu", "--out", str(tmp_path / "t.json")])
    _cli(j_sweep_cli.main, args + ["--out", str(tmp_path / "j.json")])
    got, want = (json.loads((tmp_path / f"{w}.json").read_text()) for w in "tj")
    assert len(got["reports"]) == len(want["reports"]) == 2
    assert _strip_walls(got) == _strip_walls(want)
    for g, w in zip(got["reports"], want["reports"]):
        np.testing.assert_allclose(g["losses"], w["losses"], **LOSS_TOL)
        np.testing.assert_allclose(g["final_loss"], w["final_loss"], **LOSS_TOL)
    assert t_lines[-1].startswith("[done ] sweep: 2 point(s) (2 run, 0 resumed, 0 skipped)")
