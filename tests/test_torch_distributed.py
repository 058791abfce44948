"""The 2D-mesh backend of the port (``repro_torch.core.distributed``, the
``shard_map`` branch of the front door) against the reference's mesh and
the port's simulated engine, modelled on the reference's
tests/test_distributed_subprocess.py, tests/test_precision_tune.py (bf16
on the mesh), tests/test_api.py and tests/test_session.py (the 1×1 mesh).

The port's mesh is SPMD: each check starts p_r·p_c processes that join a
gloo group through a ``file://`` store under ``tmp_path`` and run the same
code on CPU tensors (``device="cpu"``); several checks share one launch.
The reference's outputs come live from ONE JAX subprocess with
``--xla_force_host_platform_device_count=8``, started when the module's
first test starts and read when a comparison needs it — never from the
pinned ``.npz`` files. The port's simulated engine runs in this process.

Tolerances: x and the loss trace within 1e-5 (max abs) of both oracles,
the reference's own limit (its mesh runs the blocked panel walk; on CPU
tensors the port's ``gram="kernel"`` runs the same plain walk). Inside
the port, chunked, restored, timed and streamed runs are held **bitwise**
to the uninterrupted run, and every rank ends with the same bits.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.api as T
from repro.core import distributed as JD
from repro.core.engine import ParallelSGDSchedule as JS
from repro.sparse.synthetic import make_skewed_csr as j_make_skewed_csr
from repro_torch.core import distributed as TD
from repro_torch.core.engine import ParallelSGDSchedule as TS
from repro_torch.core.engine import run_parallel_sgd
from repro_torch.core.teams import stack_row_teams
from repro_torch.costmodel import schedule_comm_volume
from repro_torch.sparse.synthetic import make_skewed_csr

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
EXAMPLES = ROOT / "examples" / "specs"


def _spec(name, p_r, p_c, rounds=3, loss_every=1, delay=0, precision="fp32", eta=0.05, **kw):
    sched = TS.hybrid(p_r, 2, 4, eta, 8, rounds=rounds, loss_every=loss_every, delay=delay,
                      precision=precision)
    return T.ExperimentSpec(dataset="rcv1-sm", schedule=sched, name=name,
                            mesh=T.MeshSpec(p_r=p_r, p_c=p_c, backend="shard_map"), **kw)


# front-door cases, as the reference's wire form (both packages read it)
SPECS = {
    "front2x4": _spec("front2x4", 2, 4),
    "front4x2": _spec("front4x2", 4, 2),
    # η = 1: the delay and the bf16 rounding move x far enough that their
    # controls (the D = 0 and the fp32 run) land well outside the limits
    "delay1": _spec("delay1", 2, 4, delay=1, eta=1.0),
    "delay2": _spec("delay2", 2, 4, delay=2, eta=1.0),
    "sess2x4": _spec("sess2x4", 2, 4, rounds=4, loss_every=2),
    "sqhinge": _spec("sqhinge", 2, 2, objective="squared_hinge", l2=1e-3),
    "lsq": _spec("lsq", 2, 2, objective="least_squares"),
    "bf16": _spec("bf16", 2, 2, precision="bf16", eta=1.0),
    "base2x2": _spec("base2x2", 2, 2),
    "mesh1x1": T.ExperimentSpec(dataset="rcv1-sm", name="mesh1x1",
                                schedule=TS.hybrid(1, 2, 8, 0.05, 8, rounds=4, loss_every=2),
                                mesh=T.MeshSpec(p_r=1, p_c=1, backend="shard_map")),
    "obs_mesh": T.ExperimentSpec.from_json((EXAMPLES / "obs_mesh.json").read_text()),
    "overlap_mesh": T.ExperimentSpec.from_json((EXAMPLES / "overlap_mesh.json").read_text()),
}
SPEC_JSON = {k: v.to_json() for k, v in SPECS.items()}

# direct calls of run_hybrid_distributed on a skewed 256 × 100 matrix:
# key → (p_r, p_c, partitioner, s, b); s = 1 is the FedAvg corner
DIRECT = {
    "skew2x4_cyclic": (2, 4, "cyclic", 2, 4),
    "skew2x4_rows": (2, 4, "rows", 2, 4),
    "skew2x4_nnz": (2, 4, "nnz", 2, 4),
    "skew4x2_cyclic": (4, 2, "cyclic", 2, 4),
    "skew1x8_cyclic": (1, 8, "cyclic", 2, 4),
    "skew8x1_cyclic": (8, 1, "cyclic", 2, 4),
    "fedavg8x1": (8, 1, "rows", 1, 4),
}

# the reference, live: one JAX process with 8 host devices
REFERENCE = """
import json, sys
import jax
import numpy as np
from repro import compat
from repro.api import ExperimentSpec, run
from repro.core import ParallelSGDSchedule
from repro.core.distributed import build_2d_problem, run_hybrid_distributed
from repro.core.problem import make_problem
from repro.sparse.synthetic import make_skewed_csr

out, cases = sys.argv[1], json.loads(open(sys.argv[2]).read())
res = {}
rng = np.random.default_rng(0)
A = make_skewed_csr(256, 100, 12, 0.8, seed=3)
y = np.where(rng.random(256) < 0.5, 1.0, -1.0)
for key, (p_r, p_c, part, s, b) in cases["direct"].items():
    sched = ParallelSGDSchedule.hybrid(p_r, s, b, 0.05, 8, rounds=3, loss_every=1)
    mesh = compat.make_mesh((p_r, p_c), ("rows", "cols"), devices=jax.devices()[: p_r * p_c])
    prob, cp = build_2d_problem(A, y, p_r, p_c, part, row_multiple=s * b)
    gp = make_problem(A, y, row_multiple=s * b)
    x, losses = run_hybrid_distributed(mesh, prob, cp, np.zeros(100, np.float32), sched,
                                       loss_problem=gp)
    res[key + ".x"], res[key + ".losses"] = np.asarray(x), np.asarray(losses)
for key, text in cases["specs"].items():
    rep = run(ExperimentSpec.from_json(text))
    res[key + ".x"], res[key + ".losses"] = rep.x, rep.losses
np.savez(out, **res)
print("REFERENCE_OK", len(res))
"""

# the head and tail of every rank's program; a launch's body goes between
WORKER_HEAD = """
import dataclasses, json, pathlib, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4])
CASES = json.loads(pathlib.Path(sys.argv[5]).read_text())
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))

from repro_torch.api import ExperimentSpec, MeshSpec, Session, StopPolicy, run, sweep
from repro_torch.core import ParallelSGDSchedule
from repro_torch.core.distributed import (
    HybridDriver, build_2d_problem, make_process_mesh, run_hybrid_distributed)
from repro_torch.sparse.synthetic import make_skewed_csr

arrays, info = {}, {}


def spec(key):
    return ExperimentSpec.from_json(CASES["specs"][key])


def skewed():
    rng = np.random.default_rng(0)
    a = make_skewed_csr(256, 100, 12, 0.8, seed=3)
    return a, np.where(rng.random(256) < 0.5, 1.0, -1.0)


def direct(key):
    p_r, p_c, part, s, b = CASES["direct"][key]
    a, y = skewed()
    sched = ParallelSGDSchedule.hybrid(p_r, s, b, 0.05, 8, rounds=3, loss_every=1)
    prob, cp = build_2d_problem(a, y, p_r, p_c, part, row_multiple=s * b)
    x, losses = run_hybrid_distributed(make_process_mesh(p_r, p_c), prob, cp,
                                       np.zeros(a.n, np.float32), sched, device="cpu")
    arrays[key + ".x"], arrays[key + ".losses"] = x, losses


def front(key, the_spec=None):
    rep = run(the_spec or spec(key), device="cpu")
    arrays[key + ".x"], arrays[key + ".losses"] = rep.x, rep.losses
    info[key] = rep.ledger.to_dict()
    return rep
"""

WORKER_TAIL = """
np.savez(out / f"r{rank}.npz", **arrays)
(out / f"r{rank}.json").write_text(json.dumps(info))
dist.destroy_process_group()
"""


def launch(tmp: Path, world: int, body: str, timeout: float = 300.0) -> list:
    """Run ``body`` on ``world`` gloo ranks (CPU tensors, one thread
    each); returns each rank's (arrays, info). A rank that fails stops
    the others and fails the caller with its output."""
    tmp.mkdir(parents=True, exist_ok=True)
    cases = tmp / "cases.json"
    cases.write_text(json.dumps({"specs": SPEC_JSON, "direct": DIRECT}))
    code = WORKER_HEAD + textwrap.dedent(body) + WORKER_TAIL
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(tmp / "store"), str(tmp), str(cases)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
        ))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for log in logs:
        log.close()
    failed = [r for r, p in enumerate(procs) if p.wait() != 0]
    assert not failed, "\n".join(f"--- rank {r}:\n{(tmp / f'rank{r}.log').read_text()[-4000:]}"
                                 for r in failed)
    return [(dict(np.load(tmp / f"r{r}.npz")), json.loads((tmp / f"r{r}.json").read_text()))
            for r in range(world)]


class _Reference:
    """The reference's outputs: started at once, read when first needed."""

    def __init__(self, tmp: Path):
        self.out = tmp / "reference.npz"
        cases = tmp / "ref_cases.json"
        cases.write_text(json.dumps({"specs": SPEC_JSON, "direct": DIRECT}))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
        self.proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(self.out), str(cases)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     env=env)
        self._res = None

    def __getitem__(self, key):
        if self._res is None:
            so, se = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "REFERENCE_OK" in so, f"{so}\n{se[-4000:]}"
            self._res = dict(np.load(self.out))
        return self._res[key]


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    r = _Reference(tmp_path_factory.mktemp("reference"))
    yield r
    if r.proc.poll() is None:
        r.proc.kill()


def _mesh_fixture(world, body):
    @pytest.fixture(scope="module")
    def fixture(tmp_path_factory):
        return launch(tmp_path_factory.mktemp("mesh"), world, body)

    return fixture


mesh2x4 = _mesh_fixture(8, """
for key in ("skew2x4_cyclic", "skew2x4_rows", "skew2x4_nnz"):
    direct(key)
for key in ("front2x4", "delay1", "delay2", "obs_mesh", "overlap_mesh"):
    front(key)

# chunked ≡ monolithic; save at round 3 (off a loss boundary) → restore
full = front("sess2x4")
sess = Session(spec("sess2x4"), device="cpu")
while not sess.done:
    sess.step_rounds(1)
arrays["chunked.x"], arrays["chunked.losses"] = sess.current_x(), np.asarray(sess.losses, np.float32)
half = Session(spec("sess2x4"), device="cpu")
half.step_rounds(3)
half.save(out / "ck")
restored = Session.restore(out / "ck", device="cpu")
info["restored_rounds"] = [restored.rounds_done, restored._driver.rounds_done]
rep = restored.run()
arrays["restored.x"], arrays["restored.losses"] = rep.x, rep.losses
info["restored_stop"] = rep.stop_reason

# advance_stream over the resident arrays ≡ advance
a, y = skewed()
sched = ParallelSGDSchedule.hybrid(2, 2, 4, 0.05, 8, rounds=3)
prob, cp = build_2d_problem(a, y, 2, 4, "cyclic", row_multiple=8)
mesh = make_process_mesh(2, 4)
resident = HybridDriver(mesh, prob, cp, np.zeros(a.n, np.float32), sched, device="cpu")
resident.advance(3)
streamed = HybridDriver(mesh, prob, cp, np.zeros(a.n, np.float32), sched, device="cpu")
for _ in range(3):
    streamed.advance_stream(prob.indices.numpy(), prob.values.numpy())
arrays["advance.x"], arrays["stream.x"] = resident.gather(), streamed.gather()
info["stream_rounds"] = [resident.rounds_done, streamed.rounds_done, streamed.ledger.rounds]
""")

mesh4x2 = _mesh_fixture(8, """
direct("skew4x2_cyclic")
front("front4x2")
""")

mesh1x8 = _mesh_fixture(8, """
direct("skew1x8_cyclic")
""")

mesh8x1 = _mesh_fixture(8, """
direct("skew8x1_cyclic")
direct("fedavg8x1")
""")

mesh2x2 = _mesh_fixture(4, """
for key in ("sqhinge", "lsq", "bf16", "base2x2"):
    front(key)
timed = run(dataclasses.replace(spec("base2x2"), comm_timing=True), device="cpu")
arrays["timed.x"] = timed.x
info["timed_report"] = timed.to_json()

# every rank reaches the same max_seconds verdict at the same boundary
stopped = run(dataclasses.replace(spec("base2x2"), stop=StopPolicy(max_seconds=0.0)), device="cpu")
info["max_seconds"] = [stopped.stop_reason, stopped.rounds_completed]

# a simulated session saved at round 2, reopened on the mesh
if rank == 0:
    sim = Session(dataclasses.replace(spec("base2x2"), mesh=MeshSpec(p_r=2, p_c=2)), device="cpu")
    sim.step_rounds(2)
    sim.save(out / "elastic")
dist.barrier()
el = Session.restore_elastic(out / "elastic", mesh=MeshSpec(p_r=2, p_c=2, backend="shard_map"),
                             device="cpu")
info["elastic_start"] = [el.rounds_done, el._driver.rounds_done, el.spec.mesh.backend]
rep = el.run()
arrays["elastic.x"], arrays["elastic.losses"] = rep.x, rep.losses

# a resumable sweep of two mesh points: rank 0 writes the records
points = [dataclasses.replace(spec("base2x2"), name=f"sweep-{i}",
                              schedule=dataclasses.replace(spec("base2x2").schedule, eta=eta))
          for i, eta in enumerate((0.05, 0.025))]
calls = []
for max_points in (1, None, None):
    res = sweep(points, resume_dir=out / "sweep", max_points=max_points, device="cpu")
    calls.append([res.resumed, len(res.skipped)])
    if max_points == 1:
        arrays["sweep0.x"] = res.reports[0].x  # ran here; a resumed record holds no x
    dist.barrier()
info["sweep"] = calls
info["sweep_files"] = sorted(p.name for p in (out / "sweep").iterdir())

# a failed write on rank 0 (an injected I/O error between the autosave's
# temp write and its rename, which only the writing rank reaches) fails
# the point on every rank; all retry it together from the last autosave
from repro_torch.api import FaultPolicy
from repro_torch.core.faults import FaultEvent, FaultPlan, install
point = dataclasses.replace(spec("base2x2"), name="commit-fault",
                            faults=FaultPolicy(autosave_every=1, max_retries=1))
clean = sweep([point], resume_dir=out / "clean", device="cpu")
with install(FaultPlan(events=[FaultEvent(kind="io_error", site="commit", at=2)])) as inj:
    faulted = sweep([point], resume_dir=out / "faulted", device="cpu")
for name, res in (("clean", clean), ("faulted", faulted)):
    arrays[name + ".x"], arrays[name + ".losses"] = res.reports[0].x, res.reports[0].losses
info["commit_fault"] = [clean.attempts, faulted.attempts, len(faulted.quarantined),
                        [list(f) for f in inj.fired]]
""")


def _sim(key: str | None = None, spec=None):
    """The port's simulated engine on the same spec (this process)."""
    spec = SPECS[key] if spec is None else spec
    mesh = dataclasses.replace(spec.mesh, backend="simulated")
    return T.run(dataclasses.replace(spec, mesh=mesh), device="cpu")


def _skewed():
    rng = np.random.default_rng(0)
    a = make_skewed_csr(256, 100, 12, 0.8, seed=3)
    return a, np.where(rng.random(256) < 0.5, 1.0, -1.0)


def _sim_direct(key: str):
    p_r, _, _, s, b = DIRECT[key]
    a, y = _skewed()
    tp = stack_row_teams(a, y, p_r, row_multiple=s * b, device="cpu")
    x, _ = run_parallel_sgd(tp, torch.zeros(a.n), TS.hybrid(p_r, s, b, 0.05, 8, rounds=3))
    return x.numpy()


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert gap < TOL, f"{what}: max |Δ| = {gap}"


def _all_ranks_equal(runs, key):
    for arrays, _ in runs[1:]:
        assert np.array_equal(arrays[key], runs[0][0][key]), key


# ---------------- layout: build / scatter / gather ----------------


@pytest.mark.parametrize("partitioner", ["cyclic", "rows", "nnz"])
def test_build_2d_problem_scatter_gather_match_reference(partitioner):
    a, y = _skewed()
    ja = j_make_skewed_csr(256, 100, 12, 0.8, seed=3)
    jprob, jcp = JD.build_2d_problem(ja, y, 2, 4, partitioner, row_multiple=8)
    tprob, tcp = TD.build_2d_problem(a, y, 2, 4, partitioner, row_multiple=8)
    assert (tprob.p_r, tprob.p_c, tprob.m, tprob.n, tprob.n_loc, tprob.rows_local, tprob.width) == (
        jprob.p_r, jprob.p_c, jprob.m, jprob.n, jprob.n_loc, jprob.rows_local, jprob.width)
    assert tprob.indices.dtype == torch.int32 and tprob.values.dtype == torch.float32
    assert np.array_equal(tprob.indices.numpy(), np.asarray(jprob.indices))
    assert np.array_equal(tprob.values.numpy(), np.asarray(jprob.values))
    assert np.array_equal(tprob.col_sizes.numpy(), np.asarray(jprob.col_sizes))
    assert np.array_equal(tcp.order, jcp.order) and np.array_equal(tcp.starts, jcp.starts)
    x = np.random.default_rng(1).standard_normal(100).astype(np.float32)
    pad = TD.scatter_x(x, tcp, tprob.n_loc)
    assert np.array_equal(pad, JD.scatter_x(x, jcp, jprob.n_loc))
    assert np.array_equal(TD.gather_x(pad, tcp, tprob.n_loc, 100), x)
    assert np.array_equal(TD.gather_x(pad, tcp, tprob.n_loc, 100),
                          JD.gather_x(pad, jcp, jprob.n_loc, 100))


@pytest.mark.parametrize("case", ["fp32", "bf16", "delay2", "fedavg", "l2"])
def test_hybrid_comm_ledger_matches_reference(case):
    """The mesh round body's captured rates equal the reference's
    (``eval_shape`` there, meta tensors here) field for field."""
    a, y = _skewed()
    ja = j_make_skewed_csr(256, 100, 12, 0.8, seed=3)
    kw = {"fp32": {}, "bf16": dict(precision="bf16"), "delay2": dict(delay=2),
          "fedavg": {}, "l2": {}}[case]
    s = 1 if case == "fedavg" else 2
    obj = "squared_hinge" if case == "l2" else "logistic"
    jprob, _ = JD.build_2d_problem(ja, y, 2, 4, "cyclic", row_multiple=s * 4, objective=obj)
    tprob, _ = TD.build_2d_problem(a, y, 2, 4, "cyclic", row_multiple=s * 4, objective=obj)
    jl = JD.hybrid_comm_ledger(jprob, JS.hybrid(2, s, 4, 0.05, 8, rounds=3, **kw))
    tl = TD.hybrid_comm_ledger(tprob, TS.hybrid(2, s, 4, 0.05, 8, rounds=3, **kw))
    assert [r.to_dict() for r in tl.rates] == [r.to_dict() for r in jl.rates]
    assert tl.delay == jl.delay
    assert tl.to_dict() == jl.to_dict()


# ---------------- the mesh against both oracles ----------------


@pytest.mark.parametrize("key, fixture", [
    ("skew2x4_cyclic", "mesh2x4"), ("skew2x4_rows", "mesh2x4"), ("skew2x4_nnz", "mesh2x4"),
    ("skew4x2_cyclic", "mesh4x2"), ("skew1x8_cyclic", "mesh1x8"), ("skew8x1_cyclic", "mesh8x1"),
])
def test_mesh_matches_simulated_and_reference(key, fixture, request, ref):
    runs = request.getfixturevalue(fixture)
    got = runs[0][0]
    _close(got[key + ".x"], _sim_direct(key), f"{key} x vs simulated")
    _close(got[key + ".x"], ref[key + ".x"], f"{key} x vs reference")
    _close(got[key + ".losses"], ref[key + ".losses"], f"{key} losses vs reference")
    assert got[key + ".losses"].shape == (3,)
    _all_ranks_equal(runs, key + ".x")


def test_fedavg_corner_8x1(mesh8x1, ref):
    """p_c = 1, s = 1: the mesh runs FedAvg (with the full (G, v) per
    bundle, no SpMV special case) and lands on the simulated FedAvg."""
    got = mesh8x1[0][0]
    _close(got["fedavg8x1.x"], _sim_direct("fedavg8x1"), "FedAvg x vs simulated")
    _close(got["fedavg8x1.x"], ref["fedavg8x1.x"], "FedAvg x vs reference")
    _close(got["fedavg8x1.losses"], ref["fedavg8x1.losses"], "FedAvg losses vs reference")


@pytest.mark.parametrize("key, fixture", [("front2x4", "mesh2x4"), ("front4x2", "mesh4x2")])
def test_front_door_backend_parity(key, fixture, request, ref):
    got = request.getfixturevalue(fixture)[0][0]
    sim = _sim(key)
    assert sim.losses.shape == (3,)
    for oracle, x, losses in (("simulated", sim.x, sim.losses), ("reference", ref[key + ".x"],
                                                                 ref[key + ".losses"])):
        _close(got[key + ".x"], x, f"{key} x vs {oracle}")
        _close(got[key + ".losses"], losses, f"{key} losses vs {oracle}")


@pytest.mark.parametrize("key, fixture", [("front2x4", "mesh2x4"), ("front4x2", "mesh4x2")])
def test_comm_ledger_backend_parity(key, fixture, request):
    """The mesh Session's ledger (captured from the round body the mesh
    runs) is the simulated Session's, and both are the Table 2–3 closed
    form."""
    info = request.getfixturevalue(fixture)[0][1]
    mesh_ledger = T.CommLedger.from_dict(info[key])
    sim = _sim(key).ledger
    assert mesh_ledger.rates == sim.rates and mesh_ledger.rounds == sim.rounds == 3
    counted = mesh_ledger.counted_words()
    assert counted == sim.counted_words()
    spec = SPECS[key]
    cv = schedule_comm_volume(T.dataset_stats("rcv1-sm").n, spec.mesh.p_r, spec.mesh.p_c, 2, 4, 8,
                              rounds=3)
    assert counted == cv.words_dict()


@pytest.mark.parametrize("key", ["sqhinge", "lsq"])
def test_objective_parity_2x2(key, mesh2x2, ref):
    got = mesh2x2[0][0]
    sim = _sim(key)
    _close(got[key + ".x"], sim.x, f"{key} x vs simulated")
    _close(got[key + ".losses"], sim.losses, f"{key} losses vs simulated")
    _close(got[key + ".x"], ref[key + ".x"], f"{key} x vs reference")
    _close(got[key + ".losses"], ref[key + ".losses"], f"{key} losses vs reference")


@pytest.mark.parametrize("delay", [1, 2])
def test_delayed_pipeline_backend_parity(delay, mesh2x4, ref):
    key = f"delay{delay}"
    got, info = mesh2x4[0]
    sim = _sim(key)
    _close(got[key + ".x"], sim.x, f"{key} x vs simulated")
    _close(got[key + ".losses"], sim.losses, f"{key} losses vs simulated")
    _close(got[key + ".x"], ref[key + ".x"], f"{key} x vs reference")
    _close(got[key + ".losses"], ref[key + ".losses"], f"{key} losses vs reference")
    # the delay is live: the D = 0 run of the same spec lands ≥ 100× further
    # from the port's mesh than the reference's mesh does
    d0 = dataclasses.replace(SPECS[key], schedule=dataclasses.replace(SPECS[key].schedule, delay=0))
    gap = np.abs(_sim(spec=d0).x - got[key + ".x"]).max()
    assert gap > 100 * np.abs(got[key + ".x"] - ref[key + ".x"]).max() and gap > 0
    led = T.CommLedger.from_dict(info[key])
    assert led.delay == sim.ledger.delay == delay
    assert led.counted_words() == sim.ledger.counted_words()


def test_bf16_backend_parity_2x2(mesh2x2, ref):
    """bf16 on the mesh: the wire cast around the real sum, as the
    simulated engine casts around its identity; the ledger prices the
    (G, v) site at 2-byte words and the weight average at 4."""
    got, info = mesh2x2[0]
    sim = _sim("bf16")
    _close(got["bf16.x"], sim.x, "bf16 x vs simulated")
    _close(got["bf16.losses"], sim.losses, "bf16 losses vs simulated")
    _close(got["bf16.x"], ref["bf16.x"], "bf16 x vs reference")
    _close(got["bf16.losses"], ref["bf16.losses"], "bf16 losses vs reference")
    # the rounding is live: the fp32 run of the same spec lands ≥ 100×
    # further from the port's mesh than the reference's mesh does
    fp32 = dataclasses.replace(SPECS["bf16"],
                               schedule=dataclasses.replace(SPECS["bf16"].schedule, precision="fp32"))
    gap = np.abs(_sim(spec=fp32).x - got["bf16.x"]).max()
    assert gap > 100 * np.abs(got["bf16.x"] - ref["bf16.x"]).max() and gap > 0
    led = T.CommLedger.from_dict(info["bf16"])
    assert led.rates == sim.ledger.rates
    gram = [r for r in led.rates if r.axis == "cols" and r.span > 1]
    sync = [r for r in led.rates if r.axis == "rows" and r.span > 1]
    assert gram and all(r.word_bytes == 2 for r in gram)
    assert sync and all(r.word_bytes == 4 for r in sync)


def test_timed_mesh_run_measures_and_calibrates(mesh2x2):
    got, info = mesh2x2[0]
    assert np.array_equal(got["timed.x"], got["base2x2.x"])  # timing never moves an iterate
    assert T.CommLedger.from_dict(info["base2x2"]).round_seconds == []
    timed = T.RunReport.from_json(info["timed_report"])
    assert len(timed.ledger.round_seconds) == 3 and timed.ledger.seconds_per_round > 0
    assert set(timed.ledger.phase_seconds) == {"bundle_compute", "allreduce_gv", "param_avg"}
    pt = timed.calibration_point()
    assert pt is not None and pt.bytes_per_round > 0
    pl = T.plan(SPECS["base2x2"], calibration=T.calibrate([pt]))
    assert pl.calibrated and pl.cost.total > 0


def test_every_rank_agrees(mesh2x2, mesh2x4):
    """Every rank returns the same bits and reaches the same stop verdict
    (``max_seconds`` reads a wall the ranks agree on)."""
    for runs in (mesh2x2, mesh2x4):
        for key in runs[0][0]:
            _all_ranks_equal(runs, key)
    verdicts = {tuple(info["max_seconds"]) for _, info in mesh2x2}
    assert verdicts == {("max_seconds", 1)}


# ---------------- lifecycle on the mesh: bitwise ----------------


def test_session_mesh_chunked_and_resume_bitwise(mesh2x4, ref):
    got, info = mesh2x4[0]
    for what in ("chunked", "restored"):
        assert np.array_equal(got[what + ".x"], got["sess2x4.x"]), what
        assert np.array_equal(got[what + ".losses"], got["sess2x4.losses"]), what
    assert info["restored_rounds"] == [3, 3] and info["restored_stop"] == "rounds"
    _close(got["sess2x4.x"], ref["sess2x4.x"], "sess2x4 x vs reference")
    _close(got["sess2x4.x"], _sim("sess2x4").x, "sess2x4 x vs simulated")


def test_advance_stream_over_resident_arrays_is_advance(mesh2x4):
    got, info = mesh2x4[0]
    assert np.array_equal(got["stream.x"], got["advance.x"])
    assert np.abs(got["advance.x"]).max() > 0
    assert info["stream_rounds"] == [3, 3, 3]


def test_restore_elastic_onto_the_mesh(mesh2x2):
    """A simulated checkpoint reopened on a shard_map mesh of the same
    geometry continues the same trajectory (p_c is communication-only)."""
    got, info = mesh2x2[0]
    assert info["elastic_start"] == [2, 2, "shard_map"]
    sim = _sim("base2x2")
    _close(got["elastic.x"], sim.x, "elastic x vs simulated uninterrupted")
    _close(got["elastic.losses"], sim.losses, "elastic losses vs simulated uninterrupted")


def test_failed_rank0_write_retries_every_rank_bitwise(mesh2x2):
    """A commit fault fires on rank 0 alone (the writing rank); every rank
    fails the point, retries it from the round-1 autosave, and ends with
    the bits of the run without the fault."""
    for r, (got, info) in enumerate(mesh2x2):
        clean_attempts, attempts, quarantined, fired = info["commit_fault"]
        assert clean_attempts == [1] and attempts == [2] and quarantined == 0, (r, info["commit_fault"])
        assert fired == ([["io_error", "commit", 2]] if r == 0 else []), (r, fired)
        assert np.array_equal(got["faulted.x"], got["clean.x"]), r
        assert np.array_equal(got["faulted.losses"], got["clean.losses"]), r
    assert np.array_equal(mesh2x2[0][0]["clean.x"], mesh2x2[0][0]["base2x2.x"])


def test_sweep_of_mesh_points_resumes(mesh2x2):
    got, info = mesh2x2[0]
    assert info["sweep"] == [[[False], 1], [[True, False], 0], [[True, True], 0]]
    records = [f for f in info["sweep_files"] if f.endswith(".report.json")]
    assert len(records) == 2 and not [f for f in info["sweep_files"] if "autosave" in f]
    assert np.array_equal(got["sweep0.x"], got["base2x2.x"])  # point 0 is the base spec


@pytest.mark.parametrize("key", ["obs_mesh", "overlap_mesh"])
def test_example_mesh_specs_run(key, mesh2x4, ref):
    got, info = mesh2x4[0]
    sim = _sim(key)
    _close(got[key + ".x"], sim.x, f"{key} x vs simulated")
    _close(got[key + ".losses"], sim.losses, f"{key} losses vs simulated")
    _close(got[key + ".x"], ref[key + ".x"], f"{key} x vs reference")
    _close(got[key + ".losses"], ref[key + ".losses"], f"{key} losses vs reference")
    led = T.CommLedger.from_dict(info[key])
    assert len(led.round_seconds) == 6 and led.exposed_comm_s is not None
    assert led.delay == SPECS[key].schedule.delay


# ---------------- the 1×1 mesh in this process; refusals ----------------


def test_shard_map_refused_without_a_fitting_group(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        T.run(SPECS["mesh1x1"], device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="4 devices"):
            T.Session(SPECS["base2x2"], device="cpu")
    finally:
        dist.destroy_process_group()


def test_shard_map_1x1_in_process(tmp_path, ref):
    """The whole shard_map path on a world-size-1 group: run ≡ simulated,
    save → restore mid-run ≡ uninterrupted, bitwise."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        spec = SPECS["mesh1x1"]
        full = T.run(spec, device="cpu")
        assert full.backend == "shard_map" and full.losses.shape == (2,)
        sess = T.Session(spec, device="cpu")
        sess.step_rounds(3)  # not a loss boundary
        sess.save(tmp_path / "ck")
        rep = T.Session.restore(tmp_path / "ck", device="cpu").run()
        assert np.array_equal(rep.x, full.x) and np.array_equal(rep.losses, full.losses)
    finally:
        dist.destroy_process_group()
    sim = _sim("mesh1x1")
    _close(full.x, sim.x, "1x1 x vs simulated")
    _close(full.losses, sim.losses, "1x1 losses vs simulated")
    _close(full.x, ref["mesh1x1.x"], "1x1 x vs reference")
    _close(full.losses, ref["mesh1x1.losses"], "1x1 losses vs reference")
