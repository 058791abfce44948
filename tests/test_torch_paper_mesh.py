"""The paper's 2D grid on its datasets: the port's mesh at (1, 4), (2, 2)
and (4, 1) on news20-sm, epsilon-sm and url-sm.

A mesh rank lays out its own ELL block alone (``build_2d_problem(...,
block=(i, j))``, which ``build_problem`` and ``Session`` call on the mesh).
The block must be bitwise the ``[i, j]`` slice of the port's whole layout
and of the reference's ``build_2d_problem``, with the same ``rows_local``,
``width`` (the widest row of ANY block) and ``n_loc``, under every
partitioner.

``run(spec)`` with ``backend="shard_map"`` then runs in ONE gloo group of
four CPU processes (each file-store rank runs the nine (dataset, shape)
specs, CPU tensors: the kernels' plain versions), held within ``TOL`` (max
abs, x and the loss trace) of the reference's live ``run(spec)`` on a
four-host-device ``shard_map`` (ONE JAX process, started with the module;
``gram="blocked"``: interpret-mode Pallas is slow at url-sm's width) and
of the port's simulated engine at the same p_r; the simulated engine at
another p_r must miss that limit. Every rank must end with the same bits.
"""

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro_torch.api as T
from repro.core import distributed as JD
from repro.sparse.csr import CSRMatrix as JCSR
from repro_torch.core import distributed as TD
from repro_torch.core.engine import ParallelSGDSchedule as TS
from repro_torch.sparse.synthetic import make_dataset

ROOT = Path(__file__).resolve().parents[1]
PAPER_SM = ("news20-sm", "epsilon-sm", "url-sm")
SHAPES = ((1, 4), (2, 2), (4, 1))
PARTITIONERS = ("cyclic", "rows", "nnz")
TOL = 1e-5
ROW_MULTIPLE = 16  # s·b of the runs below
# the reference's plain panel walk: url-sm's 131,072 columns in 16 panels
BK = 8192


def _key(name: str, p_r: int, p_c: int) -> str:
    return f"{name}-{p_r}x{p_c}"


def _spec(name: str, p_r: int, p_c: int, backend: str = "shard_map", gram: str = "kernel"):
    sched = TS.hybrid(p_r, 2, 8, 1.0, 8, rounds=2, loss_every=1, p_c=p_c, gram=gram,
                      bk=BK if gram == "blocked" else 512)
    return T.ExperimentSpec(dataset=name, schedule=sched, name=_key(name, p_r, p_c),
                            mesh=T.MeshSpec(p_r=p_r, p_c=p_c, backend=backend))


CASES = {_key(name, *shape): _spec(name, *shape).to_json() for name in PAPER_SM for shape in SHAPES}
REF_CASES = {_key(name, *shape): _spec(name, *shape, gram="blocked").to_json()
             for name in PAPER_SM for shape in SHAPES}

# the reference, live: one JAX process with 4 host devices
REFERENCE = """
import json, sys
import numpy as np
from repro.api import ExperimentSpec, run

out, cases = sys.argv[1], json.loads(open(sys.argv[2]).read())
res = {}
for key, text in cases.items():
    rep = run(ExperimentSpec.from_json(text))
    res[key + ".x"], res[key + ".losses"] = rep.x, rep.losses
np.savez(out, **res)
print("REFERENCE_OK", len(res))
"""

# each rank: every case through run(spec), then a Session of each case
# reports which block it holds
RANK = """
import json, pathlib, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4])
cases = json.loads(pathlib.Path(sys.argv[5]).read_text())
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))
from repro_torch.api import ExperimentSpec, Session, run

arrays, info = {}, {}
for key, text in cases.items():
    spec = ExperimentSpec.from_json(text)
    rep = run(spec, device="cpu")
    arrays[key + ".x"], arrays[key + ".losses"] = rep.x, rep.losses
    sess = Session(spec, device="cpu")
    prob, p_r, p_c = sess.bundle.prob2d, spec.mesh.p_r, spec.mesh.p_c
    refused = 0
    for i in range(p_r):
        for j in range(p_c):
            if (i, j) != prob.block:
                try:
                    prob.rank_block(i, j)
                except ValueError:
                    refused += 1
    info[key] = {"block": list(prob.block), "shape": list(prob.indices.shape),
                 "device_shape": list(sess._driver._idx.shape), "refused": refused,
                 "rows_local": prob.rows_local, "width": prob.width, "n_loc": prob.n_loc}
np.savez(out / f"r{rank}.npz", **arrays)
(out / f"r{rank}.json").write_text(json.dumps(info))
dist.destroy_process_group()
"""


class _Ranks:
    """The four ranks of one gloo group (CPU tensors, one thread each),
    started at once; ``results()`` waits for them and returns each rank's
    (arrays, info). A rank that fails stops the others and fails the
    caller with its output."""

    def __init__(self, tmp: Path, world: int = 4):
        self.tmp, self.world = tmp, world
        cases = tmp / "cases.json"
        cases.write_text(json.dumps(CASES))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        self.logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(world), str(tmp / "store"), str(tmp), str(cases)],
            stdout=self.logs[r], stderr=subprocess.STDOUT, env=env) for r in range(world)]
        self._res = None

    def results(self, timeout: float = 300.0) -> list:
        if self._res is None:
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs) or time.monotonic() > deadline:
                    self.kill()
                    break
                time.sleep(0.05)
            for log in self.logs:
                log.close()
            failed = [r for r, p in enumerate(self.procs) if p.wait() != 0]
            assert not failed, "\n".join(f"--- rank {r}:\n{(self.tmp / f'rank{r}.log').read_text()[-4000:]}"
                                         for r in failed)
            self._res = [(dict(np.load(self.tmp / f"r{r}.npz")), json.loads((self.tmp / f"r{r}.json").read_text()))
                         for r in range(self.world)]
        return self._res

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()


class _Reference:
    """The reference's outputs: started at once, read when first needed."""

    def __init__(self, tmp: Path):
        self.out = tmp / "reference.npz"
        cases = tmp / "ref_cases.json"
        cases.write_text(json.dumps(REF_CASES))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        self.proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(self.out), str(cases)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        self._res = None

    def __getitem__(self, key):
        if self._res is None:
            so, se = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "REFERENCE_OK" in so, f"{so}\n{se[-4000:]}"
            self._res = dict(np.load(self.out))
        return self._res[key]


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The reference's process and the four ranks, started with the
    module's first test: they run beside the layout tests."""
    r = _Reference(tmp_path_factory.mktemp("reference"))
    m = _Ranks(tmp_path_factory.mktemp("paper_mesh"))
    yield r, m
    m.kill()
    if r.proc.poll() is None:
        r.proc.kill()


@pytest.fixture(scope="module")
def ref(started):
    return started[0]


@pytest.fixture(scope="module")
def ranks(started):
    return started[1].results()


@functools.lru_cache(maxsize=None)
def _dataset(name: str):
    return make_dataset(name, seed=0)


@functools.lru_cache(maxsize=None)
def _simulated(name: str, p_r: int):
    """The port's simulated engine at p_r (p_c is communication only)."""
    return T.run(_spec(name, p_r, 1, backend="simulated"), device="cpu")


def _bits(t) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(t))
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


SHAPE_IDS = [f"{p_r}x{p_c}" for p_r, p_c in SHAPES]


@pytest.mark.parametrize("partitioner", PARTITIONERS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("name", PAPER_SM)
def test_rank_block_is_bitwise_the_whole_layouts_slice(name, shape, partitioner):
    ds = _dataset(name)
    p_r, p_c = shape
    a = ds.A
    want, want_cp = JD.build_2d_problem(JCSR(a.indptr, a.indices, a.data, a.shape), ds.y, p_r, p_c,
                                        partitioner, row_multiple=ROW_MULTIPLE)
    whole, cp = TD.build_2d_problem(a, ds.y, p_r, p_c, partitioner, row_multiple=ROW_MULTIPLE)
    dims = (want.rows_local, want.width, want.n_loc)
    assert whole.block is None and (whole.rows_local, whole.width, whole.n_loc) == dims
    want_idx, want_val = np.asarray(want.indices), np.asarray(want.values)
    for i in range(p_r):
        for j in range(p_c):
            blk, blk_cp = TD.build_2d_problem(a, ds.y, p_r, p_c, partitioner, row_multiple=ROW_MULTIPLE,
                                              block=(i, j))
            assert blk.block == (i, j) and tuple(blk.indices.shape) == (want.rows_local, want.width)
            assert (blk.rows_local, blk.width, blk.n_loc, blk.p_r, blk.p_c, blk.m, blk.n) == (
                *dims, p_r, p_c, a.m, a.n)
            assert np.array_equal(blk.col_sizes.numpy(), np.asarray(want.col_sizes))
            assert np.array_equal(blk_cp.order, want_cp.order) and np.array_equal(blk_cp.starts, want_cp.starts)
            assert np.array_equal(_bits(blk.indices), _bits(whole.indices[i, j]))
            assert np.array_equal(_bits(blk.values), _bits(whole.values[i, j]))
            assert np.array_equal(_bits(blk.indices), _bits(want_idx[i, j]))
            assert np.array_equal(_bits(blk.values), _bits(want_val[i, j]))
            idx, val = blk.rank_block(i, j)
            assert idx is blk.indices and val is blk.values
            with pytest.raises(ValueError, match="holds only block"):
                blk.rank_block((i + 1) % p_r, (j + 1) % p_c)


CASE_IDS = [_key(name, *shape) for name in PAPER_SM for shape in SHAPES]
CASE_ARGS = [(name, *shape) for name in PAPER_SM for shape in SHAPES]


def _mesh_run(ranks, key):
    xs = [arrays[key + ".x"] for arrays, _ in ranks]
    losses = [arrays[key + ".losses"] for arrays, _ in ranks]
    for r in range(1, len(ranks)):
        assert np.array_equal(_bits(xs[r]), _bits(xs[0])), f"rank {r} gathered other bits"
        assert np.array_equal(_bits(losses[r]), _bits(losses[0])), f"rank {r} reported other losses"
    return xs[0], losses[0]


@pytest.mark.parametrize("name,p_r,p_c", CASE_ARGS, ids=CASE_IDS)
def test_mesh_run_matches_the_reference(ranks, ref, name, p_r, p_c):
    key = _key(name, p_r, p_c)
    x, losses = _mesh_run(ranks, key)
    assert np.abs(x).max() > 100 * TOL
    np.testing.assert_allclose(x, ref[key + ".x"], rtol=0, atol=TOL)
    np.testing.assert_allclose(losses, ref[key + ".losses"], rtol=0, atol=TOL)


@pytest.mark.parametrize("name,p_r,p_c", CASE_ARGS, ids=CASE_IDS)
def test_mesh_run_matches_the_simulated_engine(ranks, name, p_r, p_c):
    x, losses = _mesh_run(ranks, _key(name, p_r, p_c))
    sim = _simulated(name, p_r)
    np.testing.assert_allclose(x, sim.x, rtol=0, atol=TOL)
    np.testing.assert_allclose(losses, sim.losses, rtol=0, atol=TOL)
    # the control: another p_r re-teams the rows and must miss the limit
    other = _simulated(name, 2 if p_r != 2 else 4)
    assert np.abs(x - other.x).max() > 10 * TOL


@pytest.mark.parametrize("name,p_r,p_c", CASE_ARGS, ids=CASE_IDS)
def test_a_rank_holds_only_its_own_block(ranks, name, p_r, p_c):
    key = _key(name, p_r, p_c)
    whole, _ = TD.build_2d_problem(_dataset(name).A, _dataset(name).y, p_r, p_c, "cyclic",
                                   row_multiple=ROW_MULTIPLE)
    for rank, (_, info) in enumerate(ranks):
        got = info[key]
        assert got["block"] == [rank // p_c, rank % p_c]
        assert got["shape"] == got["device_shape"] == [whole.rows_local, whole.width]
        assert (got["rows_local"], got["width"], got["n_loc"]) == (whole.rows_local, whole.width, whole.n_loc)
        assert got["refused"] == p_r * p_c - 1
