"""The model mesh of the port (``repro_torch.models.sharding``,
``models/moe_ep.py``, ``optim/hybrid2d.py``, ``launch/mesh.py``, the mesh
branches of ``train/loop.py`` and ``launch/steps.py``) against the
reference's.

The port is SPMD over ``torch.distributed``: each launch starts 2, 4 or 8
processes that join a gloo group through a ``file://`` store and run CPU
tensors; every mesh of one world size runs in the same launch. The
reference's outputs come live from ONE JAX subprocess with 8 host devices,
started with the module and read when a comparison needs it. Both sides
read the same inputs: the port's parameters (``init_params`` from a seed)
written as numpy arrays, and numpy token ids.

Where JAX cannot run the reference's mesh — the (2, 2, 2) pod/data/model
mesh (XLA's SPMD partitioner aborts) and the MoE under pods (``moe_ep``
nested in the pod ``shard_map`` fails to lower) — the port is held against
the FedAvg identity the reference's own hybrid test uses: each pod's
single-device SGD step through the reference's ``lm_loss``, then the mean;
and against the port's own (2, 1, 1) run.

Tolerances: specs and ``_dispatch_slots`` equal; ``moe_ep`` within 1e-4
relative (the reference's own test); the hybrid step, its sync,
``train(mesh=...)`` and the FedAvg identity within rtol = atol = 2e-4 (the
reference's hybrid test); resume ≡ uninterrupted bitwise on the CPU; a
synchronous mesh step's gradients within 1e-5 of the single-device step's
largest entry (float32 sums over the shards in another order).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import sharding as JS
from repro.models.moe_ep import _dispatch_slots as j_dispatch_slots
from repro_torch._tree import path_key, tree_paths
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.models import init_params, param_pspecs, params_to_numpy
from repro_torch.models import sharding as TS
from repro_torch.models.config import MoEConfig
from repro_torch.models.moe_ep import _dispatch_slots as t_dispatch_slots

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
MOE_RTOL = 1e-4

P3 = ("pod", "data", "model")
# the hybrid step and sync on every mesh the reference runs: key → (arch, shape, axes)
HYBRID = {
    "qwen_211": ("qwen2.5-3b", (2, 1, 1), P3),
    "qwen_221": ("qwen2.5-3b", (2, 2, 1), P3),
    "qwen_212": ("qwen2.5-3b", (2, 1, 2), P3),
    "qwen_24": ("qwen2.5-3b", (2, 4), ("pod", "data")),
    "gemma_212": ("gemma-2b", (2, 1, 2), P3),
    "mamba_221": ("falcon-mamba-7b", (2, 2, 1), P3),
}
# the meshes the reference cannot run, held against the FedAvg identity
FEDAVG = {
    "qwen_222": ("qwen2.5-3b", (2, 2, 2), P3),
    "deepseek_212": ("deepseek-v2-lite-16b", (2, 1, 2), P3),
    "deepseek_211": ("deepseek-v2-lite-16b", (2, 1, 1), P3),
}
# moe_ep against the reference's: key → (arch, x shape, mesh shape, cf or None)
MOE = {
    "ep": ("deepseek-v2-lite-16b", (2, 16), (2, 4), 8.0),
    "fallback": ("granite-3", (2, 16), (2, 4), None),
    "decode": ("deepseek-v2-lite-16b", (2, 1), (1, 8), 8.0),
    "drops": ("deepseek-8", (2, 16), (1, 8), 2.0),
}
ARCHS = sorted({a for a, *_ in HYBRID.values()} | {a for a, *_ in FEDAVG.values()} | {"deepseek-v2-lite-16b"})
TRAIN = dict(steps=4, batch=4, seq_len=16, tau=2)


def _cfg(arch):
    if arch == "granite-3":  # the reference's fallback case: 3 experts on a 4-way model axis
        return dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")),
                                   moe=MoEConfig(n_experts=3, top_k=2, d_ff_expert=64))
    if arch == "deepseek-8":  # 8 experts, one a rank of 8: cf = 2 drops copies
        return dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1))
    return reduced(get_config(arch))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The numpy inputs both sides read: each arch's parameters (the port's
    ``init_params``, seed 0), token ids for the hybrid and FedAvg cases and
    the MoE inputs."""
    root = tmp_path_factory.mktemp("inputs")
    for arch in ARCHS + ["granite-3", "deepseek-8"]:
        cfg = _cfg(arch)
        flat = {path_key(p): a for p, a in tree_paths(params_to_numpy(init_params(cfg, dtype=torch.float32,
                                                                                  device="cpu", seed=0)))}
        np.savez(root / f"{arch}.npz", **flat)
    rng = np.random.default_rng(1)
    data = {"tokens": rng.integers(0, 512, (8, 16)).astype(np.int32)}
    for key, (arch, xs, _, _) in MOE.items():
        data[f"x_{key}"] = rng.standard_normal(xs + (_cfg(arch).d_model,)).astype(np.float32)
    np.savez(root / "data.npz", **data)
    return root


REFERENCE = r'''
import dataclasses, json, sys
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import REGISTRY, get_config, reduced
from repro.models import sharding as JS
from repro.models.config import MoEConfig
from repro.models.init import init_params, param_pspecs
from repro.models.moe_ep import moe_ep
from repro.models.transformer import lm_loss
from repro.optim.hybrid2d import make_hybrid_train_step, make_sync_step, stack_for_pods
from repro.optim.sgd import sgd

inp, out = Path(sys.argv[1]), Path(sys.argv[2])
cases = json.loads(sys.argv[3])
data = np.load(inp / "data.npz")
tokens = jnp.asarray(data["tokens"])
targets = jnp.roll(tokens, -1, axis=1)
res = {}


def cfg_of(arch):
    if arch == "granite-3":
        return dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")),
                                   moe=MoEConfig(n_experts=3, top_k=2, d_ff_expert=64))
    if arch == "deepseek-8":
        return dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1))
    return reduced(get_config(arch))


def carried(arch):
    """The port's parameters, in the reference's tree (the shapes of its own init)."""
    cfg = cfg_of(arch)
    flat = np.load(inp / f"{arch}.npz")
    shape = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    leaves, tdef = jax.tree_util.tree_flatten_with_path(shape)
    key = lambda path: "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
    return jax.tree_util.tree_unflatten(tdef, [jnp.asarray(flat[key(p)]) for p, _ in leaves])


def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = np.asarray(leaf)


# (vi) train(mesh=...): run A writes its step-2 checkpoint (the port resumes
# from it), run B is uninterrupted; the init is the port's parameters
import repro.train.loop as L
tcfg = cfg_of("qwen2.5-3b")
L.init_params = lambda cfg, key, dtype=jnp.float32: carried("qwen2.5-3b")
mesh = compat.make_mesh((2, 1, 2), ("pod", "data", "model"), devices=jax.devices()[:4])
tr = cases["train"]
with compat.set_mesh(mesh):
    L.train(tcfg, steps=2, batch=tr["batch"], seq_len=tr["seq_len"], tau=tr["tau"], mesh=mesh, log_every=1,
            checkpoint_dir=str(out / "ref_ckpt"), checkpoint_every=2)
    (out / "ref_ckpt_ready").write_text("1")
    rep = L.train(tcfg, steps=tr["steps"], batch=tr["batch"], seq_len=tr["seq_len"], tau=tr["tau"], mesh=mesh,
                  log_every=1)
res["train.losses"] = np.asarray(rep.losses)

# (iv) the hybrid step and sync: one SGD step on every pod, then the sync
for key, (arch, shape, axes) in cases["hybrid"].items():
    cfg = cfg_of(arch)
    params = carried(arch)
    n = int(np.prod(shape))
    mesh = compat.make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:n])
    with compat.set_mesh(mesh):
        opt = sgd(0.1)
        step = make_hybrid_train_step(mesh, lambda p, a, b, cfg=cfg: lm_loss(cfg, p, a, b), opt)
        sync = make_sync_step(mesh)
        st = (stack_for_pods(params, 2), stack_for_pods(opt.init(params), 2))
        st, loss = step(st, (tokens, targets))
        save(f"hyb.{key}.pre.", st[0])
        save(f"hyb.{key}.synced.", sync(st[0]))
        res[f"hyb.{key}.loss"] = np.asarray(loss)

# (v) the FedAvg identity: each pod's single-device SGD step, then the mean
for key, (arch, shape, axes) in cases["fedavg"].items():
    cfg = cfg_of(arch)
    params = carried(arch)
    half = tokens.shape[0] // 2
    g = jax.jit(jax.grad(lambda p, a, b: lm_loss(cfg, p, a, b)))
    pods = [jax.tree.map(lambda w, gw: w - 0.1 * gw, params, g(params, tokens[i * half:(i + 1) * half],
                                                               targets[i * half:(i + 1) * half])) for i in range(2)]
    save(f"fed.{key}.", jax.tree.map(lambda a, b: (a + b) / 2, *pods))

# (iii) moe_ep on its three test setups and a capacity that drops
for key, (arch, _, shape, cf) in cases["moe"].items():
    cfg = cfg_of(arch)
    layer = jax.tree.map(lambda a: a[0], carried(arch)["layers"][0])
    x = jnp.asarray(data[f"x_{key}"])
    mesh = compat.make_mesh(tuple(shape), ("data", "model"))
    kw = {} if cf is None else {"cf": cf}
    with compat.set_mesh(mesh):
        res[f"moe.{key}"] = np.asarray(jax.jit(lambda l, x: moe_ep(cfg, l, x, **kw))(layer, x))

# (i) the partition specs of every registry config, and spec_for
def entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

specs = {}
for name in sorted(REGISTRY):
    pshape = jax.eval_shape(lambda: init_params(get_config(name), jax.random.PRNGKey(0), jnp.float32))
    for shape, axes in cases["spec_meshes"]:
        for profile in ("tp", "dp"):
            for ews in (False, True):
                cfg = dataclasses.replace(get_config(name), sharding_profile=profile, expert_weight_stationary=ews)
                tree = param_pspecs(cfg, pshape, compat.abstract_mesh(tuple(shape), tuple(axes)))
                flat = jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
                specs[f"{name}|{'x'.join(map(str, shape))}|{profile}|{ews}"] = {
                    "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): entries(s)
                    for path, s in flat}
for profile in ("tp", "dp"):
    JS.set_profile(profile)
    for names in cases["axis_sets"]:
        for dim in cases["dims"]:
            specs[f"spec_for|{profile}|{','.join(names)}|{dim}"] = entries(JS.spec_for(dim, axes=frozenset(names)))
JS.set_profile("tp")
(out / "specs.json").write_text(json.dumps(specs))
np.savez(out / "reference.npz", **res)
print("REFERENCE_OK", len(res), len(specs))
'''

SPEC_MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((2, 4), ("data", "model"))]
AXIS_SETS = [("data", "model"), ("pod", "data", "model"), ("data",), ("model",), ("pod", "data"), ()]
DIMS = [d for d in JS.RULES if d is not None] + [None]


class _Reference:
    """The reference's outputs: started at once, read when first needed."""

    def __init__(self, inp: Path, out: Path):
        self.out = out
        cases = {"train": TRAIN, "hybrid": HYBRID, "fedavg": {k: v for k, v in FEDAVG.items() if k != "deepseek_211"},
                 "moe": MOE, "spec_meshes": SPEC_MESHES, "axis_sets": AXIS_SETS, "dims": DIMS}
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
        self.proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(inp), str(out), json.dumps(cases)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        self._res = None

    def _wait(self):
        if self._res is None:
            so, se = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0 and "REFERENCE_OK" in so, f"{so}\n{se[-4000:]}"
            self._res = dict(np.load(self.out / "reference.npz"))
            self.specs = json.loads((self.out / "specs.json").read_text())

    def __getitem__(self, key):
        self._wait()
        return self._res[key]

    def tree(self, prefix):
        self._wait()
        return {k[len(prefix):]: v for k, v in self._res.items() if k.startswith(prefix)}


@pytest.fixture(scope="module", autouse=True)
def ref(inputs, tmp_path_factory):
    r = _Reference(inputs, tmp_path_factory.mktemp("reference"))
    yield r
    if r.proc.poll() is None:
        r.proc.kill()


WORKER = r'''
import dataclasses, json, shutil, sys, time
from datetime import timedelta
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out, inp, cases = Path(sys.argv[4]), Path(sys.argv[5]), json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                        timeout=timedelta(seconds=300))

from repro_torch._tree import path_key, tree_paths
from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import distribute_params, init_params, lm_loss, moe_ep, param_pspecs, sharding
from repro_torch.models.config import MoEConfig
from repro_torch.optim.hybrid2d import gather_pods, make_hybrid_train_step, make_sync_step, pod_mesh
from repro_torch.optim.sgd import Optimizer, sgd
from repro_torch.train.loop import train

arrays = {}
data = np.load(inp / "data.npz")
tokens = torch.from_numpy(data["tokens"])
targets = torch.roll(tokens, -1, 1)


def cfg_of(arch):
    if arch == "granite-3":
        return dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")),
                                   moe=MoEConfig(n_experts=3, top_k=2, d_ff_expert=64))
    if arch == "deepseek-8":
        return dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1))
    return reduced(get_config(arch))


def host(arch):
    return init_params(cfg_of(arch), dtype=torch.float32, device="cpu", seed=0)


def save(prefix, tree):
    if rank == 0:
        for path, t in tree_paths(tree):
            arrays[prefix + path_key(path)] = t.detach().numpy()


def hybrid_step(prefix, arch, shape, axes, pre=True):
    """One SGD step on every pod's replica, then the pod sync."""
    cfg, mesh = cfg_of(arch), make_mesh(shape, axes, device="cpu")
    sub, params = pod_mesh(mesh), host(arch)
    if sub is not None:
        params = distribute_params(params, param_pspecs(cfg, params, sub), sub)
    opt = sgd(0.1)
    step = make_hybrid_train_step(mesh, lambda p, a, b: lm_loss(cfg, p, a, b), opt)
    (params, _), loss = step((params, opt.init(params)), (tokens, targets))
    if pre:
        save(prefix + "pre.", gather_pods(params, mesh))
    save(prefix + "synced.", gather_pods(make_sync_step(mesh)(params), mesh))
    arrays[prefix + "loss"] = loss.numpy()


def grad_opt():
    return Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))


def sync_step_grads(key, arch, shape, axes):
    """launch/steps.make_train_step on a mesh (synchronous pod × data) vs
    the single-device step: the gap of the gradients and of the loss."""
    cfg, mesh, full = cfg_of(arch), make_mesh(shape, axes, device="cpu"), host(arch)
    specs = param_pspecs(cfg, full, mesh)
    params = distribute_params(full, specs, mesh)
    g_mesh, _, loss_mesh = tsteps.make_train_step(cfg, mesh, opt=grad_opt(), param_specs=specs)(
        params, (), tokens[:4], targets[:4])
    g_one, _, loss_one = tsteps.make_train_step(cfg, None, opt=grad_opt())(full, (), tokens[:4], targets[:4])
    gaps = [float((a.full_tensor() - b).abs().max()) for (_, a), (_, b) in zip(tree_paths(g_mesh), tree_paths(g_one))]
    scale = max(float(b.abs().max()) for _, b in tree_paths(g_one))
    arrays[f"steps.{key}"] = np.array([max(gaps), scale, float(loss_mesh), float(loss_one)])


def pod_sync(key, arch, shape, axes):
    cfg, mesh, full = cfg_of(arch), make_mesh(shape, axes, device="cpu"), host(arch)
    params = distribute_params(full, param_pspecs(cfg, full, mesh), mesh)
    synced = tsteps.make_pod_sync_step(mesh)(params)
    same = all(torch.equal(a.to_local(), b.to_local()) for (_, a), (_, b) in zip(tree_paths(synced), tree_paths(params)))
    arrays[f"podsync.{key}"] = np.array(float(same))


def moe_case(key, arch, shape, cf):
    cfg, mesh, full = cfg_of(arch), make_mesh(shape, ("data", "model"), device="cpu"), host(arch)
    specs = {k: s[1:] for k, s in param_pspecs(cfg, full, mesh)["layers"][0].items()}
    layer = distribute_params({k: v[0] for k, v in full["layers"][0].items()}, specs, mesh)
    moe_ep.copies.update(routed=0, dropped=0)
    with sharding.use_mesh(mesh):
        y = moe_ep.moe_ep(cfg, layer, sharding.like(torch.from_numpy(data[f"x_{key}"]), layer["router"]), cf=cf)
    arrays[f"moe.{key}"] = y.full_tensor().numpy()
    counts = torch.tensor([moe_ep.copies["routed"], moe_ep.copies["dropped"]], dtype=torch.float64)
    dist.all_reduce(counts)
    arrays[f"moe.{key}.copies"] = counts.numpy()


def train_cases():
    cfg, tr = cfg_of("qwen2.5-3b"), cases["train"]
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    kw = dict(batch=tr["batch"], seq_len=tr["seq_len"], tau=tr["tau"], mesh=mesh, log_every=1, device="cpu")

    def run(steps, name, every, copy_from=None):
        if copy_from is not None and rank == 0:
            shutil.copytree(copy_from, out / name)
        dist.barrier()
        rep = train(cfg, steps=steps, params=host("qwen2.5-3b"), checkpoint_dir=str(out / name),
                    checkpoint_every=every, **kw)
        arrays[f"train.{name}"] = np.asarray(rep.losses)

    run(tr["steps"], "C", tr["steps"])  # uninterrupted
    run(2, "A", 2)  # writes its step-2 checkpoint
    run(tr["steps"], "B", tr["steps"], copy_from=out / "A")  # resumes at step 2
    ready = Path(cases["ref_out"]) / "ref_ckpt_ready"
    deadline = time.monotonic() + 600
    while not ready.exists():
        assert time.monotonic() < deadline, "the reference never wrote its checkpoint"
        time.sleep(0.2)
    run(tr["steps"], "R", 0, copy_from=Path(cases["ref_out"]) / "ref_ckpt")  # resumes the reference's


for case in cases["run"]:
    kind, key, args = case
    if kind == "hybrid":
        hybrid_step(f"hyb.{key}.", *args)
    elif kind == "fedavg":
        hybrid_step(f"fed.{key}.", *args, pre=False)
    elif kind == "steps":
        sync_step_grads(key, *args)
    elif kind == "podsync":
        pod_sync(key, *args)
    elif kind == "moe":
        moe_case(key, *args)
    elif kind == "train":
        train_cases()
if rank == 0:
    np.savez(out / "port.npz", **arrays)
dist.destroy_process_group()
'''


class _Launch:
    """``world`` gloo ranks running ``run`` (a list of (kind, key, args)):
    started at once, read when first needed. A rank that fails stops the
    others and fails the caller with its output."""

    def __init__(self, out: Path, inp: Path, world: int, run: list, ref_out: Path, timeout: float = 600.0):
        self.out, self.world, self.deadline = out, world, time.monotonic() + timeout
        cases = json.dumps({"run": run, "train": TRAIN, "ref_out": str(ref_out)})
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        self.logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(out / "store"), str(out),
                                        str(inp), cases], stdout=log, stderr=subprocess.STDOUT, env=env)
                      for r, log in enumerate(self.logs)]
        self._res = None

    def _wait(self):
        if self._res is None:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs) or time.monotonic() > self.deadline:
                    for p in self.procs:
                        p.kill()
                    break
                time.sleep(0.05)
            for log in self.logs:
                log.close()
            failed = [r for r, p in enumerate(self.procs) if p.wait() != 0]
            assert not failed, "\n".join(f"--- rank {r}:\n{(self.out / f'rank{r}.log').read_text()[-4000:]}"
                                         for r in failed)
            self._res = dict(np.load(self.out / "port.npz"))
        return self._res

    def __getitem__(self, key):
        return self._wait()[key]

    def tree(self, prefix):
        return {k[len(prefix):]: v for k, v in self._wait().items() if k.startswith(prefix)}

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


RUNS = {
    2: [("hybrid", "qwen_211", HYBRID["qwen_211"]), ("fedavg", "deepseek_211", FEDAVG["deepseek_211"])],
    4: [("hybrid", k, HYBRID[k]) for k in ("qwen_221", "qwen_212", "gemma_212", "mamba_221")]
       + [("fedavg", "deepseek_212", FEDAVG["deepseek_212"]), ("train", "train", ()),
          ("steps", "qwen_22", ("qwen2.5-3b", (2, 2), ("data", "model"))),
          ("steps", "deepseek_22", ("deepseek-v2-lite-16b", (2, 2), ("data", "model"))),
          ("podsync", "qwen_212", ("qwen2.5-3b", (2, 1, 2), P3))],
    8: [("hybrid", "qwen_24", HYBRID["qwen_24"]), ("fedavg", "qwen_222", FEDAVG["qwen_222"])]
       + [("moe", k, (arch, shape, cf)) for k, (arch, _, shape, cf) in MOE.items()],
}


@pytest.fixture(scope="module", autouse=True)
def port(inputs, ref, tmp_path_factory):
    launches = {w: _Launch(tmp_path_factory.mktemp(f"port{w}"), inputs, w, run, ref.out) for w, run in RUNS.items()}
    yield launches
    for launch in launches.values():
        launch.kill()


def _where(key):
    return next(w for w, run in RUNS.items() if any(k == key for _, k, _ in run))


# ---------------------------------------------------------------- in this process (the launches run meanwhile)


def test_placements_follow_the_spec_and_size_one_dims_replicate():
    """A spec's entries → DTensor placements on a mesh: Shard on each named
    dim larger than 1, in mesh order; Replicate elsewhere; out-of-order
    splits refused. Checked on a mesh-shaped stand-in (no process group)."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        def __init__(self, sizes):
            self.mesh_dim_names, self._sizes = tuple(sizes), tuple(sizes.values())

        def size(self, i):
            return self._sizes[i]

    m = Mesh({"pod": 2, "data": 4, "model": 1})
    assert TS.placements((("pod", "data"), None, "model"), m) == [Shard(0), Shard(0), Replicate()]
    assert TS.placements((None, "data"), m) == [Replicate(), Shard(1), Replicate()]
    assert TS.placements((None, "vocab_absent_axis"), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements((("data", "pod"),), m)
    assert TS.shard(torch.ones(2, 2), "batch", None).shape == (2, 2)  # a plain tensor: as it is
    assert TS.get_abstract_mesh() is None and TS.manual_axes() == frozenset()
    with TS.use_mesh(m), TS.manual({"pod"}):
        assert TS.get_abstract_mesh() is m and TS.manual_axes() == {"pod"}
        assert TS._active_axes() == {"data", "model"}
    assert TS.get_abstract_mesh() is None and TS.manual_axes() == frozenset()


# ---------------------------------------------------------------- (ii) dispatch slots


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 300), n_dst=st.integers(1, 12), cap=st.integers(1, 40), seed=st.integers(0, 999))
def test_dispatch_slots_equal_the_references(n, n_dst, cap, seed):
    import jax.numpy as jnp

    dst = np.random.default_rng(seed).integers(0, n_dst, size=n).astype(np.int32)
    want = np.asarray(j_dispatch_slots(jnp.asarray(dst), n_dst, cap))
    got = t_dispatch_slots(torch.from_numpy(dst).long(), n_dst, cap).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_slots_drop_the_references_copies():
    """A capacity that drops: the same pairs overflow (the sorts are stable)."""
    import jax.numpy as jnp

    dst = np.array([2, 0, 2, 2, 1, 2, 0, 2, 3, 2, 1, 3], np.int32)  # sentinel bucket 3
    for cap in (1, 2, 3):
        want = np.asarray(j_dispatch_slots(jnp.asarray(dst), 4, cap))
        got = t_dispatch_slots(torch.from_numpy(dst).long(), 4, cap).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got < 0).sum() > 0


# ---------------------------------------------------------------- (i) specs


def _tree_of_shapes(flat: dict):
    """The port's parameter tree (dicts; "layers" a tuple) with meta tensors
    of the given {path key: shape}."""
    tree: dict = {}
    for key, shape in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = torch.empty(shape, device="meta")
    if "layers" in tree:
        tree["layers"] = tuple(tree["layers"][str(i)] for i in range(len(tree["layers"])))
    return tree


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_param_pspecs_match_the_reference_string_for_string(name, ref):
    """Every leaf's spec on the production meshes and a (2, 4) mesh, both
    profiles, with and without expert_weight_stationary."""
    ref._wait()
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models.init import init_params as jinit

    shapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(s.shape)
              for path, s in jax.tree_util.tree_flatten_with_path(
                  jax.eval_shape(lambda: jinit(jget(name), jax.random.PRNGKey(0), jnp.float32)))[0]}
    tree = _tree_of_shapes(shapes)
    for shape, axes in SPEC_MESHES:
        for profile in ("tp", "dp"):
            for ews in (False, True):
                cfg = dataclasses.replace(get_config(name), sharding_profile=profile, expert_weight_stationary=ews)
                got = {path_key(p): _entries(s) for p, s in _spec_paths(param_pspecs(cfg, tree, dict(zip(axes, shape))))}
                want = ref.specs[f"{name}|{'x'.join(map(str, shape))}|{profile}|{ews}"]
                assert got == want, (name, shape, profile, ews)


def _spec_paths(tree, prefix=()):
    """(path, spec) of a spec tree (a spec is a tuple of entries; the
    parameters' tuples hold dicts)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _spec_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return [item for i, v in enumerate(tree) for item in _spec_paths(v, prefix + (i,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("profile", ["tp", "dp"])
def test_spec_for_matches_the_reference(profile, ref):
    ref._wait()
    try:
        TS.set_profile(profile)
        for names in AXIS_SETS:
            for dim in DIMS:
                want = ref.specs[f"spec_for|{profile}|{','.join(names)}|{dim}"]
                assert _entries(TS.spec_for(dim, axes=frozenset(names))) == want, (profile, names, dim)
    finally:
        TS.set_profile("tp")
    assert TS.RULES == JS.RULES and TS.RULES_DP == JS.RULES_DP


# ---------------------------------------------------------------- (iii) moe_ep


@pytest.mark.parametrize("key", list(MOE))
def test_moe_ep_matches_the_reference(key, port, ref):
    """The reference's three moe_ep setups (EP at cf = 8; the replicated
    fallback, 3 experts on a 4-way model axis; decode's 2 tokens on an 8-way
    axis, which 4 experts do not divide either) and cf = 2 with one expert
    a rank of 8, where copies drop: the same ones (the outputs agree)."""
    from repro_torch.models.init import padded_experts

    got, want = port[_where(key)][f"moe.{key}"], ref[f"moe.{key}"]
    assert np.abs(got - want).max() <= MOE_RTOL * max(np.abs(want).max(), 1.0)
    routed, dropped = port[_where(key)][f"moe.{key}.copies"]
    arch, _, shape, _ = MOE[key]
    # only the expert-parallel path routes copies through the all_to_all
    assert (routed > 0) == (padded_experts(_cfg(arch).moe.n_experts) % shape[1] == 0)
    assert (dropped > 0) == (key == "drops")


# ---------------------------------------------------------------- (iv)/(v) the hybrid step


def _close(got: dict, want: dict):
    assert got.keys() == want.keys() and got
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("key", list(HYBRID))
def test_hybrid_step_and_sync_match_the_reference(key, port, ref):
    run = port[_where(key)]
    _close(run.tree(f"hyb.{key}.pre."), ref.tree(f"hyb.{key}.pre."))
    _close(run.tree(f"hyb.{key}.synced."), ref.tree(f"hyb.{key}.synced."))
    np.testing.assert_allclose(run[f"hyb.{key}.loss"], ref[f"hyb.{key}.loss"], **TOL)
    # the pods drift before the sync and hold the same bits after it
    pre, synced = run.tree(f"hyb.{key}.pre."), run.tree(f"hyb.{key}.synced.")
    assert max(np.abs(a[0] - a[1]).max() for a in pre.values()) > 1e-6
    assert all(np.array_equal(a[0], a[1]) for a in synced.values())


@pytest.mark.parametrize("key", ["qwen_222", "deepseek_212"])
def test_meshes_the_reference_cannot_run_match_the_fedavg_identity(key, port, ref):
    """(2, 2, 2) and the MoE under pods: each pod's single-device SGD step
    through the reference's lm_loss, then the mean; and the port's own
    (2, 1, 1) run of the same config."""
    got = port[_where(key)].tree(f"fed.{key}.synced.")
    _close({k: v[0] for k, v in got.items()}, ref.tree(f"fed.{key}."))
    own = "qwen_211" if key == "qwen_222" else "deepseek_211"
    prefix = "hyb" if own in HYBRID else "fed"
    _close({k: v[0] for k, v in got.items()}, {k: v[0] for k, v in port[_where(own)].tree(f"{prefix}.{own}.synced.").items()})


# ---------------------------------------------------------------- (vi) train(mesh=...)


def test_train_on_a_mesh_matches_the_reference(port, ref):
    """train(mesh=(2, 1, 2)) with a sync every τ = 2 steps: the reference's
    losses (both start from the same parameters and read the same stream)."""
    np.testing.assert_allclose(port[4]["train.C"], ref["train.losses"], **TOL)


def test_resume_on_a_mesh_is_bitwise_the_uninterrupted_run(port):
    """Stopped at step 2 and resumed from its stacked checkpoint (the
    first 2 batches skipped), the run ends with the uninterrupted run's
    losses and checkpoint, bit for bit."""
    run = port[4]
    np.testing.assert_array_equal(run["train.B"], run["train.C"][2:])
    b, c = np.load(run.out / "B" / "ckpt.npz"), np.load(run.out / "C" / "ckpt.npz")
    assert sorted(b.files) == sorted(c.files)
    for k in c.files:
        np.testing.assert_array_equal(b[k], c[k], err_msg=k)


def test_mesh_checkpoints_cross_between_the_packages(port, ref):
    """The port's stacked step-2 checkpoint restores into the reference's
    stacked state and equals the reference's own step-2 checkpoint; the
    port resumes the reference's and ends with its losses."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models.init import init_params as jinit
    from repro.optim.hybrid2d import stack_for_pods
    from repro.optim.sgd import adamw
    from repro.train.checkpoint import restore_checkpoint

    run = port[4]
    ref._wait()
    params = jinit(jreduced(jget("qwen2.5-3b")), jax.random.PRNGKey(0), jnp.float32)
    like = jax.tree.map(np.asarray, (stack_for_pods(params, 2), stack_for_pods(adamw(3e-4).init(params), 2)))
    mine, step = restore_checkpoint(run.out / "A" / "ckpt", like)
    theirs, ref_step = restore_checkpoint(ref.out / "ref_ckpt" / "ckpt", like)
    assert step == ref_step == 2
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                                 jax.tree_util.tree_flatten_with_path(theirs)[0]):
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)
    np.testing.assert_allclose(run["train.R"], ref["train.losses"][2:], **TOL)


# ---------------------------------------------------------------- (vii) launch/steps


@pytest.mark.parametrize("key", ["qwen_22", "deepseek_22"])
def test_a_synchronous_mesh_step_has_the_single_device_gradients(key, port):
    """launch/steps.make_train_step on a mesh is synchronous data
    parallelism (the reference's code): its gradients and loss are the
    single-device step's."""
    gap, scale, loss_mesh, loss_one = port[_where(key)][f"steps.{key}"]
    assert gap <= 1e-5 * max(scale, 1.0) and abs(loss_mesh - loss_one) <= 1e-5 * abs(loss_one)


def test_the_pod_sync_step_keeps_what_every_pod_holds(port):
    """make_pod_sync_step on a (2, 1, 2) mesh: the parameters every pod
    already holds come back with the same bits (the reference's pmean of
    replicated parameters)."""
    assert port[4]["podsync.qwen_212"] == 1.0
