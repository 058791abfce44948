"""Decode on a model mesh: ``launch/steps.make_serve_step`` with DTensor
parameters (``param_pspecs``) and a cache laid out by ``cache_shardings``,
against the single-device decode of the port and the reference's
``decode_step`` on one device.

Two gloo launches start with the module: 2 ranks for the (1, 2) mesh and 4
for (2, 2), each decoding every case; the single-device port and the
reference run here meanwhile. Mixers: dense attention (qwen2.5-3b, the "dp"
profile under decode), MLA with the MoE (deepseek-v2-lite-16b, experts
stationary: ``moe_ep`` on the (B, 1) tokens), Mamba-1 (falcon-mamba-7b)
and the hybrid (jamba-1.5-large-398b), each reduced, with the profile and
expert placement ``resolve_config`` gives the full config under
``decode_32k``. The run goes past the cache's length, where attention wraps
and MLA clamps its slot.

Held: each step's logits within 1e-5 of the largest |logit| (the MoE's
routing asserted equal first, from the inputs each MoE layer saw); every
cache leaf keeps its ``cache_shardings`` placements after every step; and a
step's collectives, by kind and bytes, are the same whatever the cache's
length — none moves the cache.
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

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "jamba-1.5-large-398b"]
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, L, STEPS = 4, 8, 11  # past L: the ring wraps, MLA's slot clamps
LOGIT_RTOL = 1e-5

WORKER = r'''
import dataclasses, json, sys, warnings, logging
from datetime import timedelta
warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
import numpy as np
import torch, torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cases = json.loads(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                        timeout=timedelta(seconds=300))
from torch.distributed.tensor import DTensor
from repro_torch._tree import path_key, tree_paths
from repro_torch.configs import get_config, reduced
from repro_torch.launch.input_specs import SHAPES, ShapeSpec, cache_shardings, resolve_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import count_collectives
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import blocks, distribute_params, init_cache, init_params, param_pspecs, sharding

B, L, STEPS = cases["B"], cases["L"], cases["steps"]
mesh = make_mesh(tuple(cases["mesh"]), ("data", "model"), device="cpu")
tokens = np.load(cases["tokens"])
arrays = {}
seen = []  # each MoE layer's input, whole
real_moe = blocks.moe


def moe(p, cfg, x):
    seen.append(x.full_tensor() if isinstance(x, DTensor) else x)
    return real_moe(p, cfg, x)


blocks.moe = moe
for arch in cases["archs"]:
    full = resolve_config(arch, SHAPES["decode_32k"])
    cfg = dataclasses.replace(reduced(get_config(arch)), sharding_profile=full.sharding_profile,
                              expert_weight_stationary=full.expert_weight_stationary)
    host = init_params(cfg, dtype=torch.float32, device="cpu", seed=0)
    params = distribute_params(host, param_pspecs(cfg, host, mesh), mesh)
    step = make_serve_step(cfg)
    colls = {}
    for depth in (L, 2 * L):
        c = init_cache(cfg, B, depth, torch.float32, "cpu")
        cache = distribute_params(c, cache_shardings(cfg, ShapeSpec("decode", depth, B, "decode"), mesh, c), mesh)
        want = {path_key(p): list(map(str, t.placements)) for p, t in tree_paths(cache)}
        kept = True
        per_step = []
        for s in range(STEPS if depth == L else 1):
            seen.clear()
            with sharding.use_mesh(mesh), count_collectives() as stats:
                logits, cache = step(params, cache, torch.from_numpy(tokens[arch][s]))
            kept &= all(isinstance(t, DTensor) and list(map(str, t.placements)) == want[path_key(p)]
                        for p, t in tree_paths(cache))
            per_step.append([stats.count_by_kind, stats.bytes_by_kind])
            if depth == L:
                arrays[f"{arch}.logits.{s}"] = logits.full_tensor().numpy()
                for i, x in enumerate(seen):
                    arrays[f"{arch}.moe_in.{s}.{i}"] = x.numpy()
        colls[depth] = per_step
        arrays[f"{arch}.kept.{depth}"] = np.array(kept)
    arrays[f"{arch}.colls"] = np.array(json.dumps(colls))
if rank == 0:
    np.savez(out, **arrays)
dist.destroy_process_group()
'''


def _cfgs(arch):
    """The reduced config of both packages, profile and expert placement
    as ``resolve_config`` gives the full one under decode_32k."""
    import repro.configs as JC
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.input_specs import SHAPES, resolve_config

    full = resolve_config(arch, SHAPES["decode_32k"])
    kw = dict(sharding_profile=full.sharding_profile, expert_weight_stationary=full.expert_weight_stationary)
    return dataclasses.replace(JC.reduced(JC.get_config(arch)), **kw), dataclasses.replace(reduced(get_config(arch)),
                                                                                             **kw)


class _Launch:
    def __init__(self, tmp: Path, world: int, cases: dict, timeout: float = 600.0):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        self.out, self.deadline = tmp / "port.npz", time.monotonic() + timeout
        self.logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(tmp / "store"),
                                        str(self.out), json.dumps(cases)], stdout=log, stderr=subprocess.STDOUT,
                                       env=env) for r, log in enumerate(self.logs)]
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs) or time.monotonic() > self.deadline:
                    self.kill()
                    break
                time.sleep(0.05)
            failed = [r for r, p in enumerate(self.procs) if p.wait() != 0]
            for log in self.logs:
                log.seek(0)
            assert not failed, "\n".join(f"--- rank {r}:\n{self.logs[r].read()[-4000:]}" for r in failed)
            self._res = dict(np.load(self.out))
        return self._res

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    rng = np.random.default_rng(3)
    ids = {arch: rng.integers(0, _cfgs(arch)[1].vocab_size, (STEPS, B, 1)).astype(np.int64) for arch in ARCHS}
    path = tmp_path_factory.mktemp("tokens") / "tokens.npz"
    np.savez(path, **ids)
    return path, ids


@pytest.fixture(scope="module")
def mesh_runs(tokens, tmp_path_factory):
    launches = {key: _Launch(tmp_path_factory.mktemp(f"mesh{key}"), shape[0] * shape[1],
                             {"archs": ARCHS, "mesh": list(shape), "B": B, "L": L, "steps": STEPS,
                              "tokens": str(tokens[0])})
                for key, shape in MESHES.items()}
    yield launches
    for launch in launches.values():
        launch.kill()


@pytest.fixture(scope="module")
def single(tokens, mesh_runs):
    """The port's single-device decode and the reference's, on the same
    weights and ids (run here while the launches run): per arch the logits
    of every step, and each MoE layer's input."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import decode_step as jdecode
    from repro.models.transformer import init_cache as jinit_cache
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import blocks, init_cache, init_params, params_to_numpy

    out = {}
    real_moe = blocks.moe
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        params = init_params(tcfg, dtype=torch.float32, device="cpu", seed=0)
        jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
        cache, jcache = init_cache(tcfg, B, L, torch.float32, "cpu"), jinit_cache(jcfg, B, L, jnp.float32)
        step, jstep = make_serve_step(tcfg), jax.jit(lambda p, c, t, cfg=jcfg: jdecode(cfg, p, c, t))
        seen, port, ref = [], [], []
        blocks.moe = lambda p, cfg, x: (seen.append(x.clone()), real_moe(p, cfg, x))[1]
        try:
            for s in range(STEPS):
                ids = tokens[1][arch][s]
                seen_at = len(seen)
                logits, cache = step(params, cache, torch.from_numpy(ids))
                jlogits, jcache = jstep(jparams, jcache, jnp.asarray(ids, jnp.int32))
                port.append((logits.numpy(), [x.numpy() for x in seen[seen_at:]]))
                ref.append(np.asarray(jlogits))
        finally:
            blocks.moe = real_moe
        out[arch] = (port, ref, params)
    return out


def _routes(x: np.ndarray, router: torch.Tensor, k: int) -> np.ndarray:
    t = torch.from_numpy(x).reshape(-1, x.shape[-1])
    return torch.topk(torch.softmax(t.to(torch.float32) @ router.to(torch.float32), dim=-1), k, dim=-1)[1].numpy()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_mesh_matches_the_single_device_decode_step_by_step(arch, mesh, mesh_runs, single):
    run = mesh_runs[mesh].result()
    port, ref, params = single[arch]
    _, tcfg = _cfgs(arch)
    for s in range(STEPS):
        want, moe_inputs = port[s]
        if tcfg.moe is not None:  # the same experts chosen, layer by layer, before the logits are compared
            assert len(moe_inputs) == sum(1 for k in run if k.startswith(f"{arch}.moe_in.{s}."))
            for i, x in enumerate(moe_inputs):
                layer = [j for j, sp in enumerate(tcfg.period) if sp.ff == "moe"][i % sum(
                    sp.ff == "moe" for sp in tcfg.period)]
                router = params["layers"][layer]["router"][i // sum(sp.ff == "moe" for sp in tcfg.period)]
                assert np.array_equal(_routes(run[f"{arch}.moe_in.{s}.{i}"], router, tcfg.moe.top_k),
                                      _routes(x, router, tcfg.moe.top_k)), (arch, mesh, s, i)
        got = run[f"{arch}.logits.{s}"]
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= LOGIT_RTOL * scale, (arch, mesh, s)
        assert np.abs(got - ref[s]).max() <= LOGIT_RTOL * np.abs(ref[s]).max(), (arch, mesh, s)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_cache_keeps_its_layout_and_no_collective_moves_it(mesh, mesh_runs):
    """After every step each cache leaf carries the placements
    ``cache_shardings`` gave it, and a step issues the same collectives
    (kind, count, bytes) against a cache twice as long."""
    run = mesh_runs[mesh].result()
    for arch in ARCHS:
        assert bool(run[f"{arch}.kept.{L}"]) and bool(run[f"{arch}.kept.{2 * L}"]), (arch, mesh)
        colls = json.loads(str(run[f"{arch}.colls"]))
        first = colls[str(L)][0]
        assert colls[str(2 * L)][0] == first, (arch, mesh, colls[str(2 * L)][0], first)
        assert sum(first[0].values()) > 0  # the mesh does communicate
