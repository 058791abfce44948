"""The port's language-model dry run (``repro_torch.launch.{input_specs,
roofline,dryrun,report}``) against the reference's ``repro.launch``.

* ``input_specs``: every config × shape × the (16, 16), (2, 16, 16) and
  (2, 4) meshes, string for string — ``SHAPES``, ``shape_applicable``,
  ``resolve_config`` (every field), ``token_specs``, the shapes of
  ``params_shape`` and ``cache_shape``, ``cache_shardings``.
* the model half of ``roofline``: the reference's own cases
  (``tests/test_launch.py``) at the H100 rates, ``model_flops_per_step``
  equal for every config × shape, and ``count_collectives`` on a real
  2-rank gloo program against ``parse_collectives`` of the reference's HLO.
* the dry run on the fake backend, reduced configs on a (2, 2) mesh, in a
  subprocess (it starts its own process group): parameter and cache bytes a
  rank equal to the counts the reference's specs give; full-depth FLOPs on
  the line through depth 1 and 2; collective counts equal
  to a real 4-rank gloo run of the same steps; the skipped set the
  reference's.
* ``report`` on records written to a temp dir.

The reference's ``repro.launch.dryrun`` is never imported here: it sets
``XLA_FLAGS`` at import.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.input_specs as JI
import repro.launch.roofline as JR
from repro import compat
from repro.configs import REGISTRY
from repro_torch._tree import path_key, tree_paths
from repro_torch.launch import input_specs as TI
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as TR

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((2, 4), ("data", "model"))]

# the dry run's reduced cases: arch → depth (three periods, so depth 1 and 2
# extrapolate to something other than depth 2)
DRY = {"qwen2.5-3b": 3, "deepseek-v2-lite-16b": 3, "falcon-mamba-7b": 3, "jamba-1.5-large-398b": 6}
DRY_SHAPES = {"train_4k": (8, 16), "prefill_32k": (4, 16), "decode_32k": (4, 16)}  # (batch, seq)


def _entries(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _jpath(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jleaves(tree, is_leaf=None) -> dict:
    import jax

    return {_jpath(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _spec_leaves(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _spec_leaves(tree[key], prefix + (key,)).items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return {k: v for i, t in enumerate(tree) for k, v in _spec_leaves(t, prefix + (i,)).items()}
    return {path_key(prefix): tree}


def _reduced_pair(arch: str, shape_name: str, n_layers: int):
    """The reduced config of both packages at ``n_layers``, with the
    profile and expert placement ``resolve_config`` gives the full one."""
    from repro.configs import get_config as jget, reduced as jreduced
    from repro_torch.configs import get_config as tget, reduced as treduced

    full = TI.resolve_config(arch, TI.SHAPES[shape_name])
    kw = dict(n_layers=n_layers, sharding_profile=full.sharding_profile,
              expert_weight_stationary=full.expert_weight_stationary)
    return dataclasses.replace(jreduced(jget(arch)), **kw), dataclasses.replace(treduced(tget(arch)), **kw)


# ---------------------------------------------------------------- processes started with the module

DRY_SCRIPT = r'''
import dataclasses, json, sys, warnings, logging
warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.input_specs import SHAPES, ShapeSpec, resolve_config
from repro_torch.launch.mesh import make_mesh
cases, out = json.loads(sys.argv[1]), sys.argv[2]
recs = {}
with D.fake_world(4):
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for arch, depth in cases["dry"].items():
        for name, (b, s) in cases["shapes"].items():
            full = resolve_config(arch, SHAPES[name])
            cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=depth, sharding_profile=full.sharding_profile,
                                      expert_weight_stationary=full.expert_weight_stationary)
            recs[f"{arch}|{name}"] = D.run_combo(arch, name, mesh, device="cpu", cfg=cfg,
                                                 shape=ShapeSpec(name, s, b, SHAPES[name].kind))
    # the combinations the rule skips, at full size (nothing is built)
    for arch in sorted(cases["archs"]):
        for name in SHAPES:
            if not D.shape_applicable(resolve_config(arch, SHAPES[name]), SHAPES[name])[0]:
                recs[f"skip|{arch}|{name}"] = D.run_combo(arch, name, mesh, device="cpu")
open(out, "w").write(json.dumps(recs))
print("DRY_OK", len(recs))
'''

WORKER = r'''
import dataclasses, json, sys, warnings, logging
from datetime import timedelta
warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
rank, world, store, out, cases = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world,
                        timeout=timedelta(seconds=300))
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.input_specs import SHAPES, ShapeSpec, resolve_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import count_collectives
from repro_torch.models.sharding import use_mesh
res = {}
if world == 2:
    # the reference's HLO case: an all-reduce of 64 fp32, an all-gather to
    # 128 and an all-to-all of 64 — by torch.distributed's calls, then by
    # the functional collectives DTensor issues
    x = torch.arange(64, dtype=torch.float32)
    with count_collectives() as c10d:
        dist.all_reduce(x)
        g = torch.empty(128)
        dist.all_gather_into_tensor(g, x)
        a = torch.empty(64)
        dist.all_to_all_single(a, g[:64].contiguous())
    group = dist.group.WORLD
    with count_collectives() as fun:
        y = funcol.all_reduce(torch.ones(64), "sum", group)
        z = funcol.all_gather_tensor(y, 0, group)
        w = funcol.all_to_all_single(z[:64], None, None, group)
        w.wait() if hasattr(w, "wait") else w
    res = {"c10d": [c10d.count_by_kind, c10d.bytes_by_kind], "funcol": [fun.count_by_kind, fun.bytes_by_kind]}
else:
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for arch, depth in cases["dry"].items():
        for name, (b, s) in cases["shapes"].items():
            full = resolve_config(arch, SHAPES[name])
            cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=depth, sharding_profile=full.sharding_profile,
                                      expert_weight_stationary=full.expert_weight_stationary)
            step, args, inputs = D.build_step(cfg, ShapeSpec(name, s, b, SHAPES[name].kind), mesh, device="cpu",
                                              single_microbatch=True)
            g = torch.Generator().manual_seed(0)
            for k in ("tokens", "targets"):
                if k in inputs:
                    inputs[k].copy_(torch.randint(0, cfg.vocab_size, inputs[k].shape, generator=g))
            if "prefix_emb" in inputs:
                inputs["prefix_emb"].normal_(generator=g)
            with use_mesh(mesh), count_collectives() as stats:
                step(*args)
            res[f"{arch}|{name}"] = [stats.count_by_kind, stats.bytes_by_kind]
if rank == 0:
    open(out, "w").write(json.dumps(res))
dist.destroy_process_group()
'''


class _Procs:
    """Processes started at once and read when first needed; one that
    fails stops the others and fails the caller with its output."""

    def __init__(self, tmp: Path, argvs: list, timeout: float = 600.0):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        self.logs = [open(tmp / f"log{i}.txt", "w+") for i in range(len(argvs))]
        self.procs = [subprocess.Popen(a, stdout=log, stderr=subprocess.STDOUT, env=env)
                      for a, log in zip(argvs, self.logs)]
        self.deadline = time.monotonic() + timeout
        self.done = False

    def wait(self):
        if not self.done:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs) or time.monotonic() > self.deadline:
                    self.kill()
                    break
                time.sleep(0.05)
            self.done = True
        failed = [i for i, p in enumerate(self.procs) if p.wait() != 0]
        if failed:
            for log in self.logs:
                log.seek(0)
            raise AssertionError("\n".join(f"--- process {i}:\n{self.logs[i].read()[-4000:]}" for i in failed))

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def _gloo(tmp: Path, world: int, out: Path, cases: dict) -> _Procs:
    return _Procs(tmp, [[sys.executable, "-c", WORKER, str(r), str(world), str(tmp / "store"), str(out),
                         json.dumps(cases)] for r in range(world)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {"dry": DRY, "shapes": DRY_SHAPES, "archs": sorted(REGISTRY)}
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("dry", "g2", "g4")}
    # the dry run a process an arch (the first also runs the skipped set)
    dry = [[sys.executable, "-c", DRY_SCRIPT, json.dumps({**cases, "dry": {arch: depth},
                                                          "archs": cases["archs"] if i == 0 else []}),
            str(dirs["dry"] / f"out{i}.json")] for i, (arch, depth) in enumerate(DRY.items())]
    procs = {
        "dry": _Procs(dirs["dry"], dry),
        "g2": _gloo(dirs["g2"], 2, dirs["g2"] / "out.json", cases),
        "g4": _gloo(dirs["g4"], 4, dirs["g4"] / "out.json", cases),
    }

    def read(key):
        procs[key].wait()
        if key == "dry":
            return {k: v for f in sorted(dirs[key].glob("out*.json")) for k, v in json.loads(f.read_text()).items()}
        return json.loads((dirs[key] / "out.json").read_text())

    yield read
    for p in procs.values():
        p.kill()


# ---------------------------------------------------------------- (1) input_specs


def test_shapes_and_the_profile_rules_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in TI.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JI.SHAPES.items()}
    assert (TI.VISION_PREFIX_TRAIN, TI.VISION_PREFIX_PREFILL) == (JI.VISION_PREFIX_TRAIN, JI.VISION_PREFIX_PREFILL)
    assert TI.DP_PROFILE_ARCHS == JI.DP_PROFILE_ARCHS


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_input_specs_match_the_reference_string_for_string(arch):
    """shape_applicable, resolve_config (every field), _stationary_experts_ok,
    token_specs (shapes, dtypes, specs), params_shape and cache_shape
    (every leaf's shape and dtype) and cache_shardings, for every shape and
    mesh."""
    import jax

    jp = None
    for name, shape in TI.SHAPES.items():
        jcfg, tcfg = JI.resolve_config(arch, JI.SHAPES[name]), TI.resolve_config(arch, shape)
        assert json.dumps(dataclasses.asdict(tcfg), sort_keys=True, default=list) == \
            json.dumps(dataclasses.asdict(jcfg), sort_keys=True, default=list), (arch, name)
        assert TI.shape_applicable(tcfg, shape) == JI.shape_applicable(jcfg, JI.SHAPES[name])
        assert TI._stationary_experts_ok(tcfg) == JI._stationary_experts_ok(jcfg)
        if jp is None or name == "long_500k":  # the parameters depend on the arch (and the SWA overlay) only
            jp = _jleaves(JI.params_shape(jcfg))
            tp = {path_key(p): t for p, t in tree_paths(TI.params_shape(tcfg))}
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tp.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}, (arch, name)
            assert all(t.device.type == "meta" for t in tp.values())
        jc = JI.cache_shape(jcfg, JI.SHAPES[name])
        tc = TI.cache_shape(tcfg, shape)
        assert {path_key(p): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for p, t in tree_paths(tc)} == {k: (tuple(v.shape), str(v.dtype)) for k, v in _jleaves(jc).items()}
        for sizes, axes in MESHES:
            jmesh = compat.abstract_mesh(sizes, axes)
            tmesh = dict(zip(axes, sizes))
            js, jsh = JI.token_specs(jcfg, JI.SHAPES[name], jmesh)
            ts, tsh = TI.token_specs(tcfg, shape, tmesh)
            assert list(ts) == list(js)
            for k in js:
                assert tuple(ts[k].shape) == js[k].shape and str(ts[k].dtype).removeprefix("torch.") == str(js[k].dtype)
                assert _entries(tsh[k]) == _entries(jsh[k].spec), (arch, name, sizes, k)
            jcs = _jleaves(JI.cache_shardings(jcfg, JI.SHAPES[name], jmesh, jc),
                           is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
            tcs = _spec_leaves(TI.cache_shardings(tcfg, shape, tmesh, tc))
            assert {k: _entries(v) for k, v in tcs.items()} == {k: _entries(v.spec) for k, v in jcs.items()}, \
                (arch, name, sizes)


def test_batch_specs_drop_trailing_axes_until_the_batch_divides():
    for sizes, axes in MESHES:
        jmesh, tmesh = compat.abstract_mesh(sizes, axes), dict(zip(axes, sizes))
        for batch in (1, 2, 6, 32, 128, 256, 512):
            for prof in ("tp", "dp"):
                assert TI.batch_axes(tmesh, prof) == JI.batch_axes(jmesh, prof)
                assert _entries(TI._bspec(tmesh, batch, None, profile=prof)) == \
                    _entries(JI._bspec(jmesh, batch, None, profile=prof))


# ---------------------------------------------------------------- (2) roofline


def test_extrapolate_depth_is_the_references():
    assert TR.extrapolate_depth(15.0, 20.0, 9) == pytest.approx(10 + 5 * 9)
    assert TR.extrapolate_depth(10.0, 10.0, 5) == pytest.approx(10.0)
    for v1, v2, p in ((3.0, 7.5, 27), (8.0, 2.0, 4), (0.0, 1.0, 1)):
        assert TR.extrapolate_depth(v1, v2, p) == JR.extrapolate_depth(v1, v2, p)


def test_roofline_terms_at_the_h100_rates():
    """The reference's case, one second of each term at the H100 SXM's
    published rates: 989 TFLOP/s bf16, 3.35 TB/s HBM, 50 GB/s a GPU between
    nodes (NVLink 4's 900 GB/s is named, not used)."""
    t = TR.RooflineTerms(arch="x", shape="train_4k", mesh="m", flops=989e12, hbm_bytes=3.35e12,
                         collective_bytes=50e9, collective_breakdown={}, model_flops=494.5e12)
    assert t.compute_s == pytest.approx(1.0) and t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0) and t.useful_flops_ratio == pytest.approx(0.5)
    assert t.bound_s == pytest.approx(1.0)
    assert (TR.PEAK_FLOPS_BF16, TR.HBM_BW, TR.LINK_BW, TR.NVLINK_BW, TR.HBM_BYTES) == \
        (989e12, 3.35e12, 50e9, 900e9, 80e9)
    t2 = dataclasses.replace(t, collective_bytes=100e9)
    assert t2.dominant == "collective" and t2.bound_s == pytest.approx(2.0)
    row = t2.row()
    j = JR.RooflineTerms(arch="x", shape="train_4k", mesh="m", flops=989e12, hbm_bytes=3.35e12,
                         collective_bytes=100e9, collective_breakdown={}, model_flops=494.5e12)
    assert set(row) == set(j.row())
    assert TR.COLLECTIVE_KINDS == JR.COLLECTIVE_KINDS and TR._DTYPE_BYTES == JR._DTYPE_BYTES


@pytest.mark.parametrize("shape_name", list(TI.SHAPES))
def test_model_flops_per_step_is_the_references(shape_name):
    for arch in sorted(REGISTRY):
        jcfg, tcfg = JI.resolve_config(arch, JI.SHAPES[shape_name]), TI.resolve_config(arch, TI.SHAPES[shape_name])
        kind = TI.SHAPES[shape_name].kind
        assert TR.model_flops_per_step(tcfg, TI.SHAPES[shape_name], kind) == \
            JR.model_flops_per_step(jcfg, JI.SHAPES[shape_name], kind), (arch, shape_name)


HLO = """
HloModule test
ENTRY %main (x: f32[64]) -> f32[64] {
  %x = f32[64]{0} parameter(0)
  %ar = f32[64]{0} all-reduce(%x), replica_groups={}
  %ag = f32[128]{0} all-gather(%ar), dimensions={0}
  %a2a = f32[64]{0} all-to-all(%ag), dimensions={0}
  ROOT %out = f32[64]{0} add(%a2a, %ar)
}
"""


@pytest.mark.parametrize("route", ["c10d", "funcol"])
def test_count_collectives_gives_the_references_stats_for_its_hlo(route, runs):
    """An all-reduce of 64 fp32, an all-gather to 128 and an all-to-all of
    64 on a real 2-rank gloo group, through torch.distributed's calls and
    through the functional collectives: the stats ``parse_collectives``
    reads from the reference's HLO of the same program."""
    want = JR.parse_collectives(HLO)
    counts, nbytes = runs("g2")[route]
    assert counts == want.count_by_kind and nbytes == want.bytes_by_kind


def test_count_collectives_refuses_a_collective_it_does_not_know():
    class Op:
        namespace, _opname = "c10d", "some_new_collective_"

        def __call__(self, *a, **k):
            return None

    with pytest.raises(ValueError, match="does not know"):
        with TR.count_collectives():
            TR._CollectiveCounter.__torch_dispatch__(TR._CollectiveCounter(None, None), Op(), (), ())


# ---------------------------------------------------------------- (3) the dry run


def _reference_bytes(jcfg, jshape, sizes, axes) -> tuple[int, int]:
    """Parameter and cache bytes a rank from the reference's specs: each
    leaf's shape divided by the mesh sizes its spec names."""
    import jax
    from repro.models.init import param_pspecs

    mesh = compat.abstract_mesh(sizes, axes)
    sz = dict(zip(axes, sizes))

    def local(shape, spec, itemsize):
        n = itemsize
        for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            parts = 1
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                parts *= sz[a]
            assert dim % parts == 0
            n *= dim // parts
        return n

    pshape = JI.params_shape(jcfg)
    specs = _jleaves(param_pspecs(jcfg, pshape, mesh), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    pb = sum(local(v.shape, specs[k], v.dtype.itemsize) for k, v in _jleaves(pshape).items())
    cb = 0
    if jshape.kind == "decode":
        cshape = JI.cache_shape(jcfg, jshape)
        cspecs = _jleaves(JI.cache_shardings(jcfg, jshape, mesh, cshape),
                          is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
        cb = sum(local(v.shape, cspecs[k].spec, v.dtype.itemsize) for k, v in _jleaves(cshape).items())
    return pb, cb


@pytest.mark.parametrize("arch", list(DRY))
def test_dry_run_bytes_a_rank_are_the_references_and_depth_extrapolates(arch, runs):
    """At reduced width on a fake (2, 2) mesh, each shape: the parameter and
    cache bytes a rank equal what the reference's specs give; the records
    hold FLOPs, HBM and collective bytes, and the memory; and the full-depth
    FLOPs lie on the line through depth 1 and 2, the record saying whether
    the reference's ``extrapolate_depth`` (its base clamped at 0) meets them
    too. The bytes are recorded, not held: how DTensor lays out a tensor
    stacked over the periods depends on whether their count divides the
    mesh (reduced deepseek's collective bytes grow 3.965 MB from depth 1 to
    2 and 3.916 MB a period after)."""
    recs = runs("dry")
    for name, (b, s) in DRY_SHAPES.items():
        rec = recs[f"{arch}|{name}"]
        assert rec["status"] == "ok" and rec["mesh"] == "2x2:data,model", rec
        jcfg, tcfg = _reduced_pair(arch, name, DRY[arch])
        P = tcfg.n_periods
        jshape = JI.ShapeSpec(name, s, b, JI.SHAPES[name].kind)
        pb, cb = _reference_bytes(jcfg, jshape, (2, 2), ("data", "model"))
        mem = rec["memory"]
        assert (mem["param_bytes"], mem["cache_bytes"]) == (pb, cb), (name, mem, pb, cb)
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0 and rec["fits_80gb_hbm"]
        ro = rec["roofline"]
        assert ro["flops_per_dev"] > 0 and ro["hbm_bytes_per_dev"] > 0 and ro["collective_bytes_per_dev"] > 0
        assert ro["model_flops_per_dev"] == pytest.approx(
            JR.model_flops_per_step(jcfg, jshape, jshape.kind) / 4)
        check = rec["depth_check"]["flops"]
        assert check["linear_equal"], (name, check)
        assert check["equal"] == (check["full"] == TR.extrapolate_depth(check["depth1"], check["depth2"], P))


@pytest.mark.parametrize("arch", list(DRY))
def test_dry_run_collectives_are_those_of_a_real_gloo_run(arch, runs):
    """The collectives the dry run counts on the fake backend, by kind and
    bytes, are the ones a real 4-rank gloo run of the same step issues."""
    recs, real = runs("dry"), runs("g4")
    for name in DRY_SHAPES:
        ro = recs[f"{arch}|{name}"]["roofline"]
        counts, nbytes = real[f"{arch}|{name}"]
        assert ro["collective_counts"] == {k: v for k, v in counts.items() if v}, name
        assert ro["collectives"] == {k: v for k, v in nbytes.items() if v}, name


def test_the_dry_run_skips_what_the_reference_skips(runs):
    recs = runs("dry")
    skipped = {tuple(k.split("|")[1:]) for k in recs if k.startswith("skip|")}
    want = {(a, n) for a in REGISTRY for n in JI.SHAPES
            if not JI.shape_applicable(JI.resolve_config(a, JI.SHAPES[n]), JI.SHAPES[n])[0]}
    assert skipped == want and want
    for a, n in skipped:
        assert recs[f"skip|{a}|{n}"]["reason"] == JI.shape_applicable(JI.resolve_config(a, JI.SHAPES[n]),
                                                                      JI.SHAPES[n])[1]


def test_moe_host_reads_stand_in_balanced_groups_only_on_fake_tensors():
    """A fake tensor has no values to read: ``host_read`` gives the
    balanced T·k/E groups there, and the real counts on a real tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.blocks import host_read, spread

    assert spread(10, 4) == [3, 3, 2, 2] and sum(spread(7, 3)) == 7
    counts = torch.tensor([5, 0, 2])
    assert host_read(counts, lambda: [9, 9, 9]) == [5, 0, 2]
    with FakeTensorMode() as fake:
        assert host_read(fake.from_tensor(counts), lambda: spread(7, 3)) == [3, 2, 2]


# ---------------------------------------------------------------- (4) report


def test_report_prints_the_references_table_from_records(tmp_path):
    """Records of every status: an ok row with its roofline terms and the
    multi-pod cell, a skipped row, a failed one; the census lines."""
    terms = TR.RooflineTerms(arch="a", shape="train_4k", mesh="16x16:data,model", flops=989e12, hbm_bytes=1.675e12,
                             collective_bytes=10e9, collective_breakdown={"all-gather": 10}, model_flops=494.5e12)
    recs = [
        {"arch": "a", "shape": "train_4k", "mesh": "16x16:data,model", "status": "ok",
         "memory": {"peak_bytes": 12.5e9}, "roofline": terms.row()},
        {"arch": "a", "shape": "train_4k", "mesh": "2x16x16:pod,data,model", "status": "ok",
         "memory": {"peak_bytes": 7.0e9}},
        {"arch": "a", "shape": "long_500k", "mesh": "16x16:data,model", "status": "skipped",
         "reason": "pure full-attention arch: 500k decode cache/attn is not sub-quadratic"},
        {"arch": "b", "shape": "decode_32k", "mesh": "single", "status": "FAILED", "error": "x"},
    ]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    buf = io.StringIO()
    with redirect_stdout(buf):
        treport.main(["--results", str(tmp_path)])
    out = buf.getvalue()
    assert "| arch | shape | compute | memory | collective | dominant | useful | peak GB (1-pod) | multi-pod |" in out
    assert "| a | train_4k | 1.00s | 500.0ms | 200.0ms | **compute** | 0.50 | 12.50 | ok (7.0 GB) |" in out
    reason = recs[2]["reason"]
    assert f"| a | long_500k | — | — | — | SKIP: {reason[:44]} | — | — | — |" in out
    assert "| b | decode_32k | FAILED |" in out
    assert "1 combinations counted with roofline terms; 1 skipped" in out
    assert "Dominant-term census: {'compute': 1}" in out and "H100 SXM" in out
    assert treport.fmt_s(0) == "0" and treport.fmt_s(2.5e-4) == "250µs" and treport.fmt_s(3.0) == "3.00s"
