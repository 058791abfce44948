"""Multi-pod dry run of the port: the reference's ``repro.launch.dryrun``.

For every (architecture × input shape × mesh) this runs the real step of
``launch/steps.py`` once, as one rank of the production mesh, on stand-in
tensors, and records what that rank would hold and do:

* one process, ``torch.distributed`` on the fake backend
  (``torch.testing._internal.distributed.fake_pg``, rank 0 of 256 or 512)
  under a ``DeviceMesh`` of the production shape
  (``launch/mesh.make_production_mesh``) — or any mesh a caller passes, over
  a real group too;
* parameters, caches and inputs as fake tensors (``FakeTensorMode``) built
  through ``launch/input_specs``, laid out by ``distribute_params``;
* the step's FLOPs, HBM bytes and collectives counted on this rank's own
  blocks (``StepCounter``; ``roofline.count_collectives`` gives the same
  collectives), its peak bytes by
  ``torch.distributed._tools.mem_tracker.MemTracker``.

What is counted, a rank:

* **FLOPs**: ``torch.utils.flop_counter``'s count of each matmul-like op on
  the rank's local tensors (DTensor's global-shape op is not counted: the
  counter lets DTensor run and counts the local ops it issues).
* **HBM bytes**: every op's input and output bytes on the rank, views
  excepted — each op reads its operands from memory and writes its result
  back, with no fusion: an upper bound of the traffic a fused step needs.
* **collectives**: each collective's output bytes, by kind.
* **memory**: ``argument_bytes`` the parameters, cache and inputs a rank
  holds; ``peak_bytes`` MemTracker's peak over the step with them;
  ``fits_80gb_hbm`` against the H100's 80 GB.

Counts are taken at full depth (an eager run counts every layer), and at
depth 1 and 2: ``depth_check`` records whether ``extrapolate_depth`` of
those two equals the full count — the reference's assumption, checked —
and whether the unclamped line through them does (``extrapolate_depth``
clamps the depth-0 base at 0; the port's first period can cost less than
the next, its input laid out as the embedding leaves it).
The roofline counts run the train step as one microbatch of the whole
batch, as the reference's roofline lowering does; the memory run is one
microbatch of the real step (one sequence a data shard), whose peak the
real step's M microbatches repeat.

**A MoE layer's host read.** Its group sizes are read on the host
(``.tolist()``), which a fake tensor cannot give. Under ``FakeTensorMode``
only, every expert gets the balanced T·k/E rows (``blocks.host_read``), the
routing ``model_flops_per_step`` assumes; the real path keeps its one read.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu     # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch qwen2.5-3b \\
      --shape train_4k --mesh single                                   # one combo
  ... --skip-roofline                                                  # memory only
Results accumulate in results/dryrun_torch/<arch>__<shape>__<mesh>.json.
``--device`` defaults to ``cuda``: fake CUDA tensors allocate nothing, but
need a PyTorch built with CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch._tree import tree_leaves
from repro_torch.configs import REGISTRY
from repro_torch.launch import roofline as rl
from repro_torch.launch.input_specs import (
    SHAPES, cache_shape, cache_shardings, params_shape, resolve_config, shape_applicable, token_specs,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import data_parallel_size, make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.init import distribute_params, param_pspecs
from repro_torch.models.sharding import mesh_sizes, use_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
_GB = 1e9


def _mesh_label(mesh) -> str:
    sizes = mesh_sizes(mesh)
    return "x".join(str(s) for s in sizes.values()) + ":" + ",".join(sizes)


def _local_bytes(tree) -> int:
    """The bytes this rank holds of a tree (a DTensor's local block)."""
    total = 0
    for t in tree_leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation runs this op: on a cache miss
    it runs the op on global-shape stand-ins, under the active fake mode
    when there is one."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        if "tensor_meta" in code.co_name and code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


class StepCounter(TorchDispatchMode):
    """FLOPs and HBM bytes of the ops this rank runs on its own tensors,
    and its collectives (as ``roofline.count_collectives``). DTensor's
    global-shape ops are handed back (``NotImplemented``) so that DTensor
    issues its local ops, which are counted; the ops DTensor's sharding
    propagation runs under its own fake mode are not."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.stats = rl.CollectiveStats({k: 0 for k in rl.COLLECTIVE_KINDS}, {k: 0 for k in rl.COLLECTIVE_KINDS},
                                        False)
        self._collectives = rl._CollectiveCounter(self.stats, None)

    def __enter__(self):
        self._entry_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func.namespace in ("_c10d_functional", "c10d"):
            return self._collectives.__torch_dispatch__(func, types, args, kwargs)
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry_mode or _in_propagation():  # DTensor's, on global shapes
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
            kw = {k: tuple(v.shape) if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
            out_shape = tuple(out.shape) if isinstance(out, torch.Tensor) else [
                tuple(o.shape) if isinstance(o, torch.Tensor) else o for o in out]
            self.flops += flop_registry[packet](*shapes, **kw, out_val=out_shape)
        if not func.is_view:
            self.hbm_bytes += rl._nbytes(list(args)) + rl._nbytes(list(kwargs.values())) + rl._nbytes(out)
        return out


def _mem_tracker():
    """A ``MemTracker`` that, as ``StepCounter``, leaves out the ops of
    DTensor's sharding propagation."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(t is DTensor for t in types) and _in_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Tracker()


@dataclasses.dataclass
class StepRun:
    """What one run of a step gave on this rank."""

    flops: float
    hbm_bytes: float
    collectives: rl.CollectiveStats
    param_bytes: int
    cache_bytes: int
    input_bytes: int
    output_bytes: int
    peak_bytes: int | None


def build_step(cfg, shape, mesh, *, device="cuda", single_microbatch: bool = False, dtype=torch.bfloat16):
    """(step, args, inputs) of ``cfg`` × ``shape`` on ``mesh``: the step of
    ``launch/steps.py`` and its arguments — parameters (and a decode cache)
    laid out by ``param_pspecs`` (and ``cache_shardings``), the inputs of
    ``token_specs`` ({name: tensor}, also among ``args``). Under a
    ``FakeTensorMode`` they are stand-ins; outside one, real tensors (the
    token ids then uninitialized: the caller fills them). The train step
    runs the reference's optimizer (SGD, no state) and gradient dtype (bf16
    accumulators above 100 B parameters); ``single_microbatch``: the whole
    batch in one microbatch (the roofline lowering); else one microbatch of
    the real step (one sequence a data shard)."""
    from repro_torch.optim.sgd import sgd

    structs, _ = token_specs(cfg, shape, mesh, device=device)
    full = params_shape(cfg, dtype=dtype, device=device)
    specs = param_pspecs(cfg, full, mesh)
    params = distribute_params(full, specs, mesh)
    del full
    if shape.kind == "train":
        dp = data_parallel_size(mesh)
        B = shape.global_batch
        if single_microbatch:
            mps = max(B // dp, 1)
        else:
            mps = 1
            structs = {k: v[: min(dp, B)] for k, v in structs.items()}
        gdt = torch.bfloat16 if cfg.param_count() > 100e9 else torch.float32
        step = make_train_step(cfg, mesh, opt=sgd(3e-3), microbatch_per_shard=mps, param_specs=specs,
                               grad_dtype=gdt)
        return step, [params, ()] + [structs[k] for k in ("tokens", "targets", "prefix_emb") if k in structs], structs
    if shape.kind == "prefill":
        step = make_prefill_step(cfg)
        return step, [params] + [structs[k] for k in ("tokens", "prefix_emb") if k in structs], structs
    cache = cache_shape(cfg, shape, dtype=dtype, device=device)
    cache = distribute_params(cache, cache_shardings(cfg, shape, mesh, cache), mesh)
    return make_serve_step(cfg), [params, cache, structs["tokens"]], structs


def run_step(cfg, shape, mesh, *, device="cuda", single_microbatch: bool = False, memory: bool = False,
             dtype=torch.bfloat16) -> StepRun:
    """``build_step``'s step run once on fake tensors on ``device``, counted
    on this rank. ``memory``: also track the peak bytes (MemTracker)."""
    # the stand-ins are made under a fake mode; the step runs outside it, as
    # on real tensors: DTensor's own small host tensors stay real, and its
    # sharding propagation takes a fake mode of its own
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, structs = build_step(cfg, shape, mesh, device=device, single_microbatch=single_microbatch,
                                         dtype=dtype)
    params = args[0]
    cache = args[1] if shape.kind == "decode" else None
    inputs = _local_bytes(list(structs.values()))
    counter = StepCounter()
    tracker = _mem_tracker() if memory else contextlib.nullcontext()
    if memory:
        tracker.track_external(*tree_leaves(params), *tree_leaves(cache), *structs.values())
    with use_mesh(mesh), tracker, counter:
        out = step(*args)
    peak = None
    if memory:
        snap = tracker.get_tracker_snapshot("peak")
        peak = int(max(v["Total"] for v in snap.values()))
    return StepRun(flops=float(counter.flops), hbm_bytes=float(counter.hbm_bytes), collectives=counter.stats,
                   param_bytes=_local_bytes(params), cache_bytes=_local_bytes(cache), input_bytes=inputs,
                   output_bytes=_local_bytes(out), peak_bytes=peak)


def _at_depth(cfg, n_periods: int):
    return dataclasses.replace(cfg, n_layers=len(cfg.period) * n_periods)


def run_combo(arch: str, shape_name: str, mesh, *, skip_roofline: bool = False, device="cuda", cfg=None,
              shape=None, dtype=torch.bfloat16) -> dict:
    """The record of one (arch, shape, mesh): ``mesh`` a ``DeviceMesh`` over
    the current default group (the fake backend, or real ranks: the step
    then runs on fake tensors and moves nothing). ``cfg`` and ``shape``: a
    caller's own (e.g. depth cut, a smaller batch) in place of
    ``resolve_config(arch, SHAPES[shape_name])``; ``dtype`` the parameters'
    and the cache's (the reference's bf16 by default)."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or resolve_config(arch, shape)
    label = _mesh_label(mesh)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": label, "config": cfg.name, "device": str(device)}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.time()
    # 1) full depth, one microbatch of the real step — the memory a rank
    mem = run_step(cfg, shape, mesh, device=device, memory=True, dtype=dtype)
    argument = mem.param_bytes + mem.cache_bytes + mem.input_bytes
    rec["memory"] = {
        "argument_bytes": argument,
        "output_bytes": mem.output_bytes,
        "temp_bytes": max(mem.peak_bytes - argument, 0),
        "peak_bytes": mem.peak_bytes,
        "param_bytes": mem.param_bytes,
        "cache_bytes": mem.cache_bytes,
        "input_bytes": mem.input_bytes,
    }
    rec["fits_80gb_hbm"] = mem.peak_bytes < rl.HBM_BYTES
    rec["count_s_full"] = round(time.time() - t0, 1)

    if not skip_roofline:
        # 2) the roofline counts at full depth and at depth 1 and 2
        full = run_step(cfg, shape, mesh, device=device, single_microbatch=True, dtype=dtype)
        d1 = run_step(_at_depth(cfg, 1), shape, mesh, device=device, single_microbatch=True, dtype=dtype)
        d2 = run_step(_at_depth(cfg, 2), shape, mesh, device=device, single_microbatch=True, dtype=dtype)
        P = cfg.n_periods

        checks = {
            "flops": (full.flops, d1.flops, d2.flops),
            "hbm_bytes": (full.hbm_bytes, d1.hbm_bytes, d2.hbm_bytes),
            "collective_bytes": (full.collectives.total_bytes, d1.collectives.total_bytes, d2.collectives.total_bytes),
        }
        # "extrapolated": the reference's extrapolate_depth, whose base is
        # clamped at 0; "linear": the same line unclamped, d1 + (P − 1)·(d2 − d1)
        rec["depth_check"] = {}
        for k, (a, v1, v2) in checks.items():
            ext, lin = rl.extrapolate_depth(float(v1), float(v2), P), float(v1) + (P - 1) * (float(v2) - float(v1))
            rec["depth_check"][k] = {"full": float(a), "depth1": float(v1), "depth2": float(v2), "extrapolated": ext,
                                     "equal": float(a) == ext, "linear": lin, "linear_equal": float(a) == lin}
        n_dev = math.prod(mesh_sizes(mesh).values())
        terms = rl.RooflineTerms(
            arch=arch,
            shape=shape_name,
            mesh=label,
            flops=full.flops,
            hbm_bytes=full.hbm_bytes,
            collective_bytes=float(full.collectives.total_bytes),
            collective_breakdown={k: v for k, v in full.collectives.bytes_by_kind.items() if v},
            model_flops=rl.model_flops_per_step(cfg, shape, shape.kind) / n_dev,
        )
        rec["roofline"] = terms.row()
        rec["roofline"]["collectives_in_while"] = False
        rec["roofline"]["collective_counts"] = {k: v for k, v in full.collectives.count_by_kind.items() if v}

    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of ``world`` ranks on the fake backend, this
    process rank 0, for the block (no other process, no communication)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), help="one shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--skip-roofline", action="store_true")
    ap.add_argument("--device", default="cuda", help="the fake tensors' device (default cuda; cpu on a "
                                                     "PyTorch without CUDA)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(REGISTRY)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", True))

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for mlabel, multi in meshes:
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device=args.device)
            for arch in archs:
                for shape_name in shapes:
                    tag = f"{arch}__{shape_name}__{mlabel}"
                    out = RESULTS_DIR / f"{tag}.json"
                    try:
                        # roofline terms are single-pod deliverables; multi-pod
                        # proves the pod axis runs (memory only)
                        rec = run_combo(arch, shape_name, mesh, device=args.device,
                                        skip_roofline=args.skip_roofline or mlabel == "multi")
                    except Exception as e:  # a failure here is a bug in the port's sharding
                        rec = {
                            "arch": arch, "shape": shape_name, "mesh": mlabel,
                            "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-4000:],
                        }
                        failures.append(tag)
                    out.write_text(json.dumps(rec, indent=2, default=str))
                    status = rec["status"]
                    extra = ""
                    if status == "ok" and "memory" in rec:
                        extra = f" peak={rec['memory']['peak_bytes'] / _GB:.2f}GB"
                        if "roofline" in rec:
                            r = rec["roofline"]
                            extra += (
                                f" compute={r['compute_s'] * 1e3:.2f}ms"
                                f" memory={r['memory_s'] * 1e3:.2f}ms"
                                f" collective={r['collective_s'] * 1e3:.2f}ms"
                                f" dominant={r['dominant']}"
                            )
                    print(f"[{status:7s}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} combinations failed: {failures}")
    print("ALL DRY-RUN COMBINATIONS RAN.")


if __name__ == "__main__":
    main()
