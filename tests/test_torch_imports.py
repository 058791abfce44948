"""The port stands alone: importing ``repro_torch`` and every module of
it loads neither ``jax`` nor ``repro``; its sources never name them;
and ``device=None`` means the CUDA device or an error, never a quiet
landing on the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

SLICE_MODULES = [
    "repro_torch", "repro_torch.sparse.csr", "repro_torch.sparse.partition",
    "repro_torch.sparse.synthetic", "repro_torch.sparse.ell", "repro_torch.core.objective",
    "repro_torch.core.problem", "repro_torch.core.teams", "repro_torch.core.comm",
    "repro_torch.core.engine", "repro_torch.core.sgd", "repro_torch.core.sstep",
    "repro_torch.core.fedavg", "repro_torch.core.hybrid", "repro_torch.kernels.ref",
    "repro_torch.kernels.ell_gram", "repro_torch.kernels.sstep_inner",
    "repro_torch.kernels._build", "repro_torch.costmodel", "repro_torch.costmodel.machines",
    "repro_torch.costmodel.hockney", "repro_torch.costmodel.optimum",
    "repro_torch.costmodel.calibrate", "repro_torch.costmodel.refine",
    "repro_torch.costmodel.topology", "repro_torch.core.faults", "repro_torch.obs",
    "repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.train",
    "repro_torch.train.checkpoint", "repro_torch.api", "repro_torch.api.spec",
    "repro_torch.api.plan", "repro_torch.api.report", "repro_torch.api.run",
    "repro_torch.api.session", "repro_torch.api.sweep", "repro_torch.core.distributed",
    "repro_torch.obs.export", "repro_torch.launch", "repro_torch.launch.trace",
    "repro_torch.serve", "repro_torch.serve.stream", "repro_torch.serve.ingest",
    "repro_torch.serve.store", "repro_torch.serve.server", "repro_torch.serve.controller",
    "repro_torch.launch.serve", "repro_torch.launch.sweep",
    "repro_torch.kernels.tune", "repro_torch.launch.roofline", "repro_torch.models",
    "repro_torch.models.config", "repro_torch.models.init", "repro_torch.models.blocks",
    "repro_torch.models.transformer", "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.qwen2_5_3b", "repro_torch.configs.gemma_2b", "repro_torch.configs.granite_34b",
    "repro_torch.configs.mistral_nemo_12b", "repro_torch.configs.musicgen_medium",
    "repro_torch.configs.llava_next_mistral_7b", "repro_torch.configs.deepseek_v2_lite_16b",
    "repro_torch.configs.granite_moe_3b_a800m", "repro_torch.configs.jamba_1_5_large_398b",
    "repro_torch.configs.falcon_mamba_7b", "repro_torch.optim", "repro_torch.optim.sgd",
    "repro_torch.train.data", "repro_torch.train.loop", "repro_torch.launch.train",
    "repro_torch.launch.steps", "repro_torch.launch.mesh", "repro_torch.models.sharding",
    "repro_torch.models.moe_ep", "repro_torch.optim.hybrid2d",
]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in ("jax", "jaxlib", "repro", "triton") if m in sys.modules]
print("MODULES", " ".join(sorted(names)))
print("LOADED", " ".join(loaded))
"""


def test_importing_the_port_loads_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) if " " in line else (line, "") for line in out.stdout.splitlines())
    assert lines["LOADED"] == ""
    imported = set(lines["MODULES"].split())
    assert set(SLICE_MODULES) <= imported


def _port_sources():
    return sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "pattern",
    [r"^\s*(import|from)\s+jax\b", r"^\s*(import|from)\s+repro(\.|\s)", r"torch\.compile",
     r"scaled_dot_product_attention", r"torch/extension\.h"],
    ids=["import-jax", "import-repro", "torch-compile", "sdpa", "torch-extension-header"],
)
def test_port_sources_never_name(pattern):
    rx = re.compile(pattern, re.MULTILINE)
    sources = _port_sources()
    assert len(sources) > 20 and all(p.exists() for p in sources)
    hits = [str(p.relative_to(ROOT)) for p in sources if rx.search(p.read_text())]
    assert hits == []


def test_every_kernel_has_source_plain_version_and_counter():
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_gram import ell_gram_and_v, ell_gram_and_v_blocked
    from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref

    for name in _build.KERNEL_SOURCES:
        text = _build.source_path(name).read_text()
        assert "Replaces: src/repro/kernels/" in text and 'extern "C"' in text
        assert _build.library_path(name).parent == _build.build_dir()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    # one count per mode of each kernel
    for counts in (ell_gram_and_v.launches, sstep_inner.launches):
        assert set(counts) == {"fp32", "bf16"} and all(isinstance(c, int) for c in counts.values())
    assert callable(ell_gram_and_v_blocked) and callable(sstep_inner_ref)
    # the build directory is git-ignored
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_device_none_means_cuda_or_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to succeed")
    from repro_torch import resolve_device
    from repro_torch.api import ExperimentSpec, MeshSpec, Session, run, sweep
    from repro_torch.core.engine import ParallelSGDSchedule
    from repro_torch.core.problem import make_problem, problem_from_numpy
    from repro_torch.core.teams import stack_row_teams, team_problem_from_numpy
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import sweep as sweep_cli
    from repro_torch.serve import DriftStream, ModelStore
    from repro_torch.serve.ingest import stream_team_problem
    from repro_torch.sparse.ell import ell_from_csr
    from repro_torch.sparse.synthetic import make_skewed_csr
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import tune
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_cache, init_params, params_from_numpy
    from repro_torch.train import train

    a = make_skewed_csr(16, 20, 3, 0.0, seed=0)
    y = np.ones(16)
    idx, val, valid = np.zeros((1, 8, 2), np.int32), np.zeros((1, 8, 2)), np.ones((1, 8), bool)
    spec = ExperimentSpec(dataset="rcv1-sm", mesh=MeshSpec(p_r=2, p_c=2),
                          schedule=ParallelSGDSchedule.hybrid(2, 2, 8, 0.05, 8, rounds=2))
    Session(spec, device="cpu").save(tmp_path / "ck")  # the device is never in the checkpoint
    calls = [
        lambda: Session(spec),
        lambda: run(spec),
        lambda: Session.restore(tmp_path / "ck"),
        lambda: Session.restore_elastic(tmp_path / "ck", devices=2),
        lambda: sweep([spec], resume_dir=tmp_path / "sweep"),
        lambda: resolve_device(None),
        lambda: ell_from_csr(a),
        lambda: make_problem(a, y),
        lambda: stack_row_teams(a, y, 2),
        lambda: team_problem_from_numpy(idx, val, valid, p=1, m=8, n=4),
        lambda: problem_from_numpy(idx[0], val[0], valid[0], m=8, n=4),
        lambda: ModelStore(),
        lambda: stream_team_problem(DriftStream(n=20, rows=8).batch(0), 2, 20, None),
        lambda: serve_cli.main(["--spec", str(ROOT / "examples/specs/serve_drift.json"), "--rounds", "1"]),
        lambda: sweep_cli.main(["--spec", str(ROOT / "examples/specs/rcv1_hybrid.json")]),
        lambda: init_params(reduced(get_config("qwen2.5-3b"))),
        lambda: init_params(reduced(get_config("jamba-1.5-large-398b"))),
        lambda: init_cache(reduced(get_config("deepseek-v2-lite-16b")), 1, 8),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: train(reduced(get_config("qwen2.5-3b")), steps=1),
        lambda: train_cli.main(["--arch", "qwen2.5-3b", "--steps", "1"]),
        lambda: tune.device_kind(),
        lambda: tune.tune_panel(tune.PanelProfile(rows=8, width=4, n_local=64)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert ell_from_csr(a, device="cpu").values.device.type == "cpu"


def test_kernels_cannot_be_built_without_nvcc_and_say_so():
    """No compiler here: asking for a kernel library raises with the
    reason; nothing falls back."""
    import shutil

    from repro_torch.kernels import _build

    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
