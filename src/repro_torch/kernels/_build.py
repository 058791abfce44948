"""Build the CUDA sources under ``csrc/`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes one
shared library, compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``build/repro_torch_kernels/`` at the root of the checkout. The
file name carries a
hash of the source and of the flags, so an edit rebuilds and an
unchanged source is loaded as it is. Nothing is compiled on import;
``build_all`` starts one ``nvcc`` per source, all together. A missing
``nvcc`` or a failed compilation raises with the compiler's output —
there is no other way to get a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNEL_SOURCES = ("ell_gram", "sstep_inner")


def build_dir() -> pathlib.Path:
    # src/repro_torch/kernels/_build.py → the checkout's root
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def source_path(name: str) -> pathlib.Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256()
    digest.update(source_path(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, out: pathlib.Path) -> tuple[subprocess.Popen, pathlib.Path]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: pathlib.Path, out: pathlib.Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source_path(name)} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES) -> dict[str, pathlib.Path]:
    """Compile every source that has no up-to-date library yet — one
    ``nvcc`` process each, started together — and return their paths."""
    outs = {name: library_path(name) for name in names}
    running = {
        name: _start_build(name, out) for name, out in outs.items() if not out.exists()
    }
    errors = []
    for name, (proc, tmp) in running.items():
        try:
            _finish_build(name, proc, tmp, outs[name])
        except RuntimeError as err:  # let the other compilers end before raising
            errors.append(err)
    if errors:
        raise errors[0]
    return outs


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be. The
    caller sets ``argtypes``/``restype`` and keeps the handle."""
    return ctypes.CDLL(str(build_all((name,))[name]))
