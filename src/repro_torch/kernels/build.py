"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface.  On first use it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root, named by a hash of its
source, and loaded with ``ctypes``.  ``build_all`` starts one ``nvcc`` per
source at once.  A missing compiler or a failed build raises: nothing
falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

# kernel name -> its source, relative to this package
SOURCES = {
    "wavefront": _PKG / "wavefront" / "csrc" / "wavefront.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "built from source on first use")


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: pathlib.Path, job) -> str:
    """Wait for a build started by ``_start``; returns nvcc's output."""
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}:\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> dict:
    """Build every kernel source concurrently; returns name -> nvcc output
    (empty for libraries that were already built)."""
    with _LOCK:
        jobs = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, *jobs[name]) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target, job = _start(name)
            _finish(name, target, job)
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib
