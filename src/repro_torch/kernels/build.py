"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface.  On first use it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root, named by a hash of its
source, of every header a kernel may include (``*.cuh`` under this
package) and of the flags, and loaded with ``ctypes``.  ``build_all``
starts one ``nvcc`` per source at once.  A missing compiler or a failed
build raises: nothing falls back to the plain PyTorch versions.

A build holds an exclusive ``flock`` on ``<name>.lock`` in the build
directory, so processes that start together (the distributed solver's
ranks) run one ``nvcc`` per source between them: the others wait and
load the library it wrote.  The lock goes with the process that holds
it, so a killed build leaves none behind.

``check_operands``, ``require_cuda`` and ``check_launch`` are the
wrappers' shared checks.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

# kernel name -> its source
SOURCES = {
    name: _PKG / name / "csrc" / f"{name}.cu"
    for name in ("wavefront", "mmw", "expand", "bloom", "paths")
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


def headers() -> list:
    """Every header a kernel source may include, in a fixed order."""
    return sorted(_PKG.rglob("*.cuh"))


def _target(name: str) -> pathlib.Path:
    """The library of kernel ``name``: its name hashes the source, every
    header and the flags, so an edited header builds anew."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for path in headers():
        h.update(str(path.relative_to(_PKG)).encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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


@contextlib.contextmanager
def _build_lock(name: str):
    """Hold the inter-process build lock of kernel ``name``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> dict:
    """Build every kernel source concurrently; returns name -> nvcc output
    (empty for libraries that were already built)."""
    with _LOCK, contextlib.ExitStack() as locks:
        for name in SOURCES:
            locks.enter_context(_build_lock(name))
        jobs = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, *jobs[name]) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with _build_lock(name):
                target, job = _start(name)
                _finish(name, target, job)
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib


def check_operands(op: str, device, **operands) -> None:
    """Raise unless every operand ``name=(tensor, dtype)`` lies on
    ``device``, has ``dtype`` and is contiguous."""
    for name, (t, dtype) in operands.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def require_cuda(op: str, t) -> None:
    """Raise unless ``t`` lies on a CUDA device (the CPU takes the plain
    version before this is reached)."""
    if t.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {t.device}")


def check_launch(op: str, err: int, detail: str) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err} "
                           f"({detail})")
