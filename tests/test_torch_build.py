"""The port's kernel build: every source exists, its local includes are
hashed, and an edited header names a new library.

Hashing needs no ``nvcc``; the build itself runs only where there is one
(``chip_smoke.py`` phase 1).
"""
import re
import shutil
import subprocess
import sys

import pytest

from repro_torch.kernels import build

INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def test_every_kernel_source_exists_and_its_includes_are_hashed():
    assert set(build.SOURCES) == {"wavefront", "mmw", "expand", "bloom",
                                  "paths"}
    hashed = {p.resolve() for p in build.headers()}
    for name, src in build.SOURCES.items():
        assert src.is_file(), src
        for inc in INCLUDE.findall(src.read_text()):
            assert (src.parent / inc).resolve() in hashed, (name, inc)
    targets = {build._target(name) for name in build.SOURCES}
    assert len(targets) == len(build.SOURCES)
    assert all(t.parent == build.BUILD_DIR and t.suffix == ".so"
               for t in targets)


@pytest.fixture
def kernel_tree(tmp_path, monkeypatch):
    """A copy of the kernel sources and headers under tmp_path, with the
    build module pointed at it."""
    pkg, root = build._PKG, tmp_path / "kernels"
    for path in list(build.SOURCES.values()) + build.headers():
        dest = root / path.relative_to(pkg)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, dest)
    monkeypatch.setattr(build, "_PKG", root)
    monkeypatch.setattr(build, "SOURCES", {
        name: root / path.relative_to(pkg)
        for name, path in build.SOURCES.items()})
    return root


def test_edited_header_or_source_names_a_new_library(kernel_tree):
    before = {name: build._target(name) for name in build.SOURCES}
    assert build._target("wavefront") == before["wavefront"]   # stable
    header = kernel_tree / "common" / "bits.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build._target(name) for name in build.SOURCES}
    for name in ("wavefront", "mmw", "expand"):
        assert after[name] != before[name], name
    src = kernel_tree / "bloom" / "csrc" / "bloom.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build._target("bloom") != after["bloom"]
    assert build._target("mmw") == after["mmw"]
    (kernel_tree / "notes.txt").write_text("not a header")
    assert build._target("mmw") == after["mmw"]


def test_flags_are_part_of_the_name(monkeypatch):
    before = build._target("mmw")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("mmw") != before


def test_build_lock_excludes_other_processes(tmp_path, monkeypatch):
    """A build holds ``<name>.lock``: another process (a rank of the
    distributed solver) waits for it instead of running nvcc too."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    probe = ("import fcntl, sys\n"
             "f = open(sys.argv[1], 'w')\n"
             "try:\n"
             "    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
             "except BlockingIOError:\n"
             "    print('held')\n"
             "else:\n"
             "    print('free')\n")

    def other_process():
        return subprocess.run(
            [sys.executable, "-c", probe, str(tmp_path / "mmw.lock")],
            capture_output=True, text=True, timeout=60).stdout.strip()

    with build._build_lock("mmw"):
        assert other_process() == "held"
    assert other_process() == "free"
