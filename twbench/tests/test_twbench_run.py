"""A tiny copy of each cell runs end to end on the CPU and gives the one
result line; the command itself refuses to run without a card; nothing a
run imports is JAX or the JAX package."""
import io
import json
import os
import subprocess
import sys

import pytest

from twbench import harness

from conftest import ROOT, tiny_manifest

MAN = tiny_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_result_line(tiny, cell, trace):
    root, bench = tiny
    log = io.StringIO()
    out = harness.run_cell(cell, 2 ** 33 + 1, 1.5, bool(trace),
                           device="cpu", root=root, bench=bench, log=log)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True, log.getvalue()
    assert line["failed"] == 0 and line["attempted"] >= 1
    e2e = {m["name"] for m in harness.e2e_of(MAN, cell)}
    if trace:
        assert line["metrics"] and not set(line["metrics"]) & e2e
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert log.getvalue().rstrip().splitlines()[-1].startswith("check ")


def test_command_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "twbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_command_fails_without_the_program(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "twbench", tmp_path / "twbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = subprocess.run(
        [sys.executable, "twbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_no_jax_in_a_run(tiny):
    root, bench = tiny
    code = (
        "import sys, io; sys.path[:0] = [%r, %r]\n"
        "from twbench import harness\n"
        "import pathlib\n"
        "for c in %r:\n"
        "    harness.run_cell(c, 3, 1.0, False, device='cpu',\n"
        "        root=pathlib.Path(%r), bench=pathlib.Path(%r),\n"
        "        log=io.StringIO())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(ROOT / "src"), CELLS, str(root), str(bench))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(json.loads(r.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
