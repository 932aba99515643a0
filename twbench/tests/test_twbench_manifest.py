"""BENCHMARK.json keeps to the benchmark's contract, and every file it
names is found by name."""
import json
import re

import pytest

from twbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024
    assert MAN["command"][:2] == ["python3", "twbench/run.py"]
    assert len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_names_and_units(group, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    w, cfg, mix = harness.cell_parts(MAN, cell)
    assert cfg["name"] == w["config"]
    assert mix["kind"] in ("closed_solve", "closed_suite")
    e2e = {m["name"] for m in harness.e2e_of(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MAN["per_layer"] if harness.reports(m, cell, e2e)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))


def test_config_files_under_paths():
    for c in MAN["configs"]:
        assert c["file"].startswith("twbench/configs/")
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "name"] == c["name"]
