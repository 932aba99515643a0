"""A tiny copy of the benchmark for the CPU tests: the real manifest,
configurations and readers, with each mix cut to a size a test run can
hold: two relabellings of queen5_5 with a 256-row list and a
three-instance suite (myciel3, petersen, myciel4), each warmed up with
myciel3."""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "closed_solve": {"instances": ["queen5_5", "queen5_5"],
                     "knobs": {"cap": 256, "block": 128},
                     "warmup": ["myciel3"]},
    "closed_suite": {"instances": ["myciel3", "petersen", "myciel4"],
                     "warmup": ["myciel3"]},
}


def tiny_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root, bench) of the tiny copy."""
    root = tmp_path_factory.mktemp("tiny")
    bench = root / "twbench"
    src = ROOT / "twbench"
    shutil.copytree(src / "configs", bench / "configs")
    shutil.copytree(src / "metrics", bench / "metrics")
    (bench / "traffic").mkdir()
    man = tiny_manifest()
    for w in man["workloads"]:
        mix = json.loads((src / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        mix.update(TINY[mix["kind"]])
        (bench / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, bench
