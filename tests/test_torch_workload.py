"""The port's workload generator against the reference's: the same spec
gives byte-identical JSONL traces, the same bad specs fail at parse time
with the same message, and ``python -m repro_torch.workload`` writes the
file ``python -m repro.workload`` writes.

Twins of ``tests/test_workload.py``.
"""
import json
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings, strategies as st

from repro import workload as ref_wl
from repro_torch import workload as wl
from repro_torch.core import canon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace_bytes(mod, spec_dict, path):
    spec = mod.SweepSpec.parse(spec_dict) if isinstance(spec_dict, dict) \
        else spec_dict(mod)
    mod.write_trace(str(path), mod.generate(spec), spec)
    with open(path, "rb") as f:
        return f.read()


def _same_trace(tmp_path, spec):
    got = _trace_bytes(wl, spec, tmp_path / "port.jsonl")
    want = _trace_bytes(ref_wl, spec, tmp_path / "ref.jsonl")
    assert got == want
    return got


SPECS = {
    "quick": lambda m: m.quick_spec(duplicate_rate=0.5, iso_rate=0.25,
                                    requests=16, seed=4),
    "poisson_sweep_named": {
        "seed": 7, "requests": 40,
        "arrival": {"kind": "poisson", "rate_hz": 40.0},
        "sweep": {"nodes": [8, 10, 12], "p": [0.2, 0.4], "reps": 3},
        "named": {"names": ["petersen", "myciel3"], "reps": 2},
        "duplicate_rate": 0.5, "iso_rate": 0.25,
        "knobs": {"mode": ["sort", "bloom"], "reconstruct": False}},
    "knob_draws": {
        "seed": 5, "requests": 24,
        "named": {"names": ["petersen"], "reps": 1},
        "duplicate_rate": 0.3,
        "knobs": {"mode": ["sort", "bloom"], "reconstruct": False,
                  "seed": [0, 1, 2]}},
    "all_duplicates": {"seed": 2, "requests": 12,
                       "named": {"names": ["petersen"]},
                       "duplicate_rate": 1.0},
    "all_iso": lambda m: m.quick_spec(duplicate_rate=0.8, iso_rate=1.0,
                                      requests=24, seed=1),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_traces_are_byte_identical_to_the_reference(tmp_path, name):
    data = _same_trace(tmp_path, SPECS[name])
    lines = data.decode().splitlines()
    assert "meta" in json.loads(lines[0])
    back = wl.read_trace(str(tmp_path / "port.jsonl"))
    assert len(back) == len(lines) - 1
    assert wl.read_trace(str(tmp_path / "port.jsonl"))[0].t == 0.0


@given(st.integers(0, 10_000))
@settings(max_examples=8, deadline=None)
def test_property_trace_is_a_pure_function_of_the_spec(seed):
    def dump(mod, s):
        spec = mod.quick_spec(duplicate_rate=0.4, iso_rate=0.5, requests=12,
                              seed=s)
        return json.dumps([a.to_json() for a in mod.generate(spec)],
                          sort_keys=True)
    a = dump(wl, seed)
    assert a == dump(wl, seed) == dump(ref_wl, seed)
    assert a != dump(wl, seed + 1)


def test_iso_duplicates_are_isomorphic_but_byte_different():
    arrivals = wl.generate(wl.quick_spec(duplicate_rate=0.8, iso_rate=1.0,
                                         requests=24, seed=1))
    isos = [a for a in arrivals if a.iso]
    assert isos
    for a in isos:
        root = arrivals[a.dup_of]
        assert a.name.endswith("_iso") and a.n == root.n
        assert canon.graph_key(a.graph()) == canon.graph_key(root.graph())
    assert any(sorted(map(tuple, a.edges)) !=
               sorted(map(tuple, arrivals[a.dup_of].edges)) for a in isos)


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d.update(bogus=1), "unknown spec field"),
    (lambda d: d.update(seed="x"), "seed must be an int"),
    (lambda d: d.update(requests=0), "requests must be an int >= 1"),
    (lambda d: d.update(arrival={"kind": "burst"}), "arrival.kind"),
    (lambda d: d.update(duplicate_rate=1.5), "duplicate_rate"),
    (lambda d: d.update(sweep={"nodes": [8]}), "both nodes and p"),
    (lambda d: d.update(named={"names": ["not_a_graph"]}),
     "not in graph.REGISTRY"),
    (lambda d: d.update(knobs={"warp_speed": True}), "unknown knob"),
])
def test_bad_specs_fail_at_parse_time_as_in_the_reference(mutate, match):
    d = {"seed": 1, "requests": 4,
         "sweep": {"nodes": [8], "p": [0.5], "reps": 1}}
    mutate(d)
    with pytest.raises(wl.SpecError, match=match) as got:
        wl.SweepSpec.parse(dict(d))
    with pytest.raises(ref_wl.SpecError) as want:
        ref_wl.SweepSpec.parse(dict(d))
    assert str(got.value) == str(want.value)


def test_trace_without_meta_line_still_replays(tmp_path):
    a = wl.Arrival(idx=0, t=0.0, name="hand", n=3, edges=[[0, 1], [1, 2]])
    p = str(tmp_path / "bare.jsonl")
    with open(p, "w") as f:
        f.write(json.dumps(a.to_json()) + "\n\n")
    back = wl.read_trace(p)
    assert len(back) == 1 and back[0].graph().n_edges == 2
    assert ref_wl.read_trace(p)[0].to_json() == back[0].to_json()


def _cli(module, out):
    return subprocess.run(
        [sys.executable, "-m", module, "--quick", "--requests", "8",
         "--duplicate-rate", "0.5", "--seed", "3", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": os.path.join(ROOT, "src"),
             "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})


def test_cli_writes_the_reference_trace(tmp_path):
    port = _cli("repro_torch.workload", tmp_path / "port.jsonl")
    assert port.returncode == 0, port.stderr
    ref = _cli("repro.workload", tmp_path / "ref.jsonl")
    assert ref.returncode == 0, ref.stderr
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    assert len(wl.read_trace(str(tmp_path / "port.jsonl"))) == 8
    from repro_torch.workload import generator
    assert generator.main(["--quick", "--requests", "0", "--out",
                           str(tmp_path / "bad.jsonl")]) == 2
