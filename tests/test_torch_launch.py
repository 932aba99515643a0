"""Port surface: unported and ported flags, the backend registry, the CLI
and import hygiene.

Flags a backend cannot run must fail with ``BackendCapabilityError``
before any work;
ported ones run and match the reference, ``budget_bytes="auto"`` among
them (ROADMAP C1); the CLI prints the reference's result line;
``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
``repro``.  ``chip_smoke.py``'s expected values are pinned to the JAX
package's in ``tests/test_torch_chip_smoke*.py``.
"""
import json
import pathlib
import subprocess
import sys

import pytest

import oracle
from repro.core import solver as ref_solver
from repro_torch.core import backend, graph, solver, telemetry

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_graph(g):
    return graph.Graph(g.n, g.adj.copy(), g.name)


# the A3 schedules run on the torch backend (parity below); the cuda
# backend keeps the static doubling closure and rejects them, keeping the
# cases' ids
@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(backend="cuda", schedule="linear"), "doubling",
                 id="kw0-A3"),
    pytest.param(dict(backend="cuda", schedule="matmul"), "doubling",
                 id="kw1-A3"),
    (dict(backend="cuda", mode="bloom", m_bits=100), "multiple of 32"),
    pytest.param(dict(backend="cuda", schedule="while"), "doubling",
                 id="kw3-A3"),
    (dict(lanes=0), "lanes must be"), (dict(shards=0), "shards must be"),
    (dict(backend="cuda", shards=2), "CUDA device"),
    (dict(backend="cuda"), "CUDA device")])
def test_unported_flags_fail_before_work(kw, item):
    g = _port_graph(oracle.make_graph("petersen"))
    tr = telemetry.Tracker()
    with pytest.raises(backend.BackendCapabilityError, match=item):
        solver.solve(g, device="cpu", tracker=tr, **kw)
    assert tr.snapshot()["counters"] == {}


@pytest.mark.parametrize("kw", [dict(mode="bloom"), dict(use_mmw=True),
                                dict(use_simplicial=True), dict(shards=2),
                                dict(heuristics=4, start_k=0),
                                dict(schedule="linear"),
                                dict(schedule="matmul"),
                                dict(schedule="while")],
                         ids=["bloom", "mmw", "simplicial", "shards",
                              "heuristics", "linear", "matmul", "while"])
def test_ported_flags_run_and_match_reference(kw):
    g = oracle.make_graph("petersen")
    tr = telemetry.Tracker()
    got = solver.solve(_port_graph(g), device="cpu", tracker=tr, **kw)
    want = ref_solver.solve(g, **kw)
    assert (got.width, got.exact, got.lb, got.ub, got.expanded,
            got.per_k) == (want.width, want.exact, want.lb, want.ub,
                           want.expanded, want.per_k)
    assert tr.snapshot()["counters"]["expanded"] == got.expanded


def test_registry_surface():
    assert backend.BACKENDS == ("torch", "cuda")
    assert backend.DEDUP_MODES == ("sort", "bloom")
    both = ("torch", "cuda")
    assert backend.capability_table() == {
        "bloom_make_filter": both, "bloom_query_insert": both,
        "expand_degrees": both, "mmw_bound": both,
        "simplicial_mask": ("torch",), "sort_dedup": both,
        "wavefront_expand": both}
    from repro_torch.core import mmw
    assert backend.get_op("mmw_bound", "torch") is mmw.mmw_bound
    with pytest.raises(backend.BackendCapabilityError, match="fused"):
        backend.get_op("simplicial_mask", "cuda")
    with pytest.raises(backend.BackendCapabilityError, match="unknown op"):
        backend.get_op("mmw", "torch")
    with pytest.raises(backend.BackendCapabilityError, match="backend"):
        backend.get_op("wavefront_expand", "pallas")
    # only the packed (cuda) filter needs m_bits % 32 == 0
    backend.validate("torch", mode="bloom", m_bits=100)
    backend.validate("torch", shards=4, lanes=2)
    backend.validate("cuda", mode="bloom", m_bits=1 << 24, use_mmw=True,
                     use_simplicial=True)


def test_ops_equal_the_reference_ops():
    from repro.core import backend as ref_backend
    assert backend.ops() == ref_backend.ops()
    assert backend.ops() == tuple(sorted(backend.capability_table()))


def test_solve_many_auto_budget_equals_reference():
    from repro.core import batch as ref_batch
    from repro_torch.core import batch
    g = oracle.make_graph("petersen")
    [got] = batch.solve_many([_port_graph(g)], budget_bytes="auto",
                             device="cpu")
    [want] = ref_batch.solve_many([g], budget_bytes="auto")
    assert (got.width, got.expanded) == (4, 139)
    assert (got.width, got.exact, got.lb, got.ub, got.expanded,
            got.per_k) == (want.width, want.exact, want.lb, want.ub,
                           want.expanded, want.per_k)


def test_engine_counter_shims_read_the_root_tracker():
    from repro_torch.core import engine
    engine.reset_counters()
    assert all(v == 0 for v in engine.COUNTERS.values())
    engine.count(dispatches=2, host_syncs=1, shard_donations=3)
    assert (engine.COUNTERS["dispatches"], engine.COUNTERS["host_syncs"],
            engine.COUNTERS["shard_donations"]) == (2, 1, 3)
    assert engine.COUNTERS is telemetry.COUNTERS
    engine.reset_counters()
    assert engine.COUNTERS["dispatches"] == 0


def test_default_device_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solver.solve(_port_graph(oracle.make_graph("petersen")))


def _run(code_or_args, module=False):
    cmd = [sys.executable] + (["-m"] + code_or_args if module
                              else ["-c", code_or_args])
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin",
                               "JAX_PLATFORMS": "cpu",
                               "OMP_NUM_THREADS": "1"})


def test_cli_smoke_matches_reference_line():
    out = _run(["repro_torch.launch.solve", "--graph", "queen5_5",
                "--device", "cpu"], module=True)
    assert out.returncode == 0, out.stderr
    assert ("[solve] treewidth=18 exact=True lb=12 ub=18 "
            "states_expanded=2279") in out.stdout
    out = _run(["repro_torch.launch.solve", "--graph", "petersen",
                "--device", "cpu", "--reconstruct"], module=True)
    assert out.returncode == 0, out.stderr
    assert "elimination order verified: width=4" in out.stdout
    out = _run(["repro_torch.launch.solve", "--graph", "petersen",
                "--device", "cpu", "--mode", "bloom", "--mmw"], module=True)
    assert out.returncode == 0, out.stderr
    assert ("[solve] treewidth=4 exact=True lb=3 ub=5 "
            "states_expanded=108") in out.stdout
    out = _run(["repro_torch.launch.solve", "--graph", "queen5_5",
                "--device", "cpu", "--simplicial"], module=True)
    assert out.returncode == 0, out.stderr
    assert ("[solve] treewidth=18 exact=True lb=12 ub=18 "
            "states_expanded=2279") in out.stdout
    out = _run(["repro_torch.launch.solve", "--graph", "queen5_5",
                "--device", "cpu", "--batch", "4"], module=True)
    assert out.returncode == 0, out.stderr
    assert ("[solve] treewidth=18 exact=True lb=12 ub=18 "
            "states_expanded=2279") in out.stdout
    out = _run(["repro_torch.launch.solve", "--graph", "petersen",
                "--device", "cpu", "--batch", "0"], module=True)
    assert out.returncode == 2 and "lanes must be" in out.stderr


def test_import_hygiene_no_jax_no_repro():
    code = (
        "import sys, json\n"
        "import repro_torch, repro_torch.core.solver, "
        "repro_torch.core.engine, repro_torch.core.bloom, "
        "repro_torch.kernels.wavefront, repro_torch.kernels.mmw, "
        "repro_torch.kernels.expand, repro_torch.kernels.bloom, "
        "repro_torch.kernels.build, repro_torch.launch.solve, "
        "repro_torch.core.canon, repro_torch.serve.cache, "
        "repro_torch.serve.slots, repro_torch.serve.client, "
        "repro_torch.serve.twscheduler, repro_torch.launch.twserve, "
        "repro_torch.launch.twserved, repro_torch.workload, "
        "repro_torch.workload.__main__, repro_torch.core.distributed\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1].split(".")[0].rstrip(",")
            assert mod not in ("jax", "repro"), line
