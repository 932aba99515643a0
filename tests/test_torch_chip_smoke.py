"""``chip_smoke.py``'s expected values are the JAX package's.

Each table of expected results in ``chip_smoke.py`` (EXPECTED,
EXPECTED_FLAGS, EXPECTED_MANY, EXPECTED_SHARDS, EXPECTED_HEUR,
EXPECTED_UB) is recomputed here with the reference package on the CPU
and must be equal.  queen6_6's shard values are in
``tests/test_torch_chip_smoke_q6.py`` and the serving values in
``tests/test_torch_chip_smoke_serve.py``.
"""
import pathlib

import pytest

from repro.core import graph as ref_graph
from repro.core import solver as ref_solver

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["petersen", "queen5_5", "myciel4"])
def test_chip_smoke_expected_values_come_from_reference(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    want = chip_smoke.EXPECTED[name]
    got = ref_solver.solve(ref_graph.REGISTRY[name]())
    assert (got.width, got.exact, got.lb, got.ub, got.expanded) == (
        want["width"], want["exact"], want["lb"], want["ub"],
        want["expanded"])
    assert got.per_k == {want["block"]: {
        k: {"feasible": f, "inexact": i, "expanded": e}
        for k, f, i, e in want["per_k"]}}


@pytest.mark.parametrize("name", ["petersen", "myciel3", "queen5_5"])
def test_chip_smoke_suite_values_in_sort_mode_are_sequential(name):
    """``solve_many``'s default configuration gives each instance its
    sequential ``solve`` result (no padding caveat applies), so the lane
    phase's expected defaults are the reference's ``solve`` values."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    want = chip_smoke.EXPECTED_MANY["defaults"][name]
    got = ref_solver.solve(ref_graph.REGISTRY[name]())
    assert (got.width, got.exact, got.lb, got.ub, got.expanded) == (
        want["width"], want["exact"], want["lb"], want["ub"],
        want["expanded"])
    assert got.per_k == {want["block"]: {
        k: {"feasible": f, "inexact": i, "expanded": e}
        for k, f, i, e in want["per_k"]}}


@pytest.mark.parametrize("config", ["bloom+mmw", "simplicial"])
@pytest.mark.parametrize("name", ["petersen", "queen5_5", "myciel4"])
def test_chip_smoke_flag_values_come_from_reference(name, config):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    want = chip_smoke.EXPECTED_FLAGS[config][name]
    got = ref_solver.solve(ref_graph.REGISTRY[name](),
                           **chip_smoke.FLAG_CONFIGS[config])
    assert (got.width, got.exact, got.lb, got.ub, got.expanded) == (
        want["width"], want["exact"], want["lb"], want["ub"],
        want["expanded"])
    assert got.per_k == {want["block"]: {
        k: {"feasible": f, "inexact": i, "expanded": e}
        for k, f, i, e in want["per_k"]}}


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _assert_row(got, want):
    assert (got.width, got.exact, got.lb, got.ub, got.expanded) == (
        want["width"], want["exact"], want["lb"], want["ub"],
        want["expanded"])
    assert got.per_k == {want["block"]: {
        k: {"feasible": f, "inexact": i, "expanded": e}
        for k, f, i, e in want["per_k"]}}


MAIN_NAMES = ["petersen", "myciel4", "queen5_5", "queen6_6",
              pytest.param("queen7_7", marks=pytest.mark.slow)]
# queen6_6's shard pins take about a minute each on the CPU: they are in
# tests/test_torch_chip_smoke_q6.py, so that the two files run side by side
SHARD_NAMES = [n for n in MAIN_NAMES if n != "queen6_6"]


@pytest.mark.parametrize("config", ["defaults", "bloom+mmw"])
@pytest.mark.parametrize("name", SHARD_NAMES)
def test_chip_smoke_shard_values_come_from_reference(name, config):
    """EXPECTED_SHARDS is ``repro.core.solver.solve(g, shards=4)`` at the
    card's sizes (cap auto, block 2048, 2^24-bit filters)."""
    chip_smoke = _chip_smoke()
    got = ref_solver.solve(ref_graph.REGISTRY[name](),
                           shards=chip_smoke.SHARDS,
                           **chip_smoke.LANE_CONFIGS[config])
    _assert_row(got, chip_smoke.EXPECTED_SHARDS[config][name])


@pytest.mark.parametrize("name", MAIN_NAMES)
def test_chip_smoke_heuristic_values_come_from_reference(name):
    chip_smoke = _chip_smoke()
    got = ref_solver.solve(ref_graph.REGISTRY[name](),
                           heuristics=chip_smoke.HEURISTICS)
    _assert_row(got, chip_smoke.EXPECTED_HEUR[name])


def test_chip_smoke_sweep_widths_come_from_reference():
    from repro.core import bounds_engine as ref_be
    chip_smoke = _chip_smoke()
    pool = [(name, i) for name in chip_smoke.EXPECTED_UB
            for i in range(len(chip_smoke.UB_SEEDS))]
    assert len(pool) >= 16
    assert set(chip_smoke.EXPECTED_UB) == set(ref_graph.REGISTRY)
    out = ref_be.ub_orders_async(
        [ref_graph.REGISTRY[name]() for name, _ in pool],
        [chip_smoke.UB_SEEDS[i] for _, i in pool]).result()
    assert [w for w, _ in out] == [chip_smoke.EXPECTED_UB[name][i]
                                   for name, i in pool]
