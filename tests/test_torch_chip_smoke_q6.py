"""``chip_smoke.py``'s EXPECTED_SHARDS for queen6_6 are the JAX package's.

Split from ``tests/test_torch_chip_smoke.py``: each case takes about a
minute on the CPU, so the two files run side by side.
"""
import pytest

from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from test_torch_chip_smoke import _assert_row, _chip_smoke


@pytest.mark.parametrize("config", ["defaults", "bloom+mmw"])
@pytest.mark.parametrize("name", ["queen6_6"])
def test_chip_smoke_shard_values_come_from_reference(name, config):
    """EXPECTED_SHARDS is ``repro.core.solver.solve(g, shards=4)`` at the
    card's sizes (cap auto, block 2048, 2^24-bit filters)."""
    chip_smoke = _chip_smoke()
    got = ref_solver.solve(ref_graph.REGISTRY[name](),
                           shards=chip_smoke.SHARDS,
                           **chip_smoke.LANE_CONFIGS[config])
    _assert_row(got, chip_smoke.EXPECTED_SHARDS[config][name])
