"""On the card: one short run of each cell is correct, and its control is
not.  Skips without a card (run with ``-m cuda`` there)."""
import io

import pytest

from twbench import harness

MAN = harness.manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_and_control_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(cell, 2 ** 32 + 77, 5.0, False, log=io.StringIO())
    assert out["correct"] is True and out["failed"] == 0
    ctl = harness.run_cell(cell, 2 ** 32 + 78, 5.0, False,
                           log=io.StringIO(), control=True)
    assert ctl["correct"] is False
