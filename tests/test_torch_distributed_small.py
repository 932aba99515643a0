"""Port parity: the distributed solver on small meshes.

Split from ``tests/test_torch_distributed.py`` (same twins, see there):
petersen and queen5_5 on 1 and 2 ranks, and the simplicial case of
``tests/test_distributed_tw.py`` on 4.
"""
import pytest
import torch

import torch_dist_twins as twins


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("devices", [1, 2])
def test_small_meshes_match_reference(devices):
    rows = ("solve_rows", (["petersen", "queen5_5"],),
            dict(cap_local=(1 << 12) // devices, block=1 << 6))
    want, got = twins.both({"rows": rows}, devices)
    assert got == want


def test_simplicial_matches_reference():
    """The simplicial flag reaches the ranks' expansion: a tree collapses
    to one chain per level, with the reference's counts."""
    kw = dict(cap_local=1 << 10, block=32)
    want, got = twins.both({s: ("decide_tree", (12, 5, 1),
                                dict(use_simplicial=s, **kw))
                            for s in (False, True)}, 4)
    assert got == want
    assert got[True][0] and got[True][2] < got[False][2]
