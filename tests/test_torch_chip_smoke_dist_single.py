"""``chip_smoke.py``'s EXPECTED_DIST_SINGLE is the JAX package's.

Split from ``tests/test_torch_chip_smoke_dist.py``: the reference's
distributed queen6_6 on one device at cap_local 2^18 takes about half a
minute on the CPU.
"""
from test_torch_chip_smoke import _chip_smoke
from test_torch_chip_smoke_dist import dist_rows


def test_dist_single_rank_value_comes_from_reference():
    chip_smoke = _chip_smoke()
    got = dist_rows(chip_smoke, [(chip_smoke.DIST_SINGLE, {})], 1)
    assert got == {chip_smoke.DIST_SINGLE: chip_smoke.EXPECTED_DIST_SINGLE}
