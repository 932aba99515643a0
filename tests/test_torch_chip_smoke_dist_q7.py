"""``chip_smoke.py``'s EXPECTED_DIST for queen7_7 is the JAX package's.

Split from ``tests/test_torch_chip_smoke_dist.py``: the reference's
distributed queen7_7 (4 forced host devices, cap_local 2^16, block
1024; it overflows per device) takes about a minute on the CPU.
"""
from test_torch_chip_smoke import _chip_smoke
from test_torch_chip_smoke_dist import dist_rows


def test_dist_queen7_7_value_comes_from_reference():
    chip_smoke = _chip_smoke()
    got = dist_rows(chip_smoke, [("queen7_7", {})], chip_smoke.DIST_RANKS)
    assert got == {"queen7_7": chip_smoke.EXPECTED_DIST["queen7_7"]}
    assert not got["queen7_7"]["exact"]
