"""``chip_smoke.py``'s serving values (phase 9) are the JAX package's.

EXPECTED_SERVE, EXPECTED_SERVE_FLAGS and EXPECTED_SERVE_HEUR must be what
the reference's ``TwScheduler`` gives on the CPU with the pool and the
submits of phase 9.  Here for petersen, myciel4 and queen5_5 and the
heuristic-only request; queen6_6 and queen7_7 take minutes each in the
reference's scheduler on the CPU, so their values come from the command
in ``chip_smoke.py``'s comment above SERVE_POOL.
"""
import pytest

from repro.core import graph as ref_graph
from repro.serve.twscheduler import TwScheduler
from test_torch_chip_smoke import _assert_row, _chip_smoke

SMALL = ["petersen", "myciel4", "queen5_5"]
# phase 9 streams the defaults first, and its queen7_7 (n=49) ratchets the
# pool's padded n to 64 before the Bloom + MMW stream
PHASE9_N_PAD = 64


def test_chip_smoke_serve_values_come_from_reference():
    chip_smoke = _chip_smoke()
    s = TwScheduler(**chip_smoke.SERVE_POOL)
    rids = [s.submit(ref_graph.REGISTRY[name]()) for name in SMALL]
    s.run()
    for name, rid in zip(SMALL, rids):
        _assert_row(s.done[rid], chip_smoke.EXPECTED_SERVE[name])
        assert chip_smoke.EXPECTED_SERVE[name] == chip_smoke.EXPECTED[name]
    name, knobs = chip_smoke.SERVE_HEUR
    rid = s.submit(ref_graph.REGISTRY[name](), **knobs)
    s.run()
    r = s.done[rid]
    assert dict(lb=r.lb, ub=r.ub, exact=r.exact) == \
        chip_smoke.EXPECTED_SERVE_HEUR


@pytest.mark.parametrize("name", SMALL)
def test_chip_smoke_serve_flag_values_come_from_reference(name):
    """Bloom + MMW at phase 9's padded n (every lane at W=2, MMW over the
    padding rows).  The reference's eight-lane pool takes minutes for
    myciel4 there on the CPU, so the pool here has one lane: without a
    budget the planned cap does not depend on the pool's width, and the
    other lanes of a dispatch are padding that no lane's verdicts depend
    on."""
    chip_smoke = _chip_smoke()
    s = TwScheduler(**dict(chip_smoke.SERVE_POOL, lanes=1))
    s._n_pad = PHASE9_N_PAD
    rid = s.submit(ref_graph.REGISTRY[name](), **chip_smoke.SERVE_FLAGS)
    s.run()
    _assert_row(s.done[rid], chip_smoke.EXPECTED_SERVE_FLAGS[name])
