"""Port parity: the distributed solver (``repro_torch.core.distributed``).

Twins of ``tests/test_distributed_tw.py``: the reference's
``solve_distributed`` / ``decide_distributed`` with D forced host devices
in a subprocess, the port's as D ``gloo`` ranks on the CPU, at the same D
(8 here; 4, and 1 and 2 on petersen and queen5_5, in
``tests/test_torch_distributed_small.py``), both running the same
functions of ``tests/torch_dist_twins.py``.  Width, exact, lb,
ub and expanded, and each rung's verdict, ``inexact`` and ``expanded``
under both engines, must be equal, and every rank must return the same.
Checkpoints, elastic restarts, forced donation, the mesh rung and the
CLI are in ``tests/test_torch_distributed_ckpt.py``.
"""
import time

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import distributed, graph, solver
import torch_dist_twins as twins

NAMES = ["petersen", "myciel3", "queen5_5"]
LADDERS = [("petersen", 1 << 11), ("myciel3", 1 << 11),
           ("queen5_5", 1 << 8)]                       # queen: overflows
# the D=8 cases, each one call of ``twins.run_all`` on both sides
CALLS8 = {
    "match": ("solve_rows", (NAMES,), dict(cap_local=1 << 12,
                                           block=1 << 6)),
    "overflow": ("solve_rows", (["queen5_5"],),
                 dict(cap_local=32, block=32, use_preprocess=False,
                      use_paths=False)),
    "mmw": ("solve_rows", (["petersen"],),
            dict(cap_local=1 << 11, block=1 << 6, use_mmw=True)),
    "plain": ("solve_rows", (["petersen"],),
              dict(cap_local=1 << 11, block=1 << 6, use_mmw=False)),
    "ladders": ("decide_ladders", (LADDERS, ("host", "fused")),
                dict(block=1 << 6)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def d8():
    return twins.both(CALLS8, 8)


def test_distributed_matches_reference_and_single_device(d8):
    want, got = d8
    assert got["match"] == want["match"]
    for name, golden in [("petersen", 4), ("myciel3", 5), ("queen5_5", 18)]:
        single = solver.solve(graph.REGISTRY[name](), cap=1 << 15,
                              block=1 << 9, device="cpu")
        assert got["match"][name]["width"] == single.width == golden
        assert got["match"][name]["expanded"] == single.expanded, name


def test_overflow_marks_inexact_as_reference(d8):
    want, got = d8
    assert got["overflow"] == want["overflow"]
    r = got["overflow"]["queen5_5"]
    assert (not r["exact"]) or r["width"] == 18


def test_mmw_matches_reference(d8):
    want, got = d8
    assert (got["mmw"], got["plain"]) == (want["mmw"], want["plain"])
    assert got["mmw"]["petersen"]["width"] == 4
    assert got["mmw"]["petersen"]["expanded"] \
        <= got["plain"]["petersen"]["expanded"]


def test_engines_agree_with_each_other_and_reference(d8):
    """Host and fused engines, rung by rung up each ladder (queen5_5 at
    cap_local 2^8 overflows)."""
    want, got = d8
    for name, _cap in LADDERS:
        ref = want["ladders"][name]
        assert ref["host"] == ref["fused"], name
        assert got["ladders"][name]["host"] == got["ladders"][name]["fused"] \
            == ref["host"], name
    assert any(v[1] for _k, v in got["ladders"]["queen5_5"]["host"])


def test_backend_rule_and_rank_devices(monkeypatch):
    """nccl only when every rank has a card of its own; rank r on card
    r % cards; no card and no device named: the path raises."""
    assert distributed.choose_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.choose_backend("cuda", 2) == "nccl"
    assert distributed.choose_backend("cuda", 4) == "gloo"
    assert distributed.rank_device(3, "cuda") == torch.device("cuda", 1)
    assert distributed.rank_device(3, "cuda:0") == torch.device("cuda", 0)
    assert distributed.rank_device(3, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.make_solver_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.launch(twins.solve_rows, 2, [])


def test_a_failed_rank_fails_the_run():
    """The failed rank's own error raises here, not the error that its
    failure caused in its peer's collective; no rank is left running."""
    with pytest.raises(mp.ProcessRaisedException,
                       match="failed on purpose"):
        twins.port(twins.fail_on, 2, 1)


def test_a_stalled_rank_times_out_the_group():
    """A collective that waits past the group's timeout fails its rank,
    and the run raises long before the stalled rank wakes."""
    t0 = time.monotonic()
    with twins.few_cores(), pytest.raises(mp.ProcessRaisedException):
        distributed.launch(twins.stall, 2, 1, 120, device="cpu",
                           timeout_s=5, deadline_s=90)
    assert time.monotonic() - t0 < 60
