"""``correct`` comes out false for the control and for each fault a cell
can have, at a size a test run holds (the chip runs of the control at
the cells' own sizes are in PERF.md)."""
import io

import pytest

from twbench import harness

from conftest import tiny_manifest

MAN = tiny_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _run(tiny, cell, **kw):
    root, bench = tiny
    log = io.StringIO()
    out = harness.run_cell(cell, 2 ** 31 + 11, 1.5, False, device="cpu",
                           root=root, bench=bench, log=log, **kw)
    return out, log.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    out, log = _run(tiny, cell, control=True)
    assert out["correct"] is False, log
    assert out["checks"]["wrong"]["value"] > 0


def _state_unchanged(monkeypatch):
    """A level step that returns its frontier unchanged."""
    from repro_torch.core import engine

    def step(adj, allowed, k, fr, counts, live, **kw):
        import torch
        return fr, torch.zeros(fr.count.shape, dtype=torch.int64)
    monkeypatch.setattr(engine, "_level_step", step)


def _half_batch(monkeypatch):
    """Each chunk expands every other state only."""
    from repro_torch.core import engine
    real = engine.expand_chunk

    def chunk(adj, states, valid, *a, **kw):
        valid = valid.clone()
        valid[..., 1::2] = False
        return real(adj, states, valid, *a, **kw)
    monkeypatch.setattr(engine, "expand_chunk", chunk)


def _answer_altered(monkeypatch):
    """The folded answer's width is off by one where it is produced."""
    from repro_torch.core import solver
    real = solver.SuiteFold.result

    def result(self, elapsed, order=None):
        r = real(self, elapsed, order)
        r.width += 1
        return r
    monkeypatch.setattr(solver.SuiteFold, "result", result)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out, log = _run(tiny, cell)
    assert out["correct"] is False, log
