"""A tiny traced run of each cell on the CPU reports the per-layer metrics
that read the program's spans and its ``d2h_bytes`` counter, each with a
value that fits the run."""
import io
import json

import pytest

from twbench import harness

from conftest import tiny_manifest

MAN = tiny_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SPAN_METRICS = ("plan_span_s_per_solve", "level_host_s_per_solve",
                "host_reads_per_solve", "read_wait_s_per_solve",
                "d2h_bytes_per_solve")


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_cell_reads_the_spans(tiny, cell):
    root, bench = tiny
    out = harness.run_cell(cell, 2 ** 33 + 7, 1.0, True, device="cpu",
                           root=root, bench=bench, log=io.StringIO())
    line = json.loads(json.dumps(out))
    assert line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    for name in SPAN_METRICS:
        assert m.get(name) is not None, name
        assert m[name] > 0, name
    # every level's count read and each dispatch's result copy: more reads
    # than the dispatches' one result read each
    assert m["host_reads_per_solve"] > m["host_syncs_per_solve"]
    # span names are host ranges: none is a device row
    ops = {k for k, _v in line["breakdown"]["device_ops"]}
    assert not ops & {"preprocess_s", "plan_s", "rung_s", "level_s",
                      "read_s"}


def test_readers_return_nothing_without_the_spans():
    """A program without the spans (the parent of this benchmark's
    readers) gives no value and no error."""
    ctx = dict(answered=3, counters={"host_syncs": 6}, timings={
        "rung_s": {"calls": 6, "total_s": 1.0}})
    for name in SPAN_METRICS:
        assert harness.reader(name)(ctx) is None, name
    assert harness.reader("plan_span_s_per_solve")(
        dict(ctx, answered=0)) is None
