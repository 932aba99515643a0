"""Idle seconds of one benchmark cell's window, by the program span open
across each device gap, and the window's split into planning, level loop
and reads.

    PYTHONPATH=src python tools/idle_by_span.py --workload exact.queen7_7_deep \
        --seed 2147483759 [--seconds 51] [--profile 0] [--out idle_deep.json]

Runs the cell's set-up and one driver window as ``twbench/run.py --trace 1``
does (``twbench`` imported unchanged: its driver, its ``Trace``), with a
sink on the process root that keeps the window's span records
(``telemetry.Tracker.time_block``: ``start_ns``/``end_ns`` on the
profiler's clock and the ``parent`` span).  Then it reads:

* the device gaps: the gaps between the union of the card's kernel, copy
  and set intervals in the profile, as ``twbench/trace.py`` finds them;
* the spans, from the sink's records, each labelled ``parent>name`` when
  it opened inside another span.  The profile's host ranges of the same
  names check the clock: the tool prints how far their starts lie from
  the records'.

Each gap is cut by the innermost span open across each part of it, and
the parts are summed by label; the idle time that no span covers is
``(no span)``.  The table prints beside ``trace.py``'s own labels (the host
op running when each gap began).  ``--profile 0`` runs the window without
the profiler and prints only the split, as the untraced benchmark runs
it.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_SPAN = "(no span)"


def device_gaps(intervals) -> list:
    """The gaps between the union of ``(start, end)`` intervals, sorted."""
    gaps, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def innermost_segments(spans) -> list:
    """Cut time by the innermost open span: ``(start, end, name)`` spans
    in, sorted disjoint ``(start, end, name)`` segments out, each labelled
    by the open span that started last."""
    marks = sorted([(s, 1, i) for i, (s, _e, _n) in enumerate(spans)]
                   + [(e, 0, i) for i, (_s, e, _n) in enumerate(spans)])
    active, out, prev = {}, [], None
    for t, opening, i in marks:
        if active and prev is not None and t > prev:
            inner = max(active, key=lambda j: (spans[j][0], j))
            out.append((prev, t, spans[inner][2]))
        prev = t
        if opening:
            active[i] = True
        else:
            active.pop(i, None)
    return out


def idle_by_span(gaps, spans) -> dict:
    """Seconds of each gap under each innermost span; the rest under
    ``NO_SPAN``.  Times in nanoseconds."""
    segs = innermost_segments(spans)
    out = collections.Counter()
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            lo, hi = max(g0, segs[k][0]), min(g1, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += (hi - lo) * 1e-9
                covered += hi - lo
            k += 1
        out[NO_SPAN] += (g1 - g0 - covered) * 1e-9
    return dict(out)


def span_intervals(records) -> list:
    """``(start_ns, end_ns, label)`` of the sink's span records, labelled
    ``parent>name`` inside another span, else ``name``."""
    return [(r["start_ns"], r["end_ns"],
             f"{r['parent']}>{r['name']}" if r["parent"] else r["name"])
            for r in records if r.get("kind") == "time" and "start_ns" in r]


def clock_offsets_us(records, ranges) -> list:
    """Start of each profiler range minus the start of the span record of
    the same name and order, in microseconds."""
    by_name = collections.defaultdict(list)
    for s, _e, name in sorted(ranges):
        by_name[name].append(s)
    seen, out = collections.Counter(), []
    for r in sorted((r for r in records if "start_ns" in r),
                    key=lambda r: r["start_ns"]):
        i = seen[r["name"]]
        seen[r["name"]] += 1
        if i < len(by_name[r["name"]]):
            out.append((by_name[r["name"]][i] - r["start_ns"]) * 1e-3)
    return out


def split(before: dict, after: dict, answered: int, wall: float) -> dict:
    """Per answer: the window's wall, its ``preprocess_s`` + ``plan_s``,
    ``level_s`` and ``read_s`` seconds, the reads, and the rest; and
    ``paths_s``, the part of planning spent on the disjoint-paths matrix
    (its read, on a card, is also one of ``read_s``)."""
    def delta(name, key="total_s"):
        zero = {"calls": 0, "total_s": 0.0}
        return after.get(name, zero)[key] - before.get(name, zero)[key]
    n = max(answered, 1)
    out = dict(wall_s=wall / n,
               plan_s=(delta("preprocess_s") + delta("plan_s")) / n,
               level_s=delta("level_s") / n, read_s=delta("read_s") / n,
               reads=delta("read_s", "calls") / n)
    out["rest_s"] = out["wall_s"] - out["plan_s"] - out["level_s"] \
        - out["read_s"]
    out["paths_s"] = delta("paths_s") / n
    return out


def run(workload: str, seed: int, seconds: float,
        profile: bool = True) -> dict:
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from torch.autograd import DeviceType

    from repro_torch.core import telemetry
    from twbench import drivers, harness
    from twbench import trace as trace_lib

    harness.set_cache_dirs()
    _w, cfg, mix = harness.cell_parts(harness.manifest(), workload)
    dev = torch.device("cuda")
    drv = drivers.KINDS[mix["kind"]](cfg, mix, seed, dev)
    drv.setup()
    torch.cuda.synchronize()
    sink = telemetry.InMemorySink()
    telemetry.root().add_sink(sink)
    t0 = telemetry.root().snapshot(children=False)["timings"]
    if profile:
        with trace_lib.Trace(dev) as tr:
            wall = drv.window(seconds)
    else:
        wall = drv.window(seconds)
        torch.cuda.synchronize()
    t1 = telemetry.root().snapshot(children=False)["timings"]
    res = dict(workload=workload, seed=seed, profile=profile,
               answered=len(drv.answers), wall_s=wall,
               split=split(t0, t1, len(drv.answers), wall),
               device=torch.cuda.get_device_name(dev))
    if not profile:
        drv.close()
        return res
    t_reduce = time.perf_counter()
    spans = span_intervals(sink.records)
    names = {r["name"] for r in sink.records if "start_ns" in r}
    dev_iv, ranges = [], []
    for e in tr.prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev_iv.append((e.start_ns(), e.end_ns()))
        elif e.name() in names:
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
    gaps = device_gaps(dev_iv)
    by_span = idle_by_span(gaps, spans)
    offs = clock_offsets_us(sink.records, ranges)
    red = tr.reduce()
    drv.close()
    res.update(window_s=red["window_s"], busy_s=red["busy_s"],
               idle_s=sum(g1 - g0 for g0, g1 in gaps) * 1e-9,
               spans=len(spans), ranges=len(ranges),
               clock_offset_us=dict(
                   median=statistics.median(offs) if offs else None,
                   max_abs=max(map(abs, offs)) if offs else None),
               idle_by_span=by_span, idle_by_op=red["idle_gaps"],
               reduce_s=time.perf_counter() - t_reduce)
    return res


def table(res: dict) -> str:
    sp = res["split"]
    rows = [f"{res['workload']} seed {res['seed']} profiler "
            f"{'on' if res['profile'] else 'off'}: {res['answered']} "
            f"answers in {res['wall_s']:.3f} s ({res['device']})",
            "per answer: " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in sp.items())]
    if not res["profile"]:
        return "\n".join(rows)
    rows += [f"window {res['window_s']:.3f} s, busy {res['busy_s']:.3f} s, "
             f"idle in gaps {res['idle_s']:.3f} s; {res['spans']} span "
             f"records, {res['ranges']} profiler ranges, range start - "
             f"record start: median {res['clock_offset_us']['median']} us, "
             f"max |.| {res['clock_offset_us']['max_abs']} us",
             "| innermost span | idle s | % of idle | % of window |",
             "|---|---|---|---|"]
    for name, s in sorted(res["idle_by_span"].items(), key=lambda kv: -kv[1]):
        rows.append(f"| {name} | {s:.3f} | "
                    f"{100 * s / max(res['idle_s'], 1e-12):.1f} | "
                    f"{100 * s / res['window_s']:.1f} |")
    rows += ["", "| host op at the gap's start (trace.py) | idle s |",
             "|---|---|"]
    for name, s in sorted(res["idle_by_op"].items(),
                          key=lambda kv: -kv[1])[:10]:
        rows.append(f"| {name} | {s:.3f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="window length (default: BENCHMARK.json's "
                         "run_seconds)")
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1,
                    help="0: no profiler, print only the split")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
            seconds = json.load(f)["run_seconds"]
    res = run(args.workload, args.seed, seconds, bool(args.profile))
    print(table(res), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
