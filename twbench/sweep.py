"""The one-off sweeps behind numbers in the cells' files and ``PERF.md``.

    python3 twbench/sweep.py cap --seeds S1,S2,.. [--from 17] [--max-s 15]
        queen7_7 under exact_sort, relabelled by each seed: one solve per
        seed and frontier list size 2^from, 2^(from+1), ... (one warm-up
        solve of queen5_5 first), stopping after the first size at which
        a solve takes more than --max-s seconds or no solve drops a state
        (the solver's ``rung_overflows`` counter); then the plain
        reference at the last size kept, on the first seed.  The deep
        cell's ``cap`` is that size.

    python3 twbench/sweep.py bloom --workload <cell>
        the plain reference over the cell's suite with the Bloom filter's
        counts: per instance, the most distinct children one
        level inserts, the filter's false positives, and the number of
        them the fill predicts, sum over inserts of (1 - e^(-k i / m))^k.

One JSON object per line on standard output.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from twbench import compare, drivers, harness, instances  # noqa: E402
from twbench.reference import solve as ref_solve  # noqa: E402


def _overflows() -> int:
    from repro_torch.core import telemetry
    snap = telemetry.root().snapshot(children=False)
    return int(snap["counters"].get("rung_overflows", 0))


def cap_sweep(seeds: list, first: int, max_s: float) -> None:
    import torch
    from repro_torch.core import solver
    dev = torch.device("cuda")
    gs = [instances.relabelled("queen7_7", s) for s in seeds]
    cfg = harness.load_json(harness.BENCH / "configs" / "exact_sort.json")
    knobs = cfg["knobs"]
    solver.solve(drivers.to_program(instances.queen(5)), device=dev,
                 cap=1 << first, **knobs)
    torch.cuda.synchronize()
    best = None
    for p in range(first, 27):
        row = []
        for s, g in zip(seeds, gs):
            torch.cuda.reset_peak_memory_stats()
            o0 = _overflows()
            t0 = time.perf_counter()
            r = solver.solve(drivers.to_program(g), device=dev,
                             cap=1 << p, **knobs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            over = _overflows() - o0
            row.append((dt, r, over))
            print(json.dumps(dict(cap=1 << p, seed=s, solve_s=dt,
                                  width=r.width, exact=r.exact, lb=r.lb,
                                  ub=r.ub, expanded=r.expanded,
                                  rung_overflows=over,
                                  peak=torch.cuda.max_memory_allocated())),
                  flush=True)
        if max(dt for dt, _r, _o in row) > max_s:
            break
        best = (1 << p, drivers.answer_of(row[0][1]))
        if not any(o for _dt, _r, o in row):
            break
    if best is not None:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = ref_solve.solve(gs[0], cap=best[0], device=dev)
        torch.cuda.synchronize()
        print(json.dumps(dict(reference_cap=best[0], seed=seeds[0],
                              reference_s=time.perf_counter() - t0,
                              same=compare.normal(best[1])
                              == compare.normal(ref),
                              expanded=ref["expanded"],
                              exact=ref["exact"])), flush=True)


def expected_false_positives(inserted: int, m_bits: int, k: int) -> float:
    """Sum over the i-th distinct insert of the chance that all k of its
    probes find a bit already set: (1 - e^(-k i / m))^k."""
    i = np.arange(inserted, dtype=np.float64)
    return float(((1.0 - np.exp(-k * i / m_bits)) ** k).sum())


def bloom_counts(workload: str) -> None:
    import torch
    dev = torch.device("cuda")
    w, cfg, mix = harness.cell_parts(harness.manifest(), workload)
    knobs = {**cfg["knobs"], **mix.get("knobs", {})}
    m, k = knobs["m_bits"], knobs["k_hashes"]
    graphs, _order = drivers._pool(mix, 1)
    stats = [{} for _ in graphs]
    t0 = time.perf_counter()
    rs = ref_solve.solve_many(graphs, device=dev, stats=stats,
                              **drivers._ref_knobs(knobs))
    for g, r, st in zip(graphs, rs, stats):
        ins = st.get("inserted", [])
        print(json.dumps(dict(
            instance=g.name, width=r["width"], exact=r["exact"],
            levels=len(ins), most_inserted=max(ins, default=0),
            inserted=sum(ins), false_pos=sum(st.get("false_pos", [])),
            expected=sum(expected_false_positives(i, m, k)
                         for i in ins))), flush=True)
    print(json.dumps(dict(reference_s=time.perf_counter() - t0)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("cap", "bloom"))
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--from", dest="first", type=int, default=17)
    ap.add_argument("--max-s", type=float, default=15.0)
    ap.add_argument("--workload", default="bloom.table1_suite")
    a = ap.parse_args()
    harness.set_cache_dirs()
    if a.what == "cap":
        cap_sweep([int(x) for x in a.seeds.split(",")], a.first, a.max_s)
    else:
        bloom_counts(a.workload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
