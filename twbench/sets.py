"""Runs of one cell, each a fresh process of ``twbench/run.py``, and the
spread of each metric: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the
median.

    python3 twbench/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \\
        [--seconds 51] [--trace 0] [--out FILE]

Each run's result line goes to ``--out`` (JSON lines), and a summary line
(per metric: values, median, spread) to standard output, with each run's
seconds from start to exit.  Needs a card.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def spread(values: list) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="51")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    lines = []
    for seed in a.seeds.split(","):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "twbench/run.py", "--workload", a.workload,
             "--seed", seed, "--seconds", a.seconds, "--trace", a.trace],
            cwd=_ROOT, capture_output=True, text=True)
        run_s = time.perf_counter() - t0
        tail = r.stderr.strip().splitlines()[-3:]
        if r.returncode != 0 or not r.stdout.strip():
            print(json.dumps(dict(seed=seed, rc=r.returncode,
                                  stderr=r.stderr[-3000:])), flush=True)
            continue
        line = json.loads(r.stdout.strip().splitlines()[-1])
        line["seed"] = int(seed)
        line["run_s"] = run_s
        line["stderr_tail"] = tail
        lines.append(line)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        print(json.dumps(dict(seed=int(seed), correct=line["correct"],
                              attempted=line["attempted"],
                              failed=line["failed"],
                              metrics={k: v["value"] for k, v in
                                       line["metrics"].items()},
                              peak=line["device"]["memory_peak_bytes"],
                              run_s=run_s)),
              flush=True)
    summary = {}
    for name in (lines[0]["metrics"] if lines else {}):
        vals = [ln["metrics"][name]["value"] for ln in lines
                if name in ln["metrics"]]
        if len(vals) >= 2:
            summary[name] = dict(values=vals, median=statistics.median(vals),
                                 spread=spread(vals))
    print(json.dumps(dict(workload=a.workload, runs=len(lines),
                          correct=all(ln["correct"] for ln in lines),
                          summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
