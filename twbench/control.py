"""The control of ``correct``, at a cell's own size: a short window of the
cell, then the control (the plain reference with a lossy 1024-bit Bloom
dedup, ``reference/search.py``) judged in the program's place against
the reference, on each seed given.  ``correct`` has to come out false.

    python3 twbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 10]

One JSON line per seed: the checks and ``correct``.  Needs a card.
"""
import argparse
import io
import json
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from twbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    a = ap.parse_args()
    harness.set_cache_dirs()
    for seed in [int(s) for s in a.seeds.split(",")]:
        log = io.StringIO()
        out = harness.run_cell(a.workload, seed, a.seconds, False,
                               log=log, control=True)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              correct=out["correct"],
                              checks=out["checks"])), flush=True)
        print(log.getvalue(), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
