"""Run one cell of the benchmark once (see ``twbench/harness.py``):

    python3 twbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The program is the package under ``src/``.
"""
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from twbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
