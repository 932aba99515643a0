"""Restart-on-failure supervisor: the single-host stand-in for a cluster
controller (the port's own copy of ``repro.launch.supervisor``).  Wraps
any launch command; non-zero exits trigger a relaunch (bounded count),
and the wrapped trainer resumes from its newest checkpoint.

    python -m repro_torch.launch.supervisor --max-restarts 3 -- \
        python -m repro_torch.launch.train --arch qwen3-0.6b --reduced ...
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff-sec", type=float, default=0.5)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")

    attempts = 0
    while True:
        print(f"[supervisor] launch attempt {attempts}: {' '.join(cmd)}",
              flush=True)
        rc = subprocess.run(cmd).returncode
        if rc == 0:
            print("[supervisor] success", flush=True)
            return 0
        attempts += 1
        print(f"[supervisor] exit code {rc} "
              f"(attempt {attempts}/{args.max_restarts})", flush=True)
        if attempts > args.max_restarts:
            print("[supervisor] giving up", flush=True)
            return rc
        time.sleep(args.backoff_sec)


if __name__ == "__main__":
    sys.exit(main())
