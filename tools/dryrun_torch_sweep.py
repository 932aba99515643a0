"""Run the port's dry-run sweep with one process per cell, several at a time.

    PYTHONPATH=src python tools/dryrun_torch_sweep.py --jobs 8 \\
        --meshes 16x16,2x16x16 --out DIR [--deadline S] [--device cpu]

Each cell runs as ``python -m repro_torch.launch.dryrun --arch A --shape S
[--multi-pod] --out DIR`` (``launch.mesh``'s fake group of 512 ranks is
process-wide, so a process holds one mesh).  Cells start longest first
(``_ORDER``).  A cell still running ``--deadline`` seconds after the sweep
began is stopped and counted ``unfinished``.  One line per cell as it
ends, then a JSON summary: the cells per status and mesh, the sweep's
wall and each cell's seconds.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs import ARCH_IDS, SHAPES  # noqa: E402

# slowest first: prefill's 32k-token attention and scans, then training
_SHAPE_ORDER = ("prefill_32k", "train_4k", "decode_32k", "long_500k")
_ARCH_ORDER = ("xlstm-1.3b", "deepseek-coder-33b",
               "llama4-maverick-400b-a17b", "granite-3-8b", "hymba-1.5b",
               "qwen3-4b", "phi-3-vision-4.2b", "whisper-small",
               "qwen3-0.6b", "granite-moe-1b-a400m")
_MESHES = {"16x16": [], "2x16x16": ["--multi-pod"]}


def _cells(meshes):
    order = [(m, a, s) for s in _SHAPE_ORDER for a in _ARCH_ORDER
             for m in meshes]
    assert {(a, s) for _, a, s in order} == {(a, s) for a in ARCH_IDS
                                             for s in SHAPES}
    return order


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--meshes", default="16x16,2x16x16")
    ap.add_argument("--out", required=True)
    ap.add_argument("--deadline", type=float, default=3300.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    meshes = args.meshes.split(",")
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    todo = _cells(meshes)
    running = {}
    status = {}
    seconds = {}
    t0 = time.time()
    try:
        while todo or running:
            while todo and len(running) < args.jobs:
                mesh, arch, shape = todo.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out]
                cmd += _MESHES[mesh]
                if args.device:
                    cmd += ["--device", args.device]
                tag = f"{arch}__{shape}__{mesh}"
                running[tag] = (subprocess.Popen(
                    cmd, env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL), time.time())
            time.sleep(1.0)
            late = time.time() - t0 > args.deadline
            for tag, (proc, start) in list(running.items()):
                if proc.poll() is None and not late:
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                del running[tag]
                seconds[tag] = round(time.time() - start, 1)
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and proc.returncode == 0:
                    with open(path) as f:
                        status[tag] = json.load(f)["status"]
                else:
                    status[tag] = "unfinished"
                print(f"[sweep] {tag}: {status[tag]} in {seconds[tag]} s",
                      flush=True)
            if late:
                for mesh, arch, shape in todo:
                    status[f"{arch}__{shape}__{mesh}"] = "unfinished"
                todo = []
    finally:
        for proc, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    counts = {m: {} for m in meshes}
    for tag, st in status.items():
        m = tag.split("__")[2]
        counts[m][st] = counts[m].get(st, 0) + 1
    print(json.dumps({"sweep": {"counts": counts,
                                "wall_s": round(time.time() - t0, 1),
                                "jobs": args.jobs, "cells_s": seconds}}),
          flush=True)


if __name__ == "__main__":
    main()
