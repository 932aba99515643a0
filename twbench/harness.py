"""Run one cell of the benchmark once and print its result line.

    python3 twbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``twbench/configs/<config>.json``, its traffic mix in
``twbench/traffic/<traffic>.json`` (driven by the general driver its
``kind`` names, ``twbench/drivers.py``) and each per-layer metric's
reader in ``twbench/metrics/<metric>.py``.

A run: set-up (imports, the card, the kernels, the inputs from the seed,
a warm-up on the mix's small ``warmup`` instances) is ``setup_s``, from
process start; then the window of ``--seconds``, which ends with the
first whole solve or pass that ends past it; then, with the program's state
freed, the plain reference judges the answers (``compare.py``).  With
``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import time
import traceback

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux ``/proc``),
    or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs(root: pathlib.Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout.  The
    port's nvcc libraries go to ``build/repro_torch/`` by its own code."""
    base = root / "build" / "twbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_parts(man: dict, name: str, bench: pathlib.Path = BENCH) -> tuple:
    """(workload entry, configuration, traffic mix) of cell ``name``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg = load_json(bench / "configs" / f"{w['config']}.json")
    mix = load_json(bench / "traffic" / f"{w['traffic']}.json")
    return w, cfg, mix


def reader(metric: str, bench: pathlib.Path = BENCH):
    """The ``read(ctx)`` function of a per-layer metric's own file."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "twbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, cell: str, e2e: set) -> bool:
    """Does this cell report the metric?  Its ``workloads`` list, or
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e


def e2e_of(man: dict, cell: str) -> list:
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _telemetry():
    from repro_torch.core import telemetry
    snap = telemetry.root().snapshot(children=False)
    from repro_torch.kernels.bloom import ops as bloom_ops
    from repro_torch.kernels.wavefront import ops as wf_ops
    return snap, {"wavefront": wf_ops.LAUNCHES, "bloom": bloom_ops.LAUNCHES}


def _delta(before: tuple, after: tuple) -> tuple:
    (s0, l0), (s1, l1) = before, after
    counters = {k: v - s0["counters"].get(k, 0)
                for k, v in s1["counters"].items()}
    timings = {}
    for k, v in s1["timings"].items():
        o = s0["timings"].get(k, {"calls": 0, "total_s": 0.0})
        timings[k] = {"calls": v["calls"] - o["calls"],
                      "total_s": v["total_s"] - o["total_s"]}
    return counters, timings, {k: l1[k] - l0[k] for k in l1}


def plan_seconds(drv, idx: list) -> float:
    """Host planning of the window's own instances, timed again from the
    benchmark: ``preprocess`` plus ``plan_block`` of every block of more
    than one vertex, per answered instance (over ``idx``)."""
    from repro_torch.core import preprocess, solver
    from twbench.drivers import to_program
    counts = dict(drv.plan_items())
    total, n = 0.0, 0
    for i in idx:
        g = to_program(drv.instances[i])
        t0 = time.perf_counter()
        for b in preprocess.preprocess(g).blocks:
            if b.g.n > 1:
                solver.plan_block(b.g, use_clique=True, use_paths=True,
                                  start_k=None)
        dt = time.perf_counter() - t0
        total += dt * counts.get(i, 0)
        n += counts.get(i, 0)
    return total / n if n else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: pathlib.Path = ROOT,
             bench: pathlib.Path = BENCH, t_start: float = None,
             log=sys.stderr, control: bool = False) -> dict:
    """One run of cell ``name``; returns the result line's object (the
    checks under ``checks``, last).  ``device="cpu"`` is for the tests:
    the command itself refuses to run without a card.  ``control=True``
    judges the control in the program's place: the reference with a
    lossy 1024-bit Bloom dedup (``reference/search.py``), over the
    window's own instances (``twbench/control.py``)."""
    import torch
    from twbench import compare, drivers
    from twbench import trace as trace_lib

    t_start = process_start() if t_start is None else t_start
    man = manifest(root)
    w, cfg, mix = cell_parts(man, name, bench)
    dev = torch.device(device)
    drv = drivers.KINDS[mix["kind"]](cfg, mix, seed, dev)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start

    before = _telemetry()
    if trace:
        with trace_lib.Trace(dev) as tr:
            wall = drv.window(seconds)
    else:
        wall = drv.window(seconds)
    counters, timings, launches = _delta(before, _telemetry())
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)
    drv.close()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"forbidden modules loaded: {bad}")

    answered = len(drv.answers)
    ctx = dict(cell=name, answered=answered, wall_s=wall,
               counters=counters, timings=timings, launches=launches,
               trace=None, plan_s=None)
    idx = sorted({i for i, _a in drv.answers})
    if trace:
        ctx["trace"] = tr.reduce()
        ctx["plan_s"] = plan_seconds(drv, idx)

    # every answer is judged
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = drv.reference(idx, dev)
    ref_s = time.perf_counter() - t_ref
    answers = drv.answers
    if control:
        ctl = drv.reference(idx, dev, mode="bloom_small")
        answers = [(i, ctl[i]) for i, _a in answers if i in ctl]
    judged = [(i, a) for i, a in answers if i in refs]
    numbers, first = compare.judge(judged, refs, drv.failed)
    correct = compare.passes(numbers, len(judged))

    e2e = e2e_of(man, name)
    e2e_names = {m["name"] for m in e2e}
    values = {"setup_s": setup_s}
    if answered:
        values["solve_s"] = wall / answered
    metrics = {}
    if trace:
        for m in man["per_layer"]:
            if reports(m, name, e2e_names):
                v = reader(m["name"], bench)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": int(w.get("chips", 1)),
               "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(drv.attempted),
           "failed": int(drv.failed), "metrics": metrics,
           "device": devinfo}
    if trace:
        red = ctx["trace"]
        devinfo["busy_s"] = red["busy_s"]
        devinfo["window_s"] = red["window_s"]
        out["breakdown"] = trace_lib.breakdown(red)
    print(f"[twbench] {name} seed={seed}: {answered} answers in "
          f"{wall:.3f} s, {len(judged)} judged over {len(refs)} "
          f"instances, reference {ref_s:.3f} s, set-up {setup_s:.3f} s",
          file=log)
    print(f"[twbench] each solve or pass (s): "
          f"{json.dumps([round(x, 4) for x in drv.walls])}", file=log)
    if trace:
        kr = ctx["trace"]["kernels"]
        rows = {k: v[0] for k, v in kr.items()}

        def count(part):
            return sum(v for k, v in rows.items() if part in k)
        print(f"[twbench] trace rows: wavefront_kernel "
              f"{count('wavefront_kernel')} vs launches "
              f"{launches['wavefront']}; bloom_count_kernel "
              f"{count('bloom_count_kernel')} vs calls "
              f"{launches['bloom']}", file=log)
        print(f"[twbench] counters {json.dumps(counters)}", file=log)
    if first is not None:
        print(f"[twbench] first mismatch: {json.dumps(first)[:1500]}",
              file=log)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        print(f"check {k}: {v} (limit {lim})", file=log)
    return out


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    try:
        man = manifest()
        chips = int(cell_parts(man, args.workload)[0].get("chips", 1))
        import torch
        if not torch.cuda.is_available():
            print("[twbench] no CUDA device: refusing to run",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"[twbench] the cell needs {chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=t_start)
    except Exception:                               # noqa: BLE001
        traceback.print_exc()
        return 1
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
