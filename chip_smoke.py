#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  1. device: the card's name and power limit, and the nvcc build of every
     kernel from the sources in this checkout (one nvcc per source, in
     parallel), with ptxas's register and shared-memory report;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit (``torch.equal``), over a sweep of shapes with
     invalid rows and words whose bit 31 is set;
  3. main path: ``repro_torch.core.solver.solve(g)`` with its defaults
     (cuda device, cuda backend, cap auto, block 2048) on petersen,
     myciel4, queen5_5, queen6_6 and queen7_7.  Width, exact, lb, ub,
     expanded and per_k must equal the JAX package's values (EXPECTED,
     from ``repro.core.solver.solve`` on the CPU; widths also from
     tests/golden_widths.json), and every kernel of the path must have
     launched in this phase;
  4. times: each kernel and its plain version at the main path's shapes
     (B=2048 states taken from real frontiers of queen6_6 and queen7_7),
     with CUDA events, beside the least time the card could take.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM: HBM rate, and the non-tensor 32-bit rate (the float32 peak;
# used for the kernel's 32-bit integer word operations)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# ``repro.core.solver.solve(g)`` with its defaults, on the CPU:
# (k, feasible, inexact, expanded) for each rung of the one solved block
EXPECTED = {
    "petersen": dict(
        width=4, exact=True, lb=3, ub=5, expanded=139,
        block="PetersenGraph_red[10]_red",
        per_k=[(3, False, False, 40), (4, True, False, 99)]),
    "myciel4": dict(
        width=10, exact=True, lb=8, ub=11, expanded=81341,
        block="myciel4_red[23]_red",
        per_k=[(8, False, False, 5696), (9, False, False, 17056),
               (10, True, False, 58589)]),
    "queen5_5": dict(
        width=18, exact=True, lb=12, ub=18, expanded=2279,
        block="queen5_5_red[25]_red",
        per_k=[(12, False, False, 122), (13, False, False, 122),
               (14, False, False, 237), (15, False, False, 237),
               (16, False, False, 407), (17, False, False, 1154)]),
    "queen6_6": dict(
        width=25, exact=True, lb=15, ub=26, expanded=47135,
        block="queen6_6_red[36]_red",
        per_k=[(15, False, False, 237), (16, False, False, 237),
               (17, False, False, 765), (18, False, False, 765),
               (19, False, False, 1149), (20, False, False, 1149),
               (21, False, False, 2135), (22, False, False, 5633),
               (23, False, False, 6417), (24, False, False, 11185),
               (25, True, False, 17463)]),
    "queen7_7": dict(
        width=35, exact=False, lb=18, ub=37, expanded=1917876,
        block="queen7_7_red[49]_red",
        per_k=[(18, False, False, 497), (19, False, False, 497),
               (20, False, False, 4353), (21, False, False, 4353),
               (22, False, False, 7096), (23, False, False, 7096),
               (24, False, False, 7529), (25, False, False, 7529),
               (26, False, False, 14072), (27, False, False, 42829),
               (28, False, False, 51864), (29, False, False, 84226),
               (30, False, False, 107336), (31, False, True, 164088),
               (32, False, True, 226237), (33, False, True, 301916),
               (34, False, True, 378421), (35, True, True, 507937)]),
}
MAIN_PATH = ["petersen", "myciel4", "queen5_5", "queen6_6", "queen7_7"]
# (instance, k) whose largest level supplies the timing inputs
TIMING_SHAPES = [("queen6_6", 25), ("queen7_7", 30)]
DEVICE = "cuda"
SWEEP_N = (3, 17, 31, 32, 33, 36, 48, 49, 64, 100)
SWEEP_B = (1, 7, 128, 2048)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, iters=100):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(build):
    line = smi_line()
    log(f"device: {line}")
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(reports)} kernel source(s) in {build_s:.1f} s")
    for name, text in reports.items():
        for row in text.splitlines():
            if "registers" in row or "spill" in row or "smem" in row:
                log(f"  ptxas {name}: {row.strip()}")
    return line


def random_inputs(torch, np, bitset, graph, n, b, seed, device):
    rng = np.random.RandomState(seed)
    g = graph.gnp(n, 0.3, seed)
    bits = rng.rand(b, n) < rng.uniform(0.05, 0.6, size=(b, 1))
    for top in (31, 63):
        if top < n:
            bits[::2, top] = True            # words with the high bit set
    states = bitset.pack(torch.from_numpy(bits), n).to(device)
    valid = torch.from_numpy(rng.rand(b) < 0.8).to(device)
    allowed = bitset.to_words(bitset.np_allowed(n, [0] if n > 3 else []),
                              device)
    adj = bitset.to_words(g.packed(), device)
    k = int(rng.randint(n // 4, n // 2 + 1))
    return adj, states, valid, k, allowed


def max_abs_err(torch, got, want):
    err = 0
    for a, b in zip(got, want):
        d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64)
                                                & 0xFFFFFFFF)
        err = max(err, int(d.abs().max()) if d.numel() else 0)
    return err


def phase_kernels(torch, np, bitset, graph, wavefront):
    worst = 0
    for n in SWEEP_N:
        for b in SWEEP_B:
            args = random_inputs(torch, np, bitset, graph, n, b,
                                 seed=1000 * n + b, device=DEVICE)
            got = wavefront.wavefront_expand(*args, n=n)
            want = wavefront.wavefront_ref(*args, n=n)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            err = max_abs_err(torch, got, want)
            worst = max(worst, err)
            check(same, f"wavefront kernel != plain version at n={n} B={b} "
                        f"(max abs err {err})")
    log(f"kernels: wavefront bit-identical to wavefront_ref over "
        f"n={list(SWEEP_N)} x B={list(SWEEP_B)}")
    return worst


def phase_main_path(torch, graph, solver, golden, wavefront_ops):
    wavefront_ops.LAUNCHES = 0
    for name in MAIN_PATH:
        want = EXPECTED[name]
        before = wavefront_ops.LAUNCHES
        t0 = time.perf_counter()
        res = solver.solve(graph.REGISTRY[name]())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wavefront_ops.LAUNCHES - before
        got = dict(width=res.width, exact=res.exact, lb=res.lb, ub=res.ub,
                   expanded=res.expanded)
        check(got == {key: want[key] for key in got},
              f"{name}: {got} != JAX {want}")
        per_k = [(k, v["feasible"], v["inexact"], v["expanded"])
                 for k, v in res.per_k[want["block"]].items()]
        check(list(res.per_k) == [want["block"]] and per_k == want["per_k"],
              f"{name}: per_k {res.per_k} != JAX {want['per_k']}")
        if name in golden:
            check(res.width == golden[name]["tw"],
                  f"{name}: width {res.width} != golden {golden[name]}")
        check(launches > 0, f"{name}: the wavefront kernel never launched")
        log(f"solve {name}: treewidth={res.width} exact={res.exact} "
            f"lb={res.lb} ub={res.ub} expanded={res.expanded} "
            f"launches={launches} wall={wall:.3f} s "
            f"states/s={res.expanded / wall:.0f}")
    total = wavefront_ops.LAUNCHES
    check(total > 0, "the main path never launched the wavefront kernel")
    return total


def timing_inputs(torch, np, bitset, graph, preprocess, solver, batch,
                  name, k, block=2048):
    """B=block states from the largest level of ``name`` at width k."""
    g = preprocess.preprocess(graph.REGISTRY[name]()).blocks[0].g
    plan = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None)
    gk = plan.graph_at(k)
    cap = batch.plan_capacity(g.n, block=block)
    res = solver.decide(gk, k, plan.clique, cap=cap, block=block,
                        keep_levels=True, engine="host")
    level = max(res.levels, key=len)
    rows = level[:block]
    states = np.zeros((block, bitset.n_words(g.n)), dtype=np.uint32)
    states[:len(rows)] = rows
    valid = np.arange(block) < len(rows)
    dev = DEVICE
    return (bitset.to_words(gk.packed(), dev), bitset.to_words(states, dev),
            torch.from_numpy(valid).to(dev), k,
            bitset.to_words(bitset.np_allowed(g.n, plan.clique), dev),
            g.n, len(rows))


def bound_ms(torch, bitset, components, adj, states, valid, allowed, n):
    """Least time for this call: bytes moved (each input read once, each
    output written once) over HBM, or the word operations these states
    need over the 32-bit rate, whichever is larger."""
    b, w = states.shape
    nbytes = (4 * adj.numel() + 4 * states.numel() + valid.numel()
              + 4 * allowed.numel() + 4 * b * n * w + b * n)
    live = states[valid]
    z_sizes = bitset.popcount(components.closure(adj, live, n)).sum()
    hops = bitset.popcount(adj[None] & live[:, None, :]).sum()
    # one closure pass and the nb product over the component sizes, the
    # reach hops, and a word op per (v, word) for deg and for children
    ops = w * (2 * int(z_sizes) + int(hops)) + 3 * n * w * int(len(live))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def phase_times(torch, np, bitset, graph, preprocess, solver, batch,
                components, wavefront):
    rows = []
    for name, k in TIMING_SHAPES:
        adj, states, valid, kk, allowed, n, live = timing_inputs(
            torch, np, bitset, graph, preprocess, solver, batch, name, k)
        args = (adj, states, valid, kk, allowed)
        got = wavefront.wavefront_expand(*args, n=n)
        want = wavefront.wavefront_ref(*args, n=n)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"wavefront kernel != plain version on {name} states")
        ms = cuda_time_ms(torch, lambda: wavefront.wavefront_expand(*args,
                                                                    n=n))
        plain = cuda_time_ms(torch, lambda: wavefront.wavefront_ref(*args,
                                                                   n=n),
                             iters=20)
        bound, by, nbytes, ops = bound_ms(torch, bitset, components, adj,
                                          states, valid, allowed, n)
        log(f"time wavefront {name} k={k}: B={states.shape[0]} "
            f"(live {live}) n={n} W={states.shape[1]}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bound:.6f} ms by {by} "
            f"({nbytes} bytes, {ops} word ops)")
        rows.append(dict(shape=name, n=n, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by))
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import (batch, bitset, components, graph,
                                  preprocess, solver)
    from repro_torch.kernels import build, wavefront
    from repro_torch.kernels.wavefront import ops as wavefront_ops

    golden = json.loads((ROOT / "tests" / "golden_widths.json").read_text())
    t_start = time.perf_counter()
    smi = phase_device(build)
    worst = phase_kernels(torch, np, bitset, graph, wavefront)
    launches = phase_main_path(torch, graph, solver, golden, wavefront_ops)
    times = phase_times(torch, np, bitset, graph, preprocess, solver, batch,
                        components, wavefront)
    main_shape = times[0]
    kernels = [dict(
        name="wavefront", route="cuda",
        source="src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
        replaces="src/repro/kernels/wavefront/kernel.py:47",
        launches=launches, max_abs_err=worst, ms=main_shape["ms"],
        plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
        bound_by=main_shape["bound_by"], library_ms=None)]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
