#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  1. device: the card's name and power limit, and the nvcc build of every
     kernel from the sources in this checkout (one nvcc per source, all
     started together), with ptxas's register and shared-memory report;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit (``torch.equal``): the wavefront kernel under all
     four pruning-flag combinations, the MMW, expand and Bloom kernels,
     over sweeps of shapes with invalid rows, words whose bit 31 is set,
     duplicate rows and forced probe collisions;
  3. main paths: ``repro_torch.core.solver.solve(g)`` on petersen,
     myciel4, queen5_5, queen6_6 and queen7_7 with its defaults (cuda
     device and backend, cap auto, block 2048), with the paper's
     configuration (``mode="bloom", use_mmw=True``) and with
     ``use_simplicial=True``.  Width, exact, lb, ub, expanded and per_k
     must equal the JAX package's values (EXPECTED and EXPECTED_FLAGS,
     from ``repro.core.solver.solve`` on the CPU; widths also from
     tests/golden_widths.json).  Each path runs with every launch count
     set to 0 just before it and read just after, and fails unless every
     kernel of that path launched.  Then petersen and queen5_5 with
     ``reconstruct=True`` (host engine): the stitched order must be
     accepted and replay within the width;
  4. times: each kernel and its plain version at the main path's shapes
     (B=2048 states taken from real frontiers of queen6_6 and queen7_7,
     and a chunk's 2048*n sorted children for the Bloom kernel), with
     CUDA events, beside the least time the card could take;
  5. split: one queen7_7 solve in the paper's configuration under
     ``torch.profiler``: host planning, the level loop, and the device
     time of each kernel.

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
# used for the kernels' 32-bit integer word operations)
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
# ``repro.core.solver.solve(g, **FLAG_CONFIGS[config])`` on the CPU
FLAG_CONFIGS = {"bloom+mmw": dict(mode="bloom", use_mmw=True),
                "simplicial": dict(use_simplicial=True)}
EXPECTED_FLAGS = {
    "bloom+mmw": {
        "petersen": dict(
            width=4, exact=True, lb=3, ub=5, expanded=108,
            block="PetersenGraph_red[10]_red",
            per_k=[(3, False, False, 9), (4, True, False, 99)]),
        "myciel4": dict(
            width=10, exact=True, lb=8, ub=11, expanded=70553,
            block="myciel4_red[23]_red",
            per_k=[(8, False, False, 392), (9, False, False, 11592),
                   (10, True, False, 58569)]),
        "queen5_5": dict(
            width=18, exact=True, lb=12, ub=18, expanded=1839,
            block="queen5_5_red[25]_red",
            per_k=[(12, False, False, 1), (13, False, False, 16),
                   (14, False, False, 110), (15, False, False, 206),
                   (16, False, False, 369), (17, False, False, 1137)]),
        "queen6_6": dict(
            width=25, exact=True, lb=15, ub=26, expanded=41156,
            block="queen6_6_red[36]_red",
            per_k=[(15, False, False, 1), (16, False, False, 1),
                   (17, False, False, 160), (18, False, False, 200),
                   (19, False, False, 367), (20, False, False, 802),
                   (21, False, False, 1601), (22, False, False, 4035),
                   (23, False, False, 5952), (24, False, False, 10688),
                   (25, True, False, 17349)]),
        "queen7_7": dict(
            width=35, exact=False, lb=18, ub=37, expanded=1962573,
            block="queen7_7_red[49]_red",
            per_k=[(18, False, False, 1), (19, False, False, 1),
                   (20, False, False, 37), (21, False, False, 290),
                   (22, False, False, 511), (23, False, False, 690),
                   (24, False, False, 2545), (25, False, False, 4252),
                   (26, False, False, 8337), (27, False, False, 19713),
                   (28, False, False, 34420), (29, False, False, 59316),
                   (30, False, False, 87478), (31, False, False, 142828),
                   (32, False, False, 213130), (33, False, False, 342241),
                   (34, False, True, 452425), (35, True, True, 594358)]),
    },
    "simplicial": {
        "petersen": dict(
            width=4, exact=True, lb=3, ub=5, expanded=139,
            block="PetersenGraph_red[10]_red",
            per_k=[(3, False, False, 40), (4, True, False, 99)]),
        "myciel4": dict(
            width=10, exact=True, lb=8, ub=11, expanded=38292,
            block="myciel4_red[23]_red",
            per_k=[(8, False, False, 5420), (9, False, False, 11824),
                   (10, True, False, 21048)]),
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
            width=35, exact=False, lb=18, ub=37, expanded=1894707,
            block="queen7_7_red[49]_red",
            per_k=[(18, False, False, 497), (19, False, False, 497),
                   (20, False, False, 4353), (21, False, False, 4353),
                   (22, False, False, 7096), (23, False, False, 7096),
                   (24, False, False, 7529), (25, False, False, 7529),
                   (26, False, False, 14072), (27, False, False, 42829),
                   (28, False, False, 51864), (29, False, False, 84226),
                   (30, False, False, 107336), (31, False, True, 164283),
                   (32, False, True, 226008), (33, False, True, 301801),
                   (34, False, True, 379357), (35, True, True, 483981)]),
    },
}
MAIN_PATH = ["petersen", "myciel4", "queen5_5", "queen6_6", "queen7_7"]
# path -> (solve arguments, expected values, kernels that must launch)
PATHS = {
    "defaults": ({}, EXPECTED, ("wavefront",)),
    "bloom+mmw": (FLAG_CONFIGS["bloom+mmw"], EXPECTED_FLAGS["bloom+mmw"],
                  ("wavefront", "bloom")),
    "simplicial": (FLAG_CONFIGS["simplicial"],
                   EXPECTED_FLAGS["simplicial"], ("wavefront",)),
}
RECONSTRUCT = ["petersen", "queen5_5"]
# (instance, k) whose largest level supplies the timing inputs
TIMING_SHAPES = [("queen6_6", 25), ("queen7_7", 30)]
PROFILE = ("queen7_7", "bloom+mmw")
DEVICE = "cuda"
SWEEP_N = (3, 17, 31, 32, 33, 36, 48, 49, 64, 100)
SWEEP_B = (1, 7, 128, 2048)
WAVEFRONT_FLAGS = [(False, False), (True, False), (False, True),
                   (True, True)]
MMW_N = (3, 17, 31, 33, 48, 64, 100)
BLOOM_CASES = [(64, 3), (64, 17), (1 << 14, 3), (1 << 14, 17),
               (1 << 24, 17)]
BLOOM_B = (1, 2048, 2048 * 49)
M_BITS = 1 << 24            # the solver's default filter
K_HASHES = 17
KERNELS = {
    "wavefront": ("src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
                  "src/repro/kernels/wavefront/kernel.py:47"),
    "mmw": ("src/repro_torch/kernels/mmw/csrc/mmw.cu",
            "src/repro/kernels/mmw/kernel.py:97"),
    "bloom": ("src/repro_torch/kernels/bloom/csrc/bloom.cu",
              "src/repro/kernels/bloom/kernel.py:62"),
    "expand": ("src/repro_torch/kernels/expand/csrc/expand.cu",
               "src/repro/kernels/expand/kernel.py:62"),
}


def flag_name(use_mmw, use_simplicial):
    return "+".join(n for n, on in (("mmw", use_mmw),
                                    ("simplicial", use_simplicial)) if on) \
        or "none"


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


def same(torch, got, want):
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(got, want)), \
        max_abs_err(torch, got, want)


def check_wavefront(torch, np, bitset, graph, kern):
    worst = 0
    for use_mmw, use_simp in WAVEFRONT_FLAGS:
        flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        for n in SWEEP_N:
            for b in SWEEP_B:
                args = random_inputs(torch, np, bitset, graph, n, b,
                                     seed=1000 * n + b, device=DEVICE)
                ok, err = same(torch,
                               kern.wavefront_expand(*args, n=n, **flags),
                               kern.wavefront_ref(*args, n=n, **flags))
                worst = max(worst, err)
                check(ok, f"wavefront kernel != plain version at n={n} "
                          f"B={b} flags={flag_name(use_mmw, use_simp)} "
                          f"(max abs err {err})")
    log(f"kernels: wavefront bit-identical to wavefront_ref under flags "
        f"{[flag_name(*f) for f in WAVEFRONT_FLAGS]} over n={list(SWEEP_N)}"
        f" x B={list(SWEEP_B)}")
    return worst


def check_mmw(torch, np, bitset, graph, components, kern):
    worst = 0
    for n in MMW_N:
        for b in (37, 2048):
            adj, states, valid, _k, _ = random_inputs(
                torch, np, bitset, graph, n, b, seed=7 * n + b,
                device=DEVICE)
            _, reach = components.eliminated_degrees(adj, states, n)
            reach = reach * valid[:, None, None]     # invalid rows: zeros
            for k in (0, 2, 5, n):
                ok, err = same(torch, [kern.mmw_bounds(reach, states, k,
                                                       n=n)],
                               [kern.mmw_bounds_ref(reach, states, k, n=n)])
                worst = max(worst, err)
                check(ok, f"mmw kernel != plain version at n={n} B={b} "
                          f"k={k} (max abs err {err})")
    log(f"kernels: mmw bit-identical to mmw_bounds_ref over n={list(MMW_N)}"
        f" x k in (0, 2, 5, n) x B in (37, 2048)")
    return worst


def bloom_batch(torch, np, b, w, seed):
    """B rows of W random words, about 30% of them copies of an earlier
    row, about 10% invalid."""
    rng = np.random.RandomState(seed)
    states = rng.randint(0, 2**32, size=(b, w), dtype=np.uint64).astype(
        np.uint32)
    src = (rng.rand(b) * np.arange(b)).astype(np.int64)
    dup = (rng.rand(b) < 0.3) & (np.arange(b) > 0)
    for i in np.nonzero(dup)[0]:
        states[i] = states[src[i]]
    valid = rng.rand(b) < 0.9
    return (torch.from_numpy(states.view(np.int32).copy()).to(DEVICE),
            torch.from_numpy(valid).to(DEVICE))


def check_bloom(torch, np, kern):
    worst = 0
    for m_bits, k in BLOOM_CASES:
        filt = kern.make_filter_words(m_bits, device=DEVICE)
        for b in BLOOM_B:
            states, valid = bloom_batch(torch, np, b, 2, seed=m_bits + b + k)
            want = kern.bloom_insert_ref(filt.clone(), states, valid,
                                         m_bits=m_bits, k_hashes=k)
            got = kern.bloom_insert(filt, states, valid, m_bits=m_bits,
                                    k_hashes=k)
            ok, err = same(torch, got, want)
            worst = max(worst, err)
            check(ok, f"bloom kernel != plain version at m_bits={m_bits} "
                      f"k={k} B={b} (max abs err {err})")
    log(f"kernels: bloom bit-identical to bloom_insert_ref (was_new and "
        f"filter words, filter carried across batches) over "
        f"(m_bits, k)={BLOOM_CASES} x B={list(BLOOM_B)}")
    return worst


def check_expand(torch, np, bitset, graph, kern):
    worst = 0
    for n in SWEEP_N:
        for b in SWEEP_B:
            adj, states, _, _, _ = random_inputs(
                torch, np, bitset, graph, n, b, seed=3000 * n + b,
                device=DEVICE)
            ok, err = same(torch, [kern.expand_degrees(adj, states, n=n)],
                           [kern.expand_degrees_ref(adj, states, n=n)])
            worst = max(worst, err)
            check(ok, f"expand kernel != plain version at n={n} B={b} "
                      f"(max abs err {err})")
    log(f"kernels: expand bit-identical to expand_degrees_ref over "
        f"n={list(SWEEP_N)} x B={list(SWEEP_B)}")
    return worst


def phase_kernels(torch, np, bitset, graph, components, kern):
    return {"wavefront": check_wavefront(torch, np, bitset, graph,
                                         kern["wavefront"]),
            "mmw": check_mmw(torch, np, bitset, graph, components,
                             kern["mmw"]),
            "bloom": check_bloom(torch, np, kern["bloom"]),
            "expand": check_expand(torch, np, bitset, graph,
                                   kern["expand"])}


def reset_counts(ops):
    for mod in ops.values():
        mod.LAUNCHES = 0


def read_counts(ops):
    return {name: mod.LAUNCHES for name, mod in ops.items()}


def check_solve(res, name, want, golden):
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


def phase_main_paths(torch, graph, solver, golden, ops):
    """Each path with its launch counts set to 0 just before it and read
    just after; returns path -> counts and the solves' walls."""
    counts, walls = {}, {}
    for path, (kw, expected, needed) in PATHS.items():
        reset_counts(ops)
        for name in MAIN_PATH:
            before = read_counts(ops)
            t0 = time.perf_counter()
            res = solver.solve(graph.REGISTRY[name](), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls[(path, name)] = wall
            check_solve(res, f"{path} {name}", expected[name], golden)
            launched = {k: v - before[k] for k, v in read_counts(ops).items()}
            log(f"solve [{path}] {name}: treewidth={res.width} "
                f"exact={res.exact} lb={res.lb} ub={res.ub} "
                f"expanded={res.expanded} launches={launched} "
                f"wall={wall:.3f} s states/s={res.expanded / wall:.0f}")
        counts[path] = read_counts(ops)
        for kernel in needed:
            check(counts[path][kernel] > 0,
                  f"path {path}: the {kernel} kernel never launched")
        log(f"path [{path}]: launches {counts[path]}")

    reset_counts(ops)
    for name in RECONSTRUCT:
        g = graph.REGISTRY[name]()
        res = solver.solve(g, reconstruct=True)
        check(res.order is not None,
              f"reconstruct {name}: the stitched order was rejected")
        replay = solver.order_width(g, res.order)
        check(replay <= res.width == EXPECTED[name]["width"],
              f"reconstruct {name}: order replays at {replay}, width "
              f"{res.width}, JAX {EXPECTED[name]['width']}")
        log(f"reconstruct {name}: width={res.width} order verified "
            f"(replays at {replay})")
    counts["reconstruct"] = read_counts(ops)
    check(counts["reconstruct"]["wavefront"] > 0,
          "reconstruction never launched the wavefront kernel")
    return counts, walls


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


def bound(nbytes, ops):
    """Least time: bytes over HBM or word operations over the 32-bit rate,
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def closure_ops(bitset, components, adj, states, n):
    """Word operations of the closure and reach of ``states``: one closure
    pass and the nb product over the component sizes, and the reach hops."""
    w = states.shape[1]
    z_sizes = bitset.popcount(components.closure(adj, states, n)).sum()
    hops = bitset.popcount(adj[None] & states[:, None, :]).sum()
    return w * (2 * int(z_sizes) + int(hops))


def wavefront_bound(bitset, components, adj, states, valid, allowed, n,
                    pruned_rows):
    """Each input read once, each output written once; the closure's word
    operations, a word op per (v, word) for deg and for children, and for
    the pruning rules one read of the n*W reach words of every state that
    runs them (counted low: the contraction steps are not counted)."""
    b, w = states.shape
    nbytes = (4 * adj.numel() + 4 * states.numel() + valid.numel()
              + 4 * allowed.numel() + 4 * b * n * w + b * n)
    live = states[valid]
    ops = (closure_ops(bitset, components, adj, live, n)
           + 3 * n * w * int(len(live)) + n * w * pruned_rows)
    return bound(nbytes, ops) + (nbytes, ops)


def bloom_bound(torch, bloom, states, valid, m_bits, k):
    """States and the valid mask read once, was_new written once, each
    distinct filter word that a probe touches read and written once; two
    murmur3 passes (about 10 word ops per word and 10 more) and 3 ops per
    probe for every valid row."""
    b, w = states.shape
    idx = bloom.probe_indices(states[valid], m_bits, k)
    words = int(torch.unique(idx.reshape(-1) >> 5).numel())
    rows = int(valid.sum())
    nbytes = 4 * states.numel() + 2 * b + 8 * words
    ops = rows * (2 * (10 * w + 10) + 3 * k)
    return bound(nbytes, ops) + (nbytes, ops)


def time_pair(torch, fn, ref):
    return cuda_time_ms(torch, fn), cuda_time_ms(torch, ref, iters=20)


def phase_times(torch, np, bitset, graph, preprocess, solver, batch,
                components, bloom, dedup, kern):
    rows = {name: [] for name in KERNELS}
    variants = []
    for shape, k in TIMING_SHAPES:
        adj, states, valid, kk, allowed, n, live = timing_inputs(
            torch, np, bitset, graph, preprocess, solver, batch, shape, k)
        b, w = states.shape
        wf = kern["wavefront"]
        args = (adj, states, valid, kk, allowed)
        for use_mmw, use_simp in WAVEFRONT_FLAGS:
            flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
            ok, _ = same(torch, wf.wavefront_expand(*args, n=n, **flags),
                         wf.wavefront_ref(*args, n=n, **flags))
            check(ok, f"wavefront kernel != plain version on {shape} "
                      f"states, flags {flag_name(use_mmw, use_simp)}")
            ms, plain = time_pair(
                torch, lambda: wf.wavefront_expand(*args, n=n, **flags),
                lambda: wf.wavefront_ref(*args, n=n, **flags))
            pruned = 0
            if use_mmw or use_simp:
                _, feas = wf.wavefront_ref(*args, n=n)
                pruned = int(feas.any(dim=1).sum())
            bms, by, nbytes, ops = wavefront_bound(
                bitset, components, adj, states, valid, allowed, n, pruned)
            name = flag_name(use_mmw, use_simp)
            log(f"time wavefront[{name}] {shape} k={k}: B={b} (live {live})"
                f" n={n} W={w}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {bms:.6f} ms by {by} ({nbytes} bytes, {ops} word "
                f"ops)")
            entry = dict(shape=shape, flags=name, ms=ms, plain_ms=plain,
                         bound_ms=bms, bound_by=by)
            if name == "none":
                rows["wavefront"].append(entry)
            else:
                variants.append(entry)

        _, reach = components.eliminated_degrees(adj, states, n)
        mm = kern["mmw"]
        ok, _ = same(torch, [mm.mmw_bounds(reach, states, kk, n=n)],
                     [mm.mmw_bounds_ref(reach, states, kk, n=n)])
        check(ok, f"mmw kernel != plain version on {shape} states")
        ms, plain = time_pair(torch,
                              lambda: mm.mmw_bounds(reach, states, kk, n=n),
                              lambda: mm.mmw_bounds_ref(reach, states, kk,
                                                        n=n))
        nbytes = 4 * reach.numel() + 4 * states.numel() + 4 * b
        ops = n * w * b        # one read of each reach word, counted low
        bms, by = bound(nbytes, ops)
        log(f"time mmw {shape} k={k}: B={b} n={n} W={w}: kernel {ms:.4f} "
            f"ms, plain {plain:.4f} ms, bound {bms:.6f} ms by {by} "
            f"({nbytes} bytes, {ops} word ops)")
        rows["mmw"].append(dict(shape=shape, ms=ms, plain_ms=plain,
                                bound_ms=bms, bound_by=by))

        ex = kern["expand"]
        ok, _ = same(torch, [ex.expand_degrees(adj, states, n=n)],
                     [ex.expand_degrees_ref(adj, states, n=n)])
        check(ok, f"expand kernel != plain version on {shape} states")
        ms, plain = time_pair(torch,
                              lambda: ex.expand_degrees(adj, states, n=n),
                              lambda: ex.expand_degrees_ref(adj, states,
                                                            n=n))
        nbytes = 4 * adj.numel() + 4 * states.numel() + 4 * b * n
        ops = (closure_ops(bitset, components, adj, states, n)
               + 2 * n * w * b)
        bms, by = bound(nbytes, ops)
        log(f"time expand {shape} k={k}: B={b} n={n} W={w}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.6f} ms by {by}"
            f" ({nbytes} bytes, {ops} word ops)")
        rows["expand"].append(dict(shape=shape, ms=ms, plain_ms=plain,
                                   bound_ms=bms, bound_by=by))

        # the Bloom kernel's main-path input: one chunk's sorted children
        # and their first-occurrence mask, into a default-size filter
        children, feas = wf.wavefront_expand(*args, n=n)
        skeys, svalid = dedup.sort_states(children.reshape(b * n, w),
                                          feas.reshape(b * n))
        keep = dedup.unique_mask(skeys, svalid)
        bl = kern["bloom"]
        filt = bl.make_filter_words(M_BITS, device=DEVICE)
        ok, _ = same(torch,
                     bl.bloom_insert(filt.clone(), skeys, keep,
                                     m_bits=M_BITS, k_hashes=K_HASHES),
                     bl.bloom_insert_ref(filt.clone(), skeys, keep,
                                         m_bits=M_BITS, k_hashes=K_HASHES))
        check(ok, f"bloom kernel != plain version on {shape} children")
        ms, plain = time_pair(
            torch, lambda: bl.bloom_insert(filt, skeys, keep, m_bits=M_BITS,
                                           k_hashes=K_HASHES),
            lambda: bl.bloom_insert_ref(filt, skeys, keep, m_bits=M_BITS,
                                        k_hashes=K_HASHES))
        bms, by, nbytes, ops = bloom_bound(torch, bloom, skeys, keep, M_BITS,
                                           K_HASHES)
        log(f"time bloom {shape} k={k}: B={b * n} rows ({int(keep.sum())} "
            f"kept) W={w} m_bits={M_BITS} k_hashes={K_HASHES}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.6f} ms by {by} "
            f"({nbytes} bytes, {ops} word ops)")
        rows["bloom"].append(dict(shape=shape, ms=ms, plain_ms=plain,
                                  bound_ms=bms, bound_by=by))
    return rows, variants


# device-side names of the port's kernels (the rest is PyTorch's work)
PORT_KERNEL_NAMES = ("wavefront_kernel", "mmw_kernel", "expand_kernel",
                     "claim_kernel", "query_kernel", "insert_kernel")


def _device_us(evt):
    """Device time of a profiler row that is device work (a kernel, a
    copy or a memset); 0 for host-side rows, whose device time repeats
    their kernels'."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def phase_split(torch, graph, preprocess, solver, walls):
    """One solve under torch.profiler: host planning (preprocess and the
    block's bounds, timed alone), the rest of the untraced wall (the level
    loop), and device time by kernel."""
    name, path = PROFILE
    kw = PATHS[path][0]
    g = graph.REGISTRY[name]()
    t0 = time.perf_counter()
    block = preprocess.preprocess(g).blocks[0].g
    solver.plan_block(block, use_clique=True, use_paths=True, start_k=None)
    plan_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        solver.solve(g, **kw)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    wall = walls[(path, name)]
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    device_s = sum(by_kernel.values()) / 1e6
    port_s = sum(us for key, us in by_kernel.items()
                 if any(k in key for k in PORT_KERNEL_NAMES)) / 1e6
    log(f"split {name} [{path}]: wall {wall:.3f} s untraced, "
        f"{traced_s:.3f} s traced; host planning {plan_s:.3f} s; level "
        f"loop {wall - plan_s:.3f} s; device busy {device_s:.3f} s "
        f"({100 * device_s / wall:.1f}% of the untraced wall), of which "
        f"the port's kernels {port_s:.3f} s")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    for key, us in top:
        log(f"  device {us / 1e3:9.3f} ms  {key[:90]}")
    if not by_kernel:
        log("  the profiler reported no device time")


def main():
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import (batch, bitset, bloom, components, dedup,
                                  graph, preprocess, solver)
    from repro_torch.kernels import bloom as bloom_kern
    from repro_torch.kernels import build
    from repro_torch.kernels import expand as expand_kern
    from repro_torch.kernels import mmw as mmw_kern
    from repro_torch.kernels import wavefront as wavefront_kern

    kern = {"wavefront": wavefront_kern, "mmw": mmw_kern,
            "bloom": bloom_kern, "expand": expand_kern}
    ops = {name: mod.ops for name, mod in kern.items()}
    golden = json.loads((ROOT / "tests" / "golden_widths.json").read_text())
    t_start = time.perf_counter()
    smi = phase_device(build)
    worst = phase_kernels(torch, np, bitset, graph, components, kern)
    counts, walls = phase_main_paths(torch, graph, solver, golden, ops)
    times, variants = phase_times(torch, np, bitset, graph, preprocess,
                                  solver, batch, components, bloom, dedup,
                                  kern)
    phase_split(torch, graph, preprocess, solver, walls)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        main_shape = times[name][0]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[name] for c in counts.values()),
            max_abs_err=worst[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None)
        if name == "wavefront":
            entry["variants"] = [v for v in variants
                                 if v["shape"] == main_shape["shape"]]
        kernels.append(entry)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
