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
     duplicate rows and forced probe collisions; and the lane forms of
     the wavefront and Bloom kernels (one launch for L lanes, L in 1, 3
     and 8, ragged valid rows and a lane with none);
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
     the wavefront kernel also at B=128, a ``SMALL_BLOCK`` chunk, and a
     chunk's 2048*n sorted children for the Bloom kernel; the lane forms
     on 8 lanes of queen7_7 at k=23..30 and their children in 8
     filters): the kernel's device time per call by replaying a CUDA
     graph of captured wrapper calls, and the time per wrapper call with
     CUDA events, beside the least time the card could take;
  5. split: one queen7_7 solve in the paper's configuration under
     ``torch.profiler``: host planning, the level loop, and the device
     time of each kernel;
  6. lane paths: ``solve(g, lanes=4)`` on the five instances of phase 3
     and ``batch.solve_many`` with 8 lanes over myciel3, myciel4,
     queen5_5, queen6_6, petersen, desargues and queen7_7 (padded to
     n=49, W=2), under the defaults and the paper's configuration, equal
     to the JAX package's values (EXPECTED, EXPECTED_FLAGS and
     EXPECTED_MANY); each path with its launch counts set to 0 just
     before it and read just after, failing unless its kernels launched
     and some wavefront launch covered several lanes; and the suite's
     wall under ``solve_many`` beside the sequential ``solve`` loop.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.

    python3 chip_smoke.py --times-only [--src DIR]

runs phases 1 and 4 alone against the ``repro_torch`` package under
``DIR`` (default ``src`` here), for instance an unpacked older commit, so
that two versions of the kernels can be timed in turns on one card;
its last line is ``{"times": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
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

# The lane paths.  ``solve(g, lanes=SPEC_LANES, **config)`` decides
# SPEC_LANES rungs per dispatch and must give EXPECTED / EXPECTED_FLAGS
# (speculative lanes share n).  ``batch.solve_many(SUITE,
# lanes=SUITE_LANES, **config)`` pads the suite to n=49, W=2; its expected
# values are ``repro.core.batch.solve_many`` on the CPU with the same
# arguments (backend "jax", its default closure schedule "while"; every
# schedule reaches the same closure).  For the five instances of EXPECTED
# the reference gave exactly EXPECTED's and EXPECTED_FLAGS' values (no
# padding caveat of the multi-lane engine changed them), so only myciel3
# and desargues are written out.
SPEC_LANES = 4
SUITE_LANES = 8
SUITE = ["myciel3", "myciel4", "queen5_5", "queen6_6", "petersen",
         "desargues", "queen7_7"]
LANE_CONFIGS = {"defaults": {}, "bloom+mmw": FLAG_CONFIGS["bloom+mmw"]}
EXPECTED_MANY = {
    "defaults": {
        **EXPECTED,
        "myciel3": dict(
            width=5, exact=True, lb=4, ub=5, expanded=60,
            block="myciel3_red[11]_red", per_k=[(4, False, False, 60)]),
        "desargues": dict(
            width=6, exact=True, lb=4, ub=7, expanded=203306,
            block="DesarguesGraph_red[20]_red",
            per_k=[(4, False, False, 25554), (5, False, False, 61044),
                   (6, True, False, 116708)]),
    },
    "bloom+mmw": {
        **EXPECTED_FLAGS["bloom+mmw"],
        "myciel3": dict(
            width=5, exact=True, lb=4, ub=5, expanded=10,
            block="myciel3_red[11]_red", per_k=[(4, False, False, 10)]),
        "desargues": dict(
            width=6, exact=True, lb=4, ub=7, expanded=191278,
            block="DesarguesGraph_red[20]_red",
            per_k=[(4, False, False, 14439), (5, False, False, 60131),
                   (6, True, False, 116708)]),
    },
}
# lane counts and shapes of the lane kernels' checks
LANE_L = (1, 3, 8)
LANE_N = (17, 33, 49, 100)
LANE_B = (7, 128)
# timing: SUITE_LANES lanes of queen7_7, one rung each, the largest level
TIMING_LANES = ("queen7_7", tuple(range(23, 31)))
# (instance, k) whose largest level supplies the timing inputs
TIMING_SHAPES = [("queen6_6", 25), ("queen7_7", 30)]
# chunk widths of the engine: ``block`` and ``SMALL_BLOCK``
TIMING_B = (2048, 128)
# calls captured in the CUDA graph that times a kernel on the device, and
# untimed calls before any timing
GRAPH_CALLS = 50
WARMUP = 5
PROFILE = ("queen7_7", "bloom+mmw")
DEVICE = "cuda"
SWEEP_N = (3, 17, 31, 32, 33, 36, 48, 49, 64, 100)
SWEEP_B = (1, 7, 128, 2048)
# word and lane edges up to W = 8, at the engine's chunk widths
EDGE_N = (65, 256)
EDGE_B = (1, 128, 2048)
WAVEFRONT_FLAGS = [(False, False), (True, False), (False, True),
                   (True, True)]
MMW_N = (3, 17, 31, 33, 48, 64, 100)
BLOOM_CASES = [(64, 3), (64, 17), (1 << 14, 3), (1 << 14, 17),
               (1 << 24, 17)]
# probe counts: one, and groups past one warp
BLOOM_K_EDGES = [(64, 1), (1 << 14, 33), (64, 64), (1 << 24, 64)]
BLOOM_B = (1, 2048, 2048 * 49)
M_BITS = 1 << 24            # the solver's default filter
K_HASHES = 17
KERNELS = {
    "wavefront": ("src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
                  "src/repro/kernels/wavefront/kernel.py:47"),
    "wavefront_lanes": (
        "src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
        "src/repro/kernels/wavefront/kernel.py:47"),
    "bloom_lanes": ("src/repro_torch/kernels/bloom/csrc/bloom.cu",
                    "src/repro/kernels/bloom/kernel.py:62"),
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
    for _ in range(WARMUP):
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


def ptxas_rows(text):
    """(kernel<template args>, registers, stack bytes, spill bytes) for
    each entry function in nvcc's ``-Xptxas -v`` report."""
    rows, name, stack, spill = [], None, 0, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"([a-z]+_kernel)", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
            stack = spill = 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), stack, spill))
            name = None
    return rows


def phase_device(build):
    line = smi_line()
    log(f"device: {line}")
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(reports)} kernel source(s) in {build_s:.1f} s")
    for name, text in reports.items():
        for kernel, regs, stack, spill in ptxas_rows(text):
            log(f"  ptxas {name}: {kernel}: {regs} registers, {stack} bytes "
                f"stack, {spill} bytes spilled")
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


def shape_cases():
    """(n, B, all rows invalid) of the kernels' sweeps: every n with every
    B, the edge n at the chunk widths, and a chunk with no valid row."""
    cases = [(n, b, False) for n in SWEEP_N for b in SWEEP_B]
    cases += [(n, b, False) for n in EDGE_N for b in EDGE_B]
    cases += [(n, 128, True) for n in (32, 33, 64) + EDGE_N]
    return cases


def check_wavefront(torch, np, bitset, graph, kern):
    worst = 0
    for use_mmw, use_simp in WAVEFRONT_FLAGS:
        flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        for n, b, none_valid in shape_cases():
            adj, states, valid, k, allowed = random_inputs(
                torch, np, bitset, graph, n, b, seed=1000 * n + b,
                device=DEVICE)
            if none_valid:
                valid = torch.zeros_like(valid)
            args = (adj, states, valid, k, allowed)
            got = kern.wavefront_expand(*args, n=n, **flags)
            ok, err = same(torch, got,
                           kern.wavefront_ref(*args, n=n, **flags))
            worst = max(worst, err)
            check(ok and not (none_valid and bool(got[1].any())),
                  f"wavefront kernel != plain version at n={n} B={b} "
                  f"flags={flag_name(use_mmw, use_simp)} all-invalid="
                  f"{none_valid} (max abs err {err})")
    log(f"kernels: wavefront bit-identical to wavefront_ref under flags "
        f"{[flag_name(*f) for f in WAVEFRONT_FLAGS]} over n={list(SWEEP_N)}"
        f" x B={list(SWEEP_B)}, n={list(EDGE_N)} x B={list(EDGE_B)}, and "
        f"chunks of 128 rows with no valid row")
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


BLOOM_KINDS = ("random", "none valid", "one row")


def bloom_batch(torch, np, b, w, seed, kind="random"):
    """B rows of W random words: ``random`` has about 30% of them copies
    of an earlier row and about 10% invalid; ``none valid`` the same rows
    with no valid one; ``one row`` the first row B times, all valid."""
    rng = np.random.RandomState(seed)
    states = rng.randint(0, 2**32, size=(b, w), dtype=np.uint64).astype(
        np.uint32)
    src = (rng.rand(b) * np.arange(b)).astype(np.int64)
    dup = (rng.rand(b) < 0.3) & (np.arange(b) > 0)
    for i in np.nonzero(dup)[0]:
        states[i] = states[src[i]]
    valid = rng.rand(b) < 0.9
    if kind == "none valid":
        valid[:] = False
    elif kind == "one row":
        states[:] = states[0]
        valid[:] = True
    return (torch.from_numpy(states.view(np.int32).copy()).to(DEVICE),
            torch.from_numpy(valid).to(DEVICE))


def check_bloom(torch, np, kern):
    """Every (m_bits, k) case over every batch size and kind, into one
    filter per case carried from batch to batch; at 64 bits every batch
    of more than a few rows has rows that share probe bits."""
    worst = 0
    for m_bits, k in BLOOM_CASES + BLOOM_K_EDGES:
        filt = kern.make_filter_words(m_bits, device=DEVICE)
        for b in BLOOM_B:
            for kind in BLOOM_KINDS:
                states, valid = bloom_batch(torch, np, b, 2,
                                            seed=m_bits + b + k, kind=kind)
                want = kern.bloom_insert_ref(filt.clone(), states, valid,
                                             m_bits=m_bits, k_hashes=k)
                got = kern.bloom_insert(filt, states, valid, m_bits=m_bits,
                                        k_hashes=k)
                ok, err = same(torch, got, want)
                worst = max(worst, err)
                check(ok, f"bloom kernel != plain version at m_bits="
                          f"{m_bits} k={k} B={b} batch={kind} (max abs err "
                          f"{err})")
    log(f"kernels: bloom bit-identical to bloom_insert_ref (was_new and "
        f"filter words, filter carried across batches) over "
        f"(m_bits, k)={BLOOM_CASES + BLOOM_K_EDGES} x B={list(BLOOM_B)} x "
        f"batches {list(BLOOM_KINDS)}")
    return worst


def check_expand(torch, np, bitset, graph, kern):
    worst = 0
    for n, b, none_valid in shape_cases():
        if none_valid:            # the expand kernel has no valid mask
            continue
        adj, states, _, _, _ = random_inputs(
            torch, np, bitset, graph, n, b, seed=3000 * n + b,
            device=DEVICE)
        ok, err = same(torch, [kern.expand_degrees(adj, states, n=n)],
                       [kern.expand_degrees_ref(adj, states, n=n)])
        worst = max(worst, err)
        check(ok, f"expand kernel != plain version at n={n} B={b} "
                  f"(max abs err {err})")
    log(f"kernels: expand bit-identical to expand_degrees_ref over "
        f"n={list(SWEEP_N)} x B={list(SWEEP_B)} and n={list(EDGE_N)} x "
        f"B={list(EDGE_B)}")
    return worst


def lane_inputs(torch, np, bitset, graph, n, b, lanes, seed, strided):
    """Per-lane graphs, states, ragged valid rows (lane 1 has none), k and
    allowed; ``strided`` hands the kernel the states as a lane-strided
    view of a larger buffer, as the engine's chunks are."""
    rng = np.random.RandomState(seed)
    adj = np.stack([graph.gnp(n, 0.2 + 0.05 * i, seed + i).packed()
                    for i in range(lanes)])
    w = bitset.n_words(n)
    bits = rng.rand(lanes, b, n) < rng.uniform(0.05, 0.6,
                                              size=(lanes, b, 1))
    for top in (31, 63):
        if top < n:
            bits[:, ::2, top] = True         # words with the high bit set
    states = bitset.pack(torch.from_numpy(bits.reshape(-1, n)), n).reshape(
        lanes, b, w).to(DEVICE)
    if strided:
        buf = torch.zeros((lanes, 3 * b, w), dtype=torch.int32,
                          device=DEVICE)
        buf[:, b:2 * b] = states
        states = buf[:, b:2 * b]
    valid = np.arange(b)[None] < rng.randint(1, b + 1, size=(lanes, 1))
    if lanes > 1:
        valid[1] = False
    allowed = np.stack([bitset.np_allowed(n, [i % n]) for i in range(lanes)])
    k = rng.randint(n // 4, n // 2 + 1, size=lanes).astype(np.int32)
    return (bitset.to_words(adj, DEVICE), states,
            torch.from_numpy(valid).to(DEVICE),
            torch.from_numpy(k).to(DEVICE), bitset.to_words(allowed, DEVICE))


def check_wavefront_lanes(torch, np, bitset, graph, kern):
    """The lane form against the plain version under every flag set: L in
    LANE_L, ragged valid rows and a lane with none, contiguous and
    lane-strided states, and a full 2048-row chunk of 8 lanes."""
    worst = 0
    cases = [(n, b, lanes) for n in LANE_N for b in LANE_B
             for lanes in LANE_L] + [(49, 2048, 8)]
    for use_mmw, use_simp in WAVEFRONT_FLAGS:
        flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        for i, (n, b, lanes) in enumerate(cases):
            args = lane_inputs(torch, np, bitset, graph, n, b, lanes,
                               seed=100 * n + b + lanes, strided=i % 2 == 1)
            got = kern.wavefront_expand(*args, n=n, **flags)
            ok, err = same(torch, got, kern.wavefront_ref(*args, n=n,
                                                          **flags))
            worst = max(worst, err)
            check(ok and (lanes == 1 or not bool(got[1][1].any())),
                  f"lane wavefront kernel != plain version at n={n} B={b} "
                  f"L={lanes} flags={flag_name(use_mmw, use_simp)} (max abs "
                  f"err {err})")
    log(f"kernels: lane wavefront bit-identical to wavefront_ref under "
        f"flags {[flag_name(*f) for f in WAVEFRONT_FLAGS]} over "
        f"n={list(LANE_N)} x B={list(LANE_B)} x L={list(LANE_L)} and "
        f"(n, B, L)=(49, 2048, 8), ragged valid rows, a lane with none, "
        f"contiguous and lane-strided states")
    return worst


def check_bloom_lanes(torch, np, kern):
    """One filter per lane carried from batch to batch, L in LANE_L, a
    lane with no valid row, against the plain version (each lane on its
    own)."""
    worst = 0
    for m_bits, k in [(64, 3), (1 << 14, 17), (1 << 24, 17)]:
        for lanes in LANE_L:
            filt = kern.make_filter_words(m_bits, device=DEVICE, lanes=lanes)
            for b in (1, 300, 4096):
                batches = [bloom_batch(torch, np, b, 2, seed=m_bits + b + i)
                           for i in range(lanes)]
                states = torch.stack([x[0] for x in batches])
                valid = torch.stack([x[1] for x in batches])
                if lanes > 1:
                    valid[1] = False
                want = kern.bloom_insert_ref(filt.clone(), states, valid,
                                             m_bits=m_bits, k_hashes=k)
                got = kern.bloom_insert(filt, states, valid, m_bits=m_bits,
                                        k_hashes=k)
                ok, err = same(torch, got, want)
                worst = max(worst, err)
                check(ok, f"lane bloom kernel != plain version at m_bits="
                          f"{m_bits} k={k} L={lanes} B={b} (max abs err "
                          f"{err})")
    log(f"kernels: lane bloom bit-identical to bloom_insert_ref (was_new "
        f"and every lane's filter, carried across batches) over m_bits in "
        f"(64, 2^14, 2^24) x L={list(LANE_L)} x B in (1, 300, 4096)")
    return worst


def phase_kernels(torch, np, bitset, graph, components, kern):
    return {"wavefront": check_wavefront(torch, np, bitset, graph,
                                         kern["wavefront"]),
            "mmw": check_mmw(torch, np, bitset, graph, components,
                             kern["mmw"]),
            "bloom": check_bloom(torch, np, kern["bloom"]),
            "expand": check_expand(torch, np, bitset, graph,
                                   kern["expand"]),
            "wavefront_lanes": check_wavefront_lanes(
                torch, np, bitset, graph, kern["wavefront"]),
            "bloom_lanes": check_bloom_lanes(torch, np, kern["bloom"])}


def reset_counts(ops):
    for mod in ops.values():
        mod.LAUNCHES = 0
    ops["wavefront"].LAUNCHES_BY_B.clear()
    ops["wavefront"].LAUNCHES_BY_LANES.clear()


def widths(ops):
    """The wavefront kernel's launches by chunk width, widest first."""
    return dict(sorted(ops["wavefront"].LAUNCHES_BY_B.items(),
                       reverse=True))


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
    just after; returns path -> counts, path -> the wavefront kernel's
    launches by chunk width, and the solves' walls."""
    counts, by_width, walls = {}, {}, {}
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
        by_width[path] = widths(ops)
        for kernel in needed:
            check(counts[path][kernel] > 0,
                  f"path {path}: the {kernel} kernel never launched")
        log(f"path [{path}]: launches {counts[path]}; wavefront launches "
            f"by chunk width {by_width[path]}")

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
    by_width["reconstruct"] = widths(ops)
    check(counts["reconstruct"]["wavefront"] > 0,
          "reconstruction never launched the wavefront kernel")
    log(f"path [reconstruct]: launches {counts['reconstruct']}; wavefront "
        f"launches by chunk width {by_width['reconstruct']}")
    return counts, by_width, walls


def phase_lanes(torch, graph, solver, batch, golden, ops):
    """The lane paths, each with its launch counts set to 0 just before it
    and read just after: ``solve(g, lanes=SPEC_LANES)`` over MAIN_PATH and
    ``batch.solve_many(SUITE, lanes=SUITE_LANES)``, under each of
    LANE_CONFIGS; then the suite's wall under ``solve_many`` beside the
    sequential ``[solve(g) for g in SUITE]`` loop.  Returns path ->
    counts, path -> the wavefront kernel's launches by lane count, and
    the suite walls."""
    counts, by_lanes, walls = {}, {}, {}
    for config, kw in LANE_CONFIGS.items():
        needed = PATHS[config][2]
        path = f"lanes={SPEC_LANES} {config}"
        reset_counts(ops)
        for name in MAIN_PATH:
            t0 = time.perf_counter()
            res = solver.solve(graph.REGISTRY[name](), lanes=SPEC_LANES,
                               **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_solve(res, f"{path} {name}", PATHS[config][1][name],
                        golden)
            log(f"solve [{path}] {name}: treewidth={res.width} "
                f"exact={res.exact} expanded={res.expanded} "
                f"wall={wall:.3f} s")
        counts[path] = read_counts(ops)
        by_lanes[path] = dict(sorted(
            ops["wavefront"].LAUNCHES_BY_LANES.items()))

        many = f"solve_many lanes={SUITE_LANES} {config}"
        gs = [graph.REGISTRY[name]() for name in SUITE]
        reset_counts(ops)
        t0 = time.perf_counter()
        results = batch.solve_many(gs, lanes=SUITE_LANES, **kw)
        torch.cuda.synchronize()
        walls[many] = time.perf_counter() - t0
        counts[many] = read_counts(ops)
        by_lanes[many] = dict(sorted(
            ops["wavefront"].LAUNCHES_BY_LANES.items()))
        for name, res in zip(SUITE, results):
            check_solve(res, f"{many} {name}", EXPECTED_MANY[config][name],
                        golden)
            log(f"solve [{many}] {name}: treewidth={res.width} "
                f"exact={res.exact} expanded={res.expanded}")
        t0 = time.perf_counter()
        for g in gs:
            solver.solve(g, **kw)
        torch.cuda.synchronize()
        walls[f"sequential {config}"] = time.perf_counter() - t0
        for p in (path, many):
            for kernel in needed:
                check(counts[p][kernel] > 0,
                      f"path [{p}]: the {kernel} kernel never launched")
            check(max(by_lanes[p], default=0) > 1,
                  f"path [{p}]: no wavefront launch covered several lanes")
            log(f"path [{p}]: launches {counts[p]}; wavefront launches by "
                f"lane count {by_lanes[p]}")
        log(f"suite wall [{config}]: solve_many {walls[many]:.3f} s, "
            f"sequential solve loop {walls[f'sequential {config}']:.3f} s "
            f"({len(SUITE)} instances)")
    return counts, by_lanes, walls


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


def device_ms(torch, fn, calls=GRAPH_CALLS, reset=None, replays=3):
    """Device time per call of the kernels that ``fn`` launches: ``calls``
    calls captured in one CUDA graph, the graph replayed ``replays``
    times with CUDA events around each replay, the fastest replay over
    ``calls``.  The wrapper's host work is left out; the gaps between
    the graph's kernels are in.  ``reset`` restores the inputs that a
    call changes before each replay."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(replays):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def kernel_times(torch, fn, ref, reset=None):
    """(device ms per call by graph replay, ms per wrapper call by CUDA
    events, plain version's ms per call by CUDA events)."""
    times = [device_ms(torch, fn, reset=reset)]
    for f, iters in ((fn, 100), (ref, 20)):
        if reset is not None:
            reset()
        times.append(cuda_time_ms(torch, f, iters=iters))
    return tuple(times)


class FreshFilters:
    """Empty default-size filters handed out in turn, one per call, so
    that every timed Bloom call finds the filter as a level's first chunk
    does; ``reset`` empties them all and starts the turn again."""

    def __init__(self, bl, count, lanes=None):
        self.filters = [bl.make_filter_words(M_BITS, device=DEVICE,
                                             lanes=lanes)
                        for _ in range(count)]
        self.turn = 0

    def __call__(self):
        f = self.filters[self.turn % len(self.filters)]
        self.turn += 1
        return f

    def reset(self):
        for f in self.filters:
            f.zero_()
        self.turn = 0


def time_wavefront(torch, bitset, components, wf, shape, k, args, n, live):
    adj, states, valid, _kk, allowed = args
    b, w = states.shape
    entries = []
    for use_mmw, use_simp in WAVEFRONT_FLAGS:
        flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        ok, _ = same(torch, wf.wavefront_expand(*args, n=n, **flags),
                     wf.wavefront_ref(*args, n=n, **flags))
        name = flag_name(use_mmw, use_simp)
        check(ok, f"wavefront kernel != plain version on {shape} states, "
                  f"B={b}, flags {name}")
        dev, ms, plain = kernel_times(
            torch, lambda: wf.wavefront_expand(*args, n=n, **flags),
            lambda: wf.wavefront_ref(*args, n=n, **flags))
        pruned = 0
        if use_mmw or use_simp:
            _, feas = wf.wavefront_ref(*args, n=n)
            pruned = int(feas.any(dim=1).sum())
        bms, by, nbytes, ops = wavefront_bound(
            bitset, components, adj, states, valid, allowed, n, pruned)
        log(f"time wavefront[{name}] {shape} k={k}: B={b} (live {live}) "
            f"n={n} W={w}: device {dev:.4f} ms, wrapper {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bms:.6f} ms by {by} ({nbytes} bytes, "
            f"{ops} word ops)")
        entries.append(dict(shape=shape, B=b, flags=name, ms=dev,
                            wrapper_ms=ms, plain_ms=plain, bound_ms=bms,
                            bound_by=by))
    return entries


def phase_times(torch, np, bitset, graph, preprocess, solver, batch,
                components, bloom, dedup, kern, lanes=True):
    """Returns kernel -> timing entries; the wavefront kernel's first
    entry is the main one (no flags, B=2048, the first shape).  ``lanes``
    adds the lane forms (``time_lanes``)."""
    rows = {name: [] for name in KERNELS}
    for shape, k in TIMING_SHAPES:
        adj, states, valid, kk, allowed, n, live = timing_inputs(
            torch, np, bitset, graph, preprocess, solver, batch, shape, k,
            block=max(TIMING_B))
        b, w = states.shape
        wf = kern["wavefront"]
        args = (adj, states, valid, kk, allowed)
        for width in TIMING_B:
            sub = (adj, states[:width].contiguous(),
                   valid[:width].contiguous(), kk, allowed)
            rows["wavefront"] += time_wavefront(
                torch, bitset, components, wf, shape, k, sub, n,
                min(live, width))

        _, reach = components.eliminated_degrees(adj, states, n)
        mm = kern["mmw"]
        ok, _ = same(torch, [mm.mmw_bounds(reach, states, kk, n=n)],
                     [mm.mmw_bounds_ref(reach, states, kk, n=n)])
        check(ok, f"mmw kernel != plain version on {shape} states")
        dev, ms, plain = kernel_times(
            torch, lambda: mm.mmw_bounds(reach, states, kk, n=n),
            lambda: mm.mmw_bounds_ref(reach, states, kk, n=n))
        nbytes = 4 * reach.numel() + 4 * states.numel() + 4 * b
        ops = n * w * b        # one read of each reach word, counted low
        bms, by = bound(nbytes, ops)
        log(f"time mmw {shape} k={k}: B={b} n={n} W={w}: device {dev:.4f} "
            f"ms, wrapper {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bms:.6f} ms by {by} ({nbytes} bytes, {ops} word ops)")
        rows["mmw"].append(dict(shape=shape, B=b, ms=dev, wrapper_ms=ms,
                                plain_ms=plain, bound_ms=bms, bound_by=by))

        ex = kern["expand"]
        ok, _ = same(torch, [ex.expand_degrees(adj, states, n=n)],
                     [ex.expand_degrees_ref(adj, states, n=n)])
        check(ok, f"expand kernel != plain version on {shape} states")
        dev, ms, plain = kernel_times(
            torch, lambda: ex.expand_degrees(adj, states, n=n),
            lambda: ex.expand_degrees_ref(adj, states, n=n))
        nbytes = 4 * adj.numel() + 4 * states.numel() + 4 * b * n
        ops = (closure_ops(bitset, components, adj, states, n)
               + 2 * n * w * b)
        bms, by = bound(nbytes, ops)
        log(f"time expand {shape} k={k}: B={b} n={n} W={w}: device "
            f"{dev:.4f} ms, wrapper {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bms:.6f} ms by {by} ({nbytes} bytes, {ops} word ops)")
        rows["expand"].append(dict(shape=shape, B=b, ms=dev, wrapper_ms=ms,
                                   plain_ms=plain, bound_ms=bms,
                                   bound_by=by))

        # the Bloom kernel's main-path input: one chunk's sorted children
        # and their first-occurrence mask, into an empty default-size
        # filter (a fresh one for every call)
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
        fresh = FreshFilters(bl, max(GRAPH_CALLS, 100 + WARMUP))
        dev, ms, plain = kernel_times(
            torch, lambda: bl.bloom_insert(fresh(), skeys, keep,
                                           m_bits=M_BITS, k_hashes=K_HASHES),
            lambda: bl.bloom_insert_ref(fresh(), skeys, keep,
                                        m_bits=M_BITS, k_hashes=K_HASHES),
            reset=fresh.reset)
        del fresh
        bms, by, nbytes, ops = bloom_bound(torch, bloom, skeys, keep, M_BITS,
                                           K_HASHES)
        log(f"time bloom {shape} k={k}: B={b * n} rows ({int(keep.sum())} "
            f"kept) W={w} m_bits={M_BITS} k_hashes={K_HASHES}: device "
            f"{dev:.4f} ms, wrapper {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bms:.6f} ms by {by} ({nbytes} bytes, {ops} word ops)")
        rows["bloom"].append(dict(shape=shape, B=b * n, ms=dev,
                                  wrapper_ms=ms, plain_ms=plain,
                                  bound_ms=bms, bound_by=by))
    if lanes:
        time_lanes(torch, np, bitset, graph, preprocess, solver, batch,
                   components, bloom, dedup, kern, rows)
    return rows


def time_lanes(torch, np, bitset, graph, preprocess, solver, batch,
               components, bloom, dedup, kern, rows):
    """The lane forms at the lane paths' shapes: SUITE_LANES lanes of
    queen7_7, lane i at rung TIMING_LANES[1][i], each with the first 2048
    states of its largest level; B5 on each lane's sorted children into
    its own empty default-size filter."""
    shape, ks = TIMING_LANES
    block = max(TIMING_B)
    ins = [timing_inputs(torch, np, bitset, graph, preprocess, solver,
                         batch, shape, k, block=block) for k in ks]
    n = ins[0][5]
    adj, states, valid, allowed = (torch.stack([x[i] for x in ins])
                                   for i in (0, 1, 2, 4))
    kk = torch.tensor([x[3] for x in ins], dtype=torch.int32, device=DEVICE)
    live = [x[6] for x in ins]
    lanes, b, w = states.shape
    args = (adj, states, valid, kk, allowed)
    wf = kern["wavefront"]
    tag = f"{shape} k={ks[0]}..{ks[-1]}"
    for use_mmw, use_simp in WAVEFRONT_FLAGS:
        flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        name = flag_name(use_mmw, use_simp)
        ok, _ = same(torch, wf.wavefront_expand(*args, n=n, **flags),
                     wf.wavefront_ref(*args, n=n, **flags))
        check(ok, f"lane wavefront kernel != plain version on {tag}, "
                  f"flags {name}")
        dev, ms, plain = kernel_times(
            torch, lambda: wf.wavefront_expand(*args, n=n, **flags),
            lambda: wf.wavefront_ref(*args, n=n, **flags))
        nbytes = ops = 0
        for i in range(lanes):
            pruned = 0
            if use_mmw or use_simp:
                _, feas = wf.wavefront_ref(adj[i], states[i], valid[i],
                                           int(kk[i]), allowed[i], n=n)
                pruned = int(feas.any(dim=1).sum())
            _, _, nb, op = wavefront_bound(bitset, components, adj[i],
                                           states[i], valid[i], allowed[i],
                                           n, pruned)
            nbytes, ops = nbytes + nb, ops + op
        bms, by = bound(nbytes, ops)
        log(f"time wavefront lanes[{name}] {tag}: L={lanes} B={b} (live "
            f"{live}) n={n} W={w}: device {dev:.4f} ms, wrapper {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bms:.6f} ms by {by} ({nbytes} "
            f"bytes, {ops} word ops)")
        rows["wavefront_lanes"].append(dict(
            shape=tag, L=lanes, B=b, flags=name, ms=dev, wrapper_ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by))

    children, feas = wf.wavefront_expand(*args, n=n)
    skeys, svalid = dedup.sort_states(children.reshape(lanes, b * n, w),
                                      feas.reshape(lanes, b * n))
    keep = dedup.unique_mask(skeys, svalid)
    bl = kern["bloom"]
    filt = bl.make_filter_words(M_BITS, device=DEVICE, lanes=lanes)
    ok, _ = same(torch,
                 bl.bloom_insert(filt.clone(), skeys, keep, m_bits=M_BITS,
                                 k_hashes=K_HASHES),
                 bl.bloom_insert_ref(filt.clone(), skeys, keep,
                                     m_bits=M_BITS, k_hashes=K_HASHES))
    check(ok, f"lane bloom kernel != plain version on {tag} children")
    fresh = FreshFilters(bl, max(GRAPH_CALLS, 100 + WARMUP), lanes=lanes)
    dev, ms, plain = kernel_times(
        torch, lambda: bl.bloom_insert(fresh(), skeys, keep, m_bits=M_BITS,
                                       k_hashes=K_HASHES),
        lambda: bl.bloom_insert_ref(fresh(), skeys, keep, m_bits=M_BITS,
                                    k_hashes=K_HASHES),
        reset=fresh.reset)
    del fresh
    nbytes = ops = 0
    for i in range(lanes):
        _, _, nb, op = bloom_bound(torch, bloom, skeys[i], keep[i], M_BITS,
                                   K_HASHES)
        nbytes, ops = nbytes + nb, ops + op
    bms, by = bound(nbytes, ops)
    log(f"time bloom lanes {tag}: L={lanes} x {b * n} rows "
        f"({int(keep.sum())} kept) W={w} m_bits={M_BITS} "
        f"k_hashes={K_HASHES}: device {dev:.4f} ms, wrapper {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bms:.6f} ms by {by} ({nbytes} bytes, "
        f"{ops} word ops)")
    rows["bloom_lanes"].append(dict(shape=tag, L=lanes, B=b * n, ms=dev,
                                    wrapper_ms=ms, plain_ms=plain,
                                    bound_ms=bms, bound_by=by))




# device-side names of the port's kernels (the rest is PyTorch's work)
PORT_KERNEL_NAMES = ("wavefront_kernel", "mmw_kernel", "expand_kernel",
                     "claim_kernel", "resolve_kernel")


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


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--times-only", action="store_true",
                    help="run only the build and the kernel times")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
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
    t_start = time.perf_counter()
    smi = phase_device(build)
    if args.times_only:
        log(f"times of the kernels under {args.src}")
        # a tree from before the multi-lane engine has no lane form
        has_lanes = hasattr(wavefront_kern.ops, "LAUNCHES_BY_LANES")
        times = phase_times(torch, np, bitset, graph, preprocess, solver,
                            batch, components, bloom, dedup, kern,
                            lanes=has_lanes)
        log(f"build and times in {time.perf_counter() - t_start:.1f} s")
        print(smi, flush=True)
        print(json.dumps({"times": times, "src": args.src}), flush=True)
        return 0
    golden = json.loads((ROOT / "tests" / "golden_widths.json").read_text())
    t0 = time.perf_counter()
    worst = phase_kernels(torch, np, bitset, graph, components, kern)
    log(f"phase 2 (kernels) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, by_width, walls = phase_main_paths(torch, graph, solver, golden,
                                               ops)
    log(f"phase 3 (main paths) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = phase_times(torch, np, bitset, graph, preprocess, solver, batch,
                        components, bloom, dedup, kern)
    log(f"phase 4 (times) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_split(torch, graph, preprocess, solver, walls)
    log(f"phase 5 (split) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lane_counts, by_lanes, suite_walls = phase_lanes(torch, graph, solver,
                                                     batch, golden, ops)
    log(f"phase 6 (lane paths) in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        main_shape = times[name][0]
        # a lane row counts its kernel's launches on the lane paths
        base, paths = (name[:-len("_lanes")], lane_counts) \
            if name.endswith("_lanes") else (name, counts)
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[base] for c in paths.values()),
            max_abs_err=worst[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None,
            wrapper_ms=main_shape["wrapper_ms"])
        if name == "wavefront":
            entry["launches_by_width"] = by_width
        if name == "wavefront_lanes":
            entry["launches_by_lanes"] = by_lanes
            entry["suite_walls_s"] = suite_walls
        if name.startswith("wavefront"):
            entry["variants"] = [v for v in times[name][1:]
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
