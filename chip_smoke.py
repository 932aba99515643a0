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
     and 8, ragged valid rows and a lane with none), and both lane forms
     as the sharded engine drives them (SHARDS lanes sharing one
     adjacency, allowed mask and k; SHARDS 2^24-bit filters taking 2^17
     rows each, carried across two levels);
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
     wall under ``solve_many`` beside the sequential ``solve`` loop;
  7. shard paths: ``solve(g, shards=4)`` on the five instances under the
     defaults and the paper's configuration, against EXPECTED_SHARDS
     (``repro.core.solver.solve(g, shards=4)`` on the CPU), each path
     with its launch counts set to 0 just before it and read just after,
     failing unless every wavefront launch and Bloom call covered all 4
     shards; a forced-donation solve (counters must fire) and a sharded
     reconstruction; the walls beside phase 3's; then one sharded
     queen7_7 rung under ``torch.profiler`` with the routing sort and the
     owner dedup in ranges of their own;
  8. heuristics: ``solve(g, heuristics=8)`` on the five instances against
     EXPECTED_HEUR, and ``bounds_engine.ub_orders_async`` on the card over
     every REGISTRY graph with two seeds against the JAX package's widths
     (EXPECTED_UB), with the sweep timed per dispatch;
  9. serving: a ``launch.twserved.TwServer`` on the card (8 lanes, block
     2048, cap planned under ``budget_bytes="auto"``, 2^24-bit filters, a
     result cache) driven over 127.0.0.1 by ``serve.client.TwClient``:
     the five instances of phase 3 streamed together under the defaults
     and then the paper's configuration, against EXPECTED_SERVE and
     EXPECTED_SERVE_FLAGS (the JAX package's ``TwScheduler`` with the same
     submits); a relabeled queen5_5 answered from the cache with no
     launch; a ``shards=2`` queen6_6 whose every wavefront launch covers
     2 lanes; a heuristic-only request; a cancelled queen7_7 and one more
     petersen.  Each with its launch counts set to 0 just before it and
     read just after; the stream walls beside phase 3's, and the pool's
     counters.  Then the defaults' stream once more through a
     ``TwScheduler`` on the main thread under ``torch.profiler``: the
     admissions' host work and the device's busy time.

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
# The shard paths.  ``solve(g, shards=SHARDS, **config)`` on MAIN_PATH at
# full size (cap auto: each shard gets the unsharded plan, 2^17 rows at
# queen7_7; block 2048; 2^24-bit filters).  The expected values are
# ``repro.core.solver.solve(g, shards=SHARDS, **config)`` on the CPU
# (backend "jax").  Without overflow, sort mode is bit-identical to the
# unsharded solve, and the reference's Bloom + MMW values for petersen ..
# queen6_6 equal EXPECTED_FLAGS' too (its per-shard filters live for a
# rung and still changed none of them), so only queen7_7 is written out:
# with 4x the aggregate capacity it overflows later and expands more.
SHARDS = 4
EXPECTED_SHARDS = {
    "defaults": {
        **{name: EXPECTED[name] for name in MAIN_PATH[:4]},
        "queen7_7": dict(
            width=35, exact=False, lb=18, ub=37, expanded=2574272,
            block="queen7_7_red[49]_red",
            per_k=[(18, False, False, 497), (19, False, False, 497),
                   (20, False, False, 4353), (21, False, False, 4353),
                   (22, False, False, 7096), (23, False, False, 7096),
                   (24, False, False, 7529), (25, False, False, 7529),
                   (26, False, False, 14072), (27, False, False, 42829),
                   (28, False, False, 51864), (29, False, False, 84226),
                   (30, False, False, 107336), (31, False, False, 164283),
                   (32, False, False, 233457), (33, False, True, 359451),
                   (34, False, True, 552113), (35, True, True, 925691)]),
    },
    "bloom+mmw": {
        **{name: EXPECTED_FLAGS["bloom+mmw"][name] for name in MAIN_PATH[:4]},
        "queen7_7": dict(
            width=35, exact=False, lb=18, ub=37, expanded=2358861,
            block="queen7_7_red[49]_red",
            per_k=[(18, False, False, 1), (19, False, False, 1),
                   (20, False, False, 37), (21, False, False, 290),
                   (22, False, False, 511), (23, False, False, 690),
                   (24, False, False, 2545), (25, False, False, 4252),
                   (26, False, False, 8337), (27, False, False, 19713),
                   (28, False, False, 34420), (29, False, False, 59316),
                   (30, False, False, 87478), (31, False, False, 142828),
                   (32, False, False, 213130), (33, False, False, 342241),
                   (34, False, True, 536311), (35, True, True, 906760)]),
    },
}
# one forced-donation solve (every skewed level rebalanced; the defaults'
# values) and one sharded reconstruction (petersen's winning rung, k=4
# below its ub, replayed on the host engine)
DONATE = ("queen6_6", 1.0)
SHARD_RECONSTRUCT = ("petersen", 2)
# the rung that the shard phase traces (queen7_7's largest, at SHARDS)
SHARD_PROFILE = ("queen7_7", 35)
# ``solve(g, heuristics=HEURISTICS)`` (seed 0), from
# ``repro.core.solver.solve`` on the CPU: 8 rounds close petersen's ladder
# at its lower bound and lower queen7_7's ub to 36; the other three keep
# EXPECTED's values
HEURISTICS = 8
EXPECTED_HEUR = {
    **EXPECTED,
    "petersen": dict(
        width=4, exact=True, lb=3, ub=4, expanded=40,
        block="PetersenGraph_red[10]_red", per_k=[(3, False, False, 40)]),
    "queen7_7": dict(EXPECTED["queen7_7"], ub=36),
}
# ``repro.core.bounds_engine.ub_orders_async`` over every REGISTRY graph
# with each of UB_SEEDS (30 graphs padded to n=112), on the CPU: name ->
# the width for each seed
UB_SEEDS = (1, 2)
EXPECTED_UB = {
    "mcgee": (8, 7), "dyck": (9, 9), "petersen": (4, 5), "desargues": (6, 6),
    "myciel3": (5, 5), "myciel4": (11, 11), "myciel5": (20, 20),
    "queen5_5": (19, 18), "queen6_6": (26, 27), "queen7_7": (37, 38),
    "queen8_8": (50, 51), "kneser8_3": (34, 32), "8x6_torusGrid": (15, 15),
    "grid6x6": (7, 6), "ba_100_2": (11, 11)}
# The serving path (phase 9): ``launch.twserved.TwServer(port=0,
# **SERVE_POOL)`` on the card, driven over 127.0.0.1 by
# ``serve.client.TwClient``: MAIN_PATH submitted together under the
# defaults, run to the end, then MAIN_PATH with SERVE_FLAGS.  The
# defaults' stream ratchets the pool's padded n to 64 (queen7_7, n=49),
# so every Bloom + MMW lane pads to W=2 and MMW sees padding rows.
# EXPECTED_SERVE / EXPECTED_SERVE_FLAGS are the reference's scheduler on
# the CPU (JAX_PLATFORMS=cpu, PYTHONPATH=src), one request at a time at
# phase 9's padded n:
#     from repro.core import graph
#     from repro.serve.twscheduler import TwScheduler
#     s = TwScheduler(lanes=1, block=2048, cache=64, budget_bytes="auto")
#     s._n_pad = 64
#     s.submit(graph.REGISTRY[name](), **knobs); s.run()
# with knobs {} and SERVE_FLAGS.  A one-lane pool because the eight-lane
# one takes over half an hour per stream there; without a budget the
# planned cap does not depend on the pool's width, and the other lanes
# of a dispatch are padding that no lane's verdicts depend on
# (tests/test_torch_chip_smoke_serve.py pins petersen, myciel4 and
# queen5_5, the defaults in the eight-lane pool).  Under the defaults they
# equal EXPECTED (the scheduler's parity promise in sort mode); under
# Bloom + MMW they equal EXPECTED_FLAGS (no 2^24-bit filter of these
# levels fills enough for the padded word count to change a probe's
# answer, and the padding rows changed no MMW prune here), and
# ``shards=2`` gives queen6_6's EXPECTED.  SERVE_HEUR is a heuristic-only
# request; EXPECTED_SERVE_HEUR its (lb, ub, exact) from the same
# scheduler.
SERVE_POOL = dict(lanes=8, block=2048, budget_bytes="auto", cache=64)
SERVE_FLAGS = dict(mode="bloom", use_mmw=True)
SERVE_SHARDS = ("queen6_6", 2)
SERVE_HEUR = ("mcgee", dict(heuristic_only=True, heuristics=8, seed=7))
SERVE_RELABEL_SEED = 11
EXPECTED_SERVE = EXPECTED
EXPECTED_SERVE_FLAGS = EXPECTED_FLAGS["bloom+mmw"]
EXPECTED_SERVE_HEUR = dict(lb=5, ub=7, exact=False)
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


def check_shard_forms(torch, np, bitset, graph, kern):
    """The lane forms as the sharded engine drives them: SHARDS lanes that
    share one adjacency, allowed mask and k (lane-strided states, ragged
    valid rows), and SHARDS filters of 2^24 bits taking a shard's whole
    level (2^17 rows each, the per-shard cap), carried across two
    levels."""
    worst = {"wavefront_lanes": 0, "bloom_lanes": 0}
    n, b = 49, 2048
    adj, states, valid, k, allowed = lane_inputs(
        torch, np, bitset, graph, n, b, SHARDS, seed=4949, strided=True)
    args = (adj[:1].expand(SHARDS, -1, -1).contiguous(), states, valid,
            k[:1].expand(SHARDS).contiguous(),
            allowed[:1].expand(SHARDS, -1).contiguous())
    for use_mmw, use_simp in WAVEFRONT_FLAGS:
        flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
        ok, err = same(torch, kern["wavefront"].wavefront_expand(
            *args, n=n, **flags), kern["wavefront"].wavefront_ref(
            *args, n=n, **flags))
        worst["wavefront_lanes"] = max(worst["wavefront_lanes"], err)
        check(ok, f"shard-form wavefront kernel != plain version, flags "
                  f"{flag_name(use_mmw, use_simp)} (max abs err {err})")
    bl = kern["bloom"]
    rows = 1 << 17
    filt = bl.make_filter_words(M_BITS, device=DEVICE, lanes=SHARDS)
    for level in range(2):
        batches = [bloom_batch(torch, np, rows, 2, seed=17 * level + i)
                   for i in range(SHARDS)]
        states = torch.stack([x[0] for x in batches])
        valid = torch.stack([x[1] for x in batches])
        want = bl.bloom_insert_ref(filt.clone(), states, valid,
                                   m_bits=M_BITS, k_hashes=K_HASHES)
        got = bl.bloom_insert(filt, states, valid, m_bits=M_BITS,
                              k_hashes=K_HASHES)
        ok, err = same(torch, got, want)
        worst["bloom_lanes"] = max(worst["bloom_lanes"], err)
        check(ok, f"shard-form bloom kernel != plain version at level "
                  f"{level} (max abs err {err})")
    log(f"kernels: shard forms bit-identical to the plain versions: "
        f"wavefront with {SHARDS} lanes sharing adj, allowed and k (n={n}, "
        f"B={b}, every flag set), bloom with {SHARDS} x {rows} rows into "
        f"{SHARDS} 2^24-bit filters over two levels")
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
            "bloom_lanes": check_bloom_lanes(torch, np, kern["bloom"]),
            "shard_forms": check_shard_forms(torch, np, bitset, graph, kern)}


def reset_counts(ops):
    for mod in ops.values():
        mod.LAUNCHES = 0
    ops["wavefront"].LAUNCHES_BY_B.clear()
    ops["wavefront"].LAUNCHES_BY_LANES.clear()
    ops["wavefront"].LAUNCHES_BY_FLAGS.clear()
    ops["bloom"].LAUNCHES_BY_LANES.clear()


def by_lanes_of(ops):
    """Launches of the wavefront kernel and calls of the Bloom kernel by
    lane count."""
    return {name: dict(sorted(ops[name].LAUNCHES_BY_LANES.items()))
            for name in ("wavefront", "bloom")}


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


SHARD_COUNTERS = ("shard_donations", "shard_donated_rows", "shard_idle_steps")


def shard_stats(tr):
    snap = tr.snapshot()
    out = {k: snap["counters"].get(k, 0) for k in SHARD_COUNTERS}
    out["shard_peak_occupancy"] = snap.get("gauges", {}).get(
        "shard_peak_occupancy", 0)
    return out


def phase_shards(torch, graph, solver, telemetry, golden, ops, walls):
    """The shard paths, each with its launch counts set to 0 just before it
    and read just after: ``solve(g, shards=SHARDS)`` over MAIN_PATH under
    each of LANE_CONFIGS (every wavefront launch and Bloom call must cover
    all SHARDS shards), a forced-donation solve and a sharded
    reconstruction.  Returns path -> counts, path -> launches by lane
    count, path -> shard counters, and the walls beside phase 3's."""
    counts, by_lanes, stats, shard_walls = {}, {}, {}, {}
    for config, kw in LANE_CONFIGS.items():
        needed = PATHS[config][2]
        path = f"shards={SHARDS} {config}"
        tr = telemetry.Tracker()
        reset_counts(ops)
        for name in MAIN_PATH:
            t0 = time.perf_counter()
            res = solver.solve(graph.REGISTRY[name](), shards=SHARDS,
                               tracker=tr, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            shard_walls[f"{config} {name}"] = (walls[(config, name)], wall)
            check_solve(res, f"{path} {name}", EXPECTED_SHARDS[config][name],
                        golden)
            log(f"solve [{path}] {name}: treewidth={res.width} "
                f"exact={res.exact} expanded={res.expanded} wall={wall:.3f} "
                f"s (shards=1: {walls[(config, name)]:.3f} s)")
        counts[path] = read_counts(ops)
        by_lanes[path] = by_lanes_of(ops)
        stats[path] = shard_stats(tr)
        for kernel in needed:
            check(counts[path][kernel] > 0,
                  f"path [{path}]: the {kernel} kernel never launched")
            check(set(by_lanes[path][kernel]) == {SHARDS},
                  f"path [{path}]: {kernel} launches by lane count "
                  f"{by_lanes[path][kernel]}, not all of {SHARDS} shards")
        log(f"path [{path}]: launches {counts[path]}; by lane count "
            f"{by_lanes[path]}; shard counters {stats[path]}")

    name, ratio = DONATE
    path = f"shards={SHARDS} donate_ratio={ratio} {name}"
    tr = telemetry.Tracker()
    reset_counts(ops)
    res = solver.solve(graph.REGISTRY[name](), shards=SHARDS,
                       donate_ratio=ratio, tracker=tr)
    check_solve(res, path, EXPECTED[name], golden)
    counts[path], by_lanes[path] = read_counts(ops), by_lanes_of(ops)
    stats[path] = shard_stats(tr)
    check(stats[path]["shard_donations"] > 0
          and stats[path]["shard_donated_rows"] > 0,
          f"path [{path}]: no donation fired ({stats[path]})")
    log(f"path [{path}]: treewidth={res.width} expanded={res.expanded}; "
        f"launches {counts[path]}; shard counters {stats[path]}")

    name, s = SHARD_RECONSTRUCT
    path = f"shards={s} reconstruct {name}"
    reset_counts(ops)
    g = graph.REGISTRY[name]()
    res = solver.solve(g, shards=s, reconstruct=True)
    check_solve(res, path, EXPECTED[name], golden)
    check(res.order is not None, f"{path}: the stitched order was rejected")
    replay = solver.order_width(g, res.order)
    check(replay <= res.width, f"{path}: order replays at {replay}, width "
                               f"{res.width}")
    counts[path], by_lanes[path] = read_counts(ops), by_lanes_of(ops)
    check(by_lanes[path]["wavefront"].get(s, 0) > 0
          and by_lanes[path]["wavefront"].get(1, 0) > 0,
          f"path [{path}]: wavefront launches by lane count "
          f"{by_lanes[path]['wavefront']}: no launch of {s} shards, or no "
          f"replay on the host engine")
    log(f"path [{path}]: width={res.width} order verified (replays at "
        f"{replay}); launches {counts[path]}; by lane count "
        f"{by_lanes[path]}")
    return counts, by_lanes, stats, shard_walls


def phase_shard_split(torch, graph, preprocess, solver, shard, dedup):
    """One sharded rung (SHARD_PROFILE at SHARDS shards, defaults) under
    torch.profiler, with the routing (``shard.route_states``) and the
    owner dedup (``dedup.dedup_compact``) in ranges of their own: the
    device time of each against the device time of the whole rung.  Then
    the routing of the rung's largest level alone, by CUDA-graph
    replay."""
    name, k = SHARD_PROFILE
    g = preprocess.preprocess(graph.REGISTRY[name]()).blocks[0].g
    plan = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None)
    route, own = shard.route_states, dedup.dedup_compact
    calls = []

    def traced_route(rows, valid, *a):
        calls.append((rows, valid) + a)
        with torch.profiler.record_function("shard.route_states"):
            return route(rows, valid, *a)

    def traced_own(*a):
        with torch.profiler.record_function("shard.owner_dedup"):
            return own(*a)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    shard.route_states, dedup.dedup_compact = traced_route, traced_own
    try:
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            res = shard.decide_sharded(plan.graph_at(k), k, plan.clique,
                                       shards=SHARDS, cap=1 << 17,
                                       block=2048)
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    finally:
        shard.route_states, dedup.dedup_compact = route, own
    check(res.feasible, f"shard split: {name} k={k} must be feasible")
    # device busy: every kernel, copy and memset (not the ranges' own
    # spans on the device timeline); a range's device time: the kernels
    # launched inside it, summed on its host-side event
    keys = ("shard.route_states", "shard.owner_dedup")
    device_us, ranges, by_kernel = 0.0, dict.fromkeys(keys, 0.0), {}
    for evt in prof.events():
        on_device = str(getattr(evt, "device_type", "")).endswith("CUDA")
        if on_device and not getattr(evt, "is_user_annotation", False) \
                and evt.name not in keys:
            us = float(evt.self_device_time_total)
            device_us += us
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us
        elif not on_device and evt.name in keys:
            ranges[evt.name] += float(evt.device_time_total)
    port_us = sum(us for key, us in by_kernel.items()
                  if any(k in key for k in PORT_KERNEL_NAMES))
    shares = {key: (f"{us / 1e3:.3f} ms, {100 * us / device_us:.1f}%"
                    if device_us and us else "not measured")
              for key, us in ranges.items()}
    peak = max(calls, key=lambda c: int(c[1].sum()))
    route_ms = device_ms(torch, lambda: route(*peak), calls=10)
    log(f"shard split {name} k={k} [{SHARDS} shards, defaults]: "
        f"{len(calls)} levels, expanded={res.expanded}, traced wall "
        f"{traced_s:.3f} s, device busy {device_us / 1e3:.3f} ms; device "
        f"time of the routing {shares.get('shard.route_states')}, of the "
        f"owner dedup {shares.get('shard.owner_dedup')}, of the port's "
        f"kernels {port_us / 1e3:.3f} ms; routing of the largest level "
        f"({int(peak[1].sum())} of {peak[0].shape[0]} rows valid) "
        f"{route_ms:.4f} ms by CUDA-graph replay")
    for key, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  device {us / 1e3:9.3f} ms  {key[:90]}")


def phase_heuristics(torch, np, graph, solver, bounds_engine, telemetry,
                     golden, ops, walls):
    """``solve(g, heuristics=HEURISTICS)`` over MAIN_PATH (launch counts
    set to 0 just before, read just after), then ``ub_orders_async`` on
    the card over every REGISTRY graph with each of UB_SEEDS: widths as
    the reference's, orders that replay to them; the sweep timed per
    dispatch.  Returns the path's launch counts."""
    path = f"heuristics={HEURISTICS}"
    reset_counts(ops)
    for name in MAIN_PATH:
        t0 = time.perf_counter()
        res = solver.solve(graph.REGISTRY[name](), heuristics=HEURISTICS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_solve(res, f"{path} {name}", EXPECTED_HEUR[name], golden)
        log(f"solve [{path}] {name}: treewidth={res.width} "
            f"exact={res.exact} lb={res.lb} ub={res.ub} "
            f"expanded={res.expanded} wall={wall:.3f} s (defaults: "
            f"{walls[('defaults', name)]:.3f} s)")
    counts = read_counts(ops)
    check(counts["wavefront"] > 0,
          f"path [{path}]: the wavefront kernel never launched")
    log(f"path [{path}]: launches {counts}")

    pool = [(name, i) for name in EXPECTED_UB for i in range(len(UB_SEEDS))]
    gs = [graph.REGISTRY[name]() for name, _ in pool]
    seeds = [UB_SEEDS[i] for _, i in pool]
    tr = telemetry.Tracker()
    bounds_engine.LAUNCHES = 0
    out = bounds_engine.ub_orders_async(gs, seeds, tracker=tr).result()
    launches = bounds_engine.LAUNCHES
    check(launches == 1 and tr.snapshot()["counters"]["heur_lanes"]
          == len(pool), f"ub_orders_async: {launches} sweeps, counters "
                        f"{tr.snapshot()['counters']}")
    for (name, i), g, (w, order) in zip(pool, gs, out):
        check(w == EXPECTED_UB[name][i],
              f"ub_orders_async {name} seed {UB_SEEDS[i]}: width {w} != "
              f"JAX {EXPECTED_UB[name][i]}")
        check(sorted(order) == list(range(g.n))
              and solver.order_width(g, order) == w,
              f"ub_orders_async {name} seed {UB_SEEDS[i]}: the order does "
              f"not replay to width {w}")
    adjs, ranks = bounds_engine.pool_inputs(gs, seeds)
    adj_d = torch.from_numpy(adjs).to(DEVICE)
    rank_d = torch.from_numpy(ranks).to(DEVICE)
    b, n = ranks.shape
    dev = device_ms(torch, lambda: bounds_engine.min_degree_sweep(adj_d,
                                                                 rank_d),
                    calls=5)
    ms = cuda_time_ms(torch, lambda: bounds_engine.ub_orders_async(
        gs, seeds).result(), iters=10)
    # each step reads the n x n adjacency of every graph for the degrees
    # and updates it once: 2 B n^3 one-byte operations; inputs and
    # outputs once
    bms, by = bound(adjs.nbytes + ranks.nbytes + 4 * b * (n + 1),
                    2 * b * n ** 3)
    log(f"ub_orders_async on the card: {len(pool)} graphs padded to n={n}, "
        f"widths as the JAX package's, orders replay; {launches} sweep per "
        f"dispatch; sweep device {dev:.4f} ms by CUDA-graph replay, "
        f"dispatch {ms:.4f} ms by CUDA events (host packing, {n} steps, "
        f"the copy back), bound {bms:.6f} ms by {by}")
    return counts


def check_served(res, label, name, want, golden):
    """``check_solve`` for instance ``name``'s result as it came over the
    wire (its ``per_k`` keys are JSON strings)."""
    got = {key: res[key] for key in ("width", "exact", "lb", "ub",
                                     "expanded")}
    check(got == {key: want[key] for key in got},
          f"{label}: {got} != JAX {want}")
    per_k = [(int(k), v["feasible"], v["inexact"], v["expanded"])
             for k, v in res["per_k"].get(want["block"], {}).items()]
    check(list(res["per_k"]) == [want["block"]] and per_k == want["per_k"],
          f"{label}: per_k {res['per_k']} != JAX {want['per_k']}")
    if name in golden:
        check(res["width"] == golden[name]["tw"],
              f"{label}: width {res['width']} != golden {golden[name]}")


def serve_stream(client, names, **knobs):
    """Submit ``names`` together, then read each request's event stream to
    its terminal event; returns {name: (events, result)} and the wall
    from the first submit to the last terminal event."""
    t0 = time.perf_counter()
    rids = {name: client.submit(name, **knobs) for name in names}
    events = {name: list(client.stream(rid)) for name, rid in rids.items()}
    wall = time.perf_counter() - t0
    out = {}
    for name, rid in rids.items():
        check(events[name][-1]["event"] == "done",
              f"serve {name}: stream ended in {events[name][-1]}")
        out[name] = (events[name], client.result(rid))
    return out, wall


def phase_serve(torch, np, graph, twserved, client_mod, bounds_engine,
                golden, ops, walls):
    """The serving path: a ``TwServer`` on the card (SERVE_POOL) and a
    ``TwClient`` over 127.0.0.1.  Each sub-phase with its launch counts
    set to 0 just before it and read just after: the defaults' stream of
    MAIN_PATH (EXPECTED_SERVE, which is EXPECTED; some wavefront launch of
    several lanes), the Bloom + MMW stream (EXPECTED_SERVE_FLAGS; lane B1
    with MMW and lane B5 launched), a relabeled queen5_5 answered from the
    cache (no launch of any kernel), a ``shards=2`` queen6_6 (the
    defaults' values; every B1 launch of 2 lanes), a heuristic-only
    request (EXPECTED_SERVE_HEUR) and a cancelled queen7_7 followed by one
    more petersen.  Returns sub-phase -> launch counts, the walls and the
    pool's counters."""
    srv = twserved.TwServer(port=0, **SERVE_POOL)
    srv.start()
    counts, by_lanes, info = {}, {}, {}
    try:
        c = client_mod.TwClient("127.0.0.1", srv.port, timeout=300)
        check(c.ping(), "twserved did not answer a ping")
        budget = srv.sched.budget_bytes
        log(f"twserved on 127.0.0.1:{srv.port}: device {srv.sched.device}, "
            f"backend {srv.sched.decide_kw['backend']}, lanes "
            f"{len(srv.sched.pool)}, block {srv.sched.block}, budget "
            f"{budget} bytes (auto), cache {SERVE_POOL['cache']} entries")
        check(budget is not None and budget > 0,
              f"device_memory_budget() gave {budget} on the card")

        for sub, knobs, want in (("defaults", {}, EXPECTED_SERVE),
                                 ("bloom+mmw", SERVE_FLAGS,
                                  EXPECTED_SERVE_FLAGS)):
            reset_counts(ops)
            bounds_engine.LAUNCHES = 0
            got, wall = serve_stream(c, MAIN_PATH, **knobs)
            for name, (_events, res) in got.items():
                check_served(res, f"serve [{sub}] {name}", name, want[name],
                             golden)
                if sub == "defaults":
                    check_served(res, f"serve [{sub}] {name} against solve",
                                 name, EXPECTED[name], golden)
                log(f"serve [{sub}] {name}: treewidth={res['width']} "
                    f"exact={res['exact']} lb={res['lb']} ub={res['ub']} "
                    f"expanded={res['expanded']} rounds="
                    f"{_events[-1]['rounds']}")
            path = f"serve {sub}"
            counts[path] = read_counts(ops)
            by_lanes[path] = by_lanes_of(ops)
            flags = dict(ops["wavefront"].LAUNCHES_BY_FLAGS)
            check(counts[path]["wavefront"] > 0
                  and max(by_lanes[path]["wavefront"], default=0) >= 2,
                  f"path [{path}]: wavefront launches by lane count "
                  f"{by_lanes[path]['wavefront']}: none of several lanes")
            if sub == "bloom+mmw":
                check(flags.get((True, False), 0) > 0
                      and counts[path]["bloom"] > 0,
                      f"path [{path}]: wavefront launches by flags {flags}, "
                      f"Bloom calls {counts[path]['bloom']}")
            seq = sum(walls[(sub, name)] for name in MAIN_PATH)
            info[f"wall {sub}"] = (wall, seq)
            log(f"path [{path}]: launches {counts[path]}; by lane count "
                f"{by_lanes[path]}; wavefront by (mmw, simplicial) {flags}; "
                f"stream wall {wall:.3f} s for {len(MAIN_PATH)} requests "
                f"beside phase 3's sequential solves {seq:.3f} s ("
                + ", ".join(f"{n} {walls[(sub, n)]:.3f}" for n in MAIN_PATH)
                + ")")

        path = "serve cache"
        g = graph.REGISTRY["queen5_5"]()
        perm = np.random.RandomState(SERVE_RELABEL_SEED).permutation(g.n)
        reset_counts(ops)
        bounds_engine.LAUNCHES = 0
        rid = c.submit(g.relabel(perm))
        events = list(c.stream(rid))
        res = c.result(rid)
        counts[path] = dict(read_counts(ops), sweep=bounds_engine.LAUNCHES)
        check(events and all(e.get("cached") for e in events),
              f"path [{path}]: not answered from the cache: {events}")
        check(not any(counts[path].values()),
              f"path [{path}]: kernels launched on a cache hit: "
              f"{counts[path]}")
        check_served(res, f"{path} queen5_5", "queen5_5",
                     EXPECTED_SERVE["queen5_5"], golden)
        log(f"path [{path}]: relabeled queen5_5 cached, width "
            f"{res['width']}, launches {counts[path]}; cache "
            f"{c.cache_stats()}")

        name, k = SERVE_SHARDS
        path = f"serve shards={k}"
        reset_counts(ops)
        got, wall = serve_stream(c, [name], shards=k, no_cache=True)
        res = got[name][1]
        check_served(res, f"{path} {name}", name, EXPECTED_SERVE[name],
                     golden)
        counts[path], by_lanes[path] = read_counts(ops), by_lanes_of(ops)
        check(counts[path]["wavefront"] > 0
              and set(by_lanes[path]["wavefront"]) == {k},
              f"path [{path}]: wavefront launches by lane count "
              f"{by_lanes[path]['wavefront']}, not all of {k} shards")
        info[f"wall shards={k}"] = (wall, walls[("defaults", name)])
        log(f"path [{path}]: {name} treewidth={res['width']} expanded="
            f"{res['expanded']} wall {wall:.3f} s; launches {counts[path]}; "
            f"by lane count {by_lanes[path]}")

        name, knobs = SERVE_HEUR
        path = "serve heuristic_only"
        reset_counts(ops)
        bounds_engine.LAUNCHES = 0
        got, wall = serve_stream(c, [name], **knobs)
        res = got[name][1]
        counts[path] = dict(read_counts(ops), sweep=bounds_engine.LAUNCHES)
        check({key: res[key] for key in ("lb", "ub", "exact")}
              == EXPECTED_SERVE_HEUR,
              f"path [{path}] {name}: {res} != JAX {EXPECTED_SERVE_HEUR}")
        check(counts[path]["sweep"] > 0,
              f"path [{path}]: the min-degree sweep never ran")
        log(f"path [{path}]: {name} lb={res['lb']} ub={res['ub']} "
            f"exact={res['exact']} wall {wall:.3f} s; launches "
            f"{counts[path]}")

        path = "serve cancel"
        rid = c.submit("queen7_7", no_cache=True)
        events, cancelled = [], None
        for ev in c.stream(rid):
            events.append(ev)
            if cancelled is None and ev["event"] == "rung_started":
                state = c.status(rid)["state"]
                cancelled = c.cancel(rid)
                check(state == "running" and cancelled,
                      f"path [{path}]: status {state}, cancel {cancelled}")
        check(events[-1]["event"] == "cancelled"
              and c.status(rid)["state"] == "cancelled",
              f"path [{path}]: stream ended in {events[-1]}")
        after = c.result(c.submit("petersen", no_cache=True))
        check_served(after, f"{path} petersen", "petersen",
                     EXPECTED_SERVE["petersen"], golden)
        log(f"path [{path}]: queen7_7 cancelled after "
            f"{sum(e['event'] == 'rung_decided' for e in events)} decided "
            f"rungs (lb {events[-1]['lb']}, ub {events[-1]['ub']}); one "
            f"more petersen served: width {after['width']}")

        metrics = c.metrics()
        info["pool counters"] = metrics["pool"]["counters"]
        info["rounds"] = metrics["rounds"]
        log(f"metrics: rounds {metrics['rounds']}, idle syncs "
            f"{metrics['idle_syncs']}, pool counters "
            f"{metrics['pool']['counters']}")
        c.shutdown()
        srv._driver.join(timeout=60)
        check(not srv._driver.is_alive(), "twserved did not drain and stop")
    finally:
        srv.close()
    return counts, by_lanes, info


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


def phase_serve_split(torch, graph, twscheduler, info):
    """The defaults' stream of MAIN_PATH once more, through a
    ``TwScheduler`` on this thread (the server's pool, no cache) under
    torch.profiler: the stream's wall, the admissions' host work (each
    request's preprocessing and first block plan, timed around the
    scheduler's ``_start``), and the device's busy time by kernel."""
    s = twscheduler.TwScheduler(**dict(SERVE_POOL, cache=None))
    start, admit = s._start, [0.0]

    def timed_start(req):
        t0 = time.perf_counter()
        try:
            return start(req)
        finally:
            admit[0] += time.perf_counter() - t0

    s._start = timed_start
    # device activity only: the host rows of ~1000 rounds' ops would take
    # the profiler longer to summarise than the stream takes to run
    acts = [torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        rids = [s.submit(graph.REGISTRY[name]()) for name in MAIN_PATH]
        s.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, rid in zip(MAIN_PATH, rids):
        check(s.done[rid].expanded == EXPECTED_SERVE[name]["expanded"],
              f"serve split {name}: expanded {s.done[rid].expanded}")
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    device_s = sum(by_kernel.values()) / 1e6
    port_s = sum(us for key, us in by_kernel.items()
                 if any(k in key for k in PORT_KERNEL_NAMES)) / 1e6
    info["split"] = dict(traced_wall_s=wall, admission_s=admit[0],
                         device_s=device_s, port_kernels_s=port_s,
                         rounds=s.rounds,
                         summary_s=time.perf_counter() - t0 - wall)
    log(f"serve split [defaults]: {len(MAIN_PATH)} requests in {s.rounds} "
        f"rounds, traced wall {wall:.3f} s (untraced stream "
        f"{info['wall defaults'][0]:.3f} s); admissions (host planning) "
        f"{admit[0]:.3f} s; rounds {wall - admit[0]:.3f} s; device busy "
        f"{device_s:.3f} s ({100 * device_s / wall:.1f}% of the traced "
        f"wall), of which the port's kernels {port_s:.3f} s; the "
        f"profiler's summary took {info['split']['summary_s']:.1f} s")
    for key, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
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
    from repro_torch.core import (batch, bitset, bloom, bounds_engine,
                                  components, dedup, graph, preprocess,
                                  shard, solver, telemetry)
    from repro_torch.kernels import bloom as bloom_kern
    from repro_torch.kernels import build
    from repro_torch.kernels import expand as expand_kern
    from repro_torch.kernels import mmw as mmw_kern
    from repro_torch.kernels import wavefront as wavefront_kern
    from repro_torch.launch import twserved
    from repro_torch.serve import client as client_mod
    from repro_torch.serve import twscheduler

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
    t0 = time.perf_counter()
    shard_counts, shard_lanes, shard_stats_, shard_walls = phase_shards(
        torch, graph, solver, telemetry, golden, ops, walls)
    phase_shard_split(torch, graph, preprocess, solver, shard, dedup)
    log(f"phase 7 (shard paths) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    heur_counts = phase_heuristics(
        torch, np, graph, solver, bounds_engine, telemetry, golden, ops,
        walls)
    log(f"phase 8 (heuristics) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_counts, serve_lanes, serve_info = phase_serve(
        torch, np, graph, twserved, client_mod, bounds_engine, golden, ops,
        walls)
    phase_serve_split(torch, graph, twscheduler, serve_info)
    log(f"phase 9 (serving) in {time.perf_counter() - t0:.1f} s")
    worst["wavefront_lanes"] = max(worst["wavefront_lanes"],
                                   worst["shard_forms"]["wavefront_lanes"])
    worst["bloom_lanes"] = max(worst["bloom_lanes"],
                               worst["shard_forms"]["bloom_lanes"])
    # a lane row counts its kernel's launches on the lane and shard paths,
    # a single-lane row those on phase 3's paths and the heuristics path
    single = {**counts, f"heuristics={HEURISTICS}": heur_counts}
    multi = {**lane_counts, **shard_counts,
             **{p: c for p, c in serve_counts.items() if p in serve_lanes}}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        main_shape = times[name][0]
        base, paths = (name[:-len("_lanes")], multi) \
            if name.endswith("_lanes") else (name, single)
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[base] for c in paths.values()),
            max_abs_err=worst[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None,
            wrapper_ms=main_shape["wrapper_ms"])
        if name == "wavefront":
            entry["launches_by_width"] = by_width
        if name.endswith("_lanes"):
            entry["launches_by_path"] = {p: c[base] for p, c in paths.items()}
            entry["shard_launches_by_lanes"] = {
                p: lanes[base] for p, lanes in shard_lanes.items()}
            entry["serve_launches_by_lanes"] = {
                p: lanes[base] for p, lanes in serve_lanes.items()}
        if name == "wavefront_lanes":
            entry["launches_by_lanes"] = by_lanes
            entry["suite_walls_s"] = suite_walls
            entry["shard_walls_s"] = shard_walls
            entry["shard_counters"] = shard_stats_
            entry["serve"] = serve_info
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
