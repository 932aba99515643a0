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
     rows each, carried across two levels); the paths kernel against the
     host function ``bounds.disjoint_paths_matrix`` on Table-1 instances
     and against its plain version on G(n, p) up to n = 256;
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
     chunk's 2048*n sorted children for the Bloom kernel, into empty
     filters and into filters that already hold the level's second
     chunk, with the Bloom kernel's scratch bytes; the lane forms on 8
     lanes of queen7_7 at k=23..30 and their children in 8 filters; the
     paths kernel on queen6_6 at cap 26 and queen7_7 at cap 37, with the
     host wall of planning's form of it): the
     kernel's device time per call by replaying a CUDA graph of captured
     wrapper calls, and the time per wrapper call with CUDA events,
     beside the least time the card could take;
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
     admissions' host work and the device's busy time;
 10. distributed: ``distributed.solve_distributed`` with DIST_RANKS = 4
     ranks sharing the card over gloo (``distributed.launch``) at the
     CLI's defaults for ``--distributed`` (cap 2^18, so cap_local 2^16;
     block 1024) on the five instances and on queen6_6 with MMW and with
     the simplicial rule, against EXPECTED_DIST (the JAX package's
     ``solve_distributed`` with 4 forced host devices); queen6_6 on one
     rank over NCCL (a one-rank group from no environment); the
     reference's restart case (checkpoints on 4 ranks, a resume from the
     middle one on 4 ranks and on a 2-rank subgroup); the mesh rung
     ``shard.decide_sharded(mesh=...)`` against the single-lane decide;
     and ``solve(queen5_5, schedule=s, backend="torch")`` on the card for
     the four closure schedules.  Every rank's launch counts are set to 0
     just before each path and read just after, and the wavefront kernel
     must launch in every rank on queen6_6 and queen7_7; the walls beside
     phase 3's, and the host time of the collectives on queen7_7;
 11. LM serving: the port's model zoo (``repro_torch.models``) from its own
     seeded init in float32 on the card, one model at a time, with TF32
     off.  qwen3-0.6b at full width and depth: (a)
     ``serve.engine.Engine.generate_greedy`` over 4 slots (64-token
     prompts, 16 new tokens) against argmax over repeated full forwards,
     each step's logits by the cache path within LM_TOL of the full
     forward's and the tokens equal wherever the top-two margin is clear
     of it; (b) ``serve.scheduler.Scheduler`` with 4 slots and 8 requests
     (16-64-token prompts, 16 new tokens), every request finished and the
     ones with (a)'s prompts giving (a)'s tokens; (c) one prefill of 2 x
     4096 tokens (chunked attention) against full attention; (d) the same
     weights on the CPU.  Then hymba-1.5b, xlstm-1.3b, whisper-small (with
     encoder frames) and granite-moe-1b-a400m at their full configs,
     32-token prompts and 8 new tokens through ``generate_greedy`` and a
     4-request stream (not whisper, whose scheduler decodes against a zero
     cross cache, as the reference's does), every request finished:
     float32 cannot hold these deep models' decode to their forward (the
     reference's init makes them chaotic; ``tests/lm_conditioning.py``),
     so at full depth they run as an execution smoke.  Each is then cut to
     one pattern period at full width and held as in (a) to LM_TOL
     (xlstm-1.3b: LM_PERIOD_TOL); granite-moe's decode, which drops
     choices past capacity where its forward does not, also to the same
     weights decoding on the CPU, the same batch, routing equal choice for
     choice.  Parameters and bytes, prefill ms, ms per decode tick,
     tokens/s and peak bytes per model; ``{"lm_serving": [...]}`` before
     the device line.  No kernel: the models are plain PyTorch ops.
 12. LM training: the port's trainer on the card in float32, TF32 off.
     (a) ``launch.train.main`` on qwen3-0.6b at full width and depth
     (596180992 parameters, AdamW, 8 x 512 tokens a step, 30 steps, 10
     of warmup): every loss and grad_norm finite and the last five
     losses' mean below the first five's; ms per step (host clock ending
     in ``torch.cuda.synchronize()``), tokens/s beside the 6 N T / 67
     TFLOP/s bound, peak bytes; (b) one step of the same weights on the
     card and on the CPU (1 x 32): loss, nll and grad_norm within
     TRAIN_METRIC_TOL, every gradient leaf within TRAIN_GRAD_TOL of its
     range, every parameter within what each side's own AdamW m and v
     give (``adamw_excess``; the first update's slope in the gradient is
     1/eps near 0, so the parameters alone cannot be held to a fixed
     tolerance); (c) the gradients of (a)'s batch under ``remat`` "full"
     and "dots" within TRAIN_REMAT_TOL of none, and each one's peak
     bytes below none's; (d) ``microbatch=4`` against none: the
     gradients within TRAIN_GRAD_TOL, one step's parameters within the
     m/v bound; (e) at ``reduced`` size, the supervisor's crash at step
     30 and resume from 20, and 25 straight steps against 15 +
     checkpoint + restore + 10 (deterministic kernels) within
     TRAIN_RESUME_TOL; (f) 2 ranks sharing the card over gloo:
     ``compressed_psum`` against the plain mean (rel err < 0.05), and
     the compressed reduced-qwen3 training's loss falling by 0.3 in 30
     steps.  ``{"lm_training": {...}}`` before the device line.  No
     kernel: training reaches no Pallas kernel in the reference.
 13. dry run: ``launch.dryrun``'s predictions against the card, and
     production-mesh cells.  (a) In a subprocess (the dry run's fake
     process group is process-wide), ``dryrun.predict_step`` runs one
     train step of phase 12's configuration (qwen3-0.6b at full width
     and depth, AdamW, 8 x 512 tokens, float32) on meta tensors on a 1x1
     mesh and predicts the state's bytes, the step's FLOPs and its peak
     bytes; then here one real step: the ``torch.cuda.memory_allocated``
     growth over building the model and ``init_state`` must equal the
     predicted state bytes exactly, ``FlopCounterMode`` over the step
     the predicted FLOPs exactly, and the step's peak above what was
     allocated before must lie within DRY_PEAK_TOL of the prediction.
     (b) Started first and run alongside (a): ``python -m
     repro_torch.launch.dryrun`` on the 16x16 production mesh (a fake
     group of 512 ranks) for DRY_ARCHS x DRY_SHAPES at full width (the
     MoE dispatch of granite-moe runs sharded); every cell must be
     ``ok``; per-device bytes, FLOPs, wire bytes, whether the peak fits
     this card, and seconds.  ``{"dryrun": {...}}`` before the device
     line.  No kernel: the dry run reaches no Pallas kernel in the
     reference.

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
# The distributed path (phase 10).  ``distributed.solve_distributed`` on
# DIST_RANKS ranks sharing the card over gloo, with cap_local = DIST_CAP //
# ranks and block DIST_BLOCK (the CLI's ``--distributed`` defaults), on each
# of DIST_CASES.  EXPECTED_DIST is ``repro.core.distributed.
# solve_distributed`` on the CPU with 4 forced host devices
# (XLA_FLAGS=--xla_force_host_platform_device_count=4) and the same
# arguments; tests/test_torch_chip_smoke_dist*.py re-derive it.  Without
# overflow it is the single-device result; queen7_7 overflows per rank
# from the 2^16-row local buffers and expands more than phase 3's.
DIST_RANKS = 4
DIST_CAP = 1 << 18
DIST_BLOCK = 1 << 10
DIST_CASES = [(name, {}) for name in MAIN_PATH] + [
    ("queen6_6", dict(use_mmw=True)), ("queen6_6", dict(use_simplicial=True))]
EXPECTED_DIST = {
    "petersen": dict(width=4, exact=True, lb=3, ub=5, expanded=139),
    "myciel4": dict(width=10, exact=True, lb=8, ub=11, expanded=81341),
    "queen5_5": dict(width=18, exact=True, lb=12, ub=18, expanded=2279),
    "queen6_6": dict(width=25, exact=True, lb=15, ub=26, expanded=47135),
    "queen7_7": dict(width=35, exact=False, lb=18, ub=37, expanded=2186024),
    "queen6_6 use_mmw": dict(width=25, exact=True, lb=15, ub=26,
                             expanded=41156),
    "queen6_6 use_simplicial": dict(width=25, exact=True, lb=15, ub=26,
                                    expanded=47135),
}
# queen6_6 on one rank over NCCL, cap_local DIST_CAP: the reference at D=1
DIST_SINGLE = "queen6_6"
EXPECTED_DIST_SINGLE = dict(width=25, exact=True, lb=15, ub=26,
                            expanded=47135)
# the reference's restart case (tests/test_distributed_tw.py): decide k on
# the named graph with its greedy clique, checkpoints on DIST_RANKS ranks
# (host engine), then a resume from the middle checkpoint on DIST_RANKS
# ranks and on 2 (cap_local doubled); (feasible, inexact, expanded) of
# each from ``repro.core.distributed.decide_distributed`` at the same D
DIST_RESTART = dict(name="queen5_5", k=18, cap_local=1 << 11, block=1 << 6)
EXPECTED_RESTART = dict(checkpoints=6, mid_level=4,
                        full=(True, False, 2525), resume=(True, False, 2525),
                        resume2=(True, False, 2525))
# ``shard.decide_sharded(petersen, k, clique, shards=DIST_RANKS, mesh=...,
# cap=2^9, block=2^6)``: the reference's single-lane decide (cap 2^12,
# block 2^6) gives these (feasible, inexact, expanded) for k = 3, 4
MESH_RUNG = dict(name="petersen", ks=(3, 4), cap=1 << 9, block=1 << 6)
EXPECTED_MESH_RUNG = [(False, False, 40), (True, False, 99)]
# ``solve(queen5_5, schedule=s, backend="torch")`` on the card; the
# reference's ``solve(g, schedule=s)`` gives EXPECTED's row for every s
SCHEDULE_CHECK = ("queen5_5", ("doubling", "while", "linear", "matmul"))
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
# the paths kernel's checks: Table-1 instances against the host function at
# cap 0 and the plan's cap, and seeded G(n, p) at the word edges against
# its plain version on the card ((n, p, cap))
PATHS_NAMES = ("petersen", "myciel4", "queen5_5", "queen6_6", "dyck",
               "grid6x6", "queen7_7")
PATHS_GNP = ((33, 0.3, 5), (64, 0.1, 64), (65, 0.5, 3), (100, 0.05, 300),
             (129, 0.7, 2), (200, 0.03, 8), (256, 0.9, 1), (256, 0.02, 64))
# (instance, cap) of the paths kernel's times: the plan's cap of each
PATHS_TIMING = [("queen6_6", 26), ("queen7_7", 37)]
BLOOM_CASES = [(64, 3), (64, 17), (1 << 14, 3), (1 << 14, 17),
               (1 << 24, 17)]
# probe counts: one, and groups past one warp
BLOOM_K_EDGES = [(64, 1), (1 << 14, 33), (64, 64), (1 << 24, 64)]
BLOOM_B = (1, 2048, 2048 * 49)
M_BITS = 1 << 24            # the solver's default filter
K_HASHES = 17
# LM serving (phase 11): the port's model zoo on the card in float32, each
# model from its own seeded init (LM_SEED), one model at a time.  LM_MAIN
# at full width and depth; LM_OTHERS are the other cache kinds of the
# reference's decode smoke (window + SSM, pure state, cross, MoE) at their
# full configs, then cut to one pattern period for the checks.
LM_MAIN = "qwen3-0.6b"
LM_OTHERS = ("hymba-1.5b", "xlstm-1.3b", "whisper-small",
             "granite-moe-1b-a400m")
LM_SEED = 0
LM_SLOTS = 4
LM_MAIN_PROMPT, LM_MAIN_NEW = 64, 16
LM_STREAM_REQUESTS, LM_STREAM_PROMPTS = 8, (16, 64)
LM_LONG = (2, 4096)         # (batch, tokens): past 2 * attn_chunk
LM_OTHER_PROMPT, LM_OTHER_NEW = 32, 8
LM_CPU_TOKENS = (1, 32)
# card logits against the same weights by another path (full forwards,
# full attention, the CPU): max |a - b| <= LM_TOL * max |b|
LM_TOL = 1e-3
# At one pattern period an arch's cache path is held to its full forward
# within LM_TOL, or LM_PERIOD_TOL where float32 cannot hold LM_TOL there:
# xlstm-1.3b's chunkwise mLSTM against its step recurrence departs by up
# to XLSTM_CPU on the CPU in the port from its own seeded init at these
# shapes (the largest over seeds 0-3: 5.663e-4, 1.619e-4, 7.520e-4,
# 1.051e-4; tests/lm_conditioning.py item 3), and the limit is 4 times
# that.
XLSTM_CPU = 7.520e-4
LM_PERIOD_TOL = {"xlstm-1.3b": 4 * XLSTM_CPU}
# LM training (phase 12): the port's trainer on the card in float32 with
# TF32 off.  (a) ``launch.train`` on TRAIN_MAIN at full width and depth,
# AdamW, TRAIN_BATCH x TRAIN_SEQ tokens a step, TRAIN_STEPS steps (10 of
# them warmup); (b) one step of the same weights on the card and on the
# CPU at TRAIN_CPU_TOKENS; (c) the gradients under ``remat`` "full" and
# "dots" against none, at (a)'s batch; (d) ``microbatch=TRAIN_MICRO``
# against none; (e) the supervisor's crash and resume, and 25 straight
# steps against 15 + checkpoint + restore + 10, at ``reduced`` size; (f)
# ``compressed_psum`` and compressed training on TRAIN_RANKS ranks
# sharing the card over gloo.
TRAIN_MAIN = "qwen3-0.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 512
TRAIN_LR = 3e-4
TRAIN_CPU_TOKENS = (1, 32)
# (b), (d): one step from the same weights at TRAIN_CMP_LR (warmup 0)
TRAIN_CMP_LR = 1e-4
# card vs CPU: the metrics within TRAIN_METRIC_TOL (relative), each
# gradient leaf within TRAIN_GRAD_TOL of its range (the CPU twins'
# GRAD_TOL: the reference's init makes the gradients ill-conditioned,
# tests/lm_conditioning.py item 6)
TRAIN_METRIC_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_REMAT_TOL = 1e-5
TRAIN_MICRO = 4
# (d) reports the parameters past 1e-4 (test_grad_accumulation_equivalence's
# bound): an element whose gradient is near 0 moves by up to 2 * lr with the
# summation order, so the check is the m/v bound of (b)
TRAIN_MICRO_TOL = 1e-4
TRAIN_RESUME = (15, 25)     # checkpoint after 15 steps, compare at 25
TRAIN_RESUME_TOL = 1e-6
TRAIN_RANKS = 2
TRAIN_COMPRESS_ROWS = 1 << 20
TRAIN_COMPRESS_STEPS = 30
# phase 13: (a) predicts phase 12's step (TRAIN_MAIN at TRAIN_BATCH x
# TRAIN_SEQ) and holds a real step to the prediction: state bytes and
# FLOPs exactly, the peak within DRY_PEAK_TOL (relative); (b) runs the
# production-mesh cells DRY_ARCHS x DRY_SHAPES (granite-moe's decode, not
# asked for, comes with the product at a few seconds)
DRY_PEAK_TOL = 0.05
DRY_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m")
DRY_SHAPES = ("train_4k", "decode_32k")
DRY_TIMEOUT_S = 600
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
    "paths": ("src/repro_torch/kernels/paths/csrc/paths.cu",
              "none: the host function src/repro/core/bounds.py:146"),
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
            base = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
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


def warps_by_registers(regs):
    """Warps an SM can hold at ``regs`` registers a thread: 65 536
    registers, allocated 256 at a time per warp, at most 64 warps."""
    per_warp = -(-regs * 32 // 256) * 256
    return min(64, 65536 // per_warp)


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
                f"stack, {spill} bytes spilled; registers allow "
                f"{warps_by_registers(regs)} warps per SM")
    return line, reports


def log_occupancy(wf, reports):
    """Each wavefront instantiation's registers and spills (ptxas, from
    this run's build) and the warps per SM that the launch keeps resident
    (the occupancy the kernel reads to size its grid)."""
    ptx = {kernel: (regs, spill) for kernel, regs, _stack, spill
           in ptxas_rows(reports.get("wavefront", ""))}
    for w in range(1, wf.ops._lib().wavefront_max_words() + 1):
        for use_mmw, use_simp in WAVEFRONT_FLAGS:
            occ = wf.ops.occupancy(w, use_mmw, use_simp)
            regs, spill = ptx.get(
                f"wavefront_kernel<{w},{int(use_mmw)},{int(use_simp)}>",
                ("not built in this run", "not built in this run"))
            log(f"occupancy wavefront_kernel<{w},{int(use_mmw)},"
                f"{int(use_simp)}>: {regs} registers, {spill} bytes spilled;"
                f" {occ['blocks_per_sm']} blocks of {occ['threads']} threads"
                f" = {occ['warps_per_sm']} warps per SM on {occ['sms']} SMs")


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


def check_paths(torch, np, bitset, graph, kern):
    from repro_torch.core import bounds
    worst = 0
    for name in PATHS_NAMES:
        g = graph.REGISTRY[name]()
        for cap in (0, bounds.upper_bound(g)[0]):
            adj = bitset.to_words(g.packed(), DEVICE)
            want = torch.from_numpy(bounds.disjoint_paths_matrix(g, cap=cap))
            ok, err = same(torch, [kern.paths_matrix(adj, cap, n=g.n).cpu()],
                           [want])
            worst = max(worst, err)
            check(ok, f"paths kernel != host function on {name} at cap "
                      f"{cap} (max abs err {err})")
    for n, p, cap in PATHS_GNP:
        adj = bitset.to_words(graph.gnp(n, p, n).packed(), DEVICE)
        ok, err = same(torch, [kern.paths_matrix(adj, cap, n=n)],
                       [kern.paths_matrix_ref(adj, cap, n=n)])
        worst = max(worst, err)
        check(ok, f"paths kernel != plain version on G({n}, {p}) at cap "
                  f"{cap} (max abs err {err})")
    log(f"kernels: paths bit-identical to the host function on "
        f"{list(PATHS_NAMES)} at cap 0 and ub, and to paths_matrix_ref on "
        f"G(n, p) (n, p, cap) in {list(PATHS_GNP)}")
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
            "shard_forms": check_shard_forms(torch, np, bitset, graph, kern),
            "paths": check_paths(torch, np, bitset, graph, kern["paths"])}


def reset_counts(ops):
    for mod in ops.values():
        mod.LAUNCHES = 0
    ops["wavefront"].LAUNCHES_BY_B.clear()
    ops["wavefront"].LAUNCHES_BY_LANES.clear()
    ops["wavefront"].LAUNCHES_BY_FLAGS.clear()
    ops["wavefront"].LAUNCHES_BY_LANES_FLAGS.clear()
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


# path -> the wavefront kernel's launches by lane count and rules
LANES_FLAGS = {}


def lanes_flags(counter):
    """``LAUNCHES_BY_LANES_FLAGS`` as "L=<lanes> <rules>" -> launches."""
    return {f"L={lanes} {flag_name(mmw, simp)}": count
            for (lanes, mmw, simp), count in sorted(counter.items())}


def read_counts(ops, path=None):
    """Every kernel's launches; with a path, also records and logs the
    wavefront kernel's launches by lane count and rules for it."""
    if path is not None:
        LANES_FLAGS[path] = lanes_flags(
            ops["wavefront"].LAUNCHES_BY_LANES_FLAGS)
        log(f"path [{path}]: wavefront launches by lanes and rules "
            f"{LANES_FLAGS[path]}")
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
        counts[path] = read_counts(ops, path)
        by_width[path] = widths(ops)
        for kernel in needed + ("paths",):
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
    counts["reconstruct"] = read_counts(ops, "reconstruct")
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
        counts[path] = read_counts(ops, path)
        by_lanes[path] = dict(sorted(
            ops["wavefront"].LAUNCHES_BY_LANES.items()))

        many = f"solve_many lanes={SUITE_LANES} {config}"
        gs = [graph.REGISTRY[name]() for name in SUITE]
        reset_counts(ops)
        t0 = time.perf_counter()
        results = batch.solve_many(gs, lanes=SUITE_LANES, **kw)
        torch.cuda.synchronize()
        walls[many] = time.perf_counter() - t0
        counts[many] = read_counts(ops, many)
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
        counts[path] = read_counts(ops, path)
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
    counts[path], by_lanes[path] = read_counts(ops, path), by_lanes_of(ops)
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
    counts[path], by_lanes[path] = read_counts(ops, path), by_lanes_of(ops)
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
    counts = read_counts(ops, path)
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
            counts[path] = read_counts(ops, path)
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
        counts[path] = dict(read_counts(ops, path),
                            sweep=bounds_engine.LAUNCHES)
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
        counts[path], by_lanes[path] = read_counts(ops, path), by_lanes_of(ops)
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
        counts[path] = dict(read_counts(ops, path),
                            sweep=bounds_engine.LAUNCHES)
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


def dist_label(name, flags):
    return " ".join([name] + sorted(flags))


def solve_row(res):
    return dict(width=res.width, exact=res.exact, lb=res.lb, ub=res.ub,
                expanded=res.expanded)


def kernel_counts():
    """This process's launch counts of every kernel, and the wavefront
    kernel's by lane count and rules."""
    from repro_torch.kernels import bloom, expand, mmw, paths, wavefront
    return {"wavefront": wavefront.ops.LAUNCHES, "mmw": mmw.ops.LAUNCHES,
            "bloom": bloom.ops.LAUNCHES, "expand": expand.ops.LAUNCHES,
            "paths": paths.ops.LAUNCHES,
            "lanes_flags": lanes_flags(wavefront.ops.LAUNCHES_BY_LANES_FLAGS)}


def reset_kernel_counts():
    from repro_torch.kernels import bloom, expand, mmw, paths, wavefront
    for mod in (bloom, expand, mmw, paths, wavefront):
        mod.ops.LAUNCHES = 0
    wavefront.ops.LAUNCHES_BY_LANES_FLAGS.clear()


def dist_rank(mesh):
    """Phase 10 on one rank of DIST_RANKS (run by ``distributed.launch``):
    each path with this rank's launch counts set to 0 just before it and
    read just after.  Returns host values only."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import bounds, distributed, graph, shard, telemetry

    out = dict(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device),
               devices=list(mesh.devices), paths={})
    for name, flags in DIST_CASES:
        tr = telemetry.Tracker()
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = distributed.solve_distributed(
            graph.REGISTRY[name](), mesh, cap_local=DIST_CAP // mesh.size,
            block=DIST_BLOCK, tracker=tr, **flags)
        torch.cuda.synchronize()
        coll = tr.snapshot()["timings"].get("collective_s",
                                            {"calls": 0, "total_s": 0.0})
        out["paths"][dist_label(name, flags)] = dict(
            row=solve_row(res), launches=kernel_counts(),
            wall=time.perf_counter() - t0, collective_calls=coll["calls"],
            collective_s=coll["total_s"])

    r = DIST_RESTART
    g = graph.REGISTRY[r["name"]]()
    clique = bounds.greedy_max_clique(g)
    kw = dict(cap_local=r["cap_local"], block=r["block"])
    ckpts = []
    reset_kernel_counts()
    full = distributed.decide_distributed(g, r["k"], clique, mesh,
                                          checkpoint_cb=ckpts.append, **kw)
    mid = [ckpts[len(ckpts) // 2] if mesh.rank == 0 else None]
    dist.broadcast_object_list(mid, src=0, group=mesh.group)
    resume = distributed.decide_distributed(g, r["k"], clique, mesh,
                                            resume=mid[0], **kw)
    pair = dist.new_group([0, 1])              # every rank takes part
    resume2 = None
    if mesh.rank < 2:
        mesh2 = distributed.make_solver_mesh(group=pair, device=mesh.device)
        resume2 = tuple(distributed.decide_distributed(
            g, r["k"], clique, mesh2, resume=mid[0],
            cap_local=2 * r["cap_local"], block=r["block"]))
    dist.barrier(group=mesh.group)
    out["restart"] = dict(
        checkpoints=len(ckpts) if mesh.rank == 0 else None,
        mid_level=mid[0]["level"], full=tuple(full), resume=tuple(resume),
        resume2=resume2, launches=kernel_counts())

    m = MESH_RUNG
    g = graph.REGISTRY[m["name"]]()
    clique = bounds.greedy_max_clique(g)
    reset_kernel_counts()
    rungs = [shard.decide_sharded(g, k, clique, shards=mesh.size, mesh=mesh,
                                  cap=m["cap"], block=m["block"])
             for k in m["ks"]]
    out["mesh_rung"] = dict(
        results=[(x.feasible, x.inexact, x.expanded) for x in rungs],
        launches=kernel_counts())
    return out


def rank_lanes_flags(path, per_rank):
    """Records and logs the wavefront launches by lane count and rules of
    ``path``, summed over the ranks' ``launches``."""
    total = {}
    for x in per_rank:
        for key, count in x["launches"]["lanes_flags"].items():
            total[key] = total.get(key, 0) + count
    LANES_FLAGS[path] = total
    log(f"path [{path}]: wavefront launches by lanes and rules, all ranks "
        f"{total}")


def phase_distributed(torch, graph, solver, distributed, ops, walls):
    """The distributed path: queen6_6 on one rank over NCCL in this
    process, the schedules on the card, then DIST_RANKS ranks over gloo
    (``dist_rank``).  Returns path -> summed launch counts and the
    per-rank results."""
    import torch.distributed as dist

    counts = {}
    name = SCHEDULE_CHECK[0]
    for s in SCHEDULE_CHECK[1]:
        t0 = time.perf_counter()
        res = solver.solve(graph.REGISTRY[name](), schedule=s,
                           backend="torch", device=DEVICE)
        torch.cuda.synchronize()
        got = solve_row(res)
        want = {key: EXPECTED[name][key] for key in got}
        check(got == want, f"schedule {s} {name}: {got} != JAX {want}")
        log(f"solve [schedule={s}, backend=torch] {name}: "
            f"treewidth={res.width} expanded={res.expanded} "
            f"wall={time.perf_counter() - t0:.3f} s")

    mesh = distributed.make_solver_mesh()
    try:
        check(mesh.size == 1 and mesh.backend == "nccl",
              f"one rank with a card: backend {mesh.backend}, not nccl")
        reset_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = distributed.solve_distributed(
            graph.REGISTRY[DIST_SINGLE](), mesh, cap_local=DIST_CAP,
            block=DIST_BLOCK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    path = f"distributed D=1 nccl {DIST_SINGLE}"
    counts[path] = read_counts(ops, path)
    check(solve_row(res) == EXPECTED_DIST_SINGLE,
          f"{path}: {solve_row(res)} != JAX {EXPECTED_DIST_SINGLE}")
    check(counts[path]["wavefront"] > 0,
          f"{path}: the wavefront kernel never launched")
    log(f"solve [{path}]: {solve_row(res)} launches {counts[path]} wall="
        f"{wall:.3f} s (phase 3 single device: "
        f"{walls[('defaults', DIST_SINGLE)]:.3f} s)")

    t0 = time.perf_counter()
    ranks = distributed.launch(dist_rank, DIST_RANKS, device=DEVICE)
    log(f"{DIST_RANKS} ranks over {ranks[0]['backend']} on "
        f"{ranks[0]['devices']}: launch and run {time.perf_counter() - t0:.1f}"
        f" s; collectives on CUDA tensors, no host staging")
    check(all(r["backend"] == "gloo" for r in ranks),
          "ranks sharing one card must run over gloo")
    for label, want in EXPECTED_DIST.items():
        rows = [r["paths"][label]["row"] for r in ranks]
        check(all(row == want for row in rows),
              f"distributed {label}: {rows} != JAX {want}")
        launched = [r["paths"][label]["launches"]["wavefront"] for r in ranks]
        path = f"distributed D={DIST_RANKS} {label}"
        counts[path] = {k: sum(r["paths"][label]["launches"][k]
                               for r in ranks) for k in ops}
        rank_lanes_flags(path, [r["paths"][label] for r in ranks])
        if label.split()[0] in ("queen6_6", "queen7_7"):
            check(all(n > 0 for n in launched),
                  f"distributed {label}: wavefront launches by rank "
                  f"{launched}, not in every rank")
        name, *flag = label.split()
        config = {"use_simplicial": "simplicial"}.get(
            flag[0] if flag else "", "defaults")
        ref_wall = walls[(config, name)]
        log(f"solve [distributed D={DIST_RANKS} gloo] {label}: "
            f"{rows[0]} wavefront launches by rank {launched}; wall by rank "
            + ", ".join(f"{r['paths'][label]['wall']:.3f}" for r in ranks)
            + f" s (phase 3 {config}: {ref_wall:.3f} s)")
    for r in ranks:
        q7 = r["paths"]["queen7_7"]
        log(f"queen7_7 rank {r['rank']}: {q7['collective_calls']} collective "
            f"calls, host time {q7['collective_s']:.3f} s of "
            f"{q7['wall']:.3f} s")

    rs = [r["restart"] for r in ranks]
    got = dict(checkpoints=rs[0]["checkpoints"], mid_level=rs[0]["mid_level"],
               full=rs[0]["full"], resume=rs[0]["resume"],
               resume2=rs[0]["resume2"])
    check(got == EXPECTED_RESTART, f"restart: {got} != JAX {EXPECTED_RESTART}")
    check(all(x["full"] == rs[0]["full"] and x["resume"] == rs[0]["resume"]
              for x in rs) and rs[1]["resume2"] == rs[0]["resume2"],
          f"restart: ranks disagree {rs}")
    counts[f"distributed D={DIST_RANKS} restart"] = {
        k: sum(x["launches"][k] for x in rs) for k in ops}
    rank_lanes_flags(f"distributed D={DIST_RANKS} restart", rs)
    log(f"restart {DIST_RESTART['name']} k={DIST_RESTART['k']}: {got}")

    mr = [r["mesh_rung"] for r in ranks]
    check(all(x["results"] == EXPECTED_MESH_RUNG for x in mr),
          f"mesh rung: {[x['results'] for x in mr]} != JAX "
          f"{EXPECTED_MESH_RUNG}")
    counts[f"distributed D={DIST_RANKS} mesh rung"] = {
        k: sum(x["launches"][k] for x in mr) for k in ops}
    rank_lanes_flags(f"distributed D={DIST_RANKS} mesh rung", mr)
    log(f"mesh rung {MESH_RUNG['name']} k={MESH_RUNG['ks']}: "
        f"{mr[0]['results']}")
    for path, c in counts.items():
        log(f"path [{path}]: launches {c}")
    return counts, ranks


def timing_inputs(torch, np, bitset, graph, preprocess, solver, batch,
                  name, k, block=2048):
    """B=block states from the largest level of ``name`` at width k, and
    as the last item (states, valid) of the level's second chunk (every
    timed level has one)."""
    g = preprocess.preprocess(graph.REGISTRY[name]()).blocks[0].g
    plan = solver.plan_block(g, use_clique=True, use_paths=True,
                             start_k=None)
    gk = plan.graph_at(k)
    cap = batch.plan_capacity(g.n, block=block)
    res = solver.decide(gk, k, plan.clique, cap=cap, block=block,
                        keep_levels=True, engine="host")
    level = max(res.levels, key=len)
    chunks = []
    for rows in (level[:block], level[block:2 * block]):
        states = np.zeros((block, bitset.n_words(g.n)), dtype=np.uint32)
        states[:len(rows)] = rows
        chunks.append((bitset.to_words(states, DEVICE), torch.from_numpy(
            np.arange(block) < len(rows)).to(DEVICE)))
    return (bitset.to_words(gk.packed(), DEVICE), *chunks[0], k,
            bitset.to_words(bitset.np_allowed(g.n, plan.clique), DEVICE),
            g.n, min(len(level), block), chunks[1])


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


def scratch_bytes(torch, call, filt):
    """Device bytes that ``call(filt)`` asks for and frees again within
    the call (its scratch), by the caching allocator's counters of bytes
    requested, before it rounds them up to its blocks: the peak during
    the call less what is still held after it, its outputs kept alive."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = call(filt)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    del out
    return (stats["requested_bytes.all.peak"]
            - stats["requested_bytes.all.current"])


class FreshFilters:
    """Default-size filters handed out in turn, one per call, each as
    ``source`` holds it, or empty without one, so that every timed Bloom
    call finds the filter as a level's first chunk does (empty) or as a
    later chunk does (``source``: the level's other chunk inserted);
    ``reset`` restores them all and starts the turn again."""

    def __init__(self, bl, count, lanes=None, source=None):
        self.source = source
        self.filters = [bl.make_filter_words(M_BITS, device=DEVICE,
                                             lanes=lanes)
                        for _ in range(count)]
        self.reset()

    def __call__(self):
        f = self.filters[self.turn % len(self.filters)]
        self.turn += 1
        return f

    def reset(self):
        for f in self.filters:
            if self.source is None:
                f.zero_()
            else:
                f.copy_(self.source)
        self.turn = 0


def sorted_children(dedup, wf, args, n):
    """A chunk's children as the Bloom kernel gets them on the main path:
    sorted, with their first-occurrence mask ([L,] B*n rows)."""
    children, feas = wf.wavefront_expand(*args, n=n)
    *lead, b, _, w = children.shape
    skeys, svalid = dedup.sort_states(
        children.reshape(*lead, b * n, w), feas.reshape(*lead, b * n))
    return skeys, dedup.unique_mask(skeys, svalid)


def time_bloom(torch, bloom, bl, skeys, keep, other, tag):
    """The Bloom kernel on one chunk's sorted children (one lane, or a
    lane axis) into empty default-size filters and into filters that
    already hold ``other``, the sorted children of the level's second
    chunk, with its scratch beside an owner array's int32 per filter bit
    (the design before the bucketed one); returns the timing entry."""
    lanes = skeys.shape[0] if skeys.dim() == 3 else None
    warm = bl.make_filter_words(M_BITS, device=DEVICE, lanes=lanes)
    bl.bloom_insert_ref(warm, *other, m_bits=M_BITS, k_hashes=K_HASHES)
    times = {}
    for label, source in (("fresh", None), ("warm", warm)):
        start = bl.make_filter_words(M_BITS, device=DEVICE, lanes=lanes) \
            if source is None else source
        ok, _ = same(torch,
                     bl.bloom_insert(start.clone(), skeys, keep,
                                     m_bits=M_BITS, k_hashes=K_HASHES),
                     bl.bloom_insert_ref(start.clone(), skeys, keep,
                                         m_bits=M_BITS, k_hashes=K_HASHES))
        check(ok, f"bloom kernel != plain version on {tag} children, "
                  f"{label} filter")
        filters = FreshFilters(bl, max(GRAPH_CALLS, 100 + WARMUP),
                               lanes=lanes, source=source)
        times[label] = kernel_times(
            torch, lambda: bl.bloom_insert(filters(), skeys, keep,
                                           m_bits=M_BITS, k_hashes=K_HASHES),
            lambda: bl.bloom_insert_ref(filters(), skeys, keep,
                                        m_bits=M_BITS, k_hashes=K_HASHES),
            reset=filters.reset)
        del filters
    nl = lanes or 1
    nbytes = ops = 0
    for i in range(nl):
        _, _, nb, op = bloom_bound(torch, bloom, skeys.reshape(
            nl, *skeys.shape[-2:])[i], keep.reshape(nl, -1)[i], M_BITS,
            K_HASHES)
        nbytes, ops = nbytes + nb, ops + op
    bms, by = bound(nbytes, ops)
    rows = skeys.shape[-2]
    planned = bl.ops.scratch_plan(nl, rows, M_BITS, K_HASHES).nbytes
    scratch = scratch_bytes(torch, lambda f: bl.bloom_insert(
        f, skeys, keep, m_bits=M_BITS, k_hashes=K_HASHES),
        bl.make_filter_words(M_BITS, device=DEVICE, lanes=lanes))
    check(scratch == planned,
          f"bloom wrapper on {tag} children asked for {scratch} bytes of "
          f"scratch, not the {planned} bytes that ops.scratch_plan sizes")
    owner = 4 * nl * M_BITS
    (dev, ms, plain), (wdev, wms, wplain) = times["fresh"], times["warm"]
    log(f"time bloom {tag}: L={nl} x {rows} rows ({int(keep.sum())} kept; "
        f"warm filter holds {int(other[1].sum())} more) "
        f"W={skeys.shape[-1]} m_bits={M_BITS} k_hashes={K_HASHES}: device "
        f"{dev:.4f} ms fresh / {wdev:.4f} ms warm, wrapper {ms:.4f} / "
        f"{wms:.4f} ms, plain {plain:.4f} / {wplain:.4f} ms, bound "
        f"{bms:.6f} ms by {by} ({nbytes} bytes, {ops} word ops); scratch "
        f"{scratch} bytes asked for during a call, where the owner array "
        f"of the design before it held {owner} bytes")
    return dict(shape=tag, L=nl, B=rows, ms=dev, wrapper_ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by, warm_ms=wdev,
                warm_wrapper_ms=wms, warm_plain_ms=wplain,
                scratch_bytes=scratch)


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
                components, bloom, dedup, kern, reports, lanes=True):
    """Returns kernel -> timing entries; the wavefront kernel's first
    entry is the main one (no flags, B=2048, the first shape).  ``lanes``
    adds the lane forms (``time_lanes``).  Logs the wavefront kernel's
    occupancy first."""
    log_occupancy(kern["wavefront"], reports)
    rows = {name: [] for name in KERNELS}
    for shape, k in TIMING_SHAPES:
        adj, states, valid, kk, allowed, n, live, second = timing_inputs(
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
        # and their first-occurrence mask, into a default-size filter
        # that is empty or holds the level's second chunk (a fresh copy
        # for every call)
        skeys, keep = sorted_children(dedup, wf, args, n)
        other = sorted_children(dedup, wf, (adj, *second, kk, allowed), n)
        rows["bloom"].append(time_bloom(torch, bloom, kern["bloom"], skeys,
                                        keep, other, f"{shape} k={k}"))
    if lanes:
        time_lanes(torch, np, bitset, graph, preprocess, solver, batch,
                   components, bloom, dedup, kern, rows)
    if "paths" in kern:
        rows["paths"] = time_paths(torch, bitset, graph, kern["paths"])
    return rows


def time_paths(torch, bitset, graph, kern):
    """The paths kernel on PATHS_TIMING: device ms by graph replay, ms per
    call by CUDA events, the plain version's ms on the card, and the host
    wall of the form that planning calls (upload, launch and read on the
    wrapper's stream); the bound counts bytes only, the adjacency read
    once and the matrix written once."""
    out = []
    for name, cap in PATHS_TIMING:
        g = graph.REGISTRY[name]()
        adj = bitset.to_words(g.packed(), DEVICE)
        ok, _ = same(torch, [kern.paths_matrix(adj, cap, n=g.n)],
                     [kern.paths_matrix_ref(adj, cap, n=g.n)])
        check(ok, f"paths kernel != plain version on {name} at cap {cap}")
        dev, ms, plain = kernel_times(
            torch, lambda: kern.paths_matrix(adj, cap, n=g.n),
            lambda: kern.paths_matrix_ref(adj, cap, n=g.n))
        packed = g.packed()
        calls = 20
        kern.ops.disjoint_paths_matrix(packed, cap, device=DEVICE)
        t0 = time.perf_counter()
        for _ in range(calls):
            kern.ops.disjoint_paths_matrix(packed, cap, device=DEVICE)
        plan_ms = (time.perf_counter() - t0) / calls * 1e3
        nbytes = 4 * adj.numel() + 4 * g.n * g.n
        bms, by = bound(nbytes, 0)
        log(f"time paths {name} cap={cap}: n={g.n} W={adj.shape[1]} pairs="
            f"{g.n * (g.n - 1) // 2}: device {dev:.4f} ms, wrapper {ms:.4f} "
            f"ms, plain {plain:.4f} ms, planning form {plan_ms:.4f} ms, "
            f"bound {bms:.6f} ms by {by} ({nbytes} bytes)")
        out.append(dict(shape=f"{name} cap={cap}", ms=dev, wrapper_ms=ms,
                        plain_ms=plain, plan_ms=plan_ms, bound_ms=bms,
                        bound_by=by))
    return out


def lane_timing_inputs(torch, np, bitset, graph, preprocess, solver, batch):
    """The lane forms' timing inputs: SUITE_LANES lanes of TIMING_LANES'
    instance, lane i at rung TIMING_LANES[1][i], each with the first 2048
    states of its largest level.  Returns (adj, states, valid, k,
    allowed), n, the live rows per lane, the (states, valid) of each
    lane's second chunk, and a tag."""
    shape, ks = TIMING_LANES
    ins = [timing_inputs(torch, np, bitset, graph, preprocess, solver,
                         batch, shape, k, block=max(TIMING_B)) for k in ks]
    adj, states, valid, allowed = (torch.stack([x[i] for x in ins])
                                   for i in (0, 1, 2, 4))
    second = [torch.stack([x[7][i] for x in ins]) for i in (0, 1)]
    kk = torch.tensor([x[3] for x in ins], dtype=torch.int32, device=DEVICE)
    return ((adj, states, valid, kk, allowed), ins[0][5],
            [x[6] for x in ins], second, f"{shape} k={ks[0]}..{ks[-1]}")


def time_lanes(torch, np, bitset, graph, preprocess, solver, batch,
               components, bloom, dedup, kern, rows):
    """The lane forms at the lane paths' shapes: SUITE_LANES lanes of
    queen7_7, lane i at rung TIMING_LANES[1][i], each with the first 2048
    states of its largest level; B5 on each lane's sorted children into
    its own empty default-size filter."""
    args, n, live, second, tag = lane_timing_inputs(
        torch, np, bitset, graph, preprocess, solver, batch)
    adj, states, valid, kk, allowed = args
    lanes, b, w = states.shape
    wf = kern["wavefront"]
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

    skeys, keep = sorted_children(dedup, wf, args, n)
    other = sorted_children(dedup, wf, (adj, *second, kk, allowed), n)
    rows["bloom_lanes"].append(time_bloom(torch, bloom, kern["bloom"],
                                          skeys, keep, other,
                                          f"lanes {tag}"))




# Part (b) of the wavefront kernel (``--parts``): its source with the
# stores of children and feasibility replaced by a fold of each warp's
# feasibility into one word, stored only if it equals a constant that a
# mask of n <= 256 bits never takes whole, so nothing is dropped.  One
# (stores, fold) pair per layout of the source: a warp per state on a
# (B/4, L) grid (the design before the tiled one, for timing an older
# tree), and tiles on a grid sized from the work, whose fold reads the
# staged feasibility bytes instead.
PARTS_FOLDS = [(
    """#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int v = lane + kWarp * r;
    if (v < n) feasible[(size_t)row * n + v] = (feas >> r) & 1u;
  }

  uint32_t* out = children + (size_t)row * nw;
  for (int idx = lane; idx < nw; idx += kWarp) {
    const int v = idx / W;
    const int x = idx - v * W;
    uint32_t word = s[x];
    if (x == (v >> 5)) word |= 1u << (v & 31);
    out[idx] = word;
  }
}""",
    """  if (__reduce_or_sync(rt::kFull, feas) == 0x9e3779b9u)
    feasible[row] = 1;
}"""), (
    """    store_children<W>(s_states,
                      p.children + ((size_t)cur.lane * p.n_states + cur.row0) *
                                       nw,
                      cur.rows * nw, n);
    store_bytes(s_feas, feas_out, cur.rows * n);""",
    """    if (s_feas[threadIdx.x % (cur.rows * n)] == 2) feas_out[0] = 1;"""),
]


def parts_library(build, tag):
    """The wavefront library of the tree that ``build`` belongs to, built
    once more with PARTS_FOLDS applied (part (b): no stores), into
    build/parts/<tag>/."""
    import ctypes
    src = build.SOURCES["wavefront"].read_text()
    folds = [(old, fold) for old, fold in PARTS_FOLDS if old in src]
    check(len(folds) == 1, "--parts: no known store layout in the "
                           "wavefront source")
    src = src.replace(*folds[0])
    out = ROOT / "build" / "parts" / tag
    (out / "common").mkdir(parents=True, exist_ok=True)
    (out / "wavefront" / "csrc").mkdir(parents=True, exist_ok=True)
    for header in build.headers():
        rel = header.relative_to(build.SOURCES["wavefront"].parents[2])
        (out / rel).write_bytes(header.read_bytes())
    cu = out / "wavefront" / "csrc" / "wavefront.cu"
    cu.write_text(src)
    so = out / "wavefront_parts.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"--parts: nvcc failed:\n{res.stdout}"
                               f"{res.stderr}")
    for kernel, regs, stack, spill in ptxas_rows(res.stdout + res.stderr):
        log(f"  ptxas parts (b): {kernel}: {regs} registers, {spill} "
            f"bytes spilled")
    return ctypes.CDLL(str(so))


def phase_parts(torch, np, bitset, graph, preprocess, solver, batch, build,
                wf, tag):
    """Device ms by graph replay of the wavefront kernel's parts under
    every flag set, at the lane shape (TIMING_LANES) and one lane of each
    TIMING_SHAPES at B=2048: (a) stores only (the kernel with no valid
    row: children and a zero feasibility row, no closure, no rules), (b)
    compute only (``parts_library``), (c) the kernel."""
    lib_c = build.library("wavefront")
    lib_b = parts_library(build, tag)
    shapes = []
    args, n, _live, _second, lane_tag = lane_timing_inputs(
        torch, np, bitset, graph, preprocess, solver, batch)
    shapes.append((f"lanes {lane_tag}", args, n))
    for shape, k in TIMING_SHAPES:
        adj, states, valid, kk, allowed, n1, _l, _s = timing_inputs(
            torch, np, bitset, graph, preprocess, solver, batch, shape, k,
            block=max(TIMING_B))
        shapes.append((f"{shape} k={k}", (adj, states, valid, kk, allowed),
                       n1))
    out = []
    for label, a, nn in shapes:
        none_valid = (a[0], a[1], torch.zeros_like(a[2]), *a[3:])
        for use_mmw, use_simp in WAVEFRONT_FLAGS:
            flags = dict(use_mmw=use_mmw, use_simplicial=use_simp)
            times = {}
            for part, lib, xs in (("a", lib_c, none_valid), ("b", lib_b, a),
                                  ("c", lib_c, a)):
                build._LIBS["wavefront"] = lib
                try:
                    times[part] = device_ms(torch, lambda: wf.wavefront_expand(
                        *xs, n=nn, **flags))
                finally:
                    build._LIBS["wavefront"] = lib_c
            name = flag_name(use_mmw, use_simp)
            log(f"parts wavefront[{name}] {label}: (a) stores only "
                f"{times['a']:.4f} ms, (b) compute only {times['b']:.4f} ms, "
                f"(c) kernel {times['c']:.4f} ms")
            out.append(dict(shape=label, flags=name, **times))
    return out


# device-side names of the port's kernels (the rest is PyTorch's work)
PORT_KERNEL_NAMES = ("wavefront_kernel", "mmw_kernel", "expand_kernel",
                     "bloom_count_kernel", "bloom_scatter_kernel",
                     "bloom_resolve_kernel")


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


class MoeDrops:
    """Counts the expert choices that ``moe.moe_block`` drops past its
    capacity while installed (``with MoeDrops(moe) as drops``): the
    reference's dispatch drops them, so a forward's output depends on the
    other tokens of its batch wherever this count is not zero.  ``routes``
    holds each call's top-k experts per token, on the CPU."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.dropped, self.routes = torch, moe, 0, []

    def __enter__(self):
        self.orig = self.moe.moe_block
        torch, moe = self.torch, self.moe

        def counted(p, x, cfg):
            t = x.shape[0] * x.shape[1]
            _, _, _, top_e = moe.route(p, x.reshape(t, -1), cfg)
            self.routes.append(top_e.cpu())
            load = torch.bincount(top_e.reshape(-1),
                                  minlength=cfg.moe.n_experts)
            self.dropped += int(torch.clamp(
                load - moe._capacity(t, cfg), min=0).sum())
            return self.orig(p, x, cfg)
        self.moe.moe_block = counted
        return self

    def __exit__(self, *exc):
        self.moe.moe_block = self.orig


def rel_err(torch, got, want):
    return float(torch.max(torch.abs(got.float() - want.float()))
                 / torch.max(torch.abs(want.float())))


def clear_rows(torch, logits, tol=LM_TOL):
    """Rows whose top-two margin exceeds ``tol * max |logits|``."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]) > tol * float(
        torch.max(torch.abs(logits.float())))


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_greedy_check(torch, moe, model, engine, prompts, new, kw,
                    tol=LM_TOL):
    """``engine.generate_greedy`` against argmax over repeated full
    forwards of the prompts and the tokens so far (same weights, same
    batch): each step's logits by the cache path (prefill, then decode of
    the generated tokens) within ``tol`` of the full forward's last
    position, and the generated token equal to the full forward's argmax
    wherever its top-two margin is clear of ``tol``.  A decode step whose
    full forward or prefill dropped MoE choices past capacity is counted,
    not compared (its batch differs; ``lm_cpu_decode_check`` holds those).
    Returns (tokens, stats)."""
    gen = engine.generate_greedy(prompts, new, **kw)
    b, s = prompts.shape
    with MoeDrops(torch, moe) as drops:
        (last, cache), prefill_ms = timed(
            torch, lambda: engine.prefill(prompts, engine.new_cache(), **kw))
    prefill_drops = drops.dropped
    pos = torch.full((b,), s, dtype=torch.int32, device=prompts.device)
    stats = dict(tol=tol, prefill_ms=prefill_ms,
                 prefill_dropped=prefill_drops, max_rel_err=0.0,
                 near_ties=0, dropped_steps=0, compared_tokens=0)
    clear_until = [new] * b
    for step in range(new):
        if step:
            last, cache = engine.decode(gen[:, step - 1:step], cache, pos)
            pos = pos + 1
        seq = torch.cat([prompts, gen[:, :step]], dim=1)
        with MoeDrops(torch, moe) as drops, torch.inference_mode():
            full = model(seq, **kw)[0][:, -1]
        if step and (drops.dropped or prefill_drops):
            stats["dropped_steps"] += 1
            clear_until = [min(c, step) for c in clear_until]
            continue
        err = rel_err(torch, last, full)
        stats["max_rel_err"] = max(stats["max_rel_err"], err)
        check(err <= tol, f"step {step}: cache path vs full forward "
                          f"{err:.3e} > {tol:.3e}")
        clear = clear_rows(torch, full, tol)
        stats["near_ties"] += int((~clear).sum())
        for row in torch.nonzero(~clear).flatten().tolist():
            clear_until[row] = min(clear_until[row], step)
        want = torch.argmax(full, dim=-1).to(torch.int32)
        check(torch.equal(want[clear], gen[clear, step]),
              f"step {step}: generated tokens differ from the full "
              f"forward's argmax at a clear margin")
        stats["compared_tokens"] += int(clear.sum())
    stats["clear_until"] = clear_until
    return gen, stats


def greedy_line(g):
    return (f"prefill {g['prefill_ms']:.2f} ms; cache path vs full "
            f"forwards max rel err {g['max_rel_err']:.3e} (tolerance "
            f"{g['tol']:.1e}), {g['near_ties']} "
            f"near-tie row(s), {g['compared_tokens']} tokens compared, "
            f"{g['dropped_steps']} step(s) with MoE drops (prefill dropped "
            f"{g['prefill_dropped']} choices)")


def lm_cpu_decode_check(torch, moe, engine_mod, engine, prompts, gen, kw,
                        tol=LM_TOL):
    """The card's cache path against the same weights' on the CPU, the
    same batch: the prefill of ``prompts``, then the decode of ``gen``'s
    tokens step by step; each step's routing equal choice for choice (so
    the same choices are dropped past capacity) and its logits within
    ``tol``.  Returns the stats."""
    cpu = engine.model.copy_to("cpu")
    cpu_eng = engine_mod.Engine(cpu, engine.batch, engine.cache_len)
    b, s = prompts.shape
    stats = dict(tol=tol, max_rel_err=0.0, steps=0, dropped=[])

    def both(card_fn, cpu_fn, step):
        with MoeDrops(torch, moe) as card:
            last, cache = card_fn()
        with MoeDrops(torch, moe) as host:
            host_last, host_cache = cpu_fn()
        check(len(card.routes) == len(host.routes) and all(
            torch.equal(a, h) for a, h in zip(card.routes, host.routes)),
              f"step {step}: routing on the card differs from the CPU's")
        err = rel_err(torch, last.cpu(), host_last)
        check(err <= tol, f"step {step}: card vs CPU decode {err:.3e} > "
                          f"{tol:.3e}")
        stats["max_rel_err"] = max(stats["max_rel_err"], err)
        stats["steps"] += 1
        stats["dropped"].append(card.dropped)
        return cache, host_cache

    host_kw = {k: v.cpu() for k, v in kw.items()}
    cache, host_cache = both(
        lambda: engine.prefill(prompts, engine.new_cache(), **kw),
        lambda: cpu_eng.prefill(prompts.cpu(), cpu_eng.new_cache(),
                                **host_kw), 0)
    pos = torch.full((b,), s, dtype=torch.int32)
    for step in range(1, gen.shape[1]):
        tok = gen[:, step - 1:step]
        cache, host_cache = both(
            lambda: engine.decode(tok, cache, pos.to(tok.device)),
            lambda: cpu_eng.decode(tok.cpu(), host_cache, pos), step)
        pos = pos + 1
    del cpu, cpu_eng
    return stats


def lm_generate_smoke(torch, engine, prompts, new, kw):
    """``engine.generate_greedy`` as an execution smoke: the prefill's
    last logits finite and ``new`` tokens per row.  No token is held to
    another run's: the deep models are float32-chaotic, and on the card
    ``index_add_`` (the MoE combine) adds in no fixed order, so two runs
    of one prefill need not pick the same token.  Returns (tokens,
    prefill ms)."""
    (last, _), prefill_ms = timed(
        torch, lambda: engine.prefill(prompts, engine.new_cache(), **kw))
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")
    gen = engine.generate_greedy(prompts, new, **kw)
    check(tuple(gen.shape) == (prompts.shape[0], new),
          f"generate_greedy gave {tuple(gen.shape)}")
    return gen, prefill_ms


def lm_stream(torch, np, scheduler, engine, requests):
    """Drain ``requests`` [(prompt, max_tokens)] through a ``Scheduler``;
    returns (done, stats) with the wall, ticks and tokens."""
    sched = scheduler.Scheduler(engine)
    for rid, (prompt, n) in enumerate(requests):
        sched.submit(scheduler.Request(rid=rid, prompt=prompt, max_tokens=n))
    done, wall_ms = timed(torch, sched.run)
    check(sorted(done) == list(range(len(requests))),
          f"stream finished {sorted(done)} of {len(requests)} requests")
    for rid, (_, n) in enumerate(requests):
        check(len(done[rid].output) == n,
              f"request {rid}: {len(done[rid].output)} of {n} tokens")
    tokens = sum(len(r.output) for r in done.values())
    return done, dict(requests=len(requests), ticks=sched.ticks,
                      tokens=tokens, wall_ms=wall_ms,
                      ms_per_tick=wall_ms / sched.ticks,
                      tokens_per_s=tokens / (wall_ms / 1e3))


def lm_model(torch, configs, models, arch):
    cfg = configs.get_config(arch)
    model, init_ms = timed(torch, lambda: models.Model(cfg, seed=LM_SEED))
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return cfg, model, dict(arch=arch, n_layers=cfg.n_layers,
                            params=model.n_params(), param_bytes=n_bytes,
                            init_ms=init_ms)


def lm_inputs(torch, np, cfg, shape, rng):
    toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    kw = {}
    if cfg.frontend == "audio":
        kw["enc_embeds"] = torch.from_numpy((rng.standard_normal(
            (shape[0], cfg.encoder_len, cfg.d_model)) * 0.1).astype(
                np.float32)).to(DEVICE)
    return torch.from_numpy(toks).to(DEVICE), kw


def lm_free(torch):
    """Return the freed blocks to the card (callers ``del`` theirs first)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm(torch, np):
    """Phase 11: LM serving on the card (module docstring)."""
    from repro_torch import configs
    from repro_torch import models
    from repro_torch.models import moe, transformer
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import scheduler

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for float32 matmuls")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    out = []
    rng = np.random.default_rng(LM_SEED)

    # ---- LM_MAIN at full width and depth
    torch.cuda.reset_peak_memory_stats()
    cfg, model, info = lm_model(torch, configs, models, LM_MAIN)
    log(f"lm {LM_MAIN}: {info['params']} params, {info['param_bytes']} "
        f"bytes, {cfg.n_layers} layers, d_model {cfg.d_model}, init "
        f"{info['init_ms']:.1f} ms")
    new = LM_MAIN_NEW
    eng = engine_mod.Engine(model, LM_SLOTS, LM_MAIN_PROMPT + new + 16)
    prompts, kw = lm_inputs(torch, np, cfg, (LM_SLOTS, LM_MAIN_PROMPT), rng)
    gen, info["greedy"] = lm_greedy_check(torch, moe, model, eng, prompts,
                                          new, kw)
    g = info["greedy"]
    log(f"lm {LM_MAIN} (a): generate_greedy {LM_SLOTS} x {LM_MAIN_PROMPT}"
        f" + {new}: {greedy_line(g)}")
    # (b) a stream: the (a) prompts and four random-length ones
    lo, hi = LM_STREAM_PROMPTS
    reqs = [(prompts[r].cpu().numpy(), new) for r in range(LM_SLOTS)]
    for _ in range(LM_STREAM_REQUESTS - LM_SLOTS):
        n = int(rng.integers(lo, hi))
        reqs.append((rng.integers(0, cfg.vocab, n).astype(np.int32), new))
    done, info["stream"] = lm_stream(torch, np, scheduler, eng, reqs)
    same = 0
    for r in range(LM_SLOTS):
        upto = g["clear_until"][r]
        check(done[r].output[:upto] == gen[r, :upto].tolist(),
              f"stream request {r} differs from generate_greedy")
        same += upto
    st = info["stream"]
    log(f"lm {LM_MAIN} (b): Scheduler {LM_SLOTS} slots, "
        f"{st['requests']} requests: {st['ticks']} ticks, {st['tokens']} "
        f"tokens in {st['wall_ms']:.1f} ms, {st['ms_per_tick']:.2f} ms "
        f"per tick, {st['tokens_per_s']:.1f} tokens/s; {same} tokens equal"
        f" to generate_greedy's")
    del eng, done
    lm_free(torch)
    # (c) a prefill past 2 * attn_chunk: chunked against full attention
    b, s = LM_LONG
    check(s > 2 * cfg.attn_chunk, "the long prefill does not chunk")
    long_eng = engine_mod.Engine(model, b, s)
    toks, _ = lm_inputs(torch, np, cfg, LM_LONG, rng)
    (last, long_cache), long_ms = timed(
        torch, lambda: long_eng.prefill(toks, long_eng.new_cache()))
    del long_cache
    full_cfg = cfg.replace(attn_chunk=s)
    with torch.inference_mode():
        full = transformer.forward(model, full_cfg, toks)[0][:, -1]
    err = rel_err(torch, last, full)
    check(err <= LM_TOL, f"chunked vs full attention {err:.3e}")
    info["long"] = dict(shape=list(LM_LONG), prefill_ms=long_ms,
                        rel_err_vs_full_attention=err)
    log(f"lm {LM_MAIN} (c): prefill {b} x {s} (chunked attention, chunk "
        f"{cfg.attn_chunk}) {long_ms:.1f} ms; last logits vs full "
        f"attention max rel err {err:.3e}")
    del long_eng, last, full
    lm_free(torch)
    # (d) the same weights on the CPU
    cpu = model.copy_to("cpu")
    toks, _ = lm_inputs(torch, np, cfg, LM_CPU_TOKENS, rng)
    with torch.inference_mode():
        on_card = model(toks)[0]
        on_cpu = cpu(toks.cpu())[0]
    err = rel_err(torch, on_card.cpu(), on_cpu)
    check(err <= LM_TOL, f"card vs CPU {err:.3e}")
    info["cpu_rel_err"] = err
    log(f"lm {LM_MAIN} (d): {LM_CPU_TOKENS[0]} x {LM_CPU_TOKENS[1]} "
        f"forward, card vs CPU max rel err {err:.3e}")
    info["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"lm {LM_MAIN}: peak {info['peak_bytes']} bytes allocated")
    out.append(info)
    del cpu, model
    lm_free(torch)

    # ---- the other cache kinds
    for arch in LM_OTHERS:
        torch.cuda.reset_peak_memory_stats()
        cfg, model, info = lm_model(torch, configs, models, arch)
        new = LM_OTHER_NEW
        eng = engine_mod.Engine(model, LM_SLOTS, LM_OTHER_PROMPT + new)
        prompts, kw = lm_inputs(torch, np, cfg, (LM_SLOTS, LM_OTHER_PROMPT),
                                rng)
        gen, info["prefill_ms"] = lm_generate_smoke(torch, eng, prompts, new,
                                                    kw)
        log(f"lm {arch}: {info['params']} params, {info['param_bytes']} "
            f"bytes, {cfg.n_layers} layers (full depth); generate_greedy "
            f"{LM_SLOTS} x {LM_OTHER_PROMPT} + {new}: prefill "
            f"{info['prefill_ms']:.2f} ms")
        if cfg.frontend != "audio":
            reqs = [(prompts[r].cpu().numpy(), new) for r in range(LM_SLOTS)]
            _, info["stream"] = lm_stream(torch, np, scheduler, eng, reqs)
            st = info["stream"]
            log(f"lm {arch}: Scheduler {LM_SLOTS} slots, {st['requests']} "
                f"requests: {st['ticks']} ticks, {st['tokens']} tokens in "
                f"{st['wall_ms']:.1f} ms, {st['ms_per_tick']:.2f} ms per "
                f"tick, {st['tokens_per_s']:.1f} tokens/s")
        info["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"lm {arch}: peak {info['peak_bytes']} bytes allocated")
        del eng, model, gen
        lm_free(torch)
        # the checks, at one pattern period (full width)
        period = cfg.replace(n_layers=cfg.pattern_period)
        model = models.Model(period, seed=LM_SEED)
        eng = engine_mod.Engine(model, LM_SLOTS, LM_OTHER_PROMPT + new)
        gen, info["one_period"] = lm_greedy_check(
            torch, moe, model, eng, prompts, new, kw,
            tol=LM_PERIOD_TOL.get(arch, LM_TOL))
        log(f"lm {arch} cut to one pattern period ({period.n_layers} "
            f"layers): {greedy_line(info['one_period'])}")
        if cfg.moe is not None:
            c = info["cpu_decode"] = lm_cpu_decode_check(
                torch, moe, engine_mod, eng, prompts, gen, kw)
            log(f"lm {arch} cut to one pattern period: card vs CPU, "
                f"{c['steps']} steps (prefill and decode), routing equal, "
                f"max rel err {c['max_rel_err']:.3e} (tolerance "
                f"{c['tol']:.1e}); choices dropped per step {c['dropped']}")
        del eng, model, gen
        lm_free(torch)
        out.append(info)
    return out


# ---------------------------------------------------------- LM training

def tree_tensors(tree):
    """The tensors of a tree of dicts and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree]


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cpu_tree(v) for v in tree)
    return tree.to("cpu")


def train_grads(step_lib, model, tcfg, batch):
    """(gradients, metrics as floats) of one batch."""
    g, m = step_lib.grads_of(model, tcfg, batch)
    return g, {k: float(v) for k, v in m.items()}


def leaf_rel_err(torch, got, want):
    """The largest over the tensors of max |got - want| / max |want|."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach(), b.detach()
        b = b.to(a.device)
        scale = float(torch.max(torch.abs(b)))
        err = float(torch.max(torch.abs(a.float() - b.float())))
        worst = max(worst, err / scale if scale else err)
    return worst


def adamw_excess(torch, model, ps_a, ps_b, opt_a, opt_b, p0, lr, count):
    """How far two AdamW steps from the same parameters ``p0`` disagree
    beyond what their own ``m`` and ``v`` explain: the largest, over the
    elements, of |p_a - p_b| - (lr |u_a - u_b| + 2e-6 (|p0| + lr (|u_b| +
    1))), with u = m^/(sqrt(v^) + eps) in float64 (``tests/
    test_torch_train.py``).  At most 0 when they agree."""
    from repro_torch.models.params import stacked_leaves
    worst = -float("inf")
    i = 0
    for path, _, ts in stacked_leaves(model):
        ms = []
        for tree in (opt_a["m"], opt_a["v"], opt_b["m"], opt_b["v"]):
            for seg in path:
                tree = tree[seg]
            ms.append(tree)
        dev = ts[0].device
        bc1, bc2 = 1 - 0.9 ** count, 1 - 0.95 ** count
        for r in range(len(ts)):
            rows = [x[r] if "layers" in path else x for x in ms]
            ma, va, mb, vb = (x.to(dev, torch.float64) for x in rows)
            ua = (ma / bc1) / (torch.sqrt(va / bc2) + 1e-8)
            ub = (mb / bc1) / (torch.sqrt(vb / bc2) + 1e-8)
            pa, pb, p = (x[i].detach().to(dev, torch.float64)
                         for x in (ps_a, ps_b, p0))
            bound = lr * torch.abs(ua - ub) + 2e-6 * (
                torch.abs(p) + lr * (torch.abs(ub) + 1))
            worst = max(worst, float(torch.max(torch.abs(pa - pb) - bound)))
            i += 1
    return worst


def train_rank(mesh, x, steps):
    """Phase 12 (f) on one rank (run by ``distributed.launch``):
    ``compressed_psum`` of this rank's row of ``x`` and compressed training
    of reduced TRAIN_MAIN.  Returns host values only."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import step as step_lib

    dev = mesh.device
    row = torch.from_numpy(x[mesh.rank]).to(dev)
    got = step_lib.compressed_psum(row, mesh.group)
    want = torch.from_numpy(x.mean(axis=0)).to(dev)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    cfg = reduced(get_config(TRAIN_MAIN))
    model = Model(cfg, device=dev, seed=LM_SEED)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=40)
    grads_fn = step_lib.build_compressed_grads(model, tcfg, mesh.group)
    opt = opt_lib.adamw_init(model)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=4)
    losses = []
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(i).items()}
        g, m = grads_fn(model, b)
        g, _ = opt_lib.clip_by_global_norm(g, 1.0)
        opt_lib.adamw_update(g, opt, model, lr=1e-2)
        losses.append(float(m["loss"]))
    return dict(rank=mesh.rank, backend=mesh.backend, device=str(dev),
                psum_rel_err=rel, losses=losses)


def phase_lm_train(torch, np):
    """Phase 12: LM training on the card (the module docstring)."""
    import os
    import tempfile
    from repro_torch import configs
    from repro_torch.core import distributed
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    from repro_torch.models.params import (flat_params, state_from_reference,
                                           state_to_reference)
    from repro_torch.train import step as step_lib
    from repro_torch.train.checkpoint import CheckpointManager

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for float32 matmuls")
    out = {}
    cfg = configs.get_config(TRAIN_MAIN)

    # (a) the trainer's main path at full width and depth
    lm_free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = train_mod.main([
        "--arch", TRAIN_MAIN, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--lr", str(TRAIN_LR), "--log-every", "5"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = state["params"]
    check(model.device.type == "cuda", f"trained on {model.device}")
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS, f"{len(hist)} of {TRAIN_STEPS} steps")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), "a loss or grad_norm is not finite")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first5, f"loss did not fall: first five {first5:.4f}, "
                          f"last five {last5:.4f}")
    ms = [h["ms"] for h in hist]
    steady = float(np.median(ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop = 6.0 * model.n_params() * tokens
    out["main"] = dict(
        arch=TRAIN_MAIN, params=model.n_params(), batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR, wall_s=wall,
        first_step_ms=ms[0], median_step_ms=steady, step_ms=ms,
        tokens_per_s=tokens / (steady / 1e3), flop_per_step=flop,
        bound_ms=flop / OPS_PER_S * 1e3, peak_bytes=peak, losses=losses,
        grad_norms=[h["grad_norm"] for h in hist],
        first5_mean=first5, last5_mean=last5)
    log(f"train {TRAIN_MAIN} (a): {model.n_params()} params, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall:.1f} s: "
        f"first step {ms[0]:.1f} ms, median {steady:.1f} ms "
        f"({tokens / (steady / 1e3):.0f} tokens/s; bound "
        f"{flop / OPS_PER_S * 1e3:.1f} ms = 6 N T / 67 TFLOP/s), peak "
        f"{peak} bytes; loss {losses[0]:.4f} -> {losses[-1]:.4f} (first "
        f"five {first5:.4f}, last five {last5:.4f})")
    log(f"train {TRAIN_MAIN} (a) losses {[round(x, 4) for x in losses]}")
    del state, model, hist
    lm_free(torch)

    # (b) one step, the same weights on the card and on the CPU
    tcfg = configs.TrainConfig(learning_rate=TRAIN_CMP_LR, warmup_steps=0,
                               total_steps=10)
    card = Model(cfg, seed=LM_SEED)
    cpu = card.copy_to("cpu")
    rng = np.random.default_rng(LM_SEED)
    toks = rng.integers(0, cfg.vocab, TRAIN_CPU_TOKENS).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, axis=1)),
             "mask": torch.ones(TRAIN_CPU_TOKENS)}
    card_batch = {k: v.to(DEVICE) for k, v in batch.items()}
    g_card, _ = train_grads(step_lib, card, tcfg, card_batch)
    g_cpu, _ = train_grads(step_lib, cpu, tcfg, batch)
    grad_err = leaf_rel_err(torch, g_card, g_cpu)
    del g_card, g_cpu
    p0 = [p.detach().clone() for p in flat_params(cpu)]
    st_card, met_card = step_lib.build_train_step(card, tcfg)(
        step_lib.init_state(card, tcfg), card_batch)
    st_cpu, met_cpu = step_lib.build_train_step(cpu, tcfg)(
        step_lib.init_state(cpu, tcfg), batch)
    metric_err = {k: abs(float(met_card[k]) - float(met_cpu[k]))
                  / max(abs(float(met_cpu[k])), 1e-30) for k in met_cpu}
    excess = adamw_excess(torch, card, flat_params(card), flat_params(cpu),
                          st_card["opt"], st_cpu["opt"], p0, TRAIN_CMP_LR, 1)
    out["card_vs_cpu"] = dict(tokens=list(TRAIN_CPU_TOKENS),
                              lr=TRAIN_CMP_LR, grad_rel_err=grad_err,
                              metric_rel_err=metric_err,
                              param_excess=excess)
    log(f"train {TRAIN_MAIN} (b): one step {TRAIN_CPU_TOKENS[0]} x "
        f"{TRAIN_CPU_TOKENS[1]}, card vs CPU: metrics max rel err "
        f"{max(metric_err.values()):.3e} {metric_err} (tolerance "
        f"{TRAIN_METRIC_TOL:.0e}); gradients {grad_err:.3e} of their "
        f"leaf's range (tolerance {TRAIN_GRAD_TOL:.0e}); parameters beyond "
        f"their m/v bound by {excess:.3e}")
    for k in ("loss", "nll", "grad_norm"):
        check(metric_err[k] <= TRAIN_METRIC_TOL,
              f"card vs CPU {k}: {metric_err[k]:.3e}")
    check(grad_err <= TRAIN_GRAD_TOL, f"card vs CPU gradients {grad_err:.3e}")
    check(excess <= 0, f"card vs CPU parameters beyond the bound by "
                       f"{excess:.3e}")
    del st_cpu, cpu, p0, st_card
    lm_free(torch)

    # (c) remat at (a)'s batch: the same gradients, less memory
    from repro_torch.data.synthetic import SyntheticLM
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=LM_SEED)
    big = {k: torch.from_numpy(v).to(DEVICE)
           for k, v in data.batch_at(0).items()}
    remat = {}
    base = None
    for mode in ("none", "full", "dots"):
        card.cfg = cfg.replace(remat=mode)
        times = []
        for call in range(2):           # the second call warm
            g = None
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (g, m), ms_ = timed(torch, lambda: train_grads(
                step_lib, card, tcfg, big))
            times.append(ms_)
        peak_ = torch.cuda.max_memory_allocated()
        remat[mode] = dict(peak_bytes=peak_, resident_bytes=before,
                           activation_bytes=peak_ - before, ms=times[1],
                           first_ms=times[0], loss=m["loss"])
        if base is None:
            base = g
        else:
            remat[mode]["grad_rel_err"] = leaf_rel_err(torch, g, base)
        del g
    card.cfg = cfg
    del base
    out["remat"] = remat
    log(f"train {TRAIN_MAIN} (c): gradients of {TRAIN_BATCH} x {TRAIN_SEQ}"
        f" under remat: " + "; ".join(
            f"{k}: peak {v['peak_bytes']} bytes, {v['activation_bytes']} "
            f"above the {v['resident_bytes']} resident before, "
            f"{v['ms']:.1f} ms (first call {v['first_ms']:.1f} ms)"
            + (f", vs none {v['grad_rel_err']:.3e}" if "grad_rel_err" in v
               else "") for k, v in remat.items()))
    for mode in ("full", "dots"):
        check(remat[mode]["grad_rel_err"] <= TRAIN_REMAT_TOL,
              f"remat {mode} gradients {remat[mode]['grad_rel_err']:.3e}")
        check(remat[mode]["activation_bytes"] <
              remat["none"]["activation_bytes"],
              f"remat {mode} did not lower the peak")
    lm_free(torch)

    # (d) microbatch=TRAIN_MICRO against none: the accumulated gradients,
    # and one step's parameters within what each one's m and v give
    card.init(LM_SEED)
    p0 = [p.detach().to("cpu", copy=True) for p in flat_params(card)]
    runs = {}
    for micro in (0, TRAIN_MICRO):
        mcfg = configs.TrainConfig(learning_rate=TRAIN_CMP_LR,
                                   warmup_steps=0, total_steps=10,
                                   microbatch=micro)
        card.init(LM_SEED)
        g, _ = train_grads(step_lib, card, mcfg, big)
        g = [x.to("cpu") for x in g]
        st, met = step_lib.build_train_step(card, mcfg)(
            step_lib.init_state(card, mcfg), big)
        runs[micro] = dict(
            grads=g, loss=float(met["loss"]),
            params=[p.detach().to("cpu", copy=True)
                    for p in flat_params(card)],
            opt=_cpu_tree(st["opt"]))
        del st, g
        lm_free(torch)
    a, b = runs[TRAIN_MICRO], runs[0]
    grad_err = leaf_rel_err(torch, a["grads"], b["grads"])
    diff = max(float(torch.max(torch.abs(x - y)))
               for x, y in zip(a["params"], b["params"]))
    over = sum(int(torch.sum(torch.abs(x - y) > TRAIN_MICRO_TOL))
               for x, y in zip(a["params"], b["params"]))
    excess = adamw_excess(torch, card, a["params"], b["params"], a["opt"],
                          b["opt"], p0, TRAIN_CMP_LR, 1)
    out["microbatch"] = dict(microbatch=TRAIN_MICRO, lr=TRAIN_CMP_LR,
                             grad_rel_err=grad_err, max_param_diff=diff,
                             params_over_1e_4=over, param_excess=excess,
                             loss=[b["loss"], a["loss"]])
    log(f"train {TRAIN_MAIN} (d): microbatch {TRAIN_MICRO} vs none, one "
        f"step of {TRAIN_BATCH} x {TRAIN_SEQ} at lr {TRAIN_CMP_LR:g}: "
        f"gradients {grad_err:.3e} of their leaf's range (tolerance "
        f"{TRAIN_GRAD_TOL:.0e}); parameters max diff {diff:.3e}, {over} "
        f"element(s) past {TRAIN_MICRO_TOL:.0e}, beyond their m/v bound by "
        f"{excess:.3e}; loss {b['loss']:.6f} / {a['loss']:.6f}")
    check(grad_err <= TRAIN_GRAD_TOL,
          f"microbatch gradients differ {grad_err:.3e}")
    check(excess <= 0, f"microbatch parameters beyond the bound by "
                       f"{excess:.3e}")
    del card, runs, big, p0
    lm_free(torch)

    # (e) crash and resume at reduced size
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
               "--max-restarts", "2", "--",
               sys.executable, "-m", "repro_torch.launch.train",
               "--arch", TRAIN_MAIN, "--reduced", "--device", "cuda",
               "--steps", "50", "--batch", "2", "--seq", "32",
               "--ckpt-dir", tmp, "--ckpt-every", "20",
               "--crash-at-step", "30"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600)
        sup_s = time.perf_counter() - t0
        check(run.returncode == 0, f"supervisor exit {run.returncode}: "
                                   f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
        for line in ("[train] injected crash at step 30",
                     "[train] resumed from step 20", "[train] done"):
            check(line in run.stdout, f"supervisor run lacks {line!r}")
    rcfg = configs.reduced(cfg)
    rt = configs.TrainConfig(learning_rate=1e-3)
    rdata = SyntheticLM(vocab=rcfg.vocab, seq_len=32, global_batch=4, seed=9)

    def run_steps(st, lo, hi):
        fn = step_lib.build_train_step(st["params"], rt)
        for i in range(lo, hi):
            st, _ = fn(st, {k: torch.from_numpy(v).to(DEVICE)
                            for k, v in rdata.batch_at(i).items()})
        return st

    # exact resume needs the same sums: deterministic kernels for the
    # embedding's and the loss's index backward (atomics otherwise)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mid, hi = TRAIN_RESUME
        straight = run_steps(step_lib.init_state(
            Model(rcfg, seed=2), rt), 0, hi)
        s_mid = run_steps(step_lib.init_state(Model(rcfg, seed=2), rt),
                          0, mid)
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            mgr = CheckpointManager(tmp)
            mgr.save(s_mid, mid, blocking=True)
            fresh = Model(rcfg, seed=3)
            tree, step = mgr.restore(step_lib.abstract_state(fresh, rt))
        resumed = run_steps(state_from_reference(fresh, tree), step, hi)
    finally:
        torch.use_deterministic_algorithms(False)
    resume_diff = max(float(torch.max(torch.abs(x.float() - y.float())))
                      for x, y in zip(tree_tensors(state_to_reference(
                          straight)), tree_tensors(state_to_reference(
                              resumed))))
    out["resume"] = dict(supervisor_s=sup_s, straight=hi, checkpoint=mid,
                         max_diff=resume_diff)
    log(f"train {TRAIN_MAIN} reduced (e): supervisor crash at 30, resumed "
        f"from 20, done in {sup_s:.1f} s; {hi} straight steps vs {mid} + "
        f"checkpoint + restore + {hi - mid}: max diff {resume_diff:.3e} "
        f"(tolerance {TRAIN_RESUME_TOL:.0e})")
    check(resume_diff <= TRAIN_RESUME_TOL,
          f"resumed state differs by {resume_diff:.3e}")

    # (f) int8 compressed gradients on TRAIN_RANKS ranks over gloo
    x = (np.random.default_rng(LM_SEED).standard_normal(
        (TRAIN_RANKS, TRAIN_COMPRESS_ROWS)) * 0.02).astype(np.float32)
    t0 = time.perf_counter()
    ranks = distributed.launch(train_rank, TRAIN_RANKS, x,
                               TRAIN_COMPRESS_STEPS, device=DEVICE)
    comp_s = time.perf_counter() - t0
    losses = ranks[0]["losses"]
    check(all(r["losses"] == losses for r in ranks),
          "the ranks' losses differ")
    rel = max(r["psum_rel_err"] for r in ranks)
    out["compression"] = dict(ranks=TRAIN_RANKS, backend=ranks[0]["backend"],
                              psum_rel_err=rel, losses=losses, wall_s=comp_s)
    log(f"train (f): {TRAIN_RANKS} ranks over {ranks[0]['backend']} on "
        f"{ranks[0]['device']}: compressed_psum of {TRAIN_COMPRESS_ROWS} "
        f"values vs the mean, rel err {rel:.3e} (limit 0.05); compressed "
        f"training of reduced {TRAIN_MAIN}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} in {TRAIN_COMPRESS_STEPS} steps, {comp_s:.1f} s")
    check(rel < 0.05, f"compressed_psum rel err {rel:.3e}")
    check(losses[-1] < losses[0] - 0.3,
          f"compressed training: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


# phase 13 (a): the prediction, in a process of its own (the dry run's
# fake process group is process-wide); argv[1] is [arch, lr, {name:
# [shape, dtype]}] of the real step's batch
DRY_PREDICT = """
import json, sys, torch
from repro_torch import configs
from repro_torch.launch import dryrun
arch, lr, shapes = json.loads(sys.argv[1])
batch = {k: torch.empty(shape, dtype=getattr(torch, dt), device="meta")
         for k, (shape, dt) in shapes.items()}
pred = dryrun.predict_step(configs.get_config(arch),
                           configs.TrainConfig(learning_rate=lr), batch)
print("PREDICTION " + json.dumps(pred), flush=True)
"""


def dry_env():
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def dry_cells(cells, cells_dir):
    """Phase 13 (b): wait for the production-mesh cells and read them."""
    stdout, stderr = cells.communicate(timeout=DRY_TIMEOUT_S)
    check(cells.returncode == 0, f"launch.dryrun exit {cells.returncode}: "
                                 f"{stdout[-2000:]}{stderr[-2000:]}")
    got = {}
    for arch in DRY_ARCHS:
        for shape in DRY_SHAPES:
            tag = f"{arch}__{shape}__16x16"
            rec = json.loads((cells_dir / f"{tag}.json").read_text())
            check(rec["status"] == "ok",
                  f"dry run {tag}: {rec['status']} "
                  f"{rec.get('error', rec.get('reason', ''))}")
            mem = rec["memory"]
            got[tag] = dict(
                argument_bytes=mem["argument_bytes"],
                peak_bytes=mem["peak_bytes"], temp_bytes=mem["temp_bytes"],
                output_bytes=mem["output_bytes"],
                flops_per_device=rec["flops_per_device"],
                op_bytes_per_device=rec["op_bytes_per_device"],
                wire_bytes=rec["collectives_scaled"]["wire_bytes"],
                collective_ops=rec["collective_ops"], fits=rec["fits"],
                trace_s=rec["trace_sec"], wall_s=rec["wall_sec"])
            log(f"dry run (b) {tag}: per device {mem['argument_bytes']} "
                f"argument bytes, peak {mem['peak_bytes']} bytes (fits "
                f"this card: {rec['fits']}), {rec['flops_per_device']:.4e} "
                f"FLOPs, {rec['collectives_scaled']['wire_bytes']:.4e} wire "
                f"bytes in {rec['collective_ops']}, traced in "
                f"{rec['trace_sec']} s ({rec['wall_sec']} s the cell)")
            check(rec["flops_per_device"] > 0, f"{tag}: no FLOPs")
    return got


def phase_dryrun(torch, np):
    """Phase 13: the dry run (the module docstring)."""
    import shutil
    import tempfile
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import step as step_lib

    out = {}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    cells_dir = pathlib.Path(tempfile.mkdtemp(dir=scratch))
    t_cells = time.perf_counter()
    cells = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(DRY_ARCHS), "--shape", ",".join(DRY_SHAPES), "--out",
         str(cells_dir)], env=dry_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # (a) the prediction, then the real step it predicts
        cfg = configs.get_config(TRAIN_MAIN)
        tcfg = configs.TrainConfig(learning_rate=TRAIN_LR)
        host = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH,
                           seed=LM_SEED).batch_at(0)
        shapes = {k: [list(v.shape), v.dtype.name] for k, v in host.items()}
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", DRY_PREDICT,
             json.dumps([TRAIN_MAIN, TRAIN_LR, shapes])], env=dry_env(),
            capture_output=True, text=True, timeout=DRY_TIMEOUT_S)
        predict_s = time.perf_counter() - t0
        check(run.returncode == 0, f"predict_step exit {run.returncode}: "
                                   f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("PREDICTION ")][-1]
        pred = json.loads(line[len("PREDICTION "):])

        lm_free(torch)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        model = Model(cfg, seed=LM_SEED)
        state = step_lib.init_state(model, tcfg)
        torch.cuda.synchronize()
        state_bytes = torch.cuda.memory_allocated() - before
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        fn = step_lib.build_train_step(model, tcfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            state, met = fn(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before
        flops = fc.get_total_flops()
        loss = float(met["loss"])
        del state, model, batch, met, fn
        lm_free(torch)
        peak_err = (peak - pred["peak_bytes"]) / pred["peak_bytes"]
        out["predict"] = dict(
            arch=TRAIN_MAIN, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            predicted=pred, predict_s=predict_s, state_bytes=state_bytes,
            flops=flops, peak_bytes=peak, peak_rel_err=peak_err,
            step_ms=step_ms, loss=loss)
        log(f"dry run (a) {TRAIN_MAIN} at {TRAIN_BATCH} x {TRAIN_SEQ}: "
            f"predicted on meta tensors in {predict_s:.1f} s (traced "
            f"{pred['trace_sec']} s): state {pred['state_bytes']} bytes, "
            f"{pred['flops']:.0f} FLOPs, peak {pred['peak_bytes']} bytes; "
            f"the card: state {state_bytes} bytes, {flops} FLOPs, peak "
            f"{peak} bytes above the {before} allocated before "
            f"({peak_err:+.4%}), one step {step_ms:.1f} ms under "
            f"FlopCounterMode, loss {loss:.4f}")
        check(np.isfinite(loss), f"dry run (a): loss {loss}")
        check(state_bytes == pred["state_bytes"],
              f"state bytes {state_bytes} != predicted {pred['state_bytes']}")
        check(flops == pred["flops"],
              f"step FLOPs {flops} != predicted {pred['flops']}")
        check(abs(peak_err) <= DRY_PEAK_TOL,
              f"peak {peak} bytes is {peak_err:+.2%} off the predicted "
              f"{pred['peak_bytes']} (tolerance {DRY_PEAK_TOL:.0%})")
        # (b) the production-mesh cells, started first
        out["cells"] = dry_cells(cells, cells_dir)
        out["cells_wall_s"] = time.perf_counter() - t_cells
    finally:
        if cells.poll() is None:
            cells.kill()
            cells.wait()
        shutil.rmtree(cells_dir, ignore_errors=True)
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--times-only", action="store_true",
                    help="run only the build and the kernel times")
    ap.add_argument("--parts", action="store_true",
                    help="run only the build and the wavefront kernel's "
                         "parts: stores only, compute only, whole")
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
                                  components, dedup, distributed, graph,
                                  preprocess, shard, solver, telemetry)
    from repro_torch.kernels import bloom as bloom_kern
    from repro_torch.kernels import build
    from repro_torch.kernels import expand as expand_kern
    from repro_torch.kernels import mmw as mmw_kern
    from repro_torch.kernels import paths as paths_kern
    from repro_torch.kernels import wavefront as wavefront_kern
    from repro_torch.launch import twserved
    from repro_torch.serve import client as client_mod
    from repro_torch.serve import twscheduler

    kern = {"wavefront": wavefront_kern, "mmw": mmw_kern,
            "bloom": bloom_kern, "expand": expand_kern, "paths": paths_kern}
    ops = {name: mod.ops for name, mod in kern.items()}
    t_start = time.perf_counter()
    smi, reports = phase_device(build)
    if args.parts:
        parts = phase_parts(torch, np, bitset, graph, preprocess, solver,
                            batch, build, wavefront_kern.ops,
                            pathlib.Path(args.src).resolve().parent.name)
        print(smi, flush=True)
        print(json.dumps({"parts": parts, "src": args.src}), flush=True)
        return 0
    if args.times_only:
        log(f"times of the kernels under {args.src}")
        # a tree from before the multi-lane engine has no lane form
        has_lanes = hasattr(wavefront_kern.ops, "LAUNCHES_BY_LANES")
        times = phase_times(torch, np, bitset, graph, preprocess, solver,
                            batch, components, bloom, dedup, kern, reports,
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
                        components, bloom, dedup, kern, reports)
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
    t0 = time.perf_counter()
    dist_counts, dist_ranks = phase_distributed(torch, graph, solver,
                                                distributed, ops, walls)
    log(f"phase 10 (distributed) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm = phase_lm(torch, np)
    log(f"phase 11 (LM serving) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_train = phase_lm_train(torch, np)
    log(f"phase 12 (LM training) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = phase_dryrun(torch, np)
    dry["phase_s"] = time.perf_counter() - t0
    log(f"phase 13 (dry run) in {dry['phase_s']:.1f} s")
    worst["wavefront_lanes"] = max(worst["wavefront_lanes"],
                                   worst["shard_forms"]["wavefront_lanes"])
    worst["bloom_lanes"] = max(worst["bloom_lanes"],
                               worst["shard_forms"]["bloom_lanes"])
    # a lane row counts its kernel's launches on the lane and shard paths,
    # a single-lane row those on phase 3's paths and the heuristics path
    single = {**counts, f"heuristics={HEURISTICS}": heur_counts,
              **dist_counts}
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
            entry["distributed"] = {
                "launches_by_path": {p: c["wavefront"]
                                     for p, c in dist_counts.items()},
                "ranks": [{k: r[k] for k in ("rank", "backend", "device")}
                          | {"paths": {p: {k: v[k] for k in
                                           ("launches", "wall",
                                            "collective_calls",
                                            "collective_s")}
                                       for p, v in r["paths"].items()}}
                          for r in dist_ranks]}
        if name.endswith("_lanes"):
            entry["launches_by_path"] = {p: c[base] for p, c in paths.items()}
            entry["shard_launches_by_lanes"] = {
                p: lanes[base] for p, lanes in shard_lanes.items()}
            entry["serve_launches_by_lanes"] = {
                p: lanes[base] for p, lanes in serve_lanes.items()}
        if name == "wavefront_lanes":
            entry["launches_by_lanes_flags"] = LANES_FLAGS
            entry["launches_by_lanes"] = by_lanes
            entry["suite_walls_s"] = suite_walls
            entry["shard_walls_s"] = shard_walls
            entry["shard_counters"] = shard_stats_
            entry["serve"] = serve_info
        if name.startswith("wavefront"):
            entry["variants"] = [v for v in times[name][1:]
                                 if v["shape"] == main_shape["shape"]]
        if name.startswith("bloom"):
            entry.update({key: main_shape[key] for key in (
                "warm_ms", "scratch_bytes")})
        if name == "paths":
            entry["plan_ms"] = main_shape["plan_ms"]
            entry["variants"] = times[name][1:]
        kernels.append(entry)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"lm_serving": lm}), flush=True)
    print(json.dumps({"lm_training": lm_train}), flush=True)
    print(json.dumps({"dryrun": dry}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
