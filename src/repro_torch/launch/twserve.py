"""Treewidth solve service CLI of the PyTorch port: a request stream
through the continuous-batching lane scheduler
(``repro_torch.serve.twscheduler``).

    python -m repro_torch.launch.twserve --graphs myciel3,petersen,queen5_5
    python -m repro_torch.launch.twserve --graphs myciel4 --repeat 4 --lanes 4
    python -m repro_torch.launch.twserve --random 8 --lanes 8 --device cpu
    python -m repro_torch.launch.twserve --graphs petersen,queen5_5 \
        --device cpu --compare

Takes the flags of ``repro.launch.twserve``.  ``--device`` defaults to
``cuda`` and ``--backend`` to ``cuda`` on a card (the hand-written
kernels) or ``torch`` elsewhere (the plain ops); schedules other than
``doubling`` are rejected with a capability error before any work.

Every request is one graph; the scheduler packs all in-flight requests'
current deepening rungs into shared multi-lane dispatches (DESIGN.md
§10).  ``--compare`` additionally runs the same stream through
sequential per-request ``solver.solve`` calls, asserts result parity,
and reports the dispatch/sync reduction.

This CLI drains one fixed stream and exits; for the long-lived service
process (submit over TCP while dispatches are in flight, per-request
knobs, streamed rung events) see ``repro_torch.launch.twserved`` and its
client ``repro_torch.serve.client``.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", default="",
                    help="comma-separated generator names "
                         "(see core.graph.REGISTRY)")
    ap.add_argument("--random", type=int, default=0, metavar="N",
                    help="append N random gnp(n, p) requests")
    ap.add_argument("--n", type=int, default=14,
                    help="vertex count for --random instances")
    ap.add_argument("--p", type=float, default=0.3,
                    help="edge probability for --random instances")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1,
                    help="submit the stream this many times")
    ap.add_argument("--lanes", type=int, default=8,
                    help="lane pool size: max requests per shared dispatch")
    ap.add_argument("--cap", type=int, default=None,
                    help="frontier rows per lane (power of two). Default: "
                         "auto — batch.plan_capacity right-sizes each "
                         "dispatch from its largest lane's drop-free state "
                         "bound, <= the old fixed 2^17 default")
    ap.add_argument("--cap-max", type=int, default=None,
                    help="clamp for the auto-sized --cap (default 2^17)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="bound the whole lane pool's frontier memory; "
                         "pass 0 to read the device's free-memory stats")
    ap.add_argument("--block", type=int, default=1 << 11)
    ap.add_argument("--mode", default="sort", choices=["sort", "bloom"])
    ap.add_argument("--mmw", action="store_true")
    ap.add_argument("--simplicial", action="store_true",
                    help="enable simplicial-vertex branch collapse")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"],
                    help="op implementations (core.backend registry): "
                         "plain torch ops or the CUDA kernels. Default: "
                         "cuda on a CUDA device, torch elsewhere")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "ops)")
    ap.add_argument("--schedule", default=None,
                    choices=["doubling", "while", "linear", "matmul"])
    ap.add_argument("--reconstruct", action="store_true",
                    help="request a certified elimination order per solve")
    ap.add_argument("--shards", type=int, default=1,
                    help="scale every request out across this many pool "
                         "slots (sharded frontier + work donation; must "
                         "be <= --lanes)")
    ap.add_argument("--donate-ratio", type=float, default=None,
                    help="work-donation trigger for sharded requests "
                         "(default core.shard.DEFAULT_DONATE_RATIO)")
    ap.add_argument("--no-preprocess", action="store_true")
    ap.add_argument("--compare", action="store_true",
                    help="also solve the stream sequentially; assert "
                         "parity and report the dispatch reduction")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.core import backend as backend_lib
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import solver as solver_lib
    from repro_torch.core.bitset import n_words as bitset_words
    from repro_torch.serve.twscheduler import TwScheduler

    gs = []
    for name in filter(None, args.graphs.split(",")):
        if name not in graph_lib.REGISTRY:
            print(f"unknown graph {name!r}; known: "
                  f"{sorted(graph_lib.REGISTRY)}", file=sys.stderr)
            return 2
        gs.append(graph_lib.REGISTRY[name]())
    for i in range(args.random):
        gs.append(graph_lib.gnp(args.n, args.p, args.seed + i))
    gs = gs * max(1, args.repeat)
    if not gs:
        print("empty request stream: pass --graphs and/or --random",
              file=sys.stderr)
        return 2

    budget = None
    if args.budget_mb is not None:
        budget = "auto" if args.budget_mb == 0 \
            else int(args.budget_mb * 2**20)
    kw = dict(cap=args.cap, block=args.block, mode=args.mode,
              use_mmw=args.mmw, use_simplicial=args.simplicial,
              backend=args.backend, schedule=args.schedule,
              use_preprocess=not args.no_preprocess, device=args.device)
    if args.cap_max is not None:
        kw["cap_max"] = args.cap_max
    try:
        sched = TwScheduler(lanes=args.lanes, budget_bytes=budget,
                            donate_ratio=args.donate_ratio,
                            verbose=args.verbose, **kw)
    except backend_lib.BackendCapabilityError as e:
        print(f"[twserve] unsupported configuration: {e}", file=sys.stderr)
        return 2

    rids = [sched.submit(g, reconstruct=args.reconstruct,
                         shards=args.shards) for g in gs]
    engine_lib.reset_counters()
    t0 = time.time()
    done = sched.run()
    dt = time.time() - t0
    serve_counters = dict(engine_lib.COUNTERS)

    for rid, g in zip(rids, gs):
        r = done[rid]
        line = (f"[twserve] req {rid} ({g.name}): width={r.width} "
                f"exact={r.exact} lb={r.lb} ub={r.ub} "
                f"expanded={r.expanded}")
        if r.order is not None:
            line += f" order_width={solver_lib.order_width(g, r.order)}"
        print(line, flush=True)
    print(f"[twserve] {len(gs)} requests in {dt:.2f}s "
          f"({len(gs) / max(dt, 1e-9):.2f} req/s), "
          f"{sched.rounds} shared dispatches, "
          f"{serve_counters['dispatches']} total dispatches, "
          f"{serve_counters['host_syncs']} host syncs", flush=True)

    if args.compare:
        solve_kw = dict(kw)
        solve_kw.pop("cap_max", None)
        engine_lib.reset_counters()
        t0 = time.time()
        seq = [solver_lib.solve(g, reconstruct=args.reconstruct,
                                **solve_kw) for g in gs]
        seq_dt = time.time() - t0
        seq_counters = dict(engine_lib.COUNTERS)
        # bit-parity is only promised outside the §8/§10 padding caveats:
        # MMW sees padding rows, and bloom hashes over the padded word
        # count (lanes padded into a larger W than their solo run draw a
        # different Monte-Carlo false-positive set)
        one_word = len({bitset_words(g.n) for g in gs}) <= 1
        caveat_free = not args.mmw and (args.mode == "sort" or one_word)
        if caveat_free:
            for rid, g, a in zip(rids, gs, seq):
                b = done[rid]
                assert (a.width, a.exact, a.expanded) == \
                    (b.width, b.exact, b.expanded), (g.name, a, b)
            verdict = "parity OK"
        else:
            verdict = ("parity not asserted (MMW/bloom padding caveats, "
                       "DESIGN.md §10)")
        ratio = seq_counters["dispatches"] / \
            max(serve_counters["dispatches"], 1)
        print(f"[twserve] sequential: {seq_dt:.2f}s, "
              f"{seq_counters['dispatches']} dispatches -> {verdict}, "
              f"{ratio:.1f}x fewer dispatches batched", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
