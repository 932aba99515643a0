"""Treewidth solver CLI of the PyTorch port.

    python -m repro_torch.launch.solve --graph queen5_5
    python -m repro_torch.launch.solve --graph petersen --reconstruct
    python -m repro_torch.launch.solve --graph myciel4 --device cpu
    python -m repro_torch.launch.solve --graph queen5_5 --mode bloom --mmw
    python -m repro_torch.launch.solve --graph queen5_5 --simplicial
    python -m repro_torch.launch.solve --graph myciel4 --batch 4
    python -m repro_torch.launch.solve --graph queen6_6 --shards 4
    python -m repro_torch.launch.solve --graph queen5_5 --heuristics 4
    python -m repro_torch.launch.solve --graph queen6_6 --distributed
    python -m repro_torch.launch.solve --dimacs path/to/graph.gr

Takes the flags of ``repro.launch.solve``.  ``--device`` defaults to
``cuda`` and ``--backend`` to ``cuda`` on a card (the hand-written
kernels) or ``torch`` elsewhere (the plain ops).  ``--batch L`` decides L
consecutive rungs per dispatch (speculative deepening, same results).
``--shards S`` splits each rung's frontier across S shards (owner-hash
routing, work donation past ``--donate-ratio``; same results).
``--heuristics N`` runs N anytime bounds rounds, pinned by ``--seed``,
before each block's ladder.  ``--schedule`` picks the closure schedule;
the CUDA kernels run ``doubling`` only, the others run with ``--backend
torch``.

``--distributed`` runs ``core.distributed.solve_distributed`` with
``cap_local = cap // D`` (``--cap`` defaults to 2^18 there) and work
donation past ``--donate-ratio``.  ``--devices N`` starts N local ranks
on ``--device`` (rank r on card ``r % cards``; ``gloo`` when ranks share
a card or run on the CPU, ``nccl`` when each has its own); without it
the world is what the environment gives (``torchrun``'s ``RANK``,
``WORLD_SIZE``, ...), or one rank.  Rank 0 prints the result line.
Unsupported configurations are rejected with a capability error before
any work.
"""
from __future__ import annotations

import argparse
import sys


def _rank_solve(mesh, g, cap, kw):
    """One rank of ``--distributed --devices N``."""
    from repro_torch.core import distributed as dist_lib
    return dist_lib.solve_distributed(g, mesh, cap_local=cap // mesh.size,
                                      **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="",
                    help="generator name (see core.graph.REGISTRY)")
    ap.add_argument("--dimacs", default="", help="DIMACS/.gr file")
    ap.add_argument("--cap", type=int, default=None,
                    help="frontier rows per level (power of two). Default: "
                         "auto (core.batch.plan_capacity, clamped to 2^17)")
    ap.add_argument("--block", type=int, default=1 << 10)
    ap.add_argument("--mode", default="sort", choices=["sort", "bloom"])
    ap.add_argument("--engine", default="fused", choices=["fused", "host"],
                    help="wavefront driver: fused level loop or the "
                         "per-level host loop")
    ap.add_argument("--batch", type=int, default=1, metavar="LANES")
    ap.add_argument("--shards", type=int, default=1, metavar="S")
    ap.add_argument("--donate-ratio", type=float, default=None)
    ap.add_argument("--mmw", action="store_true")
    ap.add_argument("--simplicial", action="store_true")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"],
                    help="op implementations (core.backend registry): "
                         "plain torch ops or the CUDA kernels. Default: "
                         "cuda on a CUDA device, torch elsewhere")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "ops)")
    ap.add_argument("--schedule", default="doubling",
                    choices=["doubling", "while", "linear", "matmul"])
    ap.add_argument("--no-paths", action="store_true")
    ap.add_argument("--no-clique", action="store_true")
    ap.add_argument("--no-preprocess", action="store_true")
    ap.add_argument("--reconstruct", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--heuristics", type=int, default=0, metavar="N")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.core import backend as backend_lib
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import solver as solver_lib

    try:
        device = backend_lib.resolve_device(args.device)
        backend = args.backend or backend_lib.default_backend(device)
        backend_lib.validate(backend, mode=args.mode,
                             schedule=args.schedule, use_mmw=args.mmw,
                             use_simplicial=args.simplicial,
                             lanes=args.batch, shards=args.shards,
                             device=device)
    except backend_lib.BackendCapabilityError as e:
        print(f"[solve] unsupported configuration: {e}", file=sys.stderr)
        return 2

    if args.dimacs:
        g = graph_lib.read_dimacs(args.dimacs)
    elif args.graph in graph_lib.REGISTRY:
        g = graph_lib.REGISTRY[args.graph]()
    else:
        print(f"unknown graph {args.graph!r}; known: "
              f"{sorted(graph_lib.REGISTRY)}")
        return 2

    print(f"[solve] {g.name}: n={g.n} m={g.n_edges} device={device} "
          f"backend={backend}", flush=True)
    if args.devices and not args.distributed:
        print("[solve] --devices applies to --distributed only; ignoring "
              "it", file=sys.stderr)
    if args.distributed:
        from repro_torch.core import distributed as dist_lib
        if args.batch > 1:
            print("[solve] --batch applies to the single-device solver "
                  "only; ignoring it under --distributed", file=sys.stderr)
        cap = args.cap if args.cap is not None else 1 << 18
        kw = dict(block=args.block, use_mmw=args.mmw,
                  use_simplicial=args.simplicial, schedule=args.schedule,
                  backend=backend, use_clique=not args.no_clique,
                  use_paths=not args.no_paths,
                  use_preprocess=not args.no_preprocess,
                  verbose=args.verbose, engine=args.engine)
        if args.donate_ratio is not None:
            kw["donate_ratio"] = args.donate_ratio
        if args.devices:
            res = dist_lib.launch(_rank_solve, args.devices, g, cap, kw,
                                  device=device)[0]
        else:
            mesh = dist_lib.make_solver_mesh(device=args.device)
            res = _rank_solve(mesh, g, cap, kw)
            if mesh.rank != 0:
                return 0
    else:
        res = solver_lib.solve(
            g, cap=args.cap, block=args.block, mode=args.mode,
            use_mmw=args.mmw, backend=backend,
            use_simplicial=args.simplicial, schedule=args.schedule,
            use_clique=not args.no_clique, use_paths=not args.no_paths,
            use_preprocess=not args.no_preprocess,
            reconstruct=args.reconstruct, verbose=args.verbose,
            engine=args.engine, lanes=args.batch, shards=args.shards,
            donate_ratio=args.donate_ratio, heuristics=args.heuristics,
            seed=args.seed, device=device)

    print(f"[solve] treewidth={res.width} exact={res.exact} "
          f"lb={res.lb} ub={res.ub} states_expanded={res.expanded} "
          f"time={res.time_sec:.2f}s")
    if res.order is not None:
        width = solver_lib.order_width(g, res.order)
        print(f"[solve] elimination order verified: width={width}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
