"""Declarative sweep specs → open-loop arrival traces.

The paper evaluates on a hand-picked instance table; the serving North
Star needs *experiment-shaped* load — the parameter-space sweeps the
vnep-approx harness runs (``treewidth_computation_experiments``: nodes ×
connection probability × repetitions), mixed with named Table-1-style
instances, with per-request knob distributions and a duplicate-rate dial
that models real traffic's repeat submissions (the result cache's whole
reason to exist).

A **spec** is a plain dict (JSON-friendly)::

    {
      "seed": 7,
      "requests": 64,                       # total arrivals
      "arrival": {"kind": "poisson", "rate_hz": 40.0},
      "sweep":  {"nodes": [8, 10, 12], "p": [0.2, 0.4], "reps": 3},
      "named":  {"names": ["petersen", "myciel3"], "reps": 2},
      "duplicate_rate": 0.5,                # P(arrival repeats a root)
      "iso_rate": 0.25,                     # P(a duplicate is relabeled)
      "knobs":  {"mode": ["sort", "bloom"], "reconstruct": false}
    }

``SweepSpec.parse`` validates *everything up front* — a bad spec raises
``SpecError`` at parse time, never mid-replay.  ``generate`` expands the
spec into a list of :class:`Arrival`\\ s, each carrying its offset
``t`` (seconds from trace start), a self-contained graph payload
(``n`` + explicit edge list, so replay needs no generator state), its
submit knobs, and duplicate provenance (``dup_of`` = the root arrival's
index; ``iso`` marks a relabeled duplicate — same graph up to
isomorphism, byte-different adjacency, which only a *canonical* cache
key can hit).

Determinism: the whole trace is a pure function of the spec —
``generate(spec)`` twice, or in two processes, yields identical traces
(one ``random.Random(seed)`` drives every draw; G(n,p) instance seeds
are derived arithmetically from the spec seed and grid position, so the
graphs themselves are reproducible via ``graph.gnp``).

CLI::

    python -m repro_torch.workload.generator --quick --duplicate-rate 0.5 \\
        --out trace.jsonl
    python -m repro_torch.workload.generator --spec sweep.json --out trace.jsonl

Trace format: JSON lines — one meta header line, then one arrival per
line (``read_trace`` round-trips ``write_trace`` exactly).

A copy of ``repro.workload.generator`` over the port's own ``graph``, so
that the PyTorch port never imports ``repro``; a spec gives the same
trace bytes in both packages (``benchmarks/serve_load.py --trace`` reads
either).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.core import graph as graph_lib

# knobs an arrival may carry — the subset of the submit surface whose
# values are JSON primitives and make sense drawn from a distribution
KNOB_NAMES = ("reconstruct", "start_k", "mode", "use_mmw",
              "use_simplicial", "speculate", "shards", "priority",
              "heuristics", "seed", "no_cache")

_ARRIVAL_KINDS = ("uniform", "poisson")


class SpecError(ValueError):
    """A sweep spec failed validation — raised by ``SweepSpec.parse``
    with the offending field in the message, always before any replay
    starts."""


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A validated sweep spec (see the module docstring for the dict
    shape).  Construct via :meth:`parse` — the constructor itself does
    not validate."""
    seed: int
    requests: int
    arrival_kind: str                      # "uniform" | "poisson"
    gap_s: float                           # uniform: fixed gap
    rate_hz: float                         # poisson: arrival rate
    nodes: Tuple[int, ...]
    p: Tuple[float, ...]
    sweep_reps: int
    names: Tuple[str, ...]
    named_reps: int
    duplicate_rate: float
    iso_rate: float
    knobs: Dict[str, object]

    @staticmethod
    def parse(d: dict) -> "SweepSpec":
        _expect(isinstance(d, dict), f"spec must be a dict, got "
                f"{type(d).__name__}")
        known = {"seed", "requests", "arrival", "sweep", "named",
                 "duplicate_rate", "iso_rate", "knobs"}
        extra = set(d) - known
        _expect(not extra, f"unknown spec field(s) {sorted(extra)}; "
                f"known: {sorted(known)}")

        seed = d.get("seed", 0)
        _expect(isinstance(seed, int) and not isinstance(seed, bool),
                f"seed must be an int, got {seed!r}")

        arrival = d.get("arrival", {"kind": "uniform", "gap_s": 0.05})
        _expect(isinstance(arrival, dict), "arrival must be a dict")
        kind = arrival.get("kind", "uniform")
        _expect(kind in _ARRIVAL_KINDS,
                f"arrival.kind must be one of {_ARRIVAL_KINDS}, "
                f"got {kind!r}")
        gap_s = arrival.get("gap_s", 0.05)
        rate_hz = arrival.get("rate_hz", 20.0)
        _expect(isinstance(gap_s, (int, float)) and gap_s >= 0,
                f"arrival.gap_s must be >= 0, got {gap_s!r}")
        _expect(isinstance(rate_hz, (int, float)) and rate_hz > 0,
                f"arrival.rate_hz must be > 0, got {rate_hz!r}")

        sweep = d.get("sweep", {})
        _expect(isinstance(sweep, dict), "sweep must be a dict")
        nodes = tuple(sweep.get("nodes", ()))
        ps = tuple(sweep.get("p", ()))
        sweep_reps = sweep.get("reps", 1)
        for n in nodes:
            _expect(isinstance(n, int) and n >= 1,
                    f"sweep.nodes entries must be ints >= 1, got {n!r}")
        for p in ps:
            _expect(isinstance(p, (int, float)) and 0.0 <= p <= 1.0,
                    f"sweep.p entries must be in [0, 1], got {p!r}")
        _expect(isinstance(sweep_reps, int) and sweep_reps >= 1,
                f"sweep.reps must be an int >= 1, got {sweep_reps!r}")
        _expect(bool(nodes) == bool(ps),
                "sweep needs both nodes and p (or neither)")

        named = d.get("named", {})
        _expect(isinstance(named, dict), "named must be a dict")
        names = tuple(named.get("names", ()))
        named_reps = named.get("reps", 1)
        for nm in names:
            _expect(nm in graph_lib.REGISTRY,
                    f"named.names entry {nm!r} is not in graph.REGISTRY; "
                    f"known: {sorted(graph_lib.REGISTRY)}")
        _expect(isinstance(named_reps, int) and named_reps >= 1,
                f"named.reps must be an int >= 1, got {named_reps!r}")
        _expect(nodes or names,
                "spec generates no instances: give sweep.nodes + sweep.p "
                "and/or named.names")

        base_count = (len(nodes) * len(ps) * sweep_reps
                      + len(names) * named_reps)
        requests = d.get("requests", base_count)
        _expect(isinstance(requests, int) and requests >= 1,
                f"requests must be an int >= 1, got {requests!r}")

        duplicate_rate = d.get("duplicate_rate", 0.0)
        iso_rate = d.get("iso_rate", 0.0)
        for nm, v in (("duplicate_rate", duplicate_rate),
                      ("iso_rate", iso_rate)):
            _expect(isinstance(v, (int, float)) and 0.0 <= v <= 1.0,
                    f"{nm} must be in [0, 1], got {v!r}")

        knobs = d.get("knobs", {})
        _expect(isinstance(knobs, dict), "knobs must be a dict")
        for k, v in knobs.items():
            _expect(k in KNOB_NAMES,
                    f"unknown knob {k!r}; known: {sorted(KNOB_NAMES)}")
            if isinstance(v, list):
                _expect(len(v) >= 1, f"knob {k!r}: empty choice list")

        return SweepSpec(seed=int(seed), requests=int(requests),
                         arrival_kind=kind, gap_s=float(gap_s),
                         rate_hz=float(rate_hz), nodes=nodes,
                         p=tuple(float(p) for p in ps),
                         sweep_reps=int(sweep_reps), names=names,
                         named_reps=int(named_reps),
                         duplicate_rate=float(duplicate_rate),
                         iso_rate=float(iso_rate), knobs=dict(knobs))


@dataclasses.dataclass
class Arrival:
    """One trace entry: submit graph ``(n, edges)`` at offset ``t`` with
    ``knobs``.  ``dup_of`` is the index of the root arrival this one
    duplicates (None for fresh instances); ``iso`` marks a relabeled
    duplicate — isomorphic to its root, byte-different adjacency."""
    idx: int
    t: float
    name: str
    n: int
    edges: List[List[int]]
    knobs: Dict[str, object] = dataclasses.field(default_factory=dict)
    dup_of: Optional[int] = None
    iso: bool = False

    def graph(self) -> graph_lib.Graph:
        return graph_lib.from_edges(self.n, self.edges, name=self.name)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Arrival":
        return Arrival(idx=int(d["idx"]), t=float(d["t"]),
                       name=str(d["name"]), n=int(d["n"]),
                       edges=[[int(u), int(v)] for u, v in d["edges"]],
                       knobs=dict(d.get("knobs", {})),
                       dup_of=d.get("dup_of"),
                       iso=bool(d.get("iso", False)))


def _edge_list(g: graph_lib.Graph) -> List[List[int]]:
    return [[int(u), int(v)] for u in range(g.n)
            for v in range(u + 1, g.n) if g.adj[u][v]]


def _base_instances(spec: SweepSpec) -> List[Tuple[str, int,
                                                   List[List[int]]]]:
    """The fresh-instance pool: the full G(n,p) grid × reps, then the
    named mix × reps.  G(n,p) seeds are arithmetic in the grid position,
    so instance i of a spec is the same graph in every process."""
    out = []
    for ni, n in enumerate(spec.nodes):
        for pi, p in enumerate(spec.p):
            for rep in range(spec.sweep_reps):
                gseed = (spec.seed * 1000003 + ni * 10007
                         + pi * 101 + rep) % (1 << 32)
                g = graph_lib.gnp(n, p, seed=gseed)
                out.append((f"gnp{n}_p{p:g}_r{rep}", n, _edge_list(g)))
    for nm in spec.names:
        g = graph_lib.REGISTRY[nm]()
        edges = _edge_list(g)
        for rep in range(spec.named_reps):
            out.append((nm if spec.named_reps == 1 else f"{nm}_r{rep}",
                        g.n, edges))
    return out


def _draw_knobs(spec: SweepSpec, rng: random.Random) -> Dict[str, object]:
    """Fixed knob values pass through; list values are per-arrival
    uniform draws."""
    out = {}
    for k in sorted(spec.knobs):            # sorted: draw-order stability
        v = spec.knobs[k]
        out[k] = rng.choice(v) if isinstance(v, list) else v
    return out


def generate(spec: SweepSpec) -> List[Arrival]:
    """Expand a validated spec into its arrival trace (pure function of
    the spec; see the module docstring for the determinism contract).

    Arrival 0 is always fresh; each later slot is a duplicate with
    probability ``duplicate_rate`` — it repeats a uniformly chosen
    earlier *root* (fresh) arrival's graph and knobs, relabeled by a
    random vertex permutation with probability ``iso_rate``.  Fresh
    slots walk the shuffled instance pool, recycling it (new knob draws,
    same graphs) when ``requests`` exceeds the pool."""
    base = _base_instances(spec)
    rng = random.Random(spec.seed)
    rng.shuffle(base)
    arrivals: List[Arrival] = []
    roots: List[int] = []                   # indices of fresh arrivals
    t = 0.0
    fresh_i = 0
    for i in range(spec.requests):
        if i > 0:
            t += (spec.gap_s if spec.arrival_kind == "uniform"
                  else rng.expovariate(spec.rate_hz))
        if roots and rng.random() < spec.duplicate_rate:
            root = arrivals[rng.choice(roots)]
            iso = rng.random() < spec.iso_rate
            n, edges, name = root.n, root.edges, root.name
            if iso and n > 1:
                perm = list(range(n))
                rng.shuffle(perm)
                edges = sorted([sorted([perm[u], perm[v]])
                                for u, v in edges])
                name = f"{name}_iso"
            arrivals.append(Arrival(idx=i, t=round(t, 6), name=name, n=n,
                                    edges=[list(e) for e in edges],
                                    knobs=dict(root.knobs),
                                    dup_of=root.idx, iso=iso))
        else:
            name, n, edges = base[fresh_i % len(base)]
            fresh_i += 1
            arrivals.append(Arrival(idx=i, t=round(t, 6), name=name, n=n,
                                    edges=[list(e) for e in edges],
                                    knobs=_draw_knobs(spec, rng)))
            roots.append(i)
    return arrivals


# ------------------------------------------------------------------ traces

def write_trace(path: str, arrivals: List[Arrival],
                spec: Optional[SweepSpec] = None) -> None:
    """JSONL: one meta header line, then one arrival per line."""
    meta = {"trace": "twworkload", "version": 1,
            "arrivals": len(arrivals)}
    if spec is not None:
        meta["spec"] = dataclasses.asdict(spec)
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for a in arrivals:
            f.write(json.dumps(a.to_json()) + "\n")


def read_trace(path: str) -> List[Arrival]:
    """Inverse of ``write_trace`` (meta line optional, so hand-written
    traces replay too)."""
    arrivals = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "meta" in d:
                continue
            arrivals.append(Arrival.from_json(d))
    return arrivals


def quick_spec(duplicate_rate: float = 0.5, iso_rate: float = 0.25,
               requests: int = 16, seed: int = 0) -> SweepSpec:
    """The fast-tier spec: a small G(n,p) grid plus two light named
    instances, 20 ms uniform gaps — what CI's generated-trace smoke and
    ``benchmarks/cache_effect.py`` run."""
    return SweepSpec.parse({
        "seed": seed,
        "requests": requests,
        "arrival": {"kind": "uniform", "gap_s": 0.02},
        "sweep": {"nodes": [8, 10], "p": [0.25, 0.5], "reps": 1},
        "named": {"names": ["petersen", "myciel3"], "reps": 1},
        "duplicate_rate": duplicate_rate,
        "iso_rate": iso_rate,
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="expand a sweep spec into a serve_load arrival trace")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--spec", metavar="PATH",
                     help="JSON sweep spec (module docstring shape)")
    src.add_argument("--quick", action="store_true",
                     help="built-in fast-tier spec (quick_spec)")
    ap.add_argument("--requests", type=int, default=None,
                    help="override the spec's arrival count")
    ap.add_argument("--duplicate-rate", type=float, default=None,
                    help="override the spec's duplicate dial")
    ap.add_argument("--iso-rate", type=float, default=None,
                    help="override the spec's relabeled-duplicate dial")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the spec's seed")
    ap.add_argument("--out", metavar="PATH", default="wl_trace.jsonl",
                    help="trace output path (JSON lines)")
    args = ap.parse_args(argv)

    if args.quick:
        d = dataclasses.asdict(quick_spec())
        # re-nest the flat SweepSpec fields into the parse shape
        d = {"seed": d["seed"], "requests": d["requests"],
             "arrival": {"kind": d["arrival_kind"], "gap_s": d["gap_s"],
                         "rate_hz": d["rate_hz"]},
             "sweep": {"nodes": list(d["nodes"]), "p": list(d["p"]),
                       "reps": d["sweep_reps"]},
             "named": {"names": list(d["names"]), "reps": d["named_reps"]},
             "duplicate_rate": d["duplicate_rate"],
             "iso_rate": d["iso_rate"], "knobs": d["knobs"]}
    else:
        with open(args.spec, "r", encoding="utf-8") as f:
            d = json.load(f)
    if args.requests is not None:
        d["requests"] = args.requests
    if args.duplicate_rate is not None:
        d["duplicate_rate"] = args.duplicate_rate
    if args.iso_rate is not None:
        d["iso_rate"] = args.iso_rate
    if args.seed is not None:
        d["seed"] = args.seed

    try:
        spec = SweepSpec.parse(d)
    except SpecError as e:
        print(f"[workload] bad spec: {e}", file=sys.stderr)
        return 2
    arrivals = generate(spec)
    write_trace(args.out, arrivals, spec)
    dups = sum(1 for a in arrivals if a.dup_of is not None)
    isos = sum(1 for a in arrivals if a.iso)
    span = arrivals[-1].t if arrivals else 0.0
    print(f"[workload] {len(arrivals)} arrivals over {span:.2f}s -> "
          f"{args.out} ({dups} duplicates, {isos} relabeled)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
