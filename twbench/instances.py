"""Instance builders, frozen: a copy of ``repro_torch/core/graph.py``'s generators as of the benchmark's first version (queen, Mycielski, Kneser/Petersen, LCF cubic graphs, grid, G(n,p), relabelling).

The benchmark builds every input here, from its own code, and hands the
program plain ``(n, adjacency, name)`` triples, so a change to the
program's generators cannot move the yardstick.  ``Graph`` is the
minimal host graph the reference works on; ``to_program`` in
``twbench/drivers.py`` turns it into the program's own graph type.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    n: int
    adj: np.ndarray            # (n, n) bool, symmetric, zero diagonal
    name: str = "graph"

    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int32)

    def with_edges(self, extra: np.ndarray, name=None) -> "Graph":
        a = self.adj | extra | extra.T
        np.fill_diagonal(a, False)
        return Graph(self.n, a, name or self.name)

    def subgraph(self, vertices) -> "Graph":
        vertices = np.asarray(sorted(vertices))
        a = self.adj[np.ix_(vertices, vertices)]
        return Graph(len(vertices), a, f"{self.name}[{len(vertices)}]")

    def relabel(self, perm: np.ndarray) -> "Graph":
        """perm[i] = new label of old vertex i."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n)
        a = self.adj[np.ix_(inv, inv)]
        return Graph(self.n, a, self.name + "_perm")

    def edges(self) -> list:
        return [[int(u), int(v)] for u in range(self.n)
                for v in range(u + 1, self.n) if self.adj[u, v]]


def from_edges(n: int, edges, name="graph") -> Graph:
    a = np.zeros((n, n), dtype=bool)
    for u, v in edges:
        if u != v:
            a[u, v] = a[v, u] = True
    return Graph(n, a, name)


def complete(n: int) -> Graph:
    return from_edges(n, itertools.combinations(range(n), 2), f"K{n}")


def grid(rows: int, cols: int) -> Graph:
    def vid(r, c):
        return r * cols + c
    edges = []
    for r in range(rows):
        for c in range(cols):
            if r + 1 < rows:
                edges.append((vid(r, c), vid(r + 1, c)))
            if c + 1 < cols:
                edges.append((vid(r, c), vid(r, c + 1)))
    return from_edges(rows * cols, edges, f"grid{rows}x{cols}")


def queen(k: int) -> Graph:
    """k x k queen graph (vertices = squares, edges = queen moves)."""
    def vid(r, c):
        return r * k + c
    edges = []
    for r1, c1 in itertools.product(range(k), repeat=2):
        for r2, c2 in itertools.product(range(k), repeat=2):
            if (r1, c1) >= (r2, c2):
                continue
            if r1 == r2 or c1 == c2 or abs(r1 - r2) == abs(c1 - c2):
                edges.append((vid(r1, c1), vid(r2, c2)))
    return from_edges(k * k, edges, f"queen{k}_{k}")


def mycielski(g: Graph) -> Graph:
    n = g.n
    edges = []
    for u in range(n):
        for v in range(u + 1, n):
            if g.adj[u, v]:
                edges.append((u, v))
                edges.append((u, n + v))
                edges.append((v, n + u))
    for u in range(n):
        edges.append((n + u, 2 * n))
    return from_edges(2 * n + 1, edges, "mycielski")


def myciel(k: int) -> Graph:
    """DIMACS myciel-k: myciel3 has 11 vertices, myciel4 23, myciel5 47."""
    g = complete(2)
    for _ in range(k - 1):
        g = mycielski(g)
    return Graph(g.n, g.adj, f"myciel{k}")


def kneser(n: int, k: int) -> Graph:
    subs = list(itertools.combinations(range(n), k))
    sets = [frozenset(s) for s in subs]
    edges = [(i, j) for i in range(len(subs)) for j in range(i + 1, len(subs))
             if not (sets[i] & sets[j])]
    return from_edges(len(subs), edges, f"KneserGraph_{n}_{k}")


def petersen() -> Graph:
    g = kneser(5, 2)
    return Graph(g.n, g.adj, "PetersenGraph")


def lcf(n: int, pattern, reps: int, name: str) -> Graph:
    """LCF-notation cubic Hamiltonian graph: cycle 0..n-1 + chords."""
    edges = [(i, (i + 1) % n) for i in range(n)]
    seq = list(pattern) * reps
    assert len(seq) == n
    for i, jump in enumerate(seq):
        edges.append((i, (i + jump) % n))
    return from_edges(n, edges, name)


def mcgee() -> Graph:
    return lcf(24, [12, 7, -7], 8, "McGeeGraph")


def dyck() -> Graph:
    return lcf(32, [5, -5, 13, -13], 8, "DyckGraph")


def desargues() -> Graph:
    return lcf(20, [5, -5, 9, -9], 5, "DesarguesGraph")


def gnp(n: int, p: float, seed: int) -> Graph:
    rng = np.random.RandomState(seed)
    a = rng.rand(n, n) < p
    a = np.triu(a, 1)
    a = a | a.T
    return Graph(n, a, f"gnp_{n}_{p}_{seed}")


REGISTRY = {
    "mcgee": mcgee,
    "dyck": dyck,
    "petersen": petersen,
    "desargues": desargues,
    "myciel3": lambda: myciel(3),
    "myciel4": lambda: myciel(4),
    "myciel5": lambda: myciel(5),
    "queen5_5": lambda: queen(5),
    "queen6_6": lambda: queen(6),
    "queen7_7": lambda: queen(7),
    "grid6x6": lambda: grid(6, 6),
}


def permutation(n: int, seed: int, salt: int = 0) -> np.ndarray:
    """The vertex relabelling a run draws from its seed (any whole
    number, also past 32 bits) and an instance's position ``salt``."""
    rng = np.random.default_rng([int(seed) % (1 << 64), int(salt)])
    return rng.permutation(n)


def relabelled(name: str, seed: int, salt: int = 0) -> Graph:
    """Instance ``name`` relabelled by the seed's permutation; the name
    stays the instance's own."""
    g = REGISTRY[name]()
    h = g.relabel(permutation(g.n, seed, salt))
    return Graph(h.n, h.adj, name)
