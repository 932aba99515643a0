"""Graph representation + instance generators + DIMACS io (numpy).

A copy of ``repro.core.graph`` for the PyTorch port: the port never
imports ``repro``.  Everything here is host-side numpy; device tensors are
made from ``Graph.packed()`` with ``bitset.to_words``.

The solver operates on a packed adjacency matrix: ``adj_packed`` is an
``(n, W)`` uint32 array whose row ``v`` is the bitset N(v).  The numpy
boolean matrix is kept for host-side preprocessing.

Generators cover the reproducible subset of the paper's benchmark:
queen graphs, Mycielski graphs, Kneser graphs, LCF-notation cubic graphs
(McGee, Dyck), (torus) grids and seeded random families.  PACE protein /
BN instances are not redistributable offline (see DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
import itertools
import numpy as np

from . import bitset


@dataclasses.dataclass(frozen=True)
class Graph:
    n: int
    adj: np.ndarray            # (n, n) bool, symmetric, zero diagonal
    name: str = "graph"

    @property
    def n_edges(self) -> int:
        return int(self.adj.sum()) // 2

    @property
    def w(self) -> int:
        return bitset.n_words(self.n)

    def packed(self) -> np.ndarray:
        """(n, W) uint32 packed adjacency."""
        w = self.w
        out = np.zeros((self.n, w), dtype=np.uint32)
        vs, us = np.nonzero(self.adj)
        np.bitwise_or.at(out, (vs, us >> 5), np.uint32(1) << (us & 31).astype(np.uint32))
        return out

    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int32)

    def neighbors(self, v: int):
        return np.nonzero(self.adj[v])[0]

    def with_edges(self, extra: np.ndarray, name=None) -> "Graph":
        """Return a graph with additional edges OR-ed in (bool (n,n))."""
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


def from_edges(n: int, edges, name="graph") -> Graph:
    a = np.zeros((n, n), dtype=bool)
    for u, v in edges:
        if u != v:
            a[u, v] = a[v, u] = True
    return Graph(n, a, name)


# ---------------------------------------------------------------- generators

def path(n: int) -> Graph:
    return from_edges(n, [(i, i + 1) for i in range(n - 1)], f"path{n}")


def cycle(n: int) -> Graph:
    return from_edges(n, [(i, (i + 1) % n) for i in range(n)], f"cycle{n}")


def complete(n: int) -> Graph:
    return from_edges(n, itertools.combinations(range(n), 2), f"K{n}")


def complete_bipartite(a: int, b: int) -> Graph:
    return from_edges(a + b, [(i, a + j) for i in range(a) for j in range(b)],
                      f"K{a}_{b}")


def star(n: int) -> Graph:
    return from_edges(n, [(0, i) for i in range(1, n)], f"star{n}")


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


def torus_grid(rows: int, cols: int) -> Graph:
    def vid(r, c):
        return r * cols + c
    edges = []
    for r in range(rows):
        for c in range(cols):
            edges.append((vid(r, c), vid((r + 1) % rows, c)))
            edges.append((vid(r, c), vid(r, (c + 1) % cols)))
    return from_edges(rows * cols, edges, f"{rows}x{cols}_torusGrid")


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
    """Mycielski construction: tw grows, chromatic number grows, triangle-free kept."""
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
    """myciel-k in DIMACS naming: myciel3 is the 11-vertex Grotzsch graph,
    myciel4 has 23 vertices (tw 10), myciel5 has 47 (tw 19)."""
    g = complete(2)
    for _ in range(k - 1):
        g = mycielski(g)
    return Graph(g.n, g.adj, f"myciel{k}")


def kneser(n: int, k: int) -> Graph:
    """Kneser graph K(n, k): vertices = k-subsets, edges = disjoint pairs."""
    subs = list(itertools.combinations(range(n), k))
    sets = [frozenset(s) for s in subs]
    edges = [(i, j) for i in range(len(subs)) for j in range(i + 1, len(subs))
             if not (sets[i] & sets[j])]
    return from_edges(len(subs), edges, f"KneserGraph_{n}_{k}")


def petersen() -> Graph:
    g = kneser(5, 2)
    return Graph(g.n, g.adj, "PetersenGraph")


def lcf(n: int, pattern, reps: int, name: str) -> Graph:
    """LCF-notation cubic Hamiltonian graph: cycle 0..n-1 + chords i -> i+pattern."""
    edges = [(i, (i + 1) % n) for i in range(n)]
    seq = list(pattern) * reps
    assert len(seq) == n
    for i, jump in enumerate(seq):
        edges.append((i, (i + jump) % n))
    return from_edges(n, edges, name)


def mcgee() -> Graph:
    """McGee graph = (3,7)-cage, 24 vertices, LCF [12,7,-7]^8. tw = 7."""
    return lcf(24, [12, 7, -7], 8, "McGeeGraph")


def dyck() -> Graph:
    """Dyck graph, 32 vertices, LCF [5,-5,13,-13]^8. tw = 7."""
    return lcf(32, [5, -5, 13, -13], 8, "DyckGraph")


def desargues() -> Graph:
    return lcf(20, [5, -5, 9, -9], 5, "DesarguesGraph")


def gnp(n: int, p: float, seed: int) -> Graph:
    rng = np.random.RandomState(seed)
    a = rng.rand(n, n) < p
    a = np.triu(a, 1)
    a = a | a.T
    return Graph(n, a, f"gnp_{n}_{p}_{seed}")


def barabasi_albert(n: int, m: int, seed: int) -> Graph:
    """BA preferential attachment (same family as RandomBarabasiAlbert_100_2)."""
    rng = np.random.RandomState(seed)
    edges = []
    targets = list(range(m))
    repeated = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = list(rng.choice(repeated, size=m, replace=False))
    return from_edges(n, edges, f"BarabasiAlbert_{n}_{m}_{seed}")


def random_tree(n: int, seed: int) -> Graph:
    rng = np.random.RandomState(seed)
    edges = [(i, int(rng.randint(0, i))) for i in range(1, n)]
    return from_edges(n, edges, f"tree_{n}_{seed}")


def random_partial_ktree(n: int, k: int, drop: float, seed: int) -> Graph:
    """Random k-tree minus ``drop`` fraction of edges: treewidth <= k."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n, n), dtype=bool)
    clique = list(range(k + 1))
    for u in range(k + 1):
        for v in range(u + 1, k + 1):
            a[u, v] = a[v, u] = True
    cliques = [clique]
    for v in range(k + 1, n):
        c = cliques[rng.randint(len(cliques))]
        keep = rng.choice(len(c), size=k, replace=False)
        base = [c[i] for i in keep]
        for u in base:
            a[u, v] = a[v, u] = True
        cliques.append(base + [v])
    # drop edges
    es = np.argwhere(np.triu(a, 1))
    kill = es[rng.rand(len(es)) < drop]
    for u, v in kill:
        a[u, v] = a[v, u] = False
    return Graph(n, a, f"partial_{k}tree_{n}_{seed}")


# ---------------------------------------------------------------- DIMACS io

def read_dimacs(path: str) -> Graph:
    """Read a DIMACS ``.col``-style or PACE ``.gr`` graph.

    Tolerant of what real instance files actually contain: comment
    (``c ...`` / ``% ...``) and blank lines anywhere (not just a header
    block), ``e u v`` and bare ``u v`` edge lines mixed, node-weight
    ``n v w`` lines (ignored), a ``p`` header whose format token may be
    missing (``p tw n m`` / ``p edge n m`` / ``p n m``), and both 1- and
    0-based vertex numbering: files touching vertex 0 are taken as
    0-based, everything else shifts down by one (the PACE/DIMACS
    convention).  Self-loops are dropped and duplicate edges collapse
    (``from_edges``); indices past the header's ``n`` grow the graph
    instead of crashing."""
    n, edges = 0, []
    name = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t or t[0] in ("c", "%") or t[0].startswith("%"):
                continue
            if t[0] == "p":
                # "p tw n m" / "p edge n m" / bare "p n m": the vertex
                # count is the first numeric token
                nums = [x for x in t[1:] if x.lstrip("-").isdigit()]
                if not nums:
                    raise ValueError(
                        f"{path}: malformed p header {line.rstrip()!r}")
                n = int(nums[0])
            elif t[0] == "n":
                continue               # node-weight line (some .col files)
            elif t[0] == "e":
                edges.append((int(t[1]), int(t[2])))
            elif len(t) == 2:          # PACE .gr edge line
                edges.append((int(t[0]), int(t[1])))
    if any(u < 0 or v < 0 for u, v in edges):
        raise ValueError(f"{path}: negative vertex index")
    # unified base detection over all edge lines: any vertex 0 => the
    # file is 0-based; otherwise 1-based (shift down)
    if edges and not any(0 in e for e in edges):
        edges = [(u - 1, v - 1) for u, v in edges]
    if edges:
        n = max(n, max(max(e) for e in edges) + 1)
    return from_edges(n, edges, name)


def write_dimacs(g: Graph, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"p tw {g.n} {g.n_edges}\n")
        for u in range(g.n):
            for v in range(u + 1, g.n):
                if g.adj[u, v]:
                    f.write(f"{u + 1} {v + 1}\n")


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
    "queen8_8": lambda: queen(8),
    "kneser8_3": lambda: kneser(8, 3),
    "8x6_torusGrid": lambda: torus_grid(8, 6),
    "grid6x6": lambda: grid(6, 6),
    "ba_100_2": lambda: barabasi_albert(100, 2, 42),
}
