"""Host planning of the plain reference, frozen: a copy of the port's numpy planning as of the benchmark's first version (``repro_torch/core/preprocess.py``: simplicial reduction and biconnected blocks; ``core/bounds.py``: greedy clique, degeneracy, min-degree / min-fill upper bounds, disjoint-paths matrix; ``core/mmw.py::mmw_oracle``; ``core/solver.py::plan_block``).

The bounds are heuristics whose answers depend on their tie-breaking, so
the reference cannot derive the same lb, ub and clique independently: it
keeps this copy, which later changes to the program's planning do not
move.  Everything here is numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from twbench.instances import Graph


def greedy_max_clique(g: Graph, tries: int = 32, seed: int = 0) -> list:
    """Greedy clique from multiple degree-ordered starts; any clique is a
    *valid* skip set, bigger is better."""
    rng = np.random.RandomState(seed)
    best: list = []
    deg = g.degrees()
    order0 = np.argsort(-deg)
    for t in range(tries):
        order = order0 if t == 0 else rng.permutation(g.n)
        clique: list = []
        mask = np.ones(g.n, dtype=bool)
        for v in order:
            if mask[v]:
                clique.append(int(v))
                mask &= g.adj[v]
        if len(clique) > len(best):
            best = clique
    return best


def degeneracy(g: Graph) -> int:
    """Max over the min-degree elimination of current min degree."""
    adj = [set(np.nonzero(g.adj[v])[0]) for v in range(g.n)]
    alive = set(range(g.n))
    out = 0
    while alive:
        v = min(alive, key=lambda x: len(adj[x]))
        out = max(out, len(adj[v]))
        for u in adj[v]:
            adj[u].discard(v)
        alive.discard(v)
    return out


def _elimination_ub(g: Graph, strategy: str, rng=None) -> tuple:
    """Simulate a heuristic elimination; returns (width, order).

    With ``rng`` the index tiebreak is replaced by a per-run random rank,
    turning the greedy sweep into a seeded randomized restart (the
    "randomized contraction order" improver of the bounds engine).
    """
    adj = [set(np.nonzero(g.adj[v])[0]) for v in range(g.n)]
    alive = set(range(g.n))
    width, order = 0, []
    rank = (rng.permutation(g.n) if rng is not None
            else np.arange(g.n, dtype=np.int64))

    def fill_in(v):
        nbrs = list(adj[v])
        cnt = 0
        for i in range(len(nbrs)):
            for j in range(i + 1, len(nbrs)):
                if nbrs[j] not in adj[nbrs[i]]:
                    cnt += 1
        return cnt

    while alive:
        if strategy == "min_degree":
            v = min(alive, key=lambda x: (len(adj[x]), rank[x], x))
        else:  # min_fill
            v = min(alive, key=lambda x: (fill_in(x), len(adj[x]), rank[x], x))
        width = max(width, len(adj[v]))
        nbrs = list(adj[v])
        for i in range(len(nbrs)):
            for j in range(i + 1, len(nbrs)):
                a, b = nbrs[i], nbrs[j]
                adj[a].add(b)
                adj[b].add(a)
        for u in nbrs:
            adj[u].discard(v)
        adj[v].clear()
        alive.discard(v)
        order.append(int(v))
    return width, order


def upper_bound(g: Graph, seed: int = 0) -> tuple:
    """Best of min-degree / min-fill.  Returns (width, order)."""
    if g.n == 0:
        return 0, []
    w1, o1 = _elimination_ub(g, "min_degree")
    w2, o2 = _elimination_ub(g, "min_fill")
    return (w1, o1) if w1 <= w2 else (w2, o2)


def mmw_root_bound(g: Graph) -> int:
    if g.n <= 1:
        return 0
    return mmw_oracle(g.adj, set())


def lower_bound(g: Graph, seed: int = 0) -> int:
    if g.n <= 1:
        return 0
    lb = max(degeneracy(g), mmw_root_bound(g),
             len(greedy_max_clique(g, tries=8, seed=seed)) - 1)
    return lb


def disjoint_paths_matrix(g: Graph, cap: int = 64) -> np.ndarray:
    """P[u, v] = number of internally-vertex-disjoint u-v paths (capped).

    Vertex-capacity max-flow via BFS augmentation on the standard split
    graph (v_in -> v_out).  Used for the paper's rule: if P[u,v] >= k+1 the
    edge uv may be added when testing width k [Clautiaux et al.].
    Runs once per instance on the host.
    """
    n = g.n
    out = np.zeros((n, n), dtype=np.int32)
    nbrs = [list(np.nonzero(g.adj[v])[0]) for v in range(n)]

    def maxflow(s: int, t: int, limit: int) -> int:
        # node-split network: node 2v = v_in, 2v+1 = v_out
        # edges: v_in->v_out cap 1 (inf for s,t), uv edge: u_out->v_in cap 1
        flow = 0
        # residual as dict-of-dict is slow; use adjacency with capacity map
        capm = {}

        def add(a, b, c):
            capm[(a, b)] = capm.get((a, b), 0) + c
            capm.setdefault((b, a), 0)

        for v in range(n):
            add(2 * v, 2 * v + 1, 1 if v not in (s, t) else limit + 1)
        for u in range(n):
            for v in nbrs[u]:
                add(2 * u + 1, 2 * v, 1)
        adjn = [[] for _ in range(2 * n)]
        for (a, b) in capm:
            adjn[a].append(b)
        src, snk = 2 * s + 1, 2 * t
        while flow <= limit:
            # BFS for augmenting path
            parent = {src: None}
            q = [src]
            while q and snk not in parent:
                nq = []
                for a in q:
                    for b in adjn[a]:
                        if b not in parent and capm[(a, b)] > 0:
                            parent[b] = a
                            nq.append(b)
                q = nq
            if snk not in parent:
                break
            b = snk
            while parent[b] is not None:
                a = parent[b]
                capm[(a, b)] -= 1
                capm[(b, a)] += 1
                b = a
            flow += 1
        return flow

    for u in range(n):
        for v in range(u + 1, n):
            f = maxflow(u, v, cap)
            out[u, v] = out[v, u] = f
    return out


def paths_edges(g: Graph, paths: np.ndarray, k: int) -> np.ndarray:
    """Edges addable at width k: pairs with >= k+1 disjoint paths."""
    extra = (paths >= (k + 1)) & ~g.adj
    np.fill_diagonal(extra, False)
    return extra


def mmw_oracle(adj_bool, s: set, cap: int = 1 << 20) -> int:
    """Pure-python MMW on an explicit eliminated graph (test oracle)."""
    n = len(adj_bool)
    a = np.array(adj_bool, dtype=bool).copy()
    # eliminate S (in any order)
    alive = [v for v in range(n) if v not in s]
    for v in sorted(s):
        nbrs = [u for u in range(n) if a[v][u] and u != v]
        for i in nbrs:
            for j in nbrs:
                if i != j:
                    a[i][j] = True
        a[v, :] = False
        a[:, v] = False
    lb = 0
    act = set(alive)
    while len(act) > 1:
        d = {v: int(a[v].sum()) for v in act}
        v = min(act, key=lambda x: (d[x], x))
        rest = sorted(act - {v}, key=lambda x: (d[x], x))
        if rest:
            lb = max(lb, d[rest[0]])
        if d[v] == 0:
            act.remove(v)
            continue
        nbrs = [u for u in act if a[v][u]]
        u = min(nbrs, key=lambda x: (d[x], x))
        # contract u into v
        merged = (a[v] | a[u])
        merged[v] = merged[u] = False
        a[v] = merged
        a[:, v] = merged
        a[u, :] = False
        a[:, u] = False
        act.remove(u)
    return lb


def biconnected_blocks(g: Graph) -> list:
    """Iterative Hopcroft-Tarjan; returns vertex sets of biconnected blocks.

    tw(G) = max over blocks tw(G[block]) (articulation splits are safe)."""
    n = g.n
    num = [-1] * n
    low = [0] * n
    blocks = []
    estack = []
    cnt = [0]

    for root in range(n):
        if num[root] != -1:
            continue
        stack = [(root, -1, iter(np.nonzero(g.adj[root])[0]))]
        num[root] = low[root] = cnt[0]
        cnt[0] += 1
        while stack:
            v, parent, it = stack[-1]
            advanced = False
            for u in it:
                u = int(u)
                if num[u] == -1:
                    estack.append((v, u))
                    num[u] = low[u] = cnt[0]
                    cnt[0] += 1
                    stack.append((u, v, iter(np.nonzero(g.adj[u])[0])))
                    advanced = True
                    break
                elif u != parent and num[u] < num[v]:
                    estack.append((v, u))
                    low[v] = min(low[v], num[u])
            if advanced:
                continue
            stack.pop()
            if stack:
                pv = stack[-1][0]
                low[pv] = min(low[pv], low[v])
                if low[v] >= num[pv]:
                    # pv is an articulation point (or root): pop a block
                    block = set()
                    while estack:
                        a, b = estack[-1]
                        if num[a] >= num[v]:
                            estack.pop()
                            block.update((a, b))
                        else:
                            break
                    if estack and estack[-1] == (pv, v):
                        estack.pop()
                    block.update((pv, v))
                    blocks.append(sorted(block))
        if not blocks and n == 1:
            blocks.append([root])
    # isolated vertices form their own trivial blocks
    covered = set()
    for b in blocks:
        covered.update(b)
    for v in range(n):
        if v not in covered:
            blocks.append([v])
    return blocks


def simplicial_reduce(g: Graph) -> tuple:
    """Repeatedly remove simplicial vertices (N(v) is a clique).

    Safe: tw(G) = max(deg(v), tw(G - v)).  Returns (reduced graph,
    lower bound from removed vertices, kept-vertex original ids,
    removed-vertex original ids in removal order).  The removal order is
    an elimination-order prefix: replaying it eliminates each vertex while
    its neighborhood is a clique (degree = the recorded bound, no fill),
    which is what lets ``stitch_block_orders`` splice the removals back
    into a certified global order."""
    adj = g.adj.copy()
    alive = np.ones(g.n, dtype=bool)
    lb = 0
    removed: list = []
    changed = True
    while changed:
        changed = False
        for v in range(g.n):
            if not alive[v]:
                continue
            nbrs = np.nonzero(adj[v] & alive)[0]
            d = len(nbrs)
            if d == 0:
                alive[v] = False
                removed.append(int(v))
                changed = True
                continue
            sub = adj[np.ix_(nbrs, nbrs)]
            if d * (d - 1) == int(sub.sum()):   # clique
                lb = max(lb, d)
                adj[v, :] = False
                adj[:, v] = False
                alive[v] = False
                removed.append(int(v))
                changed = True
    keep = np.nonzero(alive)[0]
    if len(keep) == 0:
        return (Graph(0, np.zeros((0, 0), dtype=bool), g.name + "_red"),
                lb, keep, removed)
    sub = Graph(len(keep), adj[np.ix_(keep, keep)], g.name + "_red")
    return sub, lb, keep, removed


@dataclasses.dataclass
class Block:
    g: Graph
    vmap: np.ndarray


@dataclasses.dataclass
class Preprocessed:
    blocks: list          # Block, largest solver graph first
    lb: int               # lower bound established by reductions


def preprocess(g: Graph) -> Preprocessed:
    """Simplicial reduce -> biconnected blocks -> reduce each."""
    red, lb, keep, _removed0 = simplicial_reduce(g)
    parts: list = []
    if red.n:
        for blk in biconnected_blocks(red):
            blk = sorted(blk)
            orig = keep[np.asarray(blk, dtype=int)]
            sub, lb2, keep2, _rem2 = simplicial_reduce(red.subgraph(blk))
            lb = max(lb, lb2)
            vmap = (orig[np.asarray(keep2, dtype=int)] if sub.n
                    else np.zeros(0, dtype=int))
            parts.append(Block(sub, vmap))
    parts.sort(key=lambda b: -b.g.n)
    return Preprocessed(parts, lb)


@dataclasses.dataclass
class BlockPlan:
    g: Graph
    clique: list
    lb: int
    ub: int
    paths: object
    k0: int
    done: object = None        # (width, exact, lb, ub) when no search

    def graph_at(self, k: int) -> Graph:
        if self.paths is None:
            return self.g
        return self.g.with_edges(paths_edges(self.g, self.paths, k))


def plan_block(g: Graph) -> BlockPlan:
    """Bounds and the deepening ladder's first rung for one block, with
    the solver's defaults (clique and paths on, no start_k, no
    heuristics, seed 0)."""
    if g.n <= 1:
        return BlockPlan(g, [], 0, 0, None, 0, (0, True, 0, 0))
    clique = greedy_max_clique(g, seed=0)
    lb = max(lower_bound(g, seed=0), len(clique) - 1)
    ub, _order = upper_bound(g, seed=0)
    if lb >= ub:
        return BlockPlan(g, clique, lb, ub, None, lb, (ub, True, lb, ub))
    paths = disjoint_paths_matrix(g, cap=ub)
    return BlockPlan(g, clique, lb, ub, paths, lb)
