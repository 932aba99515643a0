"""Host-side bounds and orderings (numpy).

A copy of ``repro.core.bounds`` so that the PyTorch port never imports
``repro``; the same numpy RNG seeding gives the same cliques and orders.

These run once per instance (not per state), so they stay on the host:
  * greedy max clique  -> the paper's "eliminate the clique last" rule,
    plus clique-number lower bound (omega - 1 <= tw);
  * degeneracy         -> lower bound;
  * min-degree / min-fill elimination orderings -> upper bounds (and the
    initial candidate width for iterative deepening);
  * MMW on the whole graph -> lower bound (the same heuristic the GPU
    kernel applies per state, run once at the root).
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


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


def randomized_order(g: Graph, seed: int, strategy: str = "min_degree") -> tuple:
    """One seeded randomized-restart elimination order; (width, order).

    Deterministic per (g, seed, strategy): the greedy tiebreak is a
    random rank drawn from ``seed``, so distinct seeds explore distinct
    orders while any single seed replays bit-identically.
    """
    if g.n == 0:
        return 0, []
    return _elimination_ub(g, strategy, rng=np.random.RandomState(seed))


def upper_bound(g: Graph, seed: int = 0, restarts: int = 0) -> tuple:
    """Best of min-degree / min-fill. Returns (width, order).

    ``restarts`` adds that many seeded randomized min-degree sweeps on
    top of the two deterministic ones; ``seed`` pins them so the result
    is a pure function of (g, seed, restarts).  The defaults reproduce
    the historical deterministic bound exactly.
    """
    if g.n == 0:
        return 0, []
    w1, o1 = _elimination_ub(g, "min_degree")
    w2, o2 = _elimination_ub(g, "min_fill")
    best = (w1, o1) if w1 <= w2 else (w2, o2)
    for r in range(restarts):
        w, o = randomized_order(g, seed + r)
        if w < best[0]:
            best = (w, o)
    return best


def mmw_root_bound(g: Graph) -> int:
    """MMW lower bound on the whole graph (host mirror of core.mmw)."""
    from .mmw import mmw_oracle
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
