"""Instance preprocessing (host-side, numpy).

A copy of ``repro.core.preprocess`` so that the PyTorch port never imports
``repro``.

The paper preprocesses with the safe-separator rules of the authors'
BZTreewidth PACE submission (split on components, articulation points/pairs/
triplets, (almost-)clique separators).  We implement the first two levels —
connected components and articulation points (biconnected blocks) — plus
simplicial-vertex reduction; these are exactly safe (tw = max over parts).
Articulation pairs/triplets and almost-clique separators are documented as
out of scope (DESIGN.md §7): they need the full machinery of [5] and change
results only by further shrinking instances.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from . import telemetry
from .graph import Graph


def connected_components(g: Graph) -> list:
    seen = np.zeros(g.n, dtype=bool)
    comps = []
    for s in range(g.n):
        if seen[s]:
            continue
        stack, comp = [s], []
        seen[s] = True
        while stack:
            v = stack.pop()
            comp.append(v)
            for u in np.nonzero(g.adj[v])[0]:
                if not seen[u]:
                    seen[u] = True
                    stack.append(int(u))
        comps.append(sorted(comp))
    return comps


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
    """One solver unit plus the vertex maps reconstruction needs.

    ``g`` is the reduced block graph handed to the solver; ``vmap[i]`` is
    the original-graph id of solver vertex ``i``; ``removed`` lists the
    block-local simplicial reduction removals (original ids, removal
    order); ``vertices`` is the full block vertex set in original ids —
    including removed and articulation vertices — which is what the
    stitcher's block-cut forest is built from.  A block can be fully
    reduced away (``g.n == 0``): it is kept here anyway because its
    vertices (e.g. both endpoints of a bridge) still have to be placed in
    the global elimination order."""
    g: Graph
    vmap: np.ndarray
    removed: list
    vertices: list


@dataclasses.dataclass
class Preprocessed:
    blocks: list          # list of Block, largest solver graph first
    lb: int               # lower bound established by reductions
    original: Graph
    removed: list         # top-level reduction removals (original ids, order)


def preprocess(g: Graph, split_blocks: bool = True,
               tracker=None) -> Preprocessed:
    """Full pipeline: simplicial reduce -> biconnected blocks -> reduce each.

    Timed as a ``preprocess_s`` span on ``tracker`` (``None``: the process
    root)."""
    with telemetry.get(tracker).time_block("preprocess_s"):
        return _preprocess(g, split_blocks)


def _preprocess(g: Graph, split_blocks: bool) -> Preprocessed:
    red, lb, keep, removed0 = simplicial_reduce(g)
    parts: list = []
    if red.n:
        if split_blocks:
            for blk in biconnected_blocks(red):
                blk = sorted(blk)
                orig = keep[np.asarray(blk, dtype=int)]   # red ids -> g ids
                sub, lb2, keep2, rem2 = simplicial_reduce(red.subgraph(blk))
                lb = max(lb, lb2)
                vmap = (orig[np.asarray(keep2, dtype=int)] if sub.n
                        else np.zeros(0, dtype=int))
                parts.append(Block(sub, vmap,
                                   [int(orig[v]) for v in rem2],
                                   [int(v) for v in orig]))
        else:
            parts.append(Block(red, keep.astype(int), [],
                               [int(v) for v in keep]))
    # largest first: the hard block dominates runtime, fail fast
    parts.sort(key=lambda b: -b.g.n)
    return Preprocessed(parts, lb, g, removed0)


def stitch_block_orders(pre: Preprocessed, block_orders: list) -> list:
    """Stitch per-block elimination orders into one order for the original
    graph, leaf-to-root over the block-cut forest.

    ``block_orders[i]`` is an elimination order of ``pre.blocks[i].g`` in
    block-local solver indices (``None`` means "any order" — used for
    blocks the solver skipped because they cannot beat the width found so
    far, where every order is within budget).

    Why this preserves width: processing a leaf block eliminates its
    vertices *except* the one articulation vertex it still shares with an
    unprocessed block.  At that moment every neighbor of an eliminated
    vertex lies inside the block (all other blocks containing it are
    already collapsed into their articulation vertices), so replay degrees
    equal the block-local ones; and restricting an elimination order to an
    induced subgraph never increases its width (the restricted fill-in is
    a subgraph of the restricted full fill-in).  Fill edges stay inside
    the block, so the residual graph seen by later blocks is exactly the
    original minus processed block interiors and the recursion goes
    through.  Block-local reduction removals are replayed first — they are
    simplicial at that point in the block, with degree bounded by the
    reduction lower bound."""
    full = []
    for b, loc in zip(pre.blocks, block_orders):
        loc = list(range(b.g.n)) if loc is None else list(loc)
        full.append(list(b.removed) + [int(b.vmap[v]) for v in loc])
    owner: dict = {}
    for i, b in enumerate(pre.blocks):
        for v in b.vertices:
            owner.setdefault(v, set()).add(i)
    remaining = set(range(len(pre.blocks)))
    order = list(pre.removed)
    done = set(order)
    while remaining:
        leaf = cut = None
        for i in sorted(remaining):
            shared = [v for v in pre.blocks[i].vertices
                      if len(owner[v] & remaining) > 1]
            if len(shared) <= 1:
                leaf, cut = i, (shared[0] if shared else None)
                break
        assert leaf is not None, "block-cut forest has no leaf block"
        for v in full[leaf]:
            if v != cut and v not in done:
                order.append(v)
                done.add(v)
        remaining.discard(leaf)
    # isolated originals never entering any block (already in pre.removed
    # for reduced graphs; this is a safety net for degenerate inputs)
    order.extend(v for v in range(pre.original.n) if v not in done)
    return order
