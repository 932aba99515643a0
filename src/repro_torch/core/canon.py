"""Canonical graph labeling and content-addressed solve keys (DESIGN.md §16).

At serving scale, repeat submissions of the same instance must be cache
hits even when the client relabeled the vertices: the cache key has to be
a *complete* graph invariant, not a hash of the adjacency bytes as
submitted.  This module computes a deterministic canonical labeling by
partition refinement plus an individualization tie-break search — the
classic McKay scheme, sized for the ≤64-vertex graphs the exact solver
handles (it runs on any ``n``; the search is exact at every size, only
its worst-case cost grows):

  1. **Refinement** — iterate the 1-WL color update (a vertex's color
     becomes the rank of ``(old color, multiset of neighbor colors)``)
     until the partition is equitable.  Ranks are taken over the sorted
     signature set, so the refined coloring is isomorphism-invariant.
  2. **Individualization search** — while a color class has ≥2 vertices,
     split on the first such class: individualize each member in turn,
     re-refine, and recurse.  Two prunings keep the tree small without
     breaking canonicity: children whose refined partition has a
     non-minimal *invariant* (class sizes + equitable quotient rows —
     a pure function of the colored graph) are dropped, and a child is
     skipped when an already-discovered automorphism fixing the current
     individualization prefix maps an explored sibling onto it (the two
     subtrees are mirror images).  Automorphisms are harvested for free
     whenever two leaves produce the same canonical bytes.
  3. **Leaf** — a discrete coloring *is* a permutation; the canonical
     form is the lexicographically smallest packed adjacency matrix over
     the surviving leaves.

``canonical_form(g)`` returns ``(bytes, perm)`` with ``perm[v]`` the
canonical label of vertex ``v``; two graphs are isomorphic iff their
``bytes`` are equal, and ``g.relabel(perm)`` *is* the canonical graph.

``cache_key(g, config)`` hashes the canonical form together with the
*effective* solve configuration into the result-cache key
(``repro_torch.serve.cache``).  Everything feeding the digest is a primitive
rendered by value (never python ``hash()``), so keys are stable across
processes and ``PYTHONHASHSEED`` values.  One deliberate exception to
canonicalization: ``mode="bloom"`` results are Monte-Carlo and *label-
dependent* (the filter hashes state bitsets, so a relabeling changes the
false-positive pattern and thus ``expanded``) — bloom keys therefore
hash the as-submitted adjacency, and only bit-identical resubmissions
hit.  See DESIGN.md §16 for the full coherence argument.

A copy of ``repro.core.canon`` (numpy and hashlib) over the port's own
``graph``, so that the PyTorch port never imports ``repro``: canonical
forms, ``graph_key`` digests and perms are equal across the packages.
``cache_key`` digests are equal for equal config dicts only.  The port's
scheduler keys its own backend and schedule names (``torch``/``cuda``,
``doubling``) where the reference's keys ``jax``/``pallas`` and
``while``, so a config that names them hashes apart across packages.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph

# leaf automorphisms retained for sibling pruning; beyond this the search
# still terminates (pruning just degrades), it only exists to bound the
# per-node scan on pathologically symmetric inputs
_MAX_AUTOMORPHISMS = 64

# domain separator + version for the digest: bump when the canonical
# form or the config rendering changes, so stale persisted keys (if a
# cache is ever spilled to disk) can never alias fresh ones
_KEY_VERSION = b"twkey1"


def _adj_masks(g: Graph) -> List[int]:
    """Row bitmasks of the adjacency matrix (python ints, any n)."""
    masks = []
    for v in range(g.n):
        row = 0
        for u in np.nonzero(g.adj[v])[0]:
            row |= 1 << int(u)
        masks.append(row)
    return masks


def _neighbor_color_counts(masks: List[int], colors: List[int],
                           v: int) -> Tuple[Tuple[int, int], ...]:
    """Sorted (color, count) pairs over v's neighborhood."""
    cnt: Dict[int, int] = {}
    m = masks[v]
    while m:
        low = m & -m
        u = low.bit_length() - 1
        m ^= low
        c = colors[u]
        cnt[c] = cnt.get(c, 0) + 1
    return tuple(sorted(cnt.items()))


def _refine(n: int, masks: List[int], colors: List[int]) -> List[int]:
    """1-WL refinement to the coarsest equitable partition below
    ``colors``.  Returned color ids are signature ranks — a pure function
    of the colored graph, so the refined coloring is iso-invariant."""
    ncolors = len(set(colors))
    while True:
        sigs = [(colors[v], _neighbor_color_counts(masks, colors, v))
                for v in range(n)]
        ranks = {s: i for i, s in enumerate(sorted(set(sigs)))}
        colors = [ranks[s] for s in sigs]
        if len(ranks) == ncolors:
            return colors
        ncolors = len(ranks)


def _partition_invariant(n: int, masks: List[int],
                         colors: List[int]) -> tuple:
    """Iso-invariant summary of an equitable coloring: per color class
    (in color order) its size and one member's neighbor-color counts —
    well-defined because equitability makes every member's counts equal.
    Used to prune non-minimal siblings in the search; any invariant
    works, a discriminating one prunes more."""
    sizes: Dict[int, int] = {}
    rep: Dict[int, int] = {}
    for v, c in enumerate(colors):
        sizes[c] = sizes.get(c, 0) + 1
        rep.setdefault(c, v)
    return tuple((c, sizes[c], _neighbor_color_counts(masks, colors, rep[c]))
                 for c in sorted(rep))


def _canon_bytes(n: int, masks: List[int], perm) -> bytes:
    """Packed adjacency matrix of the relabeled graph, rows in canonical
    order, each row little-endian over canonical columns."""
    inv = [0] * n
    for v, c in enumerate(perm):
        inv[c] = v
    row_bytes = (n + 7) // 8
    out = bytearray()
    for i in range(n):
        m = masks[inv[i]]
        row = 0
        while m:
            low = m & -m
            u = low.bit_length() - 1
            m ^= low
            row |= 1 << perm[u]
        out += row.to_bytes(row_bytes, "little")
    return bytes(out)


def canonical_form(g: Graph) -> Tuple[bytes, Tuple[int, ...]]:
    """Canonical form of ``g``: ``(bytes, perm)``.

    ``bytes`` is the packed adjacency matrix of the canonically
    relabeled graph — equal iff two graphs are isomorphic (it fully
    reconstructs the graph, so equality is exact, not a heuristic).
    ``perm[v]`` is the canonical label of vertex ``v``:
    ``g.relabel(list(perm))`` has exactly the adjacency ``bytes`` packs.
    Deterministic: a pure function of the adjacency matrix."""
    n = g.n
    if n == 0:
        return b"", ()
    masks = _adj_masks(g)
    best: List[Optional[object]] = [None, None]     # bytes, perm
    autos: List[Tuple[int, ...]] = []

    def search(colors: List[int], fixed: Tuple[int, ...]) -> None:
        colors = _refine(n, masks, colors)
        if len(set(colors)) == n:                   # discrete: a leaf
            b = _canon_bytes(n, masks, colors)
            if best[0] is None or b < best[0]:
                best[0], best[1] = b, tuple(colors)
            elif b == best[0] and len(autos) < _MAX_AUTOMORPHISMS:
                # two labelings onto the same canonical graph compose to
                # an automorphism — harvested for sibling pruning
                p_best, p_here = best[1], colors
                inv_here = [0] * n
                for v, c in enumerate(p_here):
                    inv_here[c] = v
                phi = tuple(inv_here[p_best[v]] for v in range(n))
                if phi != tuple(range(n)) and phi not in autos:
                    autos.append(phi)
            return
        # canonical target cell: first color with >= 2 members
        counts: Dict[int, int] = {}
        for c in colors:
            counts[c] = counts.get(c, 0) + 1
        target = min(c for c, k in counts.items() if k > 1)
        cell = [v for v in range(n) if colors[v] == target]
        kids = []
        for v in cell:
            child = [2 * c for c in colors]
            child[v] = 2 * colors[v] + 1            # split v from its class
            rc = _refine(n, masks, child)
            kids.append((_partition_invariant(n, masks, rc), v, rc))
        min_inv = min(k[0] for k in kids)
        # orbit pruning: automorphisms fixing the individualization prefix
        # act on the cell; siblings in one orbit root identical subtrees,
        # so explore one representative per orbit.  Union-find components
        # under the generators are exactly the orbits of the generated
        # subgroup.
        parent = list(range(n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for phi in autos:
            if all(phi[f] == f for f in fixed):
                for v in range(n):
                    ra, rb = find(v), find(phi[v])
                    if ra != rb:
                        parent[ra] = rb
        tried: List[int] = []
        for inv_k, v, rc in kids:
            if inv_k != min_inv:
                continue        # iso-invariant choice: drop worse siblings
            if any(find(v) == find(u) for u in tried):
                continue        # an automorphism maps a tried sibling here
            tried.append(v)
            search(rc, fixed + (v,))
            # autos discovered inside the subtree may merge orbits
            for phi in autos:
                if all(phi[f] == f for f in fixed):
                    for u in range(n):
                        ra, rb = find(u), find(phi[u])
                        if ra != rb:
                            parent[ra] = rb

    search([0] * n, ())
    return best[0], best[1]          # type: ignore[return-value]


def graph_key(g: Graph) -> str:
    """Hex digest of the canonical form alone (no config): equal iff
    isomorphic.  What trace replay tools use to dedup reference solves."""
    b, _perm = canonical_form(g)
    h = hashlib.sha256()
    h.update(_KEY_VERSION)
    h.update(b"\0g\0")
    h.update(str(g.n).encode())
    h.update(b"\0")
    h.update(b)
    return h.hexdigest()


def _render_value(v) -> str:
    """Deterministic primitive rendering for the config half of the key.
    Only value types with stable reprs are accepted — anything else is a
    bug in the caller (a non-primitive would make keys process-local)."""
    if v is None or isinstance(v, (bool, int, str)):
        return repr(v)
    if isinstance(v, float):
        return repr(float(v))
    if isinstance(v, (tuple, list)):
        return "[" + ",".join(_render_value(x) for x in v) + "]"
    raise TypeError(
        f"cache-key config values must be primitives, got {type(v).__name__}")


def config_blob(config: dict) -> bytes:
    """Canonical byte rendering of an effective-config dict (sorted keys,
    value-rendered primitives — never python ``hash()``)."""
    parts = [f"{k}={_render_value(config[k])}" for k in sorted(config)]
    return ";".join(parts).encode()


def cache_key(g: Graph, config: dict, *,
              canonical: bool = True) -> Tuple[str, Tuple[int, ...]]:
    """Content-addressed result-cache key: ``(hexdigest, perm)``.

    ``canonical=True`` (exact-dedup modes) keys on the canonical form, so
    isomorphic resubmissions — including adversarially relabeled
    duplicates — address the same entry; ``perm`` maps submitted labels
    to canonical ones (the cache stores elimination orders in canonical
    space and translates through ``perm`` on both insert and hit).
    ``canonical=False`` (``mode="bloom"``: Monte-Carlo, label-dependent)
    keys on the as-submitted adjacency with the identity ``perm``.

    The digest covers a version tag, the vertex count, the graph bytes
    and the rendered config — stable across processes (no ``hash()``)."""
    if canonical:
        b, perm = canonical_form(g)
    else:
        b = g.packed().tobytes()
        perm = tuple(range(g.n))
    h = hashlib.sha256()
    h.update(_KEY_VERSION)
    h.update(b"\0c\0" if canonical else b"\0r\0")
    h.update(str(g.n).encode())
    h.update(b"\0")
    h.update(b)
    h.update(b"\0")
    h.update(config_blob(config))
    return h.hexdigest(), perm
