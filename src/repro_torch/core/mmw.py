"""Minor-min-width lower bound: the host oracle.

``mmw_oracle`` is a copy of ``repro.core.mmw.mmw_oracle`` (pure python
over an explicit eliminated graph).  ``bounds.mmw_root_bound`` runs it
once per instance.  The batched per-state bound (``mmw_bound``) and its
kernel belong to the pruning flags, which this package does not port yet.
"""
from __future__ import annotations

import numpy as np


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
