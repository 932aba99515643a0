"""Minor-min-width lower bound on the eliminated graph (paper §3.3).

``mmw_bound`` ports ``repro.core.mmw.mmw_bound``, batched over a leading
state axis: it is the ``torch`` backend's ``mmw_bound`` op and the plain
version of the CUDA MMW kernels (``repro_torch.kernels.mmw`` and the
``use_mmw`` path of ``repro_torch.kernels.wavefront``).  Per state S it
contracts a minimum-degree vertex into its minimum-degree neighbour, first
index on ties, until one vertex is left; the largest second-smallest
degree seen is the bound.  A row freezes once its bound exceeds ``k`` or
at most one vertex is active, as the reference's ``while_loop`` exits.

``mmw_oracle`` is a copy of ``repro.core.mmw.mmw_oracle`` (pure python
over an explicit eliminated graph); ``bounds.mmw_root_bound`` runs it once
per instance.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitset

BIG = 1 << 20


def mmw_bound(reach: torch.Tensor, s_words: torch.Tensor, k,
              *, n: int) -> torch.Tensor:
    """Lower bounds for the graphs obtained by eliminating each state.

    reach (B, n, W) int32 eliminated-graph rows (rows of v in S are
    ignored); s_words (B, W); k int.  Returns (B,) int32 bounds; a bound
    above ``k`` means the state can be pruned.

    A frozen row never moves again, so each step first retires the rows
    that froze and works on the others only.
    """
    b = reach.shape[0]
    dev = reach.device
    k = int(k)
    ar = torch.arange(n, device=dev)
    out = torch.zeros((b,), dtype=torch.int32, device=dev)
    act = ~bitset.unpack(s_words, n)                              # (R, n)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adjm = (bitset.unpack(reach, n) & act[:, None, :] & ~eye
            & act[:, :, None])                                    # (R, n, n)
    lb = torch.zeros((b,), dtype=torch.int64, device=dev)
    nact = act.sum(dim=1)
    ids = torch.arange(b, device=dev)            # working row -> batch row
    for _ in range(max(n - 1, 1)):
        live = (nact > 1) & (lb <= k)
        if not bool(live.all()):
            out[ids[~live]] = lb[~live].to(torch.int32)
            ids, adjm, act, lb, nact = (ids[live], adjm[live], act[live],
                                        lb[live], nact[live])
            if ids.numel() == 0:
                break
        r = torch.arange(ids.numel(), device=dev)
        d = torch.where(act, adjm.sum(dim=-1), BIG)               # (R, n)
        v = torch.argmin(d, dim=-1)                  # first index on ties
        dv = d[r, v]
        vhot = ar[None, :] == v[:, None]
        second = torch.where(vhot, BIG, d).min(dim=-1).values
        lb = torch.maximum(lb, torch.clamp(second, max=BIG - 1))
        vrow = adjm[r, v]
        u = torch.where(dv > 0,
                        torch.argmin(torch.where(vrow, d, BIG), dim=-1), v)
        uhot = ar[None, :] == u[:, None]
        merged = (vrow | adjm[r, u]) & act & ~uhot & ~vhot
        # clear column u, set column v to merged, then rows v and u
        adjm = ((adjm & ~(uhot | vhot)[:, None, :])
                | (merged[:, :, None] & vhot[:, None, :]))
        adjm[r, v] = merged
        adjm[r, u] = False          # no-op when u == v (isolated case)
        act = act & ~uhot
        nact = nact - 1
    out[ids] = lb.to(torch.int32)
    return out


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
