"""The plain reference's answer for one instance: width, exact, lb, ub,
expanded and the per-rung verdicts, with the solver's documented
semantics (preprocess, plan each block, deepening ladder from lb, fold
the blocks), on the frozen planning (``plan.py``) and the plain search
(``search.py``).
"""
from __future__ import annotations

import math

from twbench.instances import Graph
from twbench.reference import plan as plan_lib
from twbench.reference import search

DEFAULT_CAP = 1 << 17


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def plan_capacity(n: int, block: int, cap_max: int = DEFAULT_CAP) -> int:
    """The drop-free list size of an n-vertex block (one level appends at
    most n * C(n, n/2) rows), clamped to ``cap_max``; never below the
    chunk nor 32."""
    need = 1 if n <= 1 else n * math.comb(n, n // 2) + 1
    cap = min(_pow2_at_least(need), cap_max)
    return max(cap, 32, _pow2_at_least(min(block, cap_max)))


def blocks(g: Graph) -> list:
    """The preprocessed blocks' graphs (largest first)."""
    return [b.g for b in plan_lib.preprocess(g).blocks]


def solve(g: Graph, *, cap=None, block: int = 2048, mode: str = "sort",
          use_mmw: bool = False, n_pad=None, m_bits: int = 1 << 24,
          k_hashes: int = 17, device="cpu", stats: dict = None) -> dict:
    """``cap=None`` sizes each block's list with ``plan_capacity``.
    ``mode`` is the search's ``dedup`` (``sort``, ``bloom`` with
    ``m_bits`` and ``k_hashes``, or the control's ``bloom_small``);
    ``stats`` is handed to every rung's ``search.decide``."""
    if g.n == 0:
        return dict(width=0, exact=True, lb=0, ub=0, expanded=0, per_k={})
    pre = plan_lib.preprocess(g)
    width = lbs = ubs = pre.lb
    exact, expanded, per_k = True, 0, {}
    for part in pre.blocks:
        h = part.g
        if h.n - 1 <= width:
            continue
        bp = plan_lib.plan_block(h)
        if bp.done is not None:
            w, ex, lb, ub = bp.done
            rungs, exp = {}, 0
        else:
            lb, ub = bp.lb, bp.ub
            c = plan_capacity(h.n, block) if cap is None else cap
            rungs, exp, inexact, w, ex = {}, 0, False, ub, None
            for k in range(bp.k0, ub):
                gk = bp.graph_at(k)
                feas, inex, e = search.decide(
                    gk.adj, gk.n, k, bp.clique, cap=c, block=block,
                    dedup=mode, use_mmw=use_mmw, n_pad=n_pad, m_bits=m_bits,
                    k_hashes=k_hashes, device=device, stats=stats)
                exp += e
                rungs[k] = dict(feasible=feas, inexact=inex, expanded=e)
                if feas:
                    w, ex = k, not inexact
                    break
                inexact |= inex
            if ex is None:
                ex = not inexact
        width = max(width, w)
        exact &= ex
        expanded += exp
        lbs, ubs = max(lbs, lb), max(ubs, ub)
        per_k[h.name] = rungs
    return dict(width=width, exact=exact, lb=lbs, ub=max(ubs, width),
                expanded=expanded, per_k=per_k)


def solve_many(graphs, *, cap=None, block: int = 2048, mode: str = "sort",
               use_mmw: bool = False, m_bits: int = 1 << 24,
               k_hashes: int = 17, device="cpu", stats=None) -> list:
    """A suite solved in lanes: every block is embedded in the suite's
    largest block size (only the MMW bound sees it), and ``cap=None``
    gives every lane the largest block's list size.  ``stats``, where
    given, is a list of one dict per graph."""
    parts = [h for g in graphs for h in blocks(g)]
    n_pad = max([h.n for h in parts], default=1)
    if cap is None:
        cap = max([plan_capacity(h.n, block) for h in parts], default=32)
    stats = [None] * len(graphs) if stats is None else stats
    return [solve(g, cap=cap, block=block, mode=mode, use_mmw=use_mmw,
                  n_pad=n_pad, m_bits=m_bits, k_hashes=k_hashes,
                  device=device, stats=st) for g, st in zip(graphs, stats)]
