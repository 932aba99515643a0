"""The comparison that decides ``correct``: every judged answer of the
program against the plain reference's answer for the same instance.

An answer is its width, ``exact``, lb, ub, states expanded and each
block's per-rung verdicts (feasible, inexact, expanded).  All are exact
integers or flags, so an answer is right only when every field equals
the reference's, and the limit of each number below is 0:

* ``wrong``: judged answers that differ from the reference in any field;
* ``missing``: requests due in the window that were never answered or
  failed (an answer that comes late is late, not missing).
"""
from __future__ import annotations


def normal(a: dict) -> dict:
    """Field values with the per-rung keys as ints (the wire sends
    strings) and each verdict as a (feasible, inexact, expanded) tuple."""
    per_k = {}
    for block, rungs in (a.get("per_k") or {}).items():
        per_k[str(block)] = {
            int(k): (bool(v["feasible"]), bool(v["inexact"]),
                     int(v["expanded"])) for k, v in rungs.items()}
    return dict(width=int(a["width"]), exact=bool(a["exact"]),
                lb=int(a["lb"]), ub=int(a["ub"]),
                expanded=int(a["expanded"]), per_k=per_k)


def judge(answers: list, refs: dict, missing: int) -> tuple:
    """answers: (instance index, answer) pairs to judge, all of whose
    indices are in ``refs``.  Returns (numbers, first mismatch or None):
    numbers maps each compared name to (value, limit)."""
    wrong, first = 0, None
    for i, a in answers:
        got, want = normal(a), normal(refs[i])
        if got != want:
            wrong += 1
            if first is None:
                first = dict(instance=i, got=got, want=want)
    numbers = {"wrong": (wrong, 0), "missing": (missing, 0)}
    return numbers, first


def passes(numbers: dict, compared: int) -> bool:
    return compared > 0 and all(v <= lim for v, lim in numbers.values())
