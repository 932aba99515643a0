"""Host planning seconds per answered instance, read inside the window:
the program's ``preprocess_s`` and ``plan_s`` spans (``core/preprocess.py``,
``solver.plan_block``; host clock)."""

SPANS = ("preprocess_s", "plan_s")


def read(ctx):
    t = ctx["timings"]
    if not ctx["answered"] or not any(s in t for s in SPANS):
        return None
    return sum(t[s]["total_s"] for s in SPANS if s in t) / ctx["answered"]
