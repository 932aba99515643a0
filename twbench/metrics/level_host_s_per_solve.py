"""Host seconds spent enqueueing the levels of the level loop per answered
instance: the program's ``level_s`` span (``engine.decide_loop``, one a
level, its count read excluded; host clock)."""


def read(ctx):
    t = ctx["timings"].get("level_s")
    if not ctx["answered"] or t is None:
        return None
    return t["total_s"] / ctx["answered"]
