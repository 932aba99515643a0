"""Host planning seconds per answered instance: ``preprocess`` and
``solver.plan_block`` of the window's own instances, timed again by the
benchmark after the window (host clock)."""


def read(ctx):
    return ctx["plan_s"]
