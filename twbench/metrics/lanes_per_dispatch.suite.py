"""Lanes decided per multi-lane dispatch over the window (telemetry
``lanes_decided`` / ``dispatches``)."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("dispatches"):
        return None
    return c.get("lanes_decided", 0) / c["dispatches"]
