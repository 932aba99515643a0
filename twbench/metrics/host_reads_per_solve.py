"""Blocking device-to-host reads per answered instance: calls of the
program's ``read_s`` span (``engine.read_host``: each level's count read,
each dispatch's result)."""


def read(ctx):
    t = ctx["timings"].get("read_s")
    if not ctx["answered"] or t is None:
        return None
    return t["calls"] / ctx["answered"]
