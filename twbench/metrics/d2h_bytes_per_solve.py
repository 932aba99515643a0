"""Bytes copied from the device to the host per answered instance: the
program's process-wide ``d2h_bytes`` counter (``engine.read_host``)."""


def read(ctx):
    c = ctx["counters"]
    if not ctx["answered"] or "d2h_bytes" not in c:
        return None
    return c["d2h_bytes"] / ctx["answered"]
