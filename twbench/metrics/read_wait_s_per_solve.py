"""Host seconds blocked in device-to-host reads per answered instance: the
program's ``read_s`` span, the wait for the device plus the copy (host
clock)."""


def read(ctx):
    t = ctx["timings"].get("read_s")
    if not ctx["answered"] or t is None:
        return None
    return t["total_s"] / ctx["answered"]
