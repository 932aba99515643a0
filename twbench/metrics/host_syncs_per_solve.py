"""Host reads of device results (telemetry ``host_syncs``) per answered
instance over the window."""


def read(ctx):
    if not ctx["answered"]:
        return None
    return ctx["counters"].get("host_syncs", 0) / ctx["answered"]
