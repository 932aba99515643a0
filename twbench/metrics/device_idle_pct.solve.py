"""Share of the traced window in which no device operation ran, in %:
100 x (1 - union of kernel, copy and set intervals / window)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
