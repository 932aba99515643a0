"""Share of device-busy time in the port's own kernels, in %: the trace's
rows named after the hand-written kernels (``kernels/*/csrc``)."""

NAMES = ("wavefront_kernel", "bloom_count_kernel", "bloom_scatter_kernel",
         "bloom_resolve_kernel", "mmw_kernel", "expand_kernel")


def read(ctx):
    t = ctx["trace"]
    if not t or not t["busy_s"]:
        return None
    own = sum(v[1] for k, v in t["kernels"].items()
              if any(n in k for n in NAMES))
    if not own:
        return None
    return 100.0 * own / t["busy_s"]
