"""Share of device-busy time in the sort dedup and compaction, in %: the
trace's rows of the radix sort and its scans (``torch.sort``), the
cumulative sum and the scatter (``index_put_``) of ``core/dedup.py``."""

PARTS = ("sort", "scan", "index_put", "scatter", "cumsum")


def read(ctx):
    t = ctx["trace"]
    if not t or not t["busy_s"]:
        return None
    part = sum(v[1] for k, v in t["kernels"].items()
               if any(p in k.lower() for p in PARTS))
    if not part:
        return None
    return 100.0 * part / t["busy_s"]
