"""The device trace of a ``--trace 1`` window: ``torch.profiler`` over the
whole window, reduced to what the per-layer readers and the result line
need.

* ``busy_s``: the union of the device's kernel, copy and set intervals;
* ``kernels``: rows and seconds per device operation name;
* ``idle_gaps``: the gaps between device intervals, summed by what the
  host was doing when each began: the innermost host-side torch op then
  running, or, when none was (Python: planning, scheduling, the
  harness), ``python after`` the torch op that ended last before it;
* ``window_s``: the traced window on the host clock.
"""
from __future__ import annotations

import bisect
import collections
import time


class Trace:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.end_ns(), e.name()))
            elif not e.is_user_annotation() and e.name().startswith("aten::"):
                host.append((e.start_ns(), e.end_ns(), e.name()))
        kernels = collections.defaultdict(lambda: [0, 0.0])
        for s, t, name in dev:
            kernels[name][0] += 1
            kernels[name][1] += (t - s) * 1e-9
        dev.sort()
        busy_ns, gaps = 0, []
        cur_s = cur_e = None
        for s, t, _n in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_ns += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, t
            else:
                cur_e = max(cur_e, t)
        if cur_e is not None:
            busy_ns += cur_e - cur_s
        idle = collections.Counter()
        host.sort()
        starts = [h[0] for h in host]
        ends = sorted((h[1], h[2]) for h in host)
        end_ts = [e[0] for e in ends]
        for g0, g1 in gaps:
            # the innermost host op running at the gap's start, or else
            # the host op that ended last before it
            j = bisect.bisect_right(starts, g0) - 1
            label = None
            for _hs, he, hn in reversed(host[max(0, j - 63):j + 1]):
                if he >= g0:
                    label = hn
                    break
            if label is None:
                k = bisect.bisect_right(end_ts, g0) - 1
                label = ("python after " + ends[k][1] if k >= 0
                         else "python")
            idle[label] += (g1 - g0) * 1e-9
        return dict(busy_s=busy_ns * 1e-9, window_s=self.window_s,
                    kernels={k: tuple(v) for k, v in kernels.items()},
                    idle_gaps=dict(idle))


def breakdown(red: dict) -> dict:
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(red["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[1]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
