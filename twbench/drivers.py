"""The two kinds of traffic, each a general driver read from a mix's data
file (``twbench/traffic/<mix>.json``, key ``kind``):

* ``closed_solve``: one client solves the instances of a pool with
  ``solver.solve`` in turn, back to back;
* ``closed_suite``: one client submits the pool to one
  ``batch.solve_many`` call per pass, whole passes back to back.

Either window ends with the first whole solve or pass that ends past
``--seconds``.  A driver's ``setup`` builds the inputs and warms up the
shapes its traffic uses with the mix's ``warmup`` instances, which are
cheap to plan, through the same entry and knobs; ``window`` runs the
measured traffic; ``answers`` are the program's results, judged
afterwards against ``reference`` (which, with ``mode="bloom_small"``,
is also the benchmark's control).  The program's knobs come from the
configuration's file (``knobs``) and the mix's (``knobs``), the mix's
winning.
"""
from __future__ import annotations

import time

import numpy as np

from twbench import instances
from twbench.reference import solve as ref_solve


def to_program(g: instances.Graph):
    from repro_torch.core import graph as graph_lib
    return graph_lib.Graph(g.n, g.adj.copy(), g.name)


def answer_of(r) -> dict:
    """A program result (``SolveResult`` or the server's dict) as the
    fields that are judged."""
    get = (r.get if isinstance(r, dict) else
           (lambda k: getattr(r, k)))
    return dict(width=int(get("width")), exact=bool(get("exact")),
                lb=int(get("lb")), ub=int(get("ub")),
                expanded=int(get("expanded")), per_k=get("per_k") or {})


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.traffic, self.seed = traffic, int(seed)
        self.device = device
        self.knobs = {**config.get("knobs", {}), **traffic.get("knobs", {})}
        self.answers: list = []      # (instance index, answer dict)
        self.attempted = 0
        self.failed = 0
        self.instances: list = []    # instances.Graph per index
        self.walls: list = []        # seconds of each solve or pass

    def close(self) -> None:
        pass

    def plan_items(self) -> list:
        """(instance index, count answered) for the planning metric."""
        counts: dict = {}
        for i, _a in self.answers:
            counts[i] = counts.get(i, 0) + 1
        return sorted(counts.items())


def _pool(traffic: dict, seed: int) -> tuple:
    """A closed mix's instances and the order a run takes them in.  Every
    seed gets the same instances, relabelled once from the mix's
    ``pool_seed``; the run's seed draws only the order, so it moves the
    order and not the work."""
    names = traffic["instances"]
    graphs = [instances.relabelled(nm, traffic["pool_seed"], i)
              for i, nm in enumerate(names)]
    rng = np.random.default_rng([int(seed) % (1 << 64), 5])
    return graphs, [int(i) for i in rng.permutation(len(graphs))]


def _warmup(traffic: dict) -> list:
    return [to_program(instances.relabelled(nm, 1, i))
            for i, nm in enumerate(traffic.get("warmup", []))]


class ClosedSolve(Driver):
    """``solver.solve`` on the instances of the pool in turn."""

    def setup(self) -> None:
        from repro_torch.core import solver
        self.solver = solver
        self.instances, self.order = _pool(self.traffic, self.seed)
        self.graphs = [to_program(g) for g in self.instances]
        for g in _warmup(self.traffic):
            self._solve(g)

    def _solve(self, g):
        r = self.solver.solve(g, device=self.device, **self.knobs)
        _sync(self.device)
        return r

    def window(self, seconds: float) -> float:
        t0 = time.perf_counter()
        j = 0
        while time.perf_counter() - t0 < seconds:
            i = self.order[j % len(self.order)]
            j += 1
            self.attempted += 1
            t = time.perf_counter()
            self.answers.append((i, answer_of(self._solve(self.graphs[i]))))
            self.walls.append(time.perf_counter() - t)
        return time.perf_counter() - t0

    def reference(self, idx: list, device, mode=None) -> dict:
        return {i: ref_solve.solve(self.instances[i], device=device,
                                   **_ref_knobs(self.knobs, mode))
                for i in idx}


class ClosedSuite(Driver):
    """``batch.solve_many`` over the pool in the run's order, whole passes
    back to back."""

    def setup(self) -> None:
        from repro_torch.core import batch
        self.batch = batch
        self.instances, self.order = _pool(self.traffic, self.seed)
        self.graphs = [to_program(self.instances[i]) for i in self.order]
        warm = _warmup(self.traffic)
        if warm:
            self._pass(warm)

    def _pass(self, graphs):
        rs = self.batch.solve_many(graphs, device=self.device, **self.knobs)
        _sync(self.device)
        return rs

    def window(self, seconds: float) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.attempted += len(self.graphs)
            t = time.perf_counter()
            for i, r in zip(self.order, self._pass(self.graphs)):
                self.answers.append((i, answer_of(r)))
            self.walls.append(time.perf_counter() - t)
        return time.perf_counter() - t0

    def reference(self, idx: list, device, mode=None) -> dict:
        rs = ref_solve.solve_many(self.instances, device=device,
                                  **_ref_knobs(self.knobs, mode))
        return dict(enumerate(rs))


def _ref_knobs(k: dict, mode=None) -> dict:
    """The program's knobs that the reference takes; ``mode`` overrides
    the dedup (the control's ``bloom_small``)."""
    return dict(cap=k.get("cap"), block=k.get("block", 2048),
                mode=mode or k.get("mode", "sort"),
                use_mmw=k.get("use_mmw", False),
                m_bits=k.get("m_bits", 1 << 24),
                k_hashes=k.get("k_hashes", 17))


KINDS = {"closed_solve": ClosedSolve, "closed_suite": ClosedSuite}
