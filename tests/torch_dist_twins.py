"""Twins of the distributed solver: the reference in a subprocess with D
forced host devices, the port as D ``gloo`` ranks on the CPU.

Both sides run the same functions of this module, each on its own
package (``pkg="repro"`` or ``"repro_torch"``): their ``core`` modules
share the names and signatures used here.  The reference needs
``XLA_FLAGS`` set before ``jax`` starts, so it runs in a child process
(``reference``), as ``tests/test_distributed_tw.py`` runs it; the
port's ranks are spawned processes (``port``), so the functions live
at module level and this module imports neither package at the top.
A test file gathers its cases into one call per side and D, because
every child process pays for importing its package.

The suite runs several test workers side by side, so each twin's
reference child and group of ranks runs on ``CORES`` cores chosen by
its worker (``few_cores``); the reference-only pins of
``chip_smoke.py``'s full-size values take every core.  Every run is
bounded by a deadline.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a whole group run, and a reference child, must end within this (as
# tests/test_distributed_tw.py bounds its children)
DEADLINE_S = 420
# cores for one reference child or one group of ranks
CORES = 2


@contextlib.contextmanager
def few_cores(cores=CORES):
    """Confine this thread, and the processes it starts, to ``cores``
    cores chosen by the test worker's number (all of them for None)."""
    old = os.sched_getaffinity(0)
    cpus = sorted(old)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    n = len(cpus) if cores is None else min(cores, len(cpus))
    first = n * int(worker.lstrip("gw") or 0)
    os.sched_setaffinity(0, {cpus[(first + j) % len(cpus)]
                             for j in range(n)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, old)


def run_child(script: str, devices: int, cores=CORES):
    """Run ``script`` under ``devices`` forced host devices on ``cores``
    cores; returns the child's ``subprocess.CompletedProcess``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    with few_cores(cores):
        done = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True,
                              timeout=DEADLINE_S)
    assert done.returncode == 0, done.stdout + "\n" + done.stderr
    return done


def reference(calls, devices: int, setup: str = "", cores=CORES):
    """``run_all(mesh, calls, pkg="repro")`` in a child process with
    ``devices`` forced host devices on ``cores`` cores; ``setup`` may
    bind smaller meshes into ``meshes`` (see ``run_all``)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = pathlib.Path(tmp) / "out.pkl"
        in_path = pathlib.Path(tmp) / "calls.pkl"
        in_path.write_bytes(pickle.dumps(calls))
        run_child(textwrap.dedent(f"""
            import pickle
            import jax
            from repro.core import distributed
            import torch_dist_twins as twins
            mesh = distributed.make_solver_mesh()
            assert mesh.devices.size == {devices}
            meshes = {{}}
        """) + textwrap.dedent(setup) + textwrap.dedent(f"""
            calls = pickle.loads(open({str(in_path)!r}, "rb").read())
            out = twins.run_all(mesh, calls, pkg="repro", meshes=meshes)
            open({str(out_path)!r}, "wb").write(pickle.dumps(out))
        """), devices, cores)
        return pickle.loads(out_path.read_bytes())


def port(fn, devices: int, *args, **kwargs) -> list:
    """``fn(mesh, *args, **kwargs)`` on ``devices`` CPU ranks; the ranks'
    results in rank order."""
    from repro_torch.core import distributed
    with few_cores():
        return distributed.launch(fn, devices, *args, device="cpu",
                                  timeout_s=DEADLINE_S,
                                  deadline_s=DEADLINE_S, **kwargs)


def port_calls(calls, devices: int) -> list:
    """``run_all(mesh, calls)`` on ``devices`` CPU ranks of the port;
    every rank's results."""
    return port(run_all, devices, calls)


def both(calls: dict, devices: int):
    """The named calls on both sides at ``devices``: (the reference's
    results, the port's) by name, after checking that every rank of the
    port returned the same."""
    names, todo = list(calls), list(calls.values())
    want = dict(zip(names, reference(todo, devices)))
    got = [dict(zip(names, r)) for r in port_calls(todo, devices)]
    assert all(g == got[0] for g in got), got
    return want, got[0]


def row(r) -> dict:
    return dict(width=r.width, exact=r.exact, lb=r.lb, ub=r.ub,
                expanded=r.expanded)


# ------------------------------------------------ functions both sides run

def _core(pkg, name):
    return importlib.import_module(f"{pkg}.core.{name}")


def run_all(mesh, calls, pkg="repro_torch", meshes=None):
    """Each ``(function name, args, kwargs)`` of this module, in order,
    on ``mesh`` or, with ``ranks=r`` among the kwargs, on a mesh of the
    first r ranks: ``meshes[r]`` on the reference (bound by
    ``reference``'s ``setup``), a subgroup on the port (None on the
    ranks outside it).  Returns the results."""
    out = []
    for name, args, kw in calls:
        kw = dict(kw)
        use = mesh
        if "ranks" in kw:
            use = _sub_mesh(mesh, kw.pop("ranks"), pkg, meshes)
        out.append(None if use is None
                   else globals()[name](use, *args, pkg=pkg, **kw))
    return out


def _sub_mesh(mesh, size, pkg, meshes):
    if pkg == "repro":
        return meshes[size]
    import torch.distributed as dist
    group = dist.new_group(list(range(size)))      # every rank takes part
    if mesh.rank >= size:
        return None
    return _core(pkg, "distributed").make_solver_mesh(group=group,
                                                      device=mesh.device)


def solve_rows(mesh, names, pkg="repro_torch", **kw):
    """``solve_distributed`` on each REGISTRY name -> name -> row."""
    distributed, graph = _core(pkg, "distributed"), _core(pkg, "graph")
    return {name: row(distributed.solve_distributed(
        graph.REGISTRY[name](), mesh, **kw)) for name in names}


def decide_ladders(mesh, cases, engines, pkg="repro_torch", **kw):
    """For each (name, cap_local), each engine decides k up the ladder
    until the first feasible k -> {name: {engine: [(k, verdict), ...]}}."""
    bounds, distributed = _core(pkg, "bounds"), _core(pkg, "distributed")
    graph = _core(pkg, "graph")
    out = {}
    for name, cap_local in cases:
        g = graph.REGISTRY[name]()
        clique = bounds.greedy_max_clique(g)
        out[name] = {}
        for engine in engines:
            ladder = []
            for k in range(max(1, len(clique) - 1), g.n - len(clique)):
                res = distributed.decide_distributed(
                    g, k, clique, mesh, cap_local=cap_local, engine=engine,
                    **kw)
                ladder.append((k, tuple(res)))
                if res[0]:
                    break
            out[name][engine] = ladder
    return out


def decide_tree(mesh, n, seed, k, pkg="repro_torch", **kw):
    """``decide_distributed`` on ``random_tree(n, seed)`` with no clique."""
    distributed, graph = _core(pkg, "distributed"), _core(pkg, "graph")
    return tuple(distributed.decide_distributed(
        graph.random_tree(n, seed), k, [], mesh, **kw))


def checkpoints(mesh, name, k, pkg="repro_torch", **kw):
    """``decide_distributed`` with a checkpoint callback on every rank;
    returns (verdict, the checkpoint dicts; on the port rank 0's)."""
    bounds, distributed = _core(pkg, "bounds"), _core(pkg, "distributed")
    g = _core(pkg, "graph").REGISTRY[name]()
    ckpts = []
    res = distributed.decide_distributed(
        g, k, bounds.greedy_max_clique(g), mesh, checkpoint_cb=ckpts.append,
        **kw)
    return tuple(res), ckpts


def resume(mesh, name, k, ckpt, engine, pkg="repro_torch", **kw):
    bounds, distributed = _core(pkg, "bounds"), _core(pkg, "distributed")
    g = _core(pkg, "graph").REGISTRY[name]()
    return tuple(distributed.decide_distributed(
        g, k, bounds.greedy_max_clique(g), mesh, resume=ckpt,
        engine=engine, **kw))


def donation_counters(mesh, name, engine, pkg="repro_torch", **kw):
    """``solve_distributed`` under a tracker -> (row, shard counters)."""
    tr = _core(pkg, "telemetry").Tracker()
    r = _core(pkg, "distributed").solve_distributed(
        _core(pkg, "graph").REGISTRY[name](), mesh, engine=engine,
        tracker=tr, **kw)
    snap = tr.snapshot()
    counters = {k: snap["counters"].get(k, 0)
                for k in ("shard_donations", "shard_donated_rows",
                          "shard_idle_steps")}
    counters["shard_peak_occupancy"] = snap.get("gauges", {}).get(
        "shard_peak_occupancy", 0)
    return row(r), counters


def mesh_rungs(mesh, name, ks, pkg="repro_torch", **kw):
    """``shard.decide_sharded(..., mesh=mesh)`` for each k."""
    g = _core(pkg, "graph").REGISTRY[name]()
    clique = _core(pkg, "bounds").greedy_max_clique(g)
    shard = _core(pkg, "shard")
    out = []
    for k in ks:
        r = shard.decide_sharded(g, k, clique, shards=mesh.devices.size,
                                 mesh=mesh, **kw)
        out.append((r.feasible, r.inexact, r.expanded))
    return out


# ------------------------------------------------------ port-only helpers

def solve_rows_launched(mesh, names, **kw):
    """``solve_rows`` and this rank's wavefront-kernel launches."""
    from repro_torch.kernels.wavefront import ops
    ops.LAUNCHES = 0
    return solve_rows(mesh, names, **kw), ops.LAUNCHES


def fail_on(mesh, rank):
    """Raise on ``rank``; the others wait in a collective."""
    import torch
    import torch.distributed as dist
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} failed on purpose")
    dist.all_reduce(torch.zeros(1), group=mesh.group)


def stall(mesh, rank, seconds):
    """``rank`` sleeps past the group's timeout while the others wait in
    a collective."""
    import time
    import torch
    import torch.distributed as dist
    if mesh.rank == rank:
        time.sleep(seconds)
    dist.all_reduce(torch.zeros(1), group=mesh.group)
    return mesh.rank


def same_checkpoints(got: list, want: list) -> None:
    """Equal level by level: every scalar, and ``states`` and ``counts``
    bit for bit."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        for key in ("level", "k", "expanded", "inexact"):
            assert a[key] == b[key], (key, a[key], b[key])
        assert a["states"].dtype == np.uint32
        assert np.array_equal(a["states"], b["states"]), a["level"]
        assert np.array_equal(a["counts"], b["counts"]), a["level"]


# ------------------------------------------- int8 gradient compression (LM)

def compressed_psum_rows(mesh, x):
    """``train.step.compressed_psum`` of row ``mesh.rank`` of ``x`` over
    the ranks: every rank's result (the mean of the rows)."""
    import torch
    from repro_torch.train.step import compressed_psum
    return compressed_psum(torch.from_numpy(x[mesh.rank]),
                           mesh.group).numpy()


def compressed_training(mesh, cfg_kw, ref_params, steps, lr=1e-2):
    """The port's half of ``tests/test_grad_compression.py::
    test_compressed_training_still_learns`` from the reference's
    parameters ``ref_params``: the compressed gradients of the first step
    and each stacked leaf's shared quantisation scale (by key), and every
    step's loss."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models.params import from_reference, stacked_leaves
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import step as step_lib

    torch.set_num_threads(1)
    scales = []
    psum = step_lib.compressed_psum

    def recording_psum(g, group=None):
        gmax = torch.max(torch.abs(g.float()))
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        scales.append(max(float(gmax), 1e-12) / 127.0)
        return psum(g, group)

    step_lib.compressed_psum = recording_psum
    model = Model(ModelConfig(**cfg_kw), device="cpu")
    from_reference(model, ref_params)
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=0, total_steps=40)
    grads_fn = step_lib.build_compressed_grads(model, tcfg, mesh.group)
    opt = opt_lib.adamw_init(model)
    data = SyntheticLM(vocab=cfg_kw["vocab"], seq_len=32, global_batch=8,
                       seed=4)
    losses, first = [], None
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        g, m = grads_fn(model, b)
        if first is None:
            step_lib.compressed_psum = psum
            first, j = {}, 0
            for leaf, (path, _, ts) in enumerate(stacked_leaves(model)):
                rows = [x.numpy() for x in g[j:j + len(ts)]]
                j += len(ts)
                first["/".join(path)] = (np.stack(rows) if "layers" in path
                                         else rows[0], scales[leaf])
        g, _ = opt_lib.clip_by_global_norm(g, 1.0)
        opt_lib.adamw_update(g, opt, model, lr=lr)
        losses.append(float(m["loss"]))
    return first, losses
