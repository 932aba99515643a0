"""``chip_smoke.py``'s phase-10 values are the JAX package's.

EXPECTED_DIST (``repro.core.distributed.solve_distributed`` with 4 forced
host devices at cap_local 2^16, block 1024), EXPECTED_RESTART (the
restart case on 4 devices and on 2), EXPECTED_MESH_RUNG (the single-lane
decide) and the schedules' rows are recomputed with the reference on
the CPU, each D in a subprocess, and must equal the constants.
queen7_7's pin is in ``tests/test_torch_chip_smoke_dist_q7.py`` and the
one-device pin in ``tests/test_torch_chip_smoke_dist_single.py``, so
that the files run side by side.
"""
from repro.core import bounds as ref_bounds
from repro.core import graph as ref_graph
from repro.core import solver as ref_solver
from test_torch_chip_smoke import _chip_smoke
import torch_dist_twins as twins


def dist_rows(chip_smoke, cases, devices):
    """``solve_distributed`` rows at the card's phase-10 geometry, by
    ``chip_smoke.dist_label``."""
    calls = [("solve_rows", ([name],),
              dict(cap_local=chip_smoke.DIST_CAP // devices,
                   block=chip_smoke.DIST_BLOCK, **flags))
             for name, flags in cases]
    out = twins.reference(calls, devices, cores=None)
    return {chip_smoke.dist_label(name, flags): rows[name]
            for (name, flags), rows in zip(cases, out)}


def test_dist_values_come_from_reference():
    chip_smoke = _chip_smoke()
    cases = [c for c in chip_smoke.DIST_CASES if c[0] != "queen7_7"]
    got = dist_rows(chip_smoke, cases, chip_smoke.DIST_RANKS)
    assert got == {k: v for k, v in chip_smoke.EXPECTED_DIST.items()
                   if k != "queen7_7"}


def test_restart_values_come_from_reference():
    chip_smoke = _chip_smoke()
    r = chip_smoke.DIST_RESTART
    kw = dict(cap_local=r["cap_local"], block=r["block"])
    verdict, ckpts = twins.reference(
        [("checkpoints", (r["name"], r["k"]), kw)],
        chip_smoke.DIST_RANKS, cores=None)[0]
    mid = ckpts[len(ckpts) // 2]
    resume, resume2 = twins.reference(
        [("resume", (r["name"], r["k"], mid, "fused"), kw),
         ("resume", (r["name"], r["k"], mid, "fused"),
          dict(cap_local=2 * r["cap_local"], block=r["block"], ranks=2))],
        chip_smoke.DIST_RANKS, setup="""
        meshes[2] = distributed.make_solver_mesh(jax.devices()[:2])
    """, cores=None)
    got = dict(checkpoints=len(ckpts), mid_level=int(mid["level"]),
               full=verdict, resume=resume, resume2=resume2)
    assert got == chip_smoke.EXPECTED_RESTART


def test_mesh_rung_and_schedule_values_come_from_reference():
    chip_smoke = _chip_smoke()
    m = chip_smoke.MESH_RUNG
    g = ref_graph.REGISTRY[m["name"]]()
    clique = ref_bounds.greedy_max_clique(g)
    got = []
    for k in m["ks"]:
        r = ref_solver.decide(g, k, clique, cap=1 << 12, block=m["block"],
                              mode="sort", use_mmw=False, m_bits=1 << 24,
                              k_hashes=17, schedule="while")
        got.append((r.feasible, r.inexact, r.expanded))
    assert got == chip_smoke.EXPECTED_MESH_RUNG
    name, schedules = chip_smoke.SCHEDULE_CHECK
    want = chip_smoke.EXPECTED[name]
    for s in schedules:
        r = ref_solver.solve(ref_graph.REGISTRY[name](), schedule=s)
        assert (r.width, r.exact, r.lb, r.ub, r.expanded) == (
            want["width"], want["exact"], want["lb"], want["ub"],
            want["expanded"]), s
