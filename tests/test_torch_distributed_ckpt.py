"""Port parity: the distributed solver's checkpoints, elastic restart,
forced donation, the mesh rung of the sharded engine and the CLI.

The reference runs in a subprocess with D forced host devices, the port
as D ``gloo`` ranks on the CPU, both running the same functions of
``tests/torch_dist_twins.py``.  Checkpoint dicts must be equal level by
level (``states`` and ``counts`` bit for bit); a resume from the
reference's middle checkpoint must give the reference's verdict on the
same mesh and on a smaller one (8 -> 4, the elastic restart, on a
subgroup of the port's ranks); forced donation must fire the
reference's donation counters.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from repro.core import bounds as ref_bounds
from repro.core import solver as ref_solver
from repro_torch.core import backend, graph, shard
import torch_dist_twins as twins

QUEEN = ("queen5_5", 18)
CKPT_KW = dict(cap_local=1 << 11, block=1 << 6)
# after an elastic restart onto 4 of the 8 ranks
CKPT_KW4 = dict(cap_local=1 << 12, block=1 << 6)
MESH_RUNG = ("mesh_rungs", ("petersen", (3, 4)), dict(cap=1 << 9,
                                                       block=1 << 6))
ENGINES = ("fused", "host")
DONATE_KW = dict(cap_local=1 << 10, block=1 << 6, donate_ratio=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _resumes(mid):
    """Resume from ``mid`` under both engines on all 8 ranks and on the
    first 4."""
    return [("resume", QUEEN + (mid, e), CKPT_KW) for e in ENGINES] + [
        ("resume", QUEEN + (mid, e), dict(CKPT_KW4, ranks=4))
        for e in ENGINES]


@pytest.fixture(scope="module")
def d8():
    """Reference and port on 8: the checkpoints, the mesh rung, and the
    resumes from the reference's middle checkpoint."""
    first = [("checkpoints", QUEEN, CKPT_KW), MESH_RUNG]
    ref_full, ref_rung = twins.reference(first, 8)
    mid = ref_full[1][len(ref_full[1]) // 2]
    ref_resumes = twins.reference(_resumes(mid), 8, setup="""
        meshes[4] = distributed.make_solver_mesh(jax.devices()[:4])
    """)
    ranks = twins.port_calls(first + _resumes(mid), 8)
    for r in ranks[1:]:          # the checkpoints are rank 0's alone
        assert r[0][0] == ranks[0][0][0] and r[1:4] == ranks[0][1:4]
    assert all(r[4:] == ranks[0][4:] for r in ranks[:4])
    return dict(ref=(ref_full, ref_rung, ref_resumes), port=ranks[0])


def test_checkpoints_equal_level_by_level(d8):
    (verdict, want), _, _ = d8["ref"]
    got_verdict, got = d8["port"][0]
    assert got_verdict == verdict
    twins.same_checkpoints(got, want)
    assert got[0]["states"].shape == (8 * CKPT_KW["cap_local"], 1)


@pytest.mark.parametrize("devices", [8, 4])
def test_resume_and_elastic_restart(d8, devices):
    """Crash-restart on the same mesh and elastic restart on 4 ranks, from
    the reference's own middle checkpoint, under both engines."""
    sel = slice(0, 2) if devices == 8 else slice(2, 4)
    want = d8["ref"][2][sel]
    got = d8["port"][2:][sel]
    assert got == want
    assert all(v[0] for v in got)


@pytest.fixture(scope="module")
def donations():
    calls = [("donation_counters", ("myciel4", e), DONATE_KW)
             for e in ENGINES]
    want = dict(zip(ENGINES, twins.reference(calls, 4)))
    ranks = twins.port_calls(calls, 4)
    assert all(r == ranks[0] for r in ranks)
    return want, dict(zip(ENGINES, ranks[0]))


@pytest.mark.parametrize("engine", ENGINES)
def test_forced_donation_matches_reference_counters(donations, engine):
    want, got = donations
    assert got[engine] == want[engine]
    counters = got[engine][1]
    assert counters["shard_donations"] > 0 \
        and counters["shard_donated_rows"] > 0


def test_mesh_rung_matches_single_lane(d8):
    """``shard.decide_sharded(mesh=...)`` on 8 ranks against the
    reference's single-lane decide (the case of tests/test_shard.py) and
    the reference's mesh rung."""
    g = oracle.make_graph("petersen")
    clique = ref_bounds.greedy_max_clique(g)
    want = []
    for k in (3, 4):
        ref = ref_solver.decide(g, k, clique, cap=1 << 12, block=1 << 6,
                                mode="sort", use_mmw=False,
                                m_bits=1 << 24, k_hashes=17,
                                schedule="while")
        want.append((ref.feasible, False, ref.expanded))
    assert d8["port"][1] == d8["ref"][1] == want


def test_mesh_rung_rejects_bloom_as_reference():
    """The mesh path is exact owner dedup only; the message is the
    reference's."""
    mesh = type("Mesh", (), {"devices": np.empty(2, dtype=object),
                             "device": torch.device("cpu")})()
    g = graph.REGISTRY["petersen"]()
    with pytest.raises(backend.BackendCapabilityError,
                       match="exact owner dedup only") as got:
        shard.decide_sharded(g, 3, (), shards=2, mesh=mesh, mode="bloom",
                             device="cpu")
    from repro.core import backend as ref_backend
    from repro.core import shard as ref_shard
    with pytest.raises(ref_backend.BackendCapabilityError) as want:
        ref_shard.decide_sharded(oracle.make_graph("petersen"), 3, (),
                                 shards=2, mesh=mesh, mode="bloom")
    assert str(got.value) == str(want.value)


def test_cli_distributed_prints_the_reference_line():
    def cli(module, *extra):
        env = {"PYTHONPATH": str(twins.ROOT / "src"), "PATH": "/usr/bin:/bin",
               "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
        with twins.few_cores():
            out = subprocess.run(
                [sys.executable, "-m", module, "--graph", "queen5_5",
                 "--distributed", "--devices", "4", *extra],
                cwd=twins.ROOT, capture_output=True, text=True,
                timeout=twins.DEADLINE_S, env=env)
        assert out.returncode == 0, out.stderr
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("[solve] treewidth=")]
        assert len(line) == 1, out.stdout
        return line[0].rsplit(" time=", 1)[0]

    want = cli("repro.launch.solve")
    got = cli("repro_torch.launch.solve", "--device", "cpu")
    assert got == want == ("[solve] treewidth=18 exact=True lb=12 ub=18 "
                           "states_expanded=2279")
