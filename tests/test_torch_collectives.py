"""The port's collective accounting (``utils.collectives``) against the
``hlo`` cases of the reference's ``tests/test_sharding_hlo.py``, on
synthetic records (the port records collectives as they run instead of
parsing HLO); one DTensor redistribution on a fake mesh, recorded; and
the MoE block's static-shape expert counts against ``torch.bincount``."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.models.moe import expert_counts
from repro_torch.utils import collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shape_bytes():
    assert collectives.tensor_bytes(
        torch.empty((256, 1024), dtype=torch.bfloat16, device="meta")) == \
        256 * 1024 * 2
    assert collectives.tensor_bytes(torch.empty(16)) == 64
    assert collectives.tensor_bytes(torch.empty(8, dtype=torch.bool)) == 8
    assert collectives.tensor_bytes(
        torch.empty(4, dtype=torch.int64, device="meta")) == 32


def test_collective_bytes_raw():
    out = collectives.collective_bytes([("all-gather", 20),
                                        ("all-reduce", 16)])
    assert out["all-gather"] == 20
    assert out["all-reduce"] == 16
    assert out["total_bytes"] == 36


def test_collective_bytes_scaled_synthetic():
    # an all-reduce issued once per step of a 7-step loop, as the reference's
    # synthetic HLO has it inside a while body of 7 trips
    records = [("all-gather", 64 * 4)] + [("all-reduce", 128 * 2 * 4)] * 7
    out = collectives.collective_bytes(records)
    assert out["all-gather"] == 64 * 4
    assert out["all-reduce"] == 128 * 2 * 4 * 7
    # wire factor: AR counts 2x
    assert out["wire_bytes"] == 64 * 4 + 128 * 2 * 4 * 7 * 2
    assert collectives.count_ops(records, "all-reduce") == 7
    assert collectives.count_ops(records, "all-to-all") == 0


@pytest.mark.parametrize("op,kind", [
    (torch.ops._c10d_functional.all_reduce.default, "all-reduce"),
    (torch.ops._c10d_functional.all_gather_into_tensor.default,
     "all-gather"),
    (torch.ops._c10d_functional.reduce_scatter_tensor.default,
     "reduce-scatter"),
    (torch.ops._c10d_functional.all_to_all_single.default, "all-to-all"),
    (torch.ops.c10d.allreduce_.default, "all-reduce"),
    (torch.ops.c10d._allgather_base_.default, "all-gather"),
    (torch.ops.aten.mm.default, None),
])
def test_kind_of(op, kind):
    assert collectives.kind_of(op) == kind


_REDISTRIBUTE = """
import json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \\
    distribute_tensor
from repro_torch.launch import mesh as mesh_lib
from repro_torch.utils import collectives
mesh = mesh_lib.make_mesh((4, 4), ("data", "model"), "cpu")
out = {}
x = distribute_tensor(torch.zeros(16, 8), mesh, [Shard(0), Replicate()])
with collectives.Recorder() as rec:
    x.redistribute(mesh, [Replicate(), Replicate()])
out["gather"] = rec.records
p = DTensor.from_local(torch.zeros(16, 8), mesh, [Partial(), Replicate()],
                       run_check=False)
with collectives.Recorder() as rec:
    p.redistribute(mesh, [Replicate(), Replicate()])
out["reduce"] = rec.records
with collectives.Recorder() as rec:
    p.redistribute(mesh, [Shard(0), Replicate()])
out["scatter"] = rec.records
print("RESULT " + json.dumps(out))
"""


def test_a_dtensor_redistribution_is_recorded():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REDISTRIBUTE)], env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    got = json.loads(line[len("RESULT "):])
    # a (16, 8) float32 tensor: its 4-row shards gathered over 'data'
    assert got["gather"] == [["all-gather", 16 * 8 * 4]]
    assert got["reduce"] == [["all-reduce", 16 * 8 * 4]]
    assert got["scatter"] == [["reduce-scatter", 4 * 8 * 4]]


@pytest.mark.parametrize("seed", range(6))
def test_expert_counts_equal_bincount(seed):
    g = torch.Generator().manual_seed(seed)
    n_experts = [4, 8, 32, 128, 5, 1][seed]
    k = 1 + seed % 3
    top_e = torch.randint(0, n_experts, (97, k), generator=g)
    flat = top_e.reshape(-1)
    got = expert_counts(flat, n_experts)
    want = torch.bincount(flat, minlength=n_experts)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
