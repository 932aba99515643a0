"""Mesh construction (the port of ``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module touches no
process group or device.

``make_local_mesh`` lays the ranks of the initialised process group out
as ``(data, model)``.  ``make_production_mesh`` and ``make_mesh`` serve
the dry run only: they lay out ranks of a *fake* process group of
``FAKE_WORLD`` ranks that this process starts (``torch.distributed``'s
``fake`` backend: collectives return at once and move nothing), as the
reference's dry run forces 512 placeholder host devices.  The group is
process-wide, so they raise when a real group is initialised, and the
dry run calls them in a process of its own (``launch.dryrun``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.backend import resolve_device

FAKE_WORLD = 512


def _fake_world():
    """Start the fake group of ``FAKE_WORLD`` ranks (this process is rank
    0), or reuse it; raise if another group is initialised."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" \
                and dist.get_world_size() == FAKE_WORLD:
            return
        raise RuntimeError(
            f"a {dist.get_backend()} process group of "
            f"{dist.get_world_size()} rank(s) is initialised; the dry run's "
            f"meshes need a fake group of {FAKE_WORLD} ranks in a process "
            f"of their own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=FAKE_WORLD,
                            store=FakeStore())


def make_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` (axes ``names``) over the first
    ``prod(shape)`` ranks of the fake group, on ``device``'s type (default:
    the card).  Serves ``--tp``: the reference's ``(256 // tp, tp)``."""
    n = math.prod(shape)
    if n > FAKE_WORLD:
        raise ValueError(f"mesh {shape} has more than {FAKE_WORLD} ranks")
    _fake_world()
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 chips per pod; multi-pod adds a leading 'pod' axis of 2 (512
    chips), the reference's layout.  Axis roles: pod = pure DP (one grad
    all-reduce per step), data = FSDP/DP, model = TP/EP/SP."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(model_axis: int = 1, device=None):
    """The ranks of the initialised process group as a ``(data, model)``
    ``DeviceMesh`` on ``device``'s type (default: the card)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into model axis "
                         f"{model_axis}")
    return init_device_mesh(resolve_device(device).type,
                            (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
