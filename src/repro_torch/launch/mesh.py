"""Local mesh construction (the port of ``repro.launch.mesh``).

A FUNCTION, not a module-level constant: importing this module touches no
process group or device.  The reference's ``make_production_mesh`` (the
512-chip TPU pod layout) serves only its dry run and is not ported here.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.backend import resolve_device


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
