"""Rank functions of the sharded-step twins (``tests/test_torch_dryrun_
sharded.py``): spawned ranks import them from here by name."""
import numpy as np
import torch

MESH = (2, 2)


def sharded_grads(_solver_mesh, arch, cfg_kw, tree, batch_np):
    """One rank of a ``MESH`` ``(data, model)`` DeviceMesh over the ranks'
    gloo group: the reduced ``arch`` (``cfg_kw`` applied) with the
    reference's parameters ``tree`` carried across, its state placed by
    ``train.step.shard_state`` and its gradients taken sharded.  Returns
    the whole gradients (``flat_params`` order) and metrics as numpy."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.models import Model
    from repro_torch.models.params import from_reference
    from repro_torch.train import step as step_lib

    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(MESH))).reshape(MESH),
                      mesh_dim_names=("data", "model"))
    cfg = reduced(get_config(arch)).replace(**cfg_kw)
    model = Model(cfg, device="cpu")
    from_reference(model, tree)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    state = step_lib.shard_state({"params": model, "batch": batch}, mesh)
    with step_lib.sharded(model):
        grads, metrics = step_lib.grads_of(model, TrainConfig(),
                                           state["batch"])
    whole = lambda x: (x.full_tensor() if isinstance(x, DTensor) else x)
    return {"grads": [whole(g).detach().numpy() for g in grads],
            "metrics": {k: float(whole(v)) for k, v in metrics.items()},
            "sharded": sum(isinstance(p, DTensor) and any(
                pl.is_shard() for pl in p.placements)
                for p in model.parameters())}
