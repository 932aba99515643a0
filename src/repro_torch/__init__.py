"""repro_torch: the treewidth solver of ``repro`` ported to PyTorch and CUDA.

``repro`` (JAX, Pallas kernels for the TPU) stays the reference; this
package mirrors its layout (``core/``, ``kernels/<name>/``, ``serve/``,
``launch/``, ``configs/``, ``models/``, ``optim/``, ``train/``,
``sharding/``, ``data/``) module by module and never
imports it.

Public entry points:
  repro_torch.core.solver.solve
  repro_torch.launch.solve (CLI)
  repro_torch.models.Model, repro_torch.serve.engine.Engine,
  repro_torch.serve.scheduler.Scheduler
  repro_torch.launch.serve (LM serving CLI)
  repro_torch.launch.train, repro_torch.launch.supervisor (LM training CLIs)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
