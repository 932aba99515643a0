"""repro_torch: the treewidth solver of ``repro`` ported to PyTorch and CUDA.

``repro`` (JAX, Pallas kernels for the TPU) stays the reference; this
package mirrors its layout (``core/``, ``kernels/<name>/``, ``launch/``)
module by module and never imports it.

Public entry points:
  repro_torch.core.solver.solve
  repro_torch.launch.solve (CLI)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
