"""Hand-written CUDA kernels for Hopper, one package per TPU kernel.

build.py    — nvcc build (sm_90a) and ctypes loading, on first use, and
              the wrappers' shared checks
common/     — bits.cuh: the per-state closure, reach, simplicial and MMW
              device routines the kernels share
wavefront/  — the fused inner loop: closure, deg_S(v), feasibility,
              simplicial collapse, MMW prune and children in one pass
              (replaces repro.kernels.wavefront)
mmw/        — standalone MMW bounds from reach rows (repro.kernels.mmw)
expand/     — deg_S(v) only (repro.kernels.expand)
bloom/      — packed Bloom filter, rows inserted in order
              (repro.kernels.bloom)
paths/      — the capped disjoint-paths matrix of block planning, one
              warp per vertex pair (no TPU kernel: the JAX package
              computes it on the host, repro.core.bounds)

Each kernel but paths is registered beside its plain PyTorch version in
the backend registry (``repro_torch.core.backend``) as the ``cuda``
backend; ``solver.plan_block`` calls paths directly on a CUDA device.
"""
