"""Hand-written CUDA kernels for Hopper, one package per TPU kernel.

build.py    — nvcc build (sm_90a) and ctypes loading, on first use
wavefront/  — the fused inner loop: closure, deg_S(v), feasibility and
              children in one pass (replaces repro.kernels.wavefront)

Each kernel is registered beside its plain PyTorch version in the backend
registry (``repro_torch.core.backend``) as the ``cuda`` backend.
"""
