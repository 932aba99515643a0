"""Wrapper of the eliminated-degree CUDA kernel (``csrc/expand.cu``).

``expand_degrees`` is the ``cuda`` implementation of the registry's
``expand_degrees`` op (``repro_torch.core.backend``): deg_S(v) for every
state row and vertex, bit-identical to the ``torch`` op.  It ports
``repro.kernels.expand.ops.expand_degrees`` and the Pallas kernel behind
it; the solver does not call it (it is the fused wavefront kernel's
closure without its outputs, kept for benchmarks and tests).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``expand_degrees_ref``.  Nothing else falls back: a failed build or launch
raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import components
from repro_torch.core.backend import BackendCapabilityError
from repro_torch.kernels import build

LAUNCHES = 0

# states (warps) per thread block; the block holds the adjacency (n*W
# words) in shared memory
WARPS_PER_BLOCK = 4

_c = ctypes.c_void_p
_i = ctypes.c_int
# adj, states, n, w, n_states, warps_per_block, deg, stream
_ARGTYPES = [_c, _c, _i, _i, _i, _i, _c, _c]


def expand_degrees_ref(adj, states, *, n: int):
    """Plain PyTorch version of the kernel: the ``torch`` backend op."""
    deg, _reach = components.eliminated_degrees(adj, states, n)
    return deg


def _lib():
    lib = build.library("expand")
    if lib.expand_launch.argtypes is None:
        lib.expand_launch.argtypes = _ARGTYPES
        lib.expand_launch.restype = ctypes.c_int
        lib.expand_max_words.argtypes = []
        lib.expand_max_words.restype = ctypes.c_int
    return lib


def expand_degrees(adj, states, *, n: int):
    """deg_S(v) for every state row and vertex.

    adj (n, W) int32 words; states (B, W) int32 -> (B, n) int32.
    """
    global LAUNCHES
    if states.dim() != 2 or adj.shape != (n, states.shape[-1]):
        raise ValueError(f"expand_degrees: expected adj ({n}, W) and "
                         f"states (B, W); got {tuple(adj.shape)}, "
                         f"{tuple(states.shape)}")
    build.check_operands("expand_degrees", states.device,
                         adj=(adj, torch.int32),
                         states=(states, torch.int32))
    if states.device.type == "cpu":
        return expand_degrees_ref(adj, states, n=n)
    build.require_cuda("expand_degrees", states)
    b, w = states.shape
    lib = _lib()
    if w > lib.expand_max_words():
        raise BackendCapabilityError(
            f"the CUDA expand kernel supports W <= {lib.expand_max_words()} "
            f"(n <= {32 * lib.expand_max_words()}); got n={n}, W={w}")
    deg = torch.empty((b, n), dtype=torch.int32, device=states.device)
    with torch.cuda.device(states.device):
        err = lib.expand_launch(adj.data_ptr(), states.data_ptr(), n, w, b,
                                WARPS_PER_BLOCK, deg.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    build.check_launch("expand", err, f"n={n}, W={w}, B={b}")
    LAUNCHES += 1
    return deg
