"""Wrapper of the minor-min-width CUDA kernel (``csrc/mmw.cu``).

``mmw_bounds`` is the ``cuda`` implementation of the registry's
``mmw_bound`` op (``repro_torch.core.backend``), bit-identical to the
``torch`` op ``repro_torch.core.mmw.mmw_bound``.  It ports
``repro.kernels.mmw.ops.mmw_bounds`` and the Pallas kernel behind it.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``mmw_bounds_ref``.  Nothing else falls back: a failed build or launch
raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mmw
from repro_torch.core.backend import BackendCapabilityError
from repro_torch.kernels import build

LAUNCHES = 0

# states (warps) per thread block
WARPS_PER_BLOCK = 8

_c = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = [_c, _c, _i, _i, _i, _i, _i, _c, _c]


def mmw_bounds_ref(reach, states, k, *, n: int):
    """Plain PyTorch version of the kernel: the ``torch`` backend op."""
    return mmw.mmw_bound(reach, states, k, n=n)


def _lib():
    lib = build.library("mmw")
    if lib.mmw_launch.argtypes is None:
        lib.mmw_launch.argtypes = _ARGTYPES
        lib.mmw_launch.restype = ctypes.c_int
        lib.mmw_max_words.argtypes = []
        lib.mmw_max_words.restype = ctypes.c_int
    return lib


def mmw_bounds(reach, states, k, *, n: int):
    """MMW lower bounds of a batch of states.

    reach (B, n, W) int32 eliminated-graph rows; states (B, W) int32; k
    int -> (B,) int32 bounds, frozen once they exceed k.
    """
    global LAUNCHES
    if states.dim() != 2 or reach.shape != (states.shape[0], n,
                                            states.shape[-1]):
        raise ValueError(f"mmw_bounds: expected reach (B, {n}, W) and "
                         f"states (B, W); got {tuple(reach.shape)}, "
                         f"{tuple(states.shape)}")
    build.check_operands("mmw_bounds", states.device,
                         reach=(reach, torch.int32),
                         states=(states, torch.int32))
    if states.device.type == "cpu":
        return mmw_bounds_ref(reach, states, k, n=n)
    build.require_cuda("mmw_bounds", states)
    b, w = states.shape
    lib = _lib()
    if w > lib.mmw_max_words():
        raise BackendCapabilityError(
            f"the CUDA MMW kernel supports W <= {lib.mmw_max_words()} "
            f"(n <= {32 * lib.mmw_max_words()}); got n={n}, W={w}")
    lb = torch.empty((b,), dtype=torch.int32, device=states.device)
    with torch.cuda.device(states.device):
        err = lib.mmw_launch(reach.data_ptr(), states.data_ptr(), int(k), n,
                             w, b, WARPS_PER_BLOCK, lb.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    build.check_launch("mmw", err, f"n={n}, W={w}, B={b}")
    LAUNCHES += 1
    return lb
