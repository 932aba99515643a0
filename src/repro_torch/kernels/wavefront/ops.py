"""Wrapper of the fused wavefront CUDA kernel (``csrc/wavefront.cu``).

``wavefront_expand`` is the ``cuda`` implementation of the registry's
``wavefront_expand`` op (``repro_torch.core.backend``), with the same
signature and bit-identical outputs as the ``torch`` op
(``repro_torch.core.expand.wavefront_expand``), both pruning rules
included.  It ports ``repro.kernels.wavefront.ops.wavefront_expand`` and
the Pallas kernel behind it.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``wavefront_ref``.  Nothing else falls back: a failed build or launch
raises.  ``LAUNCHES`` counts kernel launches, and ``LAUNCHES_BY_B`` the
same launches by chunk width (rows B of ``states``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core import expand
from repro_torch.core.backend import BackendCapabilityError
from repro_torch.kernels import build

LAUNCHES = 0
LAUNCHES_BY_B: collections.Counter = collections.Counter()

# states (warps) per thread block.  A block holds the adjacency (n*W words)
# in shared memory; under the simplicial rule each warp adds n*W words, 40
# KB per block at the largest W (8) and n (256)
WARPS_PER_BLOCK = 4

_c = ctypes.c_void_p
_i = ctypes.c_int
# adj, states, valid, allowed, k, n, w, n_states, warps_per_block,
# use_mmw, use_simplicial, children, feasible, stream
_ARGTYPES = [_c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _c, _c, _c]


def wavefront_ref(adj, states, valid, k, allowed, *, n: int,
                  schedule: str = "doubling", use_mmw: bool = False,
                  use_simplicial: bool = False):
    """Plain PyTorch version of the kernel: the ``torch`` backend op."""
    return expand.wavefront_expand(adj, states, valid, k, allowed, n=n,
                                   schedule=schedule, use_mmw=use_mmw,
                                   use_simplicial=use_simplicial)


def _lib():
    lib = build.library("wavefront")
    if lib.wavefront_launch.argtypes is None:
        lib.wavefront_launch.argtypes = _ARGTYPES
        lib.wavefront_launch.restype = ctypes.c_int
        lib.wavefront_max_words.argtypes = []
        lib.wavefront_max_words.restype = ctypes.c_int
    return lib


def _check(adj, states, valid, allowed, n):
    b, w = states.shape if states.dim() == 2 else (None, None)
    if w is None or adj.shape != (n, w) or allowed.shape != (w,) \
            or valid.shape != (b,):
        raise ValueError(
            f"wavefront_expand: expected adj ({n}, W), states (B, W), "
            f"valid (B,), allowed (W,); got {tuple(adj.shape)}, "
            f"{tuple(states.shape)}, {tuple(valid.shape)}, "
            f"{tuple(allowed.shape)}")
    build.check_operands("wavefront_expand", states.device,
                         adj=(adj, torch.int32), states=(states, torch.int32),
                         allowed=(allowed, torch.int32),
                         valid=(valid, torch.bool))


def wavefront_expand(adj, states, valid, k, allowed, *, n: int,
                     schedule: str = "doubling", use_mmw: bool = False,
                     use_simplicial: bool = False):
    """Fused expand + feasibility + pruning rules for a block of states.

    adj (n, W) int32 words; states (B, W) int32; valid (B,) bool; k int;
    allowed (W,) int32 -> (children (B, n, W) int32, feasible (B, n) bool).
    """
    global LAUNCHES
    if schedule != "doubling":
        raise BackendCapabilityError(
            f"the CUDA wavefront kernel runs the static doubling closure; "
            f"schedule={schedule!r} is not ported (ROADMAP A3)")
    _check(adj, states, valid, allowed, n)
    if states.device.type == "cpu":
        return wavefront_ref(adj, states, valid, k, allowed, n=n,
                             use_mmw=use_mmw, use_simplicial=use_simplicial)
    build.require_cuda("wavefront_expand", states)
    b, w = states.shape
    lib = _lib()
    if w > lib.wavefront_max_words():
        raise BackendCapabilityError(
            f"the CUDA wavefront kernel keeps a state's rows in registers "
            f"and supports W <= {lib.wavefront_max_words()} "
            f"(n <= {32 * lib.wavefront_max_words()}); got n={n}, W={w}")
    children = torch.empty((b, n, w), dtype=torch.int32, device=states.device)
    feasible = torch.empty((b, n), dtype=torch.bool, device=states.device)
    with torch.cuda.device(states.device):
        err = lib.wavefront_launch(
            adj.data_ptr(), states.data_ptr(), valid.data_ptr(),
            allowed.data_ptr(), int(k), n, w, b, WARPS_PER_BLOCK,
            int(use_mmw), int(use_simplicial), children.data_ptr(),
            feasible.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch("wavefront", err, f"n={n}, W={w}, B={b}")
    LAUNCHES += 1
    LAUNCHES_BY_B[b] += 1
    return children, feasible
