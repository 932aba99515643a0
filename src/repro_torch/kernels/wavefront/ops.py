"""Wrapper of the fused wavefront CUDA kernel (``csrc/wavefront.cu``).

``wavefront_expand`` is the ``cuda`` implementation of the registry's
``wavefront_expand`` op (``repro_torch.core.backend``), with the same
signature and bit-identical outputs as the ``torch`` op
(``repro_torch.core.expand.wavefront_expand``), both pruning rules
included.  It ports ``repro.kernels.wavefront.ops.wavefront_expand`` and
the Pallas kernel behind it.  Given a leading lane axis (states
``(L, B, W)``) it expands every lane in one launch: the multi-lane
engine's form, which the reference gets from ``pallas_call``'s batching
rule under ``vmap``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``wavefront_ref``.  Nothing else falls back: a failed build or launch
raises.  ``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_B`` the same
launches by chunk width (rows B of each lane's states) and
``LAUNCHES_BY_LANES`` by lane count L (1 for the single-lane form) and
``LAUNCHES_BY_FLAGS`` by pruning rules, keyed ``(use_mmw,
use_simplicial)``.
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
LAUNCHES_BY_LANES: collections.Counter = collections.Counter()
LAUNCHES_BY_FLAGS: collections.Counter = collections.Counter()

# states (warps) per thread block.  A block holds the adjacency (n*W words)
# in shared memory; under the simplicial rule each warp adds n*W words, 40
# KB per block at the largest W (8) and n (256)
WARPS_PER_BLOCK = 4

_c = ctypes.c_void_p
_i = ctypes.c_int
# adj, states, states_lane_stride, valid, allowed, k, k_lanes, n, w,
# n_states, lanes, warps_per_block, use_mmw, use_simplicial, children,
# feasible, stream
_ARGTYPES = [_c, _c, ctypes.c_size_t, _c, _c, _i, _c, _i, _i, _i, _i, _i,
             _i, _i, _c, _c, _c]


def wavefront_ref(adj, states, valid, k, allowed, *, n: int,
                  schedule: str = "doubling", use_mmw: bool = False,
                  use_simplicial: bool = False):
    """Plain PyTorch version of the kernel: the ``torch`` backend op.
    With a lane axis it expands each lane on its own (``k`` is then an
    ``(L,)`` tensor)."""
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


def _check(adj, states, valid, k, allowed, n):
    """Shapes of the single-lane form, or of the lane form with a leading
    L on every operand and ``k`` an (L,) int32 tensor; states may be a
    lane-strided view whose rows are contiguous."""
    lanes = states.dim() == 3
    lead = tuple(states.shape[:1]) if lanes else ()
    b, w = states.shape[-2:] if states.dim() in (2, 3) else (None, None)
    k_ok = (isinstance(k, torch.Tensor) and k.shape == lead
            and k.dtype == torch.int32 and k.device == states.device) \
        if lanes else not isinstance(k, torch.Tensor) or k.dim() == 0
    if w is None or adj.shape != lead + (n, w) \
            or allowed.shape != lead + (w,) or valid.shape != lead + (b,) \
            or not k_ok:
        raise ValueError(
            f"wavefront_expand: expected adj ([L,] {n}, W), states ([L,] "
            f"B, W), valid ([L,] B), allowed ([L,] W) and k an int, or an "
            f"(L,) int32 tensor on the states' device with the lane axis; "
            f"got {tuple(adj.shape)}, {tuple(states.shape)}, "
            f"{tuple(valid.shape)}, {tuple(allowed.shape)}, k={k!r}")
    if states.dtype != torch.int32:
        raise TypeError(f"wavefront_expand: states must be torch.int32, "
                        f"got {states.dtype}")
    if (w > 1 and states.stride(-1) != 1) \
            or (b > 1 and states.stride(-2) != w):
        raise ValueError("wavefront_expand: each lane's states must be "
                         "contiguous rows")
    build.check_operands("wavefront_expand", states.device,
                         adj=(adj, torch.int32),
                         allowed=(allowed, torch.int32),
                         valid=(valid, torch.bool))


def wavefront_expand(adj, states, valid, k, allowed, *, n: int,
                     schedule: str = "doubling", use_mmw: bool = False,
                     use_simplicial: bool = False):
    """Fused expand + feasibility + pruning rules for a block of states.

    adj (n, W) int32 words; states (B, W) int32; valid (B,) bool; k int;
    allowed (W,) int32 -> (children (B, n, W) int32, feasible (B, n) bool).
    With a lane axis: adj (L, n, W), states (L, B, W), valid (L, B), k an
    (L,) int32 tensor, allowed (L, W) -> children (L, B, n, W), feasible
    (L, B, n), all lanes in one launch.
    """
    global LAUNCHES
    if schedule != "doubling":
        raise BackendCapabilityError(
            f"the CUDA wavefront kernel runs the static doubling closure; "
            f"schedule={schedule!r} is not ported (ROADMAP A3)")
    _check(adj, states, valid, k, allowed, n)
    if states.device.type == "cpu":
        return wavefront_ref(adj, states, valid, k, allowed, n=n,
                             use_mmw=use_mmw, use_simplicial=use_simplicial)
    build.require_cuda("wavefront_expand", states)
    lanes = states.dim() == 3
    nl = states.shape[0] if lanes else 1
    b, w = states.shape[-2:]
    lib = _lib()
    if w > lib.wavefront_max_words():
        raise BackendCapabilityError(
            f"the CUDA wavefront kernel keeps a state's rows in registers "
            f"and supports W <= {lib.wavefront_max_words()} "
            f"(n <= {32 * lib.wavefront_max_words()}); got n={n}, W={w}")
    lead = (nl,) if lanes else ()
    children = torch.empty(lead + (b, n, w), dtype=torch.int32,
                           device=states.device)
    feasible = torch.empty(lead + (b, n), dtype=torch.bool,
                           device=states.device)
    with torch.cuda.device(states.device):
        err = lib.wavefront_launch(
            adj.data_ptr(), states.data_ptr(),
            states.stride(0) if lanes else 0, valid.data_ptr(),
            allowed.data_ptr(), 0 if lanes else int(k),
            k.data_ptr() if lanes else None, n, w, b, nl, WARPS_PER_BLOCK,
            int(use_mmw), int(use_simplicial), children.data_ptr(),
            feasible.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch("wavefront", err, f"n={n}, W={w}, B={b}, L={nl}")
    if b and nl:
        LAUNCHES += 1
        LAUNCHES_BY_B[b] += 1
        LAUNCHES_BY_LANES[nl] += 1
        LAUNCHES_BY_FLAGS[(bool(use_mmw), bool(use_simplicial))] += 1
    return children, feasible
