"""Collective accounting for the dry run (the counterpart of the reference's
``repro.utils.hlo`` and ``repro.utils.hlo2``).

The reference parses the compiled, per-device HLO for all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute ops and sums
their result bytes, once per loop body (``hlo``) and scaled by each loop's
trip count (``hlo2``).  The port runs its sharded program eagerly, so
``Recorder`` sees every collective as it is issued, loop iterations
included: its counts are what ``hlo2``'s trip-scaled ones measure.  A
record is ``(kind, bytes)``: the reference's kind name and the bytes of
the collective's result tensors on one rank.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

# bytes-on-wire multiplier per element byte (ring algorithms, large N limit)
_WIRE_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

KINDS = tuple(_WIRE_FACTOR)

# op names of the functional (``_c10d_functional``) and the process-group
# (``c10d``) collectives, by the reference's kind
_OPS = {
    "all-reduce": ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_", "allreduce_",
                   "allreduce_coalesced_"),
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced", "allgather_",
                   "_allgather_base_", "allgather_into_tensor_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                       "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
    "collective-permute": ("send", "recv_"),
}
_KIND_OF = {(ns, name): kind for kind, names in _OPS.items()
            for name in names for ns in ("_c10d_functional", "c10d")}


def tensor_bytes(t) -> int:
    """Bytes of a tensor's elements (a DTensor's local shard)."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * _DTYPE_BYTES[t.dtype]


def kind_of(func):
    """The reference's kind name of a collective op, else None."""
    ns, _, name = func._overloadpacket._qualified_op_name.partition("::")
    return _KIND_OF.get((ns, name))


def flat_tensors(x) -> list:
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of them
    (an op's arguments or outputs)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flat_tensors(v)]
    return []


class Recorder(TorchDispatchMode):
    """Records ``(kind, bytes)`` for every collective issued while it is
    active.  It lets DTensor desugar its ops first (``NotImplemented`` for
    DTensor arguments), so it sees the per-rank tensors and the
    collectives DTensor issues for them; ``observe`` sees every such op.
    The ops DTensor runs on fake tensors to propagate shapes are not the
    program's and are not observed."""

    def __init__(self):
        super().__init__()
        self.records = []
        self._kinds = {}

    @staticmethod
    def _delegate(types):
        """NotImplemented for DTensor arguments, True for the fake tensors
        of DTensor's shape propagation (run, not observed), else False."""
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return any(issubclass(t, FakeTensor) for t in types)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        skip = self._delegate(types)
        kwargs = kwargs or {}
        if skip is NotImplemented:
            return skip
        out = func(*args, **kwargs)
        if not skip:
            self.observe(func, args, kwargs, out)
        return out

    def observe(self, func, args, kwargs, out):
        if func not in self._kinds:
            self._kinds[func] = kind_of(func)
        kind = self._kinds[func]
        if kind is not None:
            self.records.append(
                (kind, sum(tensor_bytes(t) for t in flat_tensors(out))))


def collective_bytes(records) -> dict:
    """Per-rank collective bytes by kind, plus ``total_bytes`` (unweighted)
    and ``wire_bytes`` (weighted by each kind's wire factor)."""
    out = defaultdict(int)
    for kind, nbytes in records:
        out[kind] += nbytes
    stats = dict(out)
    stats["total_bytes"] = sum(out.values())
    stats["wire_bytes"] = sum(
        v * _WIRE_FACTOR.get(k, 1.0) for k, v in out.items())
    return stats


def count_ops(records, kind: str) -> int:
    return sum(1 for k, _ in records if k == kind)
