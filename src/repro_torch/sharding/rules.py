"""Logical-axis -> mesh-axis mapping with divisibility fallback (the port
of ``repro.sharding.rules``).

2D "FSDP x TP" layout (MaxText-style):
  embed  -> data axis   (fully-sharded parameters across DP)
  heads/kv/mlp/vocab/expert -> model axis (tensor/expert parallel)
  pod    -> pure DP (params replicated across pods; one grad all-reduce)

A mapping is applied only when the dimension is divisible by the mesh axis
size and the mesh axis is not already consumed by another dimension of the
same tensor; otherwise the dimension falls back to replicated.

A spec is a ``Spec``: a tuple with one entry per dim, each ``None``, a
mesh axis name, or a tuple of names, entry for entry the reference's
``PartitionSpec`` (a one-name tuple is written as the name, as
``PartitionSpec`` normalises it).  A mesh is anything with the axis sizes:
a ``torch.distributed`` ``DeviceMesh`` with dim names, or an object whose
``.shape`` maps axis names to sizes (the reference's duck type).
``placements`` turns a spec into ``DeviceMesh`` placements.

Specs of parameters are on the reference's *stacked* shapes
(``model.spec``; the ``layers`` dim is never sharded), so a per-repetition
tensor of the port takes its leaf's spec without the leading entry
(``param_specs``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.models.params import map_spec, stacked_leaves

DEFAULT_RULES = {
    "embed": ("data",),
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "layers": (),
}


class Spec(tuple):
    """Per-dim mesh axes of a tensor (the reference's ``PartitionSpec``)."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {nm: mesh.size(i) for i, nm in enumerate(names)}
    return dict(mesh.shape)


def _mesh_size(mesh, names: Tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for nm in names:
        size *= sizes[nm]
    return size


def _entry(names: Tuple[str, ...]):
    if len(names) == 0:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh, rules=None) -> Spec:
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        target = ()
        if ax is not None:
            for cand in rules.get(ax, ()):
                if cand in sizes and cand not in used \
                        and dim % sizes[cand] == 0:
                    target = target + (cand,)
                    used.add(cand)
                    break   # one mesh axis per dim in the default layout
        parts.append(_entry(target))
    return Spec(parts)


def param_shardings(spec_tree, mesh, rules=None):
    """Tree of specs matching a (stacked) Param spec tree."""
    return map_spec(lambda p: spec_for(p.shape, p.axes, mesh, rules),
                    spec_tree)


def param_specs(model, mesh, rules=None) -> dict:
    """The spec of each of ``model``'s tensors, by parameter name: a
    stacked leaf's spec without its ``layers`` entry for each of its
    repetitions."""
    by_id = {}
    for path, p, ts in stacked_leaves(model):
        spec = spec_for(p.shape, p.axes, mesh, rules)
        for t in ts:
            by_id[id(t)] = Spec(spec[1:]) if "layers" in path else spec
    return {name: by_id[id(t)] for name, t in model.named_parameters()}


def dp_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_sharding(mesh, ndim: int = 2,
                   batch_size: Optional[int] = None) -> Spec:
    """Shard the leading batch dim over (pod, data); replicate when the
    batch does not divide (e.g. long_500k's global batch of 1)."""
    dp = dp_axes(mesh)
    if batch_size is not None and batch_size % max(_mesh_size(mesh, dp), 1):
        return Spec([None] * ndim)
    return Spec([_entry(dp)] + [None] * (ndim - 1))


def batch_shardings_for(specs: dict, mesh) -> dict:
    return {k: batch_sharding(mesh, len(v.shape), v.shape[0])
            for k, v in specs.items()}


def replicated(mesh) -> Spec:
    return Spec()


def cache_shardings(cache, mesh):
    """Specs for the port's decode/prefill cache: a list of one unit dict
    per repetition, each leaf ``(B, ...)``.

    Batch (dim 0) shards over DP; dim 1 shards over the model axis when
    divisible.  These are the reference's dims 1 and 2 of its stacked
    ``(reps, B, ...)`` leaves, whose spec is this one behind a ``None``.
    For KV caches dim 1 is the *sequence* (sequence-sharded attention);
    for SSM states it is d_inner, giving plain TP."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dpn = _mesh_size(mesh, dp)

    def one(leaf):
        shape = leaf.shape
        parts: list = [None] * len(shape)
        if len(shape) >= 1 and dpn > 1 and shape[0] % dpn == 0:
            parts[0] = _entry(dp)
        if len(shape) >= 2 and "model" in sizes \
                and shape[1] % sizes["model"] == 0:
            parts[1] = "model"
        return Spec(parts)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return one(node)
    return walk(cache)


def placements(spec: Spec, mesh) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements on ``mesh``: one
    per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that axis,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for nm in (() if entry is None else
                   (entry,) if isinstance(entry, str) else entry):
            out[names.index(nm)] = Shard(d)
    return tuple(out)
