"""Minimal parameter/spec system: the port of ``repro.models.params``.

A model is described by a *spec tree*: nested dicts whose leaves are
``Param(shape, logical_axes, init, scale)``.  From the same spec we derive:

  * the modules: ``ParamTree`` holds each leaf as an ``nn.Parameter``
    under its key, and each stacked ``"layers"`` subtree as an
    ``nn.ModuleList`` with one entry per repetition (the reference stacks
    them on a leading axis for ``lax.scan``);
  * seeded initialisation from an explicit ``torch.Generator``;
  * abstract tensors on the ``meta`` device (nothing allocated);
  * the weight carry-across from the reference's stacked tree
    (``from_reference``) and back (``to_reference_tree``), and of a
    whole train state (``state_from_reference``, ``state_to_reference``).

Logical axis names used across the zoo:
  "embed"   — d_model dim
  "heads"   — attention head dim
  "kv"      — kv head dim
  "mlp"     — feed-forward hidden
  "vocab"   — (padded) vocabulary
  "expert"  — MoE expert dim
  "layers"  — stacked repeat dim
  None      — replicated

Initialisation follows the reference's rule on the *stacked* spec: a leaf's
fan-in is ``shape[0]`` of its stacked shape, which for every per-layer
weight is the number of repetitions, so its std is ``scale / sqrt(n_reps)``;
``embed`` leaves use ``0.02 * scale`` and ``small`` leaves ``0.006 *
scale``.  The port's modules are unstacked, so each repetition is drawn
on its own with the stacked leaf's std.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"         # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_param(x) -> bool:
    return isinstance(x, Param)


def map_spec(fn: Callable, spec):
    """Map fn over Param leaves of a nested dict tree."""
    if is_param(spec):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: map_spec(fn, v) for k, v in spec.items()}
    raise TypeError(type(spec))


def leaves(spec, path: Tuple[str, ...] = ()) -> Iterator[Tuple[tuple, Param]]:
    """(path, Param) for every leaf, keys sorted at each level (the
    reference's ``init_params`` order)."""
    if is_param(spec):
        yield path, spec
        return
    for k in sorted(spec):
        yield from leaves(spec[k], path + (k,))


def init_std(p: Param) -> Optional[float]:
    """The reference's init std for a leaf of the stacked spec; ``None``
    for the constant (zeros / ones) leaves."""
    if p.init in ("zeros", "ones"):
        return None
    if p.init == "embed":
        return p.scale * 0.02
    if p.init == "small":
        return p.scale * 0.006
    fan_in = p.shape[0] if len(p.shape) > 1 else max(p.shape[0], 1)
    return p.scale / math.sqrt(fan_in)


def _fill(t: torch.Tensor, p: Param, gen: torch.Generator):
    std = init_std(p)
    with torch.no_grad():
        if p.init == "zeros":
            t.zero_()
        elif p.init == "ones":
            t.fill_(1.0)
        else:
            draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            draw.normal_(0.0, std, generator=gen)
            t.copy_(draw)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def init_params(spec, seed: int = 0, dtype=torch.float32, device="cpu"):
    """Concrete init of a spec into a nested dict of tensors (for blocks
    used on their own, as the tests do)."""
    gen = generator(seed, device)
    out: dict = {}
    for path, p in leaves(spec):
        val = torch.empty(p.shape, dtype=dtype, device=device)
        _fill(val, p, gen)
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = val
    return out


def abstract_params(spec, dtype=torch.float32):
    return map_spec(
        lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), spec)


def spec_axes(spec):
    return map_spec(lambda p: p.axes, spec)


def count_params(spec) -> int:
    total = [0]
    map_spec(lambda p: total.__setitem__(0, total[0] + int(np.prod(p.shape))),
             spec)
    return total[0]


def stack_spec(spec, reps: int):
    """Prepend a 'layers' axis to every leaf (the reference's scan layout)."""
    return map_spec(
        lambda p: Param((reps,) + p.shape, ("layers",) + p.axes,
                        p.init, p.scale), spec)


def unstack_spec(spec) -> Tuple[int, dict]:
    """(reps, per-repetition spec) of a spec built by ``stack_spec``."""
    reps = {p.shape[0] for _, p in leaves(spec)}
    assert len(reps) == 1, reps
    return reps.pop(), map_spec(
        lambda p: Param(p.shape[1:], p.axes[1:], p.init, p.scale), spec)


class ParamTree(nn.Module):
    """A spec tree as modules: each Param leaf an ``nn.Parameter`` under its
    key, each nested dict a ``ParamTree``, and each ``"layers"`` subtree
    (stacked by ``stack_spec``) an ``nn.ModuleList`` of one ``ParamTree``
    per repetition.  ``tree["key"]`` and ``"key" in tree`` read like the
    reference's dicts, so the block functions take either."""

    def __init__(self, spec: dict, dtype=torch.float32, device="cpu"):
        super().__init__()
        for k, v in spec.items():
            if is_param(v):
                self.register_parameter(k, nn.Parameter(
                    torch.empty(v.shape, dtype=dtype, device=device)))
            elif k == "layers":
                reps, unit = unstack_spec(v)
                self.add_module(k, nn.ModuleList(
                    ParamTree(unit, dtype, device) for _ in range(reps)))
            else:
                self.add_module(k, ParamTree(v, dtype, device))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def _targets(tree: nn.Module, path: tuple) -> List[torch.Tensor]:
    """The tensors of ``tree`` that the stacked leaf at ``path`` maps to:
    one per repetition under a ``"layers"`` ModuleList, else one."""
    nodes = [tree]
    for seg in path:
        nxt = []
        for node in nodes:
            child = node[seg]
            nxt.extend(child if isinstance(child, nn.ModuleList) else [child])
        nodes = nxt
    return nodes


def init_tree(tree: nn.Module, seed: int = 0):
    """Fill ``tree`` (a ``ParamTree`` of ``tree.spec``) in place from a
    generator seeded with ``seed`` on the parameters' device."""
    gen = None
    for path, p in leaves(tree.spec):
        for t in _targets(tree, path):
            if gen is None:
                gen = generator(seed, t.device)
            _fill(t, p, gen)


def _lookup(tree: dict, path: tuple):
    node = tree
    for seg in path:
        if not isinstance(node, dict) or seg not in node:
            raise KeyError(f"reference tree has no leaf {'/'.join(path)}")
        node = node[seg]
    return node


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _as_tensor(x) -> torch.Tensor:
    """A reference leaf as a tensor: torch tensors as they are, numpy
    arrays copied (bfloat16 read through float32, which holds every
    bfloat16 value exactly, and returned as bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def from_reference(tree_module: nn.Module, tree: dict):
    """Load the reference's parameter tree (nested dicts of numpy arrays
    or tensors, per-layer leaves stacked ``(n_reps, ...)``) into
    ``tree_module``.

    Shapes must match exactly and the tree must hold exactly the spec's
    leaves.  ``tree_module`` is a ``ParamTree`` of ``tree_module.spec``."""
    specs = list(leaves(tree_module.spec))
    if _count_leaves(tree) != len(specs):
        raise ValueError(f"reference tree has {_count_leaves(tree)} leaves, "
                         f"the spec {len(specs)}")
    with torch.no_grad():
        for path, p in specs:
            src = _as_tensor(_lookup(tree, path))
            if tuple(src.shape) != p.shape:
                raise ValueError(f"{'/'.join(path)}: reference shape "
                                 f"{tuple(src.shape)}, spec {p.shape}")
            targets = _targets(tree_module, path)
            if "layers" in path:
                for r, t in enumerate(targets):
                    t.copy_(src[r])
            else:
                targets[0].copy_(src)


def to_reference_tree(tree_module: nn.Module) -> dict:
    """The reference's stacked tree of ``tree_module`` (a ``ParamTree`` of
    ``tree_module.spec``) as numpy arrays (float32 for bfloat16
    parameters)."""
    out: dict = {}
    for path, _ in leaves(tree_module.spec):
        ts = [t.detach().cpu() for t in _targets(tree_module, path)]
        ts = [t.float() if t.dtype == torch.bfloat16 else t for t in ts]
        val = np.stack([t.numpy() for t in ts]) if "layers" in path \
            else ts[0].numpy()
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = val
    return out


def stacked_leaves(tree_module: nn.Module):
    """(path, stacked ``Param``, its tensors) for every leaf of
    ``tree_module.spec`` in the reference's leaf order (keys sorted at
    each level); a stacked leaf's tensors are its repetitions in turn."""
    return [(path, p, _targets(tree_module, path))
            for path, p in leaves(tree_module.spec)]


def flat_params(tree_module: nn.Module) -> List[torch.Tensor]:
    """The parameters in ``stacked_leaves`` order: the order in which the
    train step and the optimizers take gradients."""
    return [t for _, _, ts in stacked_leaves(tree_module) for t in ts]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def state_to_reference(state: dict) -> dict:
    """The reference's tree of a train state ``{"params": Model, "opt",
    "step"}`` as new CPU tensors (copies, which later steps do not
    change) in the reference's layout and dtypes: parameters stacked
    ``(n_reps, ...)``, the optimizer state (already stacked) and the
    step."""
    params: dict = {}
    for path, _, ts in stacked_leaves(state["params"]):
        node = params
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = torch.stack([t.detach() for t in ts]).cpu() \
            if "layers" in path else _host(ts[0])
    return {"params": params, "opt": _tree_map(_host, state["opt"]),
            "step": _host(state["step"])}


def state_from_reference(model: nn.Module, ref_state: dict) -> dict:
    """A train state on ``model``'s device from the reference's tree
    ``{"params", "opt", "step"}`` (numpy arrays, bfloat16 ones included,
    or tensors): the parameters are loaded into ``model``; the optimizer
    state (AdamW's ``m``/``v``, or Adafactor's ``(vr, vc)`` tuples and
    bfloat16 ``m``; ``count``) and the step keep the reference's stacked
    shapes and dtypes."""
    from_reference(model, ref_state["params"])
    dev = next(model.parameters()).device
    move = lambda x: _as_tensor(x).to(dev)
    return {"params": model, "opt": _tree_map(move, ref_state["opt"]),
            "step": move(ref_state["step"])}
