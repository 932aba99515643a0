"""Backend registry: every wavefront op, registered once per backend.

Ports ``repro.core.backend`` with the same op names and signatures.  The
backends are:

  torch   the plain PyTorch ops in ``core/*``; they run on any device,
          the CPU included
  cuda    the hand-written Hopper kernels in ``repro_torch.kernels``

Capability table:

  op                 torch   cuda
  wavefront_expand     ✓      ✓     cuda: fused CUDA kernel (sm_90a)
  sort_dedup           ✓      ✓*    *torch.sort on both; a hand-written
                                     sort is queued (ROADMAP B2)

What the port does not do yet fails in ``validate`` with a
``BackendCapabilityError`` naming the ROADMAP item that adds it, before
any work starts.  Loaders are thunks, so importing this module loads no
kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

BACKENDS: Tuple[str, ...] = ("torch", "cuda")

DEDUP_MODES: Tuple[str, ...] = ("sort",)

# closure schedules ported so far (the reference's jax backend also has
# "while", "linear" and "matmul": the Table-6 sweep)
SCHEDULES: Tuple[str, ...] = ("doubling",)


class BackendCapabilityError(ValueError):
    """An op/backend/flag combination the registry cannot dispatch."""


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    doc: str
    loaders: Dict[str, Callable[[], Callable]]

    def resolve(self, backend: str) -> Callable:
        if backend not in self.loaders:
            have = ", ".join(sorted(self.loaders))
            raise BackendCapabilityError(
                f"op {self.name!r} has no {backend!r} implementation "
                f"(available backends: {have}). {self.doc}")
        return self.loaders[backend]()


_OPS: Dict[str, OpSpec] = {}


def _register(name: str, doc: str, **loaders) -> None:
    _OPS[name] = OpSpec(name=name, doc=doc, loaders=loaders)


def get_op(name: str, backend: str) -> Callable:
    """Resolve an op implementation; raises BackendCapabilityError with the
    available alternatives."""
    if backend not in BACKENDS:
        raise BackendCapabilityError(
            f"unknown backend {backend!r}; known backends: "
            f"{', '.join(BACKENDS)}")
    if name not in _OPS:
        raise BackendCapabilityError(
            f"unknown op {name!r}; registered ops: "
            f"{', '.join(sorted(_OPS))}")
    return _OPS[name].resolve(backend)


def capability_table() -> Dict[str, Tuple[str, ...]]:
    """op name -> backends that implement it (for docs and tests)."""
    return {name: tuple(b for b in BACKENDS if b in spec.loaders)
            for name, spec in sorted(_OPS.items())}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when no card is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch ops on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def default_backend(device: torch.device) -> str:
    """``cuda`` (the hand kernels) on a card, ``torch`` elsewhere."""
    return "cuda" if device.type == "cuda" else "torch"


def validate(backend: str, *, mode: str = "sort",
             schedule: str = "doubling", use_mmw: bool = False,
             use_simplicial: bool = False, lanes: int = 1,
             shards: int = 1, heuristics: int = 0,
             device: Optional[torch.device] = None) -> None:
    """Fail fast on configurations the port cannot run (yet)."""
    if backend not in BACKENDS:
        raise BackendCapabilityError(
            f"unknown backend {backend!r}; known backends: "
            f"{', '.join(BACKENDS)}")
    if mode not in DEDUP_MODES:
        raise BackendCapabilityError(
            f"dedup mode {mode!r} is not ported; the port runs exact "
            "sort-mode dedup (Bloom mode: ROADMAP A7, B5)")
    if schedule not in SCHEDULES:
        raise BackendCapabilityError(
            f"schedule={schedule!r} is not ported (supported: "
            f"{', '.join(SCHEDULES)}); the other closure schedules are "
            "the Table-6 sweep (ROADMAP A3)")
    if use_mmw:
        raise BackendCapabilityError(
            "use_mmw is not ported (MMW pruning: ROADMAP B4)")
    if use_simplicial:
        raise BackendCapabilityError(
            "use_simplicial is not ported (simplicial collapse: ROADMAP B3)")
    if lanes != 1:
        raise BackendCapabilityError(
            f"lanes={lanes}: the multi-lane engine is not ported "
            "(ROADMAP A8); run with lanes=1")
    if shards != 1:
        raise BackendCapabilityError(
            f"shards={shards}: the sharded engine is not ported "
            "(ROADMAP A10); run with shards=1")
    if heuristics:
        raise BackendCapabilityError(
            f"heuristics={heuristics}: the anytime bounds engine is not "
            "ported (ROADMAP A9); run with heuristics=0")
    if backend == "cuda" and device is not None \
            and torch.device(device).type != "cuda":
        raise BackendCapabilityError(
            f"backend='cuda' runs the CUDA kernels and needs a CUDA device "
            f"(got {device}); use backend='torch' on the CPU")
    get_op("wavefront_expand", backend)


# ------------------------------------------------------------ registrations

def _torch_wavefront_expand():
    from . import expand
    return expand.wavefront_expand


def _cuda_wavefront_expand():
    from repro_torch.kernels.wavefront import wavefront_expand
    return wavefront_expand


def _sort_dedup():
    from . import dedup

    def sort_dedup(flat, mask):
        skeys, svalid = dedup.sort_states(flat, mask)
        keep = dedup.unique_mask(skeys, svalid)
        return skeys, keep
    return sort_dedup


_register(
    "wavefront_expand",
    "The fused Listing-1 inner loop: expand + feasibility -> (children, "
    "feasible).",
    torch=_torch_wavefront_expand, cuda=_cuda_wavefront_expand)
_register(
    "sort_dedup",
    "Exact unsigned lexicographic sort + first-occurrence mask. torch.sort "
    "under both backends; a hand-written Hopper sort is queued "
    "(ROADMAP B2).",
    torch=_sort_dedup, cuda=_sort_dedup)
