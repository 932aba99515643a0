"""Backend registry: every wavefront op, registered once per backend.

Ports ``repro.core.backend`` with the same op names and signatures.  The
backends are:

  torch   the plain PyTorch ops in ``core/*``; they run on any device,
          the CPU included
  cuda    the hand-written Hopper kernels in ``repro_torch.kernels``

Capability table:

  op                 torch   cuda
  wavefront_expand     ✓      ✓     cuda: fused CUDA kernel, both pruning
                                     rules inside (sm_90a)
  expand_degrees       ✓      ✓     degrees only (no reach output)
  mmw_bound            ✓      ✓
  simplicial_mask      ✓      —     cuda: the rule exists only fused
                                     inside wavefront_expand
  sort_dedup           ✓      ✓*    *torch.sort on both; a hand-written
                                     sort is queued (ROADMAP B2)
  bloom_query_insert   ✓      ✓     torch: byte per bit, whole batch
                                     queried first; cuda: packed words,
                                     row-order inserts
  bloom_make_filter    ✓      ✓     torch: uint8 per bit; cuda: packed
                                     int32 words

``wavefront_expand``, ``sort_dedup`` and ``bloom_query_insert`` also take
a leading lane axis (the multi-lane engine, ``core.batch``, whose lanes
are also the sharded engine's shards, ``core.shard``): states
``(L, B, W)`` with per-lane adjacency, allowed mask and an ``(L,)`` int32
``k`` tensor; rows ``(L, M, W)`` sorted lane by lane; one filter per lane
(``bloom_make_filter(..., lanes=L)``).  Under ``cuda`` each is one
launch (or call) for every lane.

The ``torch`` ops take every closure schedule of the reference's
``jax`` backend (``TORCH_SCHEDULES``); the CUDA kernels bake in the
static doubling one (``CUDA_SCHEDULES``), as the reference's Pallas
kernels do.  What a backend cannot run fails in ``validate`` with a
``BackendCapabilityError``, before any work starts.  Loaders are
thunks, so importing this module loads no kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

BACKENDS: Tuple[str, ...] = ("torch", "cuda")

DEDUP_MODES: Tuple[str, ...] = ("sort", "bloom")

# backends whose ops take the leading lane axis of the multi-lane and the
# sharded engines
BATCHED_BACKENDS: Tuple[str, ...] = ("torch", "cuda")

# closure schedules of the torch ops (the Table-6 sweep); the CUDA kernels
# bake in the static-trip-count doubling schedule
TORCH_SCHEDULES: Tuple[str, ...] = ("doubling", "while", "linear", "matmul")
CUDA_SCHEDULES: Tuple[str, ...] = ("doubling",)


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


def ops() -> Tuple[str, ...]:
    return tuple(sorted(_OPS))


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


def device_memory_budget(fraction: float = 0.5,
                         device=None) -> Optional[int]:
    """Device memory available for frontier pools, in bytes.

    ``fraction`` of what the caching allocator could still hand out on
    ``device`` (default: the current card): the free bytes that
    ``torch.cuda.mem_get_info`` reports plus the blocks torch has
    reserved but not allocated, which it counts as used.  The rest stays headroom
    for the adjacency, children and sort buffers.  Returns ``None`` on
    the CPU or when no card is present, which ``batch.plan_capacity``
    treats as "state-space bound only"."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    return int((free + max(0, cached)) * fraction)


def default_backend(device: torch.device) -> str:
    """``cuda`` (the hand kernels) on a card, ``torch`` elsewhere."""
    return "cuda" if device.type == "cuda" else "torch"


def validate(backend: str, *, mode: str = "sort",
             schedule: str = "doubling", use_mmw: bool = False,
             use_simplicial: bool = False, m_bits: Optional[int] = None,
             lanes: int = 1, shards: int = 1,
             device: Optional[torch.device] = None) -> None:
    """Fail fast on configurations the port cannot run (yet)."""
    if backend not in BACKENDS:
        raise BackendCapabilityError(
            f"unknown backend {backend!r}; known backends: "
            f"{', '.join(BACKENDS)}")
    if mode not in DEDUP_MODES:
        raise BackendCapabilityError(
            f"unknown dedup mode {mode!r}; known modes: "
            f"{', '.join(DEDUP_MODES)}")
    schedules = CUDA_SCHEDULES if backend == "cuda" else TORCH_SCHEDULES
    if schedule not in schedules:
        raise BackendCapabilityError(
            f"backend={backend!r} does not implement schedule="
            f"{schedule!r} (supported: {', '.join(schedules)}). The CUDA "
            "wavefront kernel bakes in the static doubling fixpoint; the "
            "other schedules exist only as torch reference loops; use "
            "schedule='doubling' or backend='torch'.")
    if lanes < 1:
        raise BackendCapabilityError(
            f"lanes must be >= 1 (got {lanes})")
    if lanes > 1 and backend not in BATCHED_BACKENDS:
        raise BackendCapabilityError(
            f"backend {backend!r} does not support the multi-lane engine "
            f"(batched backends: {', '.join(BATCHED_BACKENDS)}); run with "
            "lanes=1 or switch backend.")
    if shards < 1:
        raise BackendCapabilityError(
            f"shards must be >= 1 (got {shards})")
    if shards > 1 and backend not in BATCHED_BACKENDS:
        raise BackendCapabilityError(
            f"backend {backend!r} does not support the sharded engine "
            f"(batched backends: {', '.join(BATCHED_BACKENDS)}); run with "
            "shards=1 or switch backend.")
    if mode == "bloom" and backend == "cuda" \
            and m_bits is not None and m_bits % 32:
        raise BackendCapabilityError(
            f"backend='cuda' keeps the Bloom filter bit-packed in 32-bit "
            f"words, so m_bits must be a multiple of 32 (got {m_bits}). "
            "Round m_bits up or use backend='torch'.")
    if backend == "cuda" and device is not None \
            and torch.device(device).type != "cuda":
        raise BackendCapabilityError(
            f"backend='cuda' runs the CUDA kernels and needs a CUDA device "
            f"(got {device}); use backend='torch' on the CPU")
    get_op("wavefront_expand", backend)
    if use_mmw:
        get_op("mmw_bound", backend)
    if use_simplicial and backend == "torch":
        # under cuda the rule exists only fused inside wavefront_expand
        get_op("simplicial_mask", "torch")
    if mode == "bloom":
        get_op("bloom_query_insert", backend)


# ------------------------------------------------------------ registrations

def _torch_wavefront_expand():
    from . import expand
    return expand.wavefront_expand


def _cuda_wavefront_expand():
    from repro_torch.kernels.wavefront import wavefront_expand
    return wavefront_expand


def _torch_expand_degrees():
    from . import components

    def expand_degrees(adj, states, *, n, schedule="doubling"):
        deg, _reach = components.eliminated_degrees(adj, states, n,
                                                    schedule=schedule)
        return deg
    return expand_degrees


def _cuda_expand_degrees():
    from repro_torch.kernels.expand import expand_degrees

    def expand_degrees_op(adj, states, *, n, schedule="doubling"):
        if schedule not in CUDA_SCHEDULES:
            raise BackendCapabilityError(
                f"the CUDA expand kernel bakes in the static doubling "
                f"closure; schedule={schedule!r} runs on backend='torch'")
        return expand_degrees(adj, states, n=n)
    return expand_degrees_op


def _torch_mmw_bound():
    from . import mmw
    return mmw.mmw_bound


def _cuda_mmw_bound():
    from repro_torch.kernels.mmw import mmw_bounds
    return mmw_bounds


def _torch_simplicial_mask():
    from . import expand
    return expand.simplicial_mask


def _sort_dedup():
    from . import dedup

    def sort_dedup(flat, mask):
        skeys, svalid = dedup.sort_states(flat, mask)
        keep = dedup.unique_mask(skeys, svalid)
        return skeys, keep
    return sort_dedup


def _torch_bloom_query_insert():
    from . import bloom
    return bloom.query_and_insert


def _cuda_bloom_query_insert():
    from repro_torch.kernels.bloom import bloom_insert
    return bloom_insert


def _torch_bloom_make_filter():
    from . import bloom
    return bloom.make_filter


def _cuda_bloom_make_filter():
    from repro_torch.kernels.bloom import make_filter_words
    return make_filter_words


_register(
    "wavefront_expand",
    "The fused Listing-1 inner loop: expand + feasibility + simplicial "
    "collapse + MMW prune -> (children, feasible).",
    torch=_torch_wavefront_expand, cuda=_cuda_wavefront_expand)
_register(
    "expand_degrees",
    "deg_S(v) only (no reach / children): benchmark and test surface of "
    "the unfused expansion kernel.",
    torch=_torch_expand_degrees, cuda=_cuda_expand_degrees)
_register(
    "mmw_bound",
    "Batched minor-min-width lower bounds from precomputed reach rows.",
    torch=_torch_mmw_bound, cuda=_cuda_mmw_bound)
_register(
    "simplicial_mask",
    "Standalone simplicial-candidate mask. Under cuda the rule exists "
    "only fused inside wavefront_expand; use backend='torch' or the fused "
    "op.",
    torch=_torch_simplicial_mask)
_register(
    "sort_dedup",
    "Exact unsigned lexicographic sort + first-occurrence mask. torch.sort "
    "under both backends; a hand-written Hopper sort is queued "
    "(ROADMAP B2).",
    torch=_sort_dedup, cuda=_sort_dedup)
_register(
    "bloom_query_insert",
    "Bloom-filter query-and-insert. torch: byte per bit, the whole batch "
    "queried before it is inserted; cuda: packed words, rows inserted in "
    "order. Identical was_new bits for batches whose rows share no probe "
    "bits.",
    torch=_torch_bloom_query_insert, cuda=_cuda_bloom_query_insert)
_register(
    "bloom_make_filter",
    "Backend-matched empty Bloom filter of m_bits bits on ``device``.",
    torch=_torch_bloom_make_filter, cuda=_cuda_bloom_make_filter)
