"""Wrapper of the disjoint-paths CUDA kernel (``csrc/paths.cu``).

``paths_matrix`` computes the capped disjoint-paths matrix of one graph,
``P[u, v] = min(#internally vertex-disjoint u-v paths, cap + 1)``, equal
bit for bit to the host function ``repro_torch.core.bounds.
disjoint_paths_matrix``.  It ports no Pallas kernel: the JAX package
computes the matrix on the host.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``paths_matrix_ref``, the same augmenting search over W-word vertex
masks, batched over the pair axis.  Nothing else falls back: a failed
build or launch raises.  ``LAUNCHES`` counts kernel launches.

``disjoint_paths_matrix`` is the form that block planning calls
(``solver.plan_block`` on a card): it uploads the packed adjacency,
launches and reads the matrix back (``engine.read_host``) on a stream of
its own, one per device, so the read waits for this kernel alone and not
for work already queued on the solver's stream.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.core import bitset, engine, telemetry
from repro_torch.core.backend import BackendCapabilityError
from repro_torch.kernels import build

LAUNCHES = 0

# pairs (warps) per thread block; the block holds the adjacency (n*W
# words) in shared memory
WARPS_PER_BLOCK = 8

# pairs per step of the plain version (its largest tensor is
# PAIR_CHUNK x n x W int64 words: 128 MiB at n = 256)
PAIR_CHUNK = 8192

_c = ctypes.c_void_p
_i = ctypes.c_int
# adj, n, w, cap, warps_per_block, out, stream
_ARGTYPES = [_c, _i, _i, _i, _i, _c, _c]

_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


# ---------------------------------------------------------- plain version

def _pack(mask, w: int):
    """(A, n) bool -> (A, W) int64 words (bit v of word v >> 5)."""
    a, n = mask.shape
    padded = torch.zeros((a, 32 * w), dtype=torch.int64, device=mask.device)
    padded[:, :n] = mask
    shifts = torch.arange(32, device=mask.device)
    return (padded.view(a, w, 32) << shifts).sum(-1)


def _one_hot_words(q, w: int):
    """Vertices q (any shape) -> their single-bit words, shape + (W,)."""
    word = torch.arange(w, device=q.device)
    return torch.where(word == (q >> 5)[..., None], 1 << (q & 31)[..., None],
                       0)


def _search(words, s, t, flow, tin, pred, succ):
    """One layered search per pair from s_out to t_in over the residual
    graph, as ``paths.cu``'s ``augment``.  Returns (found, par, self_in):
    par[y] is the out-node that first reached y_in over an edge, self_in
    the in-nodes reached from their own out-node."""
    a, n = flow.shape
    w = words.shape[1]
    ar = torch.arange(a, device=s.device)
    vin = torch.zeros((a, n), dtype=torch.bool, device=s.device)
    vout, fout, self_in = (torch.zeros_like(vin) for _ in range(3))
    vin[ar, s] = vout[ar, s] = vout[ar, t] = fout[ar, s] = True
    par = torch.zeros((a, n), dtype=torch.int64, device=s.device)
    # arcs into y_in that carry flow: from pred[y], and into t from tin
    # (and from s, whose edge st counted up front)
    ex = _one_hot_words(pred, w) * flow[..., None]
    ex[ar, t] |= _pack(tin, w) | _one_hot_words(s, w)
    searching = torch.ones(a, dtype=torch.bool, device=s.device)
    found = torch.zeros_like(searching)
    while bool(searching.any()):
        cand = words[None] & _pack(fout, w)[:, None, :] & ~ex
        nonzero = cand != 0
        first = nonzero.to(torch.uint8).argmax(-1)
        word = cand.gather(-1, first[..., None]).squeeze(-1)
        low_bit = torch.frexp((word & -word).double()).exponent - 1
        open_in = ~vin & searching[:, None]
        edge = open_in & nonzero.any(-1)
        self_ = open_in & ~edge & flow & fout
        par = torch.where(edge, 32 * first + low_bit, par)
        self_in |= self_
        fin = edge | self_
        vin |= fin
        hit = fin[ar, t]
        found |= hit
        searching &= ~hit & fin.any(1)
        reached = torch.where(flow, fin.gather(1, succ), fin)
        fout = ~vout & searching[:, None] & reached
        vout |= fout
        searching &= fout.any(1)
    return found, par, self_in


def _augment(s, t, flow, tin, pred, succ, par, self_in):
    """Walk each pair's path back from t_in and push one unit along it;
    updates flow, tin, pred and succ in place."""
    a, n = flow.shape
    ar = torch.arange(a, device=s.device)
    has_pred = flow.clone()
    v = t.clone()
    inner = torch.ones(a, dtype=torch.bool, device=s.device)
    done = torch.zeros_like(inner)
    while not bool(done.all()):
        at_in = ~done & inner
        at_out = ~done & ~inner
        own = at_in & (v != t) & self_in[ar, v]        # y_out -> y_in
        edge = at_in & ~own                            # x_out -> v_in
        x = par[ar, v]
        into_t = edge & (v == t)
        tin[ar[into_t], x[into_t]] = True
        mid = edge & (v != t)
        pred[ar[mid], v[mid]] = x[mid]
        has_pred[ar[mid], v[mid]] = True
        done |= at_out & (v == s)
        back = at_out & ~done & flow[ar, v]            # succ[v]_in -> v_out
        y = succ[ar, v]
        has_pred[ar[back], y[back]] = False
        v = torch.where(edge, x, torch.where(back, y, v))
        inner = torch.where(at_in, False, torch.where(at_out & ~done, True,
                                                      inner))
    flow.copy_(has_pred)
    rows, ys = flow.nonzero(as_tuple=True)
    xs = pred[rows, ys]
    inner_x = xs != s[rows]
    succ[rows[inner_x], xs[inner_x]] = ys[inner_x]
    rows, xs = tin.nonzero(as_tuple=True)
    succ[rows, xs] = t[rows]


def _pairs_ref(words, deg, adjacent, s, t, cap: int, n: int):
    """Capped path counts of the pairs (s, t), one per pair."""
    a = s.shape[0]
    target = torch.clamp(torch.minimum(deg[s], deg[t]).clamp(max=cap + 1),
                         min=0)
    count = adjacent[s, t].to(torch.int64)
    flow = torch.zeros((a, n), dtype=torch.bool, device=s.device)
    tin = torch.zeros_like(flow)
    pred = torch.zeros((a, n), dtype=torch.int64, device=s.device)
    succ = torch.zeros_like(pred)
    live = count < target
    while bool(live.any()):
        idx = live.nonzero(as_tuple=True)[0]
        st = [x[idx] for x in (s, t, flow, tin, pred, succ)]
        found, par, self_in = _search(words, *st)
        live[idx[~found]] = False
        hit = found.nonzero(as_tuple=True)[0]
        if len(hit):
            sub = [x[hit] for x in st]
            _augment(*sub, par[hit], self_in[hit])
            rows = idx[hit]
            for dst, src in zip((flow, tin, pred, succ), sub[2:]):
                dst[rows] = src
            count[rows] += 1
        live &= count < target
    return torch.minimum(count, target)


def paths_matrix_ref(adj, cap: int, *, n: int, chunk: int = PAIR_CHUNK):
    """Plain PyTorch version of the kernel: adj (n, W) int32 words -> (n,
    n) int32 matrix on adj's device."""
    out = torch.zeros((n, n), dtype=torch.int32, device=adj.device)
    if n < 2:
        return out
    words = adj.to(torch.int64) & 0xFFFFFFFF
    v = torch.arange(n, device=adj.device)
    adjacent = ((words[:, v >> 5] >> (v & 31)) & 1).bool()
    deg = adjacent.sum(1)
    pairs = torch.triu_indices(n, n, 1, device=adj.device)
    for lo in range(0, pairs.shape[1], chunk):
        s, t = pairs[0, lo:lo + chunk], pairs[1, lo:lo + chunk]
        value = _pairs_ref(words, deg, adjacent, s, t, int(cap), n).to(
            torch.int32)
        out[s, t] = value
        out[t, s] = value
    return out


# ----------------------------------------------------------------- kernel

def _lib():
    lib = build.library("paths")
    if lib.paths_launch.argtypes is None:
        lib.paths_launch.argtypes = _ARGTYPES
        lib.paths_launch.restype = ctypes.c_int
        lib.paths_max_words.argtypes = []
        lib.paths_max_words.restype = ctypes.c_int
    return lib


def max_vertices() -> int:
    """The largest n the kernel takes (32 x its most words)."""
    return 32 * _lib().paths_max_words()


def paths_matrix(adj, cap: int, *, n: int):
    """The capped disjoint-paths matrix of one graph.

    adj (n, W) int32 words -> (n, n) int32, symmetric, zero diagonal, on
    adj's device; launched on the current stream.
    """
    global LAUNCHES
    if adj.dim() != 2 or adj.shape[0] != n or 32 * adj.shape[1] < n:
        raise ValueError(f"paths_matrix: expected adj ({n}, W) with W >= "
                         f"{bitset.n_words(n)}; got {tuple(adj.shape)}")
    build.check_operands("paths_matrix", adj.device, adj=(adj, torch.int32))
    if adj.device.type == "cpu":
        return paths_matrix_ref(adj, cap, n=n)
    build.require_cuda("paths_matrix", adj)
    w = adj.shape[1]
    lib = _lib()
    if w > lib.paths_max_words():
        raise BackendCapabilityError(
            f"the CUDA paths kernel supports W <= {lib.paths_max_words()} "
            f"(n <= {32 * lib.paths_max_words()}); got n={n}, W={w}")
    out = torch.empty((n, n), dtype=torch.int32, device=adj.device)
    with torch.cuda.device(adj.device):
        err = lib.paths_launch(adj.data_ptr(), n, w, int(cap),
                               WARPS_PER_BLOCK, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    build.check_launch("paths", err, f"n={n}, W={w}, cap={cap}")
    LAUNCHES += 1
    return out


def side_stream(device) -> torch.cuda.Stream:
    """The wrapper's own stream on ``device`` (made on first use)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _STREAMS_LOCK:
        stream = _STREAMS.get(index)
        if stream is None:
            stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def disjoint_paths_matrix(packed: np.ndarray, cap: int, *, device,
                          tracker=None) -> np.ndarray:
    """The matrix of the graph whose packed adjacency is ``packed`` ((n,
    W) uint32), computed on the card ``device``, as a host (n, n) int32
    array.  The upload, the launch and the one blocking read
    (``engine.read_host``: a ``read_s`` span on ``tracker``) run on
    ``side_stream(device)``."""
    n = packed.shape[0]
    stream = side_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        adj = bitset.to_words(packed, device)
        out = paths_matrix(adj, cap, n=n)
        (host,) = engine.read_host((out,), telemetry.get(tracker))
    return host.numpy()
