"""Port parity: the wavefront op and the CUDA kernel module's wrapper.

The port's ``wavefront_expand`` (the ``torch`` backend op, and the kernel
wrapper's CPU path ``wavefront_ref``) must be bit-identical to
``repro.core.expand.wavefront_expand`` and to the Pallas kernel in
interpret mode, and agree with the DFS oracle.  The CUDA kernel itself
runs only on a card: its case skips here and runs through
``chip_smoke.py`` there.
"""
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitset as ref_bitset
from repro.core import expand as ref_expand
from repro.core import graph as ref_graph
from repro.kernels.wavefront import wavefront_expand as pallas_wavefront
from repro_torch.core import backend, bitset, components, expand
from repro_torch.kernels import wavefront as kernel_mod


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, n_states, seed, p=0.3, high_bit=False):
    rng = random.Random(seed)
    g = ref_graph.gnp(n, p, seed)
    ss = [set(rng.sample(range(n), rng.randint(0, max(0, n // 2))))
          for _ in range(n_states)]
    if high_bit:
        top = [v for v in (31, 63) if v < n]
        for s in ss[::2]:
            s.update(top)
    states = ref_bitset.np_pack(ss, n)
    valid = np.ones((n_states,), dtype=bool)
    allowed = np.asarray(ref_bitset.full(n))
    return g, ss, g.packed(), states, valid, allowed


def _ref(adj, states, valid, k, allowed, n):
    c, f = ref_expand.wavefront_expand(jnp.asarray(adj), jnp.asarray(states),
                                       jnp.asarray(valid), jnp.int32(k),
                                       jnp.asarray(allowed), n=n)
    return np.asarray(c), np.asarray(f)


def _ref_flags(adj, states, valid, k, allowed, n):
    c, f = ref_expand.wavefront_expand(jnp.asarray(adj), jnp.asarray(states),
                                       jnp.asarray(valid), jnp.int32(k),
                                       jnp.asarray(allowed), n=n,
                                       use_mmw=True, use_simplicial=True)
    return np.asarray(c), np.asarray(f)


def _port(fn, adj, states, valid, k, allowed, n):
    c, f = fn(bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu"),
              torch.from_numpy(valid), k, bitset.to_words(allowed, "cpu"),
              n=n)
    assert c.dtype == torch.int32 and f.dtype == torch.bool
    return bitset.from_words(c), f.numpy()


PORT_FNS = {"torch_op": expand.wavefront_expand,
            "kernel_cpu_path": kernel_mod.wavefront_expand,
            "registry_torch": backend.get_op("wavefront_expand", "torch")}


@pytest.mark.parametrize("fn", list(PORT_FNS), ids=list(PORT_FNS))
@pytest.mark.parametrize("n", [3, 17, 31, 32, 33, 48, 64, 70])
def test_matches_reference_shape_sweep(n, fn):
    _, _, adj, states, valid, allowed = _case(n, 6, seed=n, high_bit=True)
    for k in (1, n // 4, n // 2):
        gc, gf = _port(PORT_FNS[fn], adj, states, valid, k, allowed, n)
        wc, wf = _ref(adj, states, valid, k, allowed, n)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("n", [3, 17, 33])
def test_matches_pallas_kernel_in_interpret_mode(n):
    _, _, adj, states, valid, allowed = _case(n, 5, seed=n + 1)
    valid[1] = False
    pc, pf = pallas_wavefront(jnp.asarray(adj), jnp.asarray(states),
                              jnp.asarray(valid), jnp.int32(n // 3),
                              jnp.asarray(allowed), n=n, block=2,
                              interpret=True)
    gc, gf = _port(kernel_mod.wavefront_expand, adj, states, valid, n // 3,
                   allowed, n)
    np.testing.assert_array_equal(gc, np.asarray(pc))
    np.testing.assert_array_equal(gf, np.asarray(pf))


@pytest.mark.parametrize("n", [17, 33, 49])
def test_mmw_rule_matches_reference_where_the_contraction_stops(n):
    """The plain ``wavefront_expand`` with ``use_mmw=True`` (the torch op
    and the wrapper's CPU path) equals the JAX package's wavefront op on
    states from a numpy seed, with k at and around n - |S| - 1, where the
    kernel's contraction stops once nact - 1 <= k; some rows are pruned
    by the rule."""
    rng = np.random.RandomState(n)
    pruned = 0
    for p in (0.3, 0.5, 0.9):
        g = ref_graph.gnp(n, p, n + int(100 * p))
        size = n // 4
        sets = [set(rng.choice(n, size, replace=False)) for _ in range(8)]
        states = ref_bitset.np_pack(sets, n)
        valid = np.ones((len(sets),), dtype=bool)
        valid[3] = False
        allowed = np.asarray(ref_bitset.full(n))
        nact = n - size
        for k in sorted({nact - 3, nact - 2, nact - 1, nact,
                         *rng.randint(nact // 3, nact - 3, size=3)}):
            c, f = ref_expand.wavefront_expand(
                jnp.asarray(g.packed()), jnp.asarray(states),
                jnp.asarray(valid), jnp.int32(k), jnp.asarray(allowed),
                n=n, use_mmw=True)
            for fn in (expand.wavefront_expand, kernel_mod.wavefront_expand):
                gc, gf = fn(bitset.to_words(g.packed(), "cpu"),
                            bitset.to_words(states, "cpu"),
                            torch.from_numpy(valid), k,
                            bitset.to_words(allowed, "cpu"), n=n,
                            use_mmw=True)
                np.testing.assert_array_equal(bitset.from_words(gc),
                                              np.asarray(c))
                np.testing.assert_array_equal(gf.numpy(), np.asarray(f))
            _, plain = _ref(g.packed(), states, valid, k, allowed, n)
            pruned += int((plain.any(1) & ~np.asarray(f).any(1)).sum())
    assert pruned > 0


@pytest.mark.parametrize("n_states", [1, 2, 5, 8, 13])
def test_batch_sweep_with_invalid_rows_and_allowed_mask(n_states):
    n = 16
    _, _, adj, states, valid, _ = _case(n, n_states, seed=7)
    valid[::3] = False
    allowed = ref_bitset.np_allowed(n, [0, 5, 15])
    gc, gf = _port(kernel_mod.wavefront_expand, adj, states, valid, 4,
                   allowed, n)
    wc, wf = _ref(adj, states, valid, 4, allowed, n)
    assert gc.shape == (n_states, n, bitset.n_words(n))
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gf, wf)
    assert not gf[::3].any()


def test_feasibility_matches_dfs_oracle():
    n = 14
    g, ss, adj, states, valid, allowed = _case(n, 5, seed=3, p=0.4)
    k = 4
    _, feas = _port(kernel_mod.wavefront_expand, adj, states, valid, k,
                    allowed, n)
    adjb = [list(map(bool, row)) for row in g.adj]
    for b, s in enumerate(ss):
        for v in range(n):
            want = (v not in s) and ref_expand.degree_oracle(adjb, s, v) <= k
            assert bool(feas[b, v]) == want, (b, v, s)
            assert (expand.degree_oracle(adjb, s, v)
                    == ref_expand.degree_oracle(adjb, s, v))


@pytest.mark.parametrize("n", [5, 20, 33])
def test_components_match_reference(n):
    from repro.core import components as ref_components
    _, _, adj, states, _, _ = _case(n, 4, seed=11 + n, high_bit=True)
    z = bitset.from_words(components.closure(bitset.to_words(adj, "cpu"),
                                             bitset.to_words(states, "cpu"),
                                             n))
    deg, reach = components.eliminated_degrees(
        bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu"), n)
    for b in range(states.shape[0]):
        s = jnp.asarray(states[b])
        a = jnp.asarray(adj)
        np.testing.assert_array_equal(
            z[b], np.asarray(ref_components.closure(a, s, n)))
        wdeg, wreach = ref_components.eliminated_degrees(a, s, n)
        np.testing.assert_array_equal(deg[b].numpy(), np.asarray(wdeg))
        np.testing.assert_array_equal(bitset.from_words(reach[b]),
                                      np.asarray(wreach))


def test_wrapper_rejects_bad_inputs_and_unported_flags():
    n = 40
    _, _, adj, states, valid, allowed = _case(n, 3, seed=1)
    a, s = bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu")
    v, al = torch.from_numpy(valid), bitset.to_words(allowed, "cpu")
    with pytest.raises(TypeError, match="int32"):
        kernel_mod.wavefront_expand(a.to(torch.int64), s, v, 3, al, n=n)
    with pytest.raises(ValueError, match="expected adj"):
        kernel_mod.wavefront_expand(a[:-1], s, v, 3, al, n=n)
    strided = torch.zeros((2, 3), dtype=torch.int32).t()
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kernel_mod.wavefront_expand(a, strided, v, 3, al, n=n)
    # the pruning flags are ported: the CPU path runs them (their parity is
    # in test_torch_pruning.py)
    gc, gf = kernel_mod.wavefront_expand(a, s, v, 3, al, n=n, use_mmw=True,
                                         use_simplicial=True)
    wc, wf = _ref_flags(adj, states, valid, 3, allowed, n)
    np.testing.assert_array_equal(bitset.from_words(gc), wc)
    np.testing.assert_array_equal(gf.numpy(), wf)
    with pytest.raises(backend.BackendCapabilityError, match="doubling"):
        kernel_mod.wavefront_expand(a, s, v, 3, al, n=n, schedule="while")


def test_cpu_path_does_not_count_launches():
    n = 10
    _, _, adj, states, valid, allowed = _case(n, 3, seed=2)
    before = kernel_mod.ops.LAUNCHES
    by_b = dict(kernel_mod.ops.LAUNCHES_BY_B)
    _port(kernel_mod.wavefront_expand, adj, states, valid, 3, allowed, n)
    assert kernel_mod.ops.LAUNCHES == before
    assert dict(kernel_mod.ops.LAUNCHES_BY_B) == by_b


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wavefront kernel is CUDA C++ "
                    "for sm_90a with no CPU mode (chip_smoke.py runs it)")
    for n in (3, 17, 31, 32, 33, 36, 48, 49, 64, 100):
        _, _, adj, states, valid, allowed = _case(n, 37, seed=n,
                                                  high_bit=True)
        valid[::4] = False
        dev = "cuda"
        args = (bitset.to_words(adj, dev), bitset.to_words(states, dev),
                torch.from_numpy(valid).to(dev), n // 3,
                bitset.to_words(allowed, dev))
        gc, gf = kernel_mod.wavefront_expand(*args, n=n)
        wc, wf = kernel_mod.wavefront_ref(*args, n=n)
        assert torch.equal(gc, wc) and torch.equal(gf, wf)


def _warp_model(adj, s, n):
    """The CUDA kernel's per-warp arithmetic (``rt::reach_rows``) in numpy
    words: each component C of G[S] grown from its lowest unassigned
    member, one member's adjacency row at a time (the lowest queued member
    first), N(C) the OR of its members' rows, and reach[v] = adj[v] | N(C)
    for every C that adj[v] meets.  adj (n, W) uint32, s (W,) uint32 ->
    (z (each member's row: its component), reach (n, W) uint32, deg (n,)
    int)."""
    w = adj.shape[1]
    rows = 32 * w                           # lane + 32 r for r < W
    a = np.zeros((rows, w), dtype=np.uint32)
    a[:n] = adj
    below = np.array([(1 << max(0, min(32, n - 32 * x))) - 1
                      for x in range(w)], dtype=np.uint64).astype(np.uint32)
    sn = s & below

    def members(words):
        return [32 * x + b for x in range(w) for b in range(32)
                if (int(words[x]) >> b) & 1]

    eye = np.zeros((rows, w), dtype=np.uint32)
    for v in range(rows):
        eye[v, v >> 5] = np.uint32(1 << (v & 31))
    z = np.zeros_like(a)
    reach = a.copy()
    left = set(members(sn))
    while left:
        comp = np.zeros((w,), dtype=np.uint32)
        nbr = np.zeros((w,), dtype=np.uint32)
        todo = [min(left)]
        while todo:                         # pop the lowest queued member
            j = min(todo)
            comp |= eye[j]
            nbr |= a[j]
            todo = members(nbr & sn & ~comp)
        left -= set(members(comp))
        z[members(comp)] = comp
        hit = (a & comp[None]).any(axis=1)
        reach[hit] |= nbr
    q = reach & ~s[None] & ~eye
    deg = np.array([sum(bin(int(x)).count("1") for x in row) for row in q])
    return z[:n], reach[:n], deg[:n]


def _model_states(n, seed):
    """States over n vertices: empty, all but one vertex, random ones, and
    (where n > 31) ones with bit 31 of a word set."""
    rng = np.random.RandomState(seed)
    sets = [set(), set(range(n)) - {n // 2}]
    for _ in range(4):
        sets.append(set(np.flatnonzero(rng.rand(n) < rng.uniform(0.1, 0.7))))
    for top in (31, 63, 95):
        if top < n:
            sets.append(set(np.flatnonzero(rng.rand(n) < 0.3)) | {top})
    return sets


@pytest.mark.parametrize("n", [3, 17, 31, 32, 33, 48, 63, 64, 65, 100])
def test_warp_algorithm_matches_reference(n):
    """The kernel's closure (components of G[S] grown member by member),
    nb and reach equal the JAX reference's doubling closure and degrees,
    and the port's plain wavefront op, exactly (bitsets)."""
    from repro.core import components as ref_components
    g = ref_graph.gnp(n, 0.25, n + 5)
    adj = np.asarray(g.packed(), dtype=np.uint32)
    sets = _model_states(n, seed=n)
    states = np.asarray(ref_bitset.np_pack(sets, n), dtype=np.uint32)
    a = jnp.asarray(adj)
    feas_model = np.zeros((len(sets), n), dtype=bool)
    k = n // 3
    allowed = np.asarray(ref_bitset.np_allowed(n, [0]), dtype=np.uint32)
    for b, s in enumerate(states):
        z, reach, deg = _warp_model(adj, s, n)
        np.testing.assert_array_equal(
            z, np.asarray(ref_components.closure(a, jnp.asarray(s), n)))
        wdeg, wreach = ref_components.eliminated_degrees(a, jnp.asarray(s), n)
        np.testing.assert_array_equal(deg, np.asarray(wdeg))
        np.testing.assert_array_equal(reach, np.asarray(wreach))
        for v in range(n):
            feas_model[b, v] = (deg[v] <= k and v not in sets[b]
                                and (int(allowed[v >> 5]) >> (v & 31)) & 1)
    valid = np.ones((len(sets),), dtype=bool)
    gc, gf = _port(kernel_mod.wavefront_ref, adj, states, valid, k, allowed, n)
    np.testing.assert_array_equal(gf, feas_model)
    eye = np.asarray(ref_bitset.np_pack([{v} for v in range(n)], n),
                     dtype=np.uint32)
    np.testing.assert_array_equal(gc, states[:, None, :] | eye[None])
