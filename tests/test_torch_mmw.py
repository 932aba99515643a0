"""Port parity: the minor-min-width bound and its CUDA kernel's wrapper.

``repro_torch.core.mmw.mmw_bound`` (the ``torch`` op, and the CPU path of
``repro_torch.kernels.mmw.mmw_bounds``) must equal
``repro.core.mmw.mmw_bound`` vmapped over states, the Pallas MMW kernel
in interpret mode and, for bounds that never froze, the python
contraction oracle.  Inputs are the JAX package's reach rows of random
states, made from a seed.  The CUDA kernel's own test is in
``test_torch_cuda.py``.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as ref_bitset
from repro.core import components as ref_components
from repro.core import graph as ref_graph
from repro.core import mmw as ref_mmw
from repro.kernels.mmw import mmw_bounds as pallas_mmw
from repro_torch.core import backend, bitset, mmw
from repro_torch.kernels import mmw as kernel_mod
# the contraction replayed step by step in numpy (it imports no JAX, so it
# lives with the card tests, which use it too)
from test_torch_cuda import replay_contraction


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, n_states, seed, p=0.3):
    """(graph, sets, reach (B, n, W) uint32, states (B, W) uint32)."""
    rng = random.Random(seed)
    g = ref_graph.gnp(n, p, seed)
    ss = [set(rng.sample(range(n), rng.randint(0, n // 2)))
          for _ in range(n_states)]
    states = ref_bitset.np_pack(ss, n)
    _, reach = jax.vmap(lambda s: ref_components.eliminated_degrees(
        jnp.asarray(g.packed()), s, n))(jnp.asarray(states))
    return g, ss, np.asarray(reach), states


def _ref(reach, states, k, n):
    return np.asarray(jax.vmap(lambda r, s: ref_mmw.mmw_bound(r, s, k, n))(
        jnp.asarray(reach), jnp.asarray(states)))


def _port(fn, reach, states, k, n):
    lb = fn(bitset.to_words(reach, "cpu"), bitset.to_words(states, "cpu"),
            k, n=n)
    assert lb.dtype == torch.int32
    return lb.numpy()


PORT_FNS = {"torch_op": mmw.mmw_bound,
            "kernel_cpu_path": kernel_mod.mmw_bounds,
            "registry_torch": backend.get_op("mmw_bound", "torch")}


@pytest.mark.parametrize("density", [0.05, 0.6, 0.95])
@pytest.mark.parametrize("k", [0, 2, 5])
@pytest.mark.parametrize("n", [5, 16, 31, 33, 48, 64])
def test_matches_reference_sweep(n, k, density):
    _, _, reach, states = _case(n, 6, seed=n + 7 * k, p=density)
    want = _ref(reach, states, k, n)
    for name, fn in PORT_FNS.items():
        np.testing.assert_array_equal(_port(fn, reach, states, k, n), want,
                                      err_msg=name)


@pytest.mark.parametrize("n", [5, 20, 33])
def test_matches_pallas_kernel_in_interpret_mode(n):
    _, _, reach, states = _case(n, 7, seed=3 * n, p=0.5)
    for k in (2, 1000):
        want = np.asarray(pallas_mmw(jnp.asarray(reach), jnp.asarray(states),
                                     jnp.int32(k), n=n, block=4,
                                     interpret=True))
        np.testing.assert_array_equal(
            _port(kernel_mod.mmw_bounds, reach, states, k, n), want)


@pytest.mark.parametrize("seed", range(6))
def test_matches_contraction_oracle(seed):
    rng = random.Random(seed)
    n = rng.randint(3, 24)
    g, ss, reach, states = _case(n, 4, seed, p=rng.choice([0.15, 0.3, 0.5]))
    got = _port(mmw.mmw_bound, reach, states, 1000, n)
    for b, s in enumerate(ss):
        assert got[b] == ref_mmw.mmw_oracle(g.adj, s)
        assert got[b] == mmw.mmw_oracle(g.adj, s)


def test_known_graphs_and_early_freeze():
    for g, want in ((ref_graph.complete(6), 5), (ref_graph.cycle(8), 2),
                    (ref_graph.path(8), 1)):
        _, reach = ref_components.eliminated_degrees(
            jnp.asarray(g.packed()), ref_bitset.zeros(g.n), g.n)
        states = np.zeros((1, ref_bitset.n_words(g.n)), np.uint32)
        assert _port(mmw.mmw_bound, np.asarray(reach)[None], states, 1000,
                     g.n)[0] == want
    g = ref_graph.complete(8)
    _, reach = ref_components.eliminated_degrees(
        jnp.asarray(g.packed()), ref_bitset.zeros(8), 8)
    states = np.zeros((1, 1), np.uint32)
    got = _port(mmw.mmw_bound, np.asarray(reach)[None], states, 2, 8)[0]
    assert got == _ref(np.asarray(reach)[None], states, 2, 8)[0] >= 3


def test_wrapper_rejects_bad_inputs():
    _, _, reach, states = _case(12, 3, seed=1)
    r, s = bitset.to_words(reach, "cpu"), bitset.to_words(states, "cpu")
    with pytest.raises(ValueError, match="expected reach"):
        kernel_mod.mmw_bounds(r[:, :-1], s, 3, n=12)
    with pytest.raises(TypeError, match="int32"):
        kernel_mod.mmw_bounds(r.to(torch.int64), s, 3, n=12)
    before = kernel_mod.ops.LAUNCHES
    kernel_mod.mmw_bounds(r, s, 3, n=12)
    assert kernel_mod.ops.LAUNCHES == before


# ------------------------------------------- where B1's contraction stops

def _stop_cases(n, seed):
    """(reach bool (n, n), S bool (n,), k) from a numpy seed: G(n, p) at
    several densities, states of every size class, and for each state k
    at and around n - |S| (so that nact = k + 1 and k + 2 at the start),
    at a few random values and at 0 and n."""
    rng = np.random.RandomState(seed)
    out = []
    for p in (0.2, 0.5, 0.8, 0.95):
        g = ref_graph.gnp(n, p, int(rng.randint(1 << 30)))
        adj = jnp.asarray(g.packed())
        for _ in range(6):
            s_bits = rng.rand(n) < rng.choice([0.05, 0.2, 0.5])
            words = ref_bitset.np_pack([set(np.flatnonzero(s_bits))], n)[0]
            _, reach = ref_components.eliminated_degrees(
                adj, jnp.asarray(words), n)
            reach = np.asarray(ref_bitset.unpack(reach, n), dtype=bool)
            nact = n - int(s_bits.sum())
            ks = {0, n, nact - 3, nact - 2, nact - 1, nact,
                  *rng.randint(0, n, size=2)}
            out += [(reach, s_bits, int(k), words) for k in ks if k >= 0]
    return out


@pytest.mark.parametrize("n", [9, 17, 33, 49])
def test_contraction_stops_once_it_can_no_longer_exceed_k(n):
    """The wavefront kernel's MMW loop stops once nact - 1 <= k: every
    degree in the contracted graph is at most nact - 1, so no later step
    can lift lb past k.  The replay ends at the JAX package's
    ``mmw_bound``; whenever a step begins with nact - 1 <= k and lb <= k,
    the final lb is <= k; and the stopped loop prunes exactly the states
    that the full loop prunes."""
    crossed_last = 0
    for reach, s_bits, k, words in _stop_cases(n, seed=n):
        lb, steps = replay_contraction(reach, s_bits.copy(), k, n)
        want = int(ref_mmw.mmw_bound(jnp.asarray(ref_bitset.np_pack(
            [set(np.flatnonzero(r)) for r in reach], n)), jnp.asarray(words),
            jnp.int32(k), n))
        assert lb == want, (n, k)
        for nact, lb0 in steps:
            if nact - 1 <= k and lb0 <= k:
                assert lb <= k, (n, k, nact, lb0, lb)
        stopped, short = replay_contraction(reach, s_bits.copy(), k, n,
                                            stop_at_k=True)
        assert (stopped > k) == (lb > k), (n, k, stopped, lb)
        assert len(short) <= max(0, n - int(s_bits.sum()) - (k + 1))
        # lb crossed k on the last step that the stopped loop runs
        crossed_last += bool(short) and short[-1][0] == k + 2 \
            and stopped > k
    assert crossed_last > 0, n
