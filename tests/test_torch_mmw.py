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
