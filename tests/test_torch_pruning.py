"""Port parity: the pruning rules in the wavefront op, and expand_degrees.

The port's ``wavefront_expand`` with ``use_mmw`` and ``use_simplicial``
(the ``torch`` op, and the CUDA wrapper's CPU path) must be bit-identical
to ``repro.core.expand.wavefront_expand`` with the same flags and to the
Pallas wavefront kernel in interpret mode.  ``simplicial_mask`` and
``expand_degrees`` must equal the reference's registry ops.  The CUDA
kernels' own tests are in ``test_torch_cuda.py``.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.core import bitset as ref_bitset
from repro.core import expand as ref_expand
from repro.core import graph as ref_graph
from repro.kernels.wavefront import wavefront_expand as pallas_wavefront
from repro_torch.core import backend, bitset, expand
from repro_torch.kernels import expand as expand_kernel
from repro_torch.kernels import wavefront as kernel_mod

FLAGS = [(True, False), (False, True), (True, True)]
FLAG_IDS = ["mmw", "simplicial", "mmw+simplicial"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Test workers run side by side; one torch thread each keeps them from
    oversubscribing the CPU (the results do not depend on it)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, n_states, seed, p=0.3):
    rng = random.Random(seed)
    g = ref_graph.gnp(n, p, seed)
    ss = [set(rng.sample(range(n), rng.randint(0, max(0, n // 2))))
          for _ in range(n_states)]
    states = ref_bitset.np_pack(ss, n)
    valid = np.ones((n_states,), dtype=bool)
    allowed = np.asarray(ref_bitset.full(n))
    return g.packed(), states, valid, allowed


def _ref(adj, states, valid, k, allowed, n, **flags):
    c, f = ref_expand.wavefront_expand(
        jnp.asarray(adj), jnp.asarray(states), jnp.asarray(valid),
        jnp.int32(k), jnp.asarray(allowed), n=n, **flags)
    return np.asarray(c), np.asarray(f)


def _port(fn, adj, states, valid, k, allowed, n, **flags):
    c, f = fn(bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu"),
              torch.from_numpy(valid), k, bitset.to_words(allowed, "cpu"),
              n=n, **flags)
    return bitset.from_words(c), f.numpy()


PORT_FNS = {"torch_op": expand.wavefront_expand,
            "kernel_cpu_path": kernel_mod.wavefront_expand}


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("fn", list(PORT_FNS), ids=list(PORT_FNS))
def test_pruning_flags_match_reference(fn, flags):
    """The cases of the reference's own test_pruning_flags_match_ref."""
    n = 20
    adj, states, valid, allowed = _case(n, 8, seed=5, p=0.35)
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for k in (2, 4, 8):
        gc, gf = _port(PORT_FNS[fn], adj, states, valid, k, allowed, n, **kw)
        wc, wf = _ref(adj, states, valid, k, allowed, n, **kw)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("n", [3, 17, 33, 48, 64])
def test_pruning_flags_shape_sweep_with_invalid_rows(n, flags):
    adj, states, valid, _ = _case(n, 9, seed=n + 1, p=0.4)
    valid[::4] = False
    allowed = ref_bitset.np_allowed(n, [0, n - 1])
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for k in (1, n // 4, n // 2):
        gc, gf = _port(kernel_mod.wavefront_expand, adj, states, valid, k,
                       allowed, n, **kw)
        wc, wf = _ref(adj, states, valid, k, allowed, n, **kw)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gf, wf)
        assert not gf[::4].any()


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_pruning_flags_match_pallas_kernel_in_interpret_mode(flags):
    n = 17
    adj, states, valid, allowed = _case(n, 6, seed=11, p=0.4)
    valid[1] = False
    kw = dict(use_mmw=flags[0], use_simplicial=flags[1])
    for k in (3, 6):
        pc, pf = pallas_wavefront(jnp.asarray(adj), jnp.asarray(states),
                                  jnp.asarray(valid), jnp.int32(k),
                                  jnp.asarray(allowed), n=n, block=2,
                                  interpret=True, **kw)
        gc, gf = _port(kernel_mod.wavefront_expand, adj, states, valid, k,
                       allowed, n, **kw)
        np.testing.assert_array_equal(gc, np.asarray(pc))
        np.testing.assert_array_equal(gf, np.asarray(pf))


@pytest.mark.parametrize("n", [6, 20, 40])
def test_simplicial_mask_and_collapse_match_reference(n):
    adj, states, valid, allowed = _case(n, 8, seed=2 * n, p=0.45)
    _, wfeas, _, reach = ref_expand.expand_block(
        jnp.asarray(adj), jnp.asarray(states), jnp.asarray(valid),
        jnp.int32(n // 2), jnp.asarray(allowed), n)
    want = np.asarray(ref_backend.get_op("simplicial_mask", "jax")(
        jnp.asarray(adj), jnp.asarray(states), reach, wfeas, n))
    want_c = np.asarray(ref_expand.collapse_simplicial(wfeas,
                                                       jnp.asarray(want)))
    op = backend.get_op("simplicial_mask", "torch")
    feas_t = torch.from_numpy(np.array(wfeas))
    got = op(bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu"),
             bitset.to_words(np.asarray(reach), "cpu"), feas_t, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        expand.collapse_simplicial(feas_t, got).numpy(), want_c)


@pytest.mark.parametrize("n", [3, 17, 31, 33, 48, 64])
def test_expand_degrees_matches_reference_op(n):
    adj, states, _, _ = _case(n, 7, seed=n)
    states = np.concatenate([states, np.zeros_like(states[:2])])  # padding
    want = np.asarray(ref_backend.get_op("expand_degrees", "jax")(
        jnp.asarray(adj), jnp.asarray(states), n=n))
    a, s = bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu")
    for fn in (backend.get_op("expand_degrees", "torch"),
               expand_kernel.expand_degrees):
        got = fn(a, s, n=n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_expand_wrapper_checks_and_cpu_path_counts_nothing():
    adj, states, _, _ = _case(12, 3, seed=4)
    a, s = bitset.to_words(adj, "cpu"), bitset.to_words(states, "cpu")
    with pytest.raises(ValueError, match="expected adj"):
        expand_kernel.expand_degrees(a[:-1], s, n=12)
    with pytest.raises(TypeError, match="int32"):
        expand_kernel.expand_degrees(a, s.to(torch.int64), n=12)
    before = expand_kernel.ops.LAUNCHES
    expand_kernel.expand_degrees(a, s, n=12)
    assert expand_kernel.ops.LAUNCHES == before
    with pytest.raises(backend.BackendCapabilityError,
                       match="static doubling closure"):
        backend.get_op("expand_degrees", "cuda")(a, s, n=12,
                                                 schedule="while")
