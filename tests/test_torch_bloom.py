"""Port parity: Bloom-filter dedup, in both of the reference's semantics.

* ``repro_torch.core.bloom`` (the ``torch`` backend: byte per bit, the
  whole batch queried before it is inserted) against
  ``repro.core.bloom``: murmur3 against ``murmur3_ref`` with words whose
  bit 31 is set, probe positions, and ``query_and_insert``.
* ``repro_torch.kernels.bloom.bloom_insert_ref`` (the CUDA kernel's plain
  version: packed words, rows inserted in order) against
  ``repro.kernels.bloom.ref.bloom_ref`` and the Pallas kernel in interpret
  mode, with duplicates and colliding rows.

The two semantics differ on batches whose rows share probe bits, so they
are never compared with each other.  ``bloom_ref`` adds ``h1 + i*h2`` in
python integers, while ``probe_indices`` and the Pallas kernel wrap it at
2^32 first; they agree when ``m_bits`` is a power of two.  For other
``m_bits`` the port follows the Pallas kernel, and the case compares with
it.  The CUDA kernel's own test is in
``test_torch_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as ref_bloom
from repro.kernels.bloom import bloom_insert as pallas_bloom
from repro.kernels.bloom import bloom_ref
from repro_torch.core import backend, bitset, bloom
from repro_torch.kernels import bloom as kernel_mod


def _words(rng, b, w):
    return rng.randint(0, 2**32, size=(b, w), dtype=np.uint64).astype(
        np.uint32)


def _case(b, w, seed, dup_frac=0.3):
    """The reference test's batches: random words, injected duplicates,
    about a tenth of the rows invalid."""
    rng = np.random.RandomState(seed)
    states = _words(rng, b, w)
    for i in range(1, b):
        if rng.rand() < dup_frac:
            states[i] = states[rng.randint(i)]
    valid = rng.rand(b) < 0.9
    return states, valid


def test_murmur3_matches_reference_with_high_words():
    rng = np.random.RandomState(0)
    for w in (1, 2, 3, 8):
        words = _words(rng, 40, w)
        words[::3, 0] |= np.uint32(1 << 31)
        got1 = bloom.murmur3_words(bitset.to_words(words, "cpu"),
                                   bloom.SEED1).numpy()
        got2 = bloom.murmur3_words(bitset.to_words(words, "cpu"),
                                   bloom.SEED2).numpy()
        jax1 = np.asarray(ref_bloom.murmur3_words(jnp.asarray(words),
                                                  ref_bloom.SEED1))
        np.testing.assert_array_equal(got1, jax1.astype(np.int64))
        for i in range(40):
            assert got1[i] == ref_bloom.murmur3_ref(words[i],
                                                    int(ref_bloom.SEED1))
            assert got2[i] == ref_bloom.murmur3_ref(words[i],
                                                    int(ref_bloom.SEED2))
            assert got2[i] == bloom.murmur3_ref(words[i], bloom.SEED2)
    for name in ("C1", "C2", "MIX1", "MIX2", "SEED1", "SEED2", "DEFAULT_K",
                 "DEFAULT_BITS_PER_ELEM"):
        assert int(getattr(bloom, name)) == int(getattr(ref_bloom, name))


@pytest.mark.parametrize("m_bits", [64, 96, 1000, 1 << 14, 1 << 24])
def test_probe_indices_match_reference(m_bits):
    words = _words(np.random.RandomState(m_bits % 97), 30, 2)
    want = np.asarray(ref_bloom.probe_indices(jnp.asarray(words), m_bits, 17))
    got = bloom.probe_indices(bitset.to_words(words, "cpu"), m_bits, 17)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m_bits,k", [(64, 3), (100, 3), (1 << 12, 17)])
def test_query_and_insert_matches_jax_with_collisions(m_bits, k):
    rng = np.random.RandomState(m_bits + k)
    filt = (rng.rand(m_bits) < 0.3).astype(np.uint8)
    op = backend.get_op("bloom_query_insert", "torch")
    for _ in range(20):
        states, valid = _case(12, 2, seed=int(rng.randint(1 << 30)))
        want_new, want_f = ref_bloom.query_and_insert(
            jnp.asarray(filt), jnp.asarray(states), jnp.asarray(valid),
            m_bits, k)
        got_new, got_f = op(torch.from_numpy(filt.copy()),
                            bitset.to_words(states, "cpu"),
                            torch.from_numpy(valid), m_bits=m_bits,
                            k_hashes=k)
        np.testing.assert_array_equal(got_new.numpy(), np.asarray(want_new))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        filt = np.asarray(want_f)
    made = backend.get_op("bloom_make_filter", "torch")(m_bits, device="cpu")
    assert made.dtype == torch.uint8 and made.shape == (m_bits,)
    assert not made.any()


def _row_order(filt0, states, valid, m_bits, k):
    fw = bitset.to_words(filt0, "cpu")
    new, out = kernel_mod.bloom_insert(fw, bitset.to_words(states, "cpu"),
                                       torch.from_numpy(valid),
                                       m_bits=m_bits, k_hashes=k)
    assert out.data_ptr() == fw.data_ptr()        # updated in place
    return new.numpy(), bitset.from_words(out)


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_row_order_matches_bloom_ref_word_sweep(w):
    m_bits = 1 << 12
    states, valid = _case(12, w, seed=w)
    filt0 = np.zeros((m_bits // 32,), dtype=np.uint32)
    want_new, want_f = bloom_ref(filt0, states, valid, m_bits, 17)
    got_new, got_f = _row_order(filt0, states, valid, m_bits, 17)
    np.testing.assert_array_equal(got_new, want_new)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("m_bits,k", [(64, 3), (64, 17), (1 << 14, 3),
                                      (1 << 14, 17)])
def test_row_order_matches_bloom_ref_with_collisions(m_bits, k):
    """Small filters force distinct rows onto shared probe bits: the case
    where the two semantics part; the filter is carried batch to batch."""
    rng = np.random.RandomState(m_bits * k)
    filt = np.zeros((m_bits // 32,), dtype=np.uint32)
    saw_shared = False
    for _ in range(25):
        states, valid = _case(16, 2, seed=int(rng.randint(1 << 30)),
                              dup_frac=0.2)
        want_new, want_f = bloom_ref(filt, states, valid, m_bits, k)
        got_new, got_f = _row_order(filt, states, valid, m_bits, k)
        np.testing.assert_array_equal(got_new, want_new)
        np.testing.assert_array_equal(got_f, want_f)
        qi_new, _ = ref_bloom.query_and_insert(
            jnp.asarray(np.unpackbits(filt.view(np.uint8),
                                      bitorder="little")),
            jnp.asarray(states), jnp.asarray(valid), m_bits, k)
        saw_shared |= not np.array_equal(np.asarray(qi_new), want_new)
        filt = want_f
    if m_bits == 64:
        assert saw_shared, "no batch exercised rows sharing probe bits"


def test_row_order_duplicates_see_earlier_rows():
    """The reference's block-sweep case: the second half repeats the
    first, so exactly the first half is new."""
    m_bits = 1 << 14
    states, _ = _case(16, 2, seed=3, dup_frac=0.0)
    states[8:] = states[:8]
    valid = np.ones(16, dtype=bool)
    filt0 = np.zeros((m_bits // 32,), dtype=np.uint32)
    got_new, got_f = _row_order(filt0, states, valid, m_bits, 17)
    assert got_new[:8].all() and not got_new[8:].any()
    again, _ = _row_order(got_f, states, valid, m_bits, 17)
    assert not again.any()
    none_valid, same = _row_order(got_f, states, np.zeros(16, bool), m_bits,
                                  17)
    assert not none_valid.any()
    np.testing.assert_array_equal(same, got_f)


@pytest.mark.parametrize("m_bits", [96, 1000 - 1000 % 32, 1 << 12])
def test_row_order_matches_pallas_kernel_in_interpret_mode(m_bits):
    """m_bits that are not powers of two: the probe sum wraps at 2^32
    before the modulus, as in the Pallas kernel."""
    rng = np.random.RandomState(m_bits)
    for k in (3, 17):
        states, valid = _case(13, 2, seed=int(rng.randint(1 << 30)))
        filt0 = np.zeros((m_bits // 32,), dtype=np.uint32)
        want_new, want_f = pallas_bloom(
            jnp.asarray(filt0), jnp.asarray(states), jnp.asarray(valid),
            m_bits=m_bits, k_hashes=k, block=4, interpret=True)
        got_new, got_f = _row_order(filt0, states, valid, m_bits, k)
        np.testing.assert_array_equal(got_new, np.asarray(want_new))
        np.testing.assert_array_equal(got_f, np.asarray(want_f))


def test_packed_filter_surface():
    assert backend.get_op("bloom_make_filter", "cuda") is not None
    words = kernel_mod.make_filter_words(1 << 10, device="cpu")
    assert words.dtype == torch.int32 and words.shape == (32,)
    with pytest.raises(ValueError, match="m_bits % 32"):
        kernel_mod.make_filter_words(100)
    states, valid = _case(4, 2, seed=1)
    with pytest.raises(ValueError, match="expected filter_words"):
        kernel_mod.bloom_insert(words[:-1], bitset.to_words(states, "cpu"),
                                torch.from_numpy(valid), m_bits=1 << 10,
                                k_hashes=3)
    before = kernel_mod.ops.LAUNCHES
    _row_order(np.zeros(32, np.uint32), states, valid, 1 << 10, 3)
    assert kernel_mod.ops.LAUNCHES == before


@pytest.mark.parametrize("m_bits", [64, 1 << 14])
def test_lane_form_matches_vmapped_pallas_kernel_in_interpret_mode(m_bits):
    """The lane form (one filter per lane, rows in order within each lane)
    against the reference's Pallas op under ``jax.vmap``, as
    ``repro/core/shard.py`` calls it per shard: unequal valid counts, a
    lane with no valid row, a half-full filter, and the filters carried
    to a second batch."""
    from repro.core import backend as ref_backend
    query_insert = functools.partial(
        ref_backend.get_op("bloom_query_insert", "pallas"), m_bits=m_bits,
        k_hashes=17)
    rng = np.random.RandomState(m_bits)
    lanes, b = 3, 10
    filt = _words(rng, lanes, m_bits // 32)
    filt[0] = 0
    for _ in range(2):
        states = np.stack([_case(b, 2, seed=int(rng.randint(1 << 30)))[0]
                           for _ in range(lanes)])
        valid = np.arange(b)[None] % np.array([[1], [1], [3]]) == 0
        valid[1] = False
        want_new, want_f = jax.vmap(query_insert)(
            jnp.asarray(filt), jnp.asarray(states), jnp.asarray(valid))
        fw = bitset.to_words(filt, "cpu")
        got_new, got_f = kernel_mod.bloom_insert(
            fw, bitset.to_words(states, "cpu"), torch.from_numpy(valid),
            m_bits=m_bits, k_hashes=17)
        np.testing.assert_array_equal(got_new.numpy(),
                                      np.asarray(want_new).astype(bool))
        np.testing.assert_array_equal(bitset.from_words(got_f),
                                      np.asarray(want_f))
        assert not got_new[1].any()
        filt = np.asarray(want_f)


def test_scratch_is_sized_from_the_call_shapes_not_m_bits():
    """The CUDA kernel's scratch (``ops.scratch_plan``) holds a slot per
    probe, a list entry, a lost-claim count and claim masks per row and
    three counters per bucket: the same bytes for every m_bits, and at
    the lane engine's Bloom shape (8 lanes of 2048 * 49 children, 17
    probes) far below the int32 per filter bit of 2^24-bit filters that
    an owner array would take (512 MiB)."""
    ops = kernel_mod.ops
    for lanes, rows, k in [(1, 1, 1), (3, 300, 33), (8, 2048 * 49, 17)]:
        sizes = set()
        for m_bits in (64, 96, 3200, 1 << 12, (1 << 12) + 32, 1 << 13,
                       (1 << 13) + 32, 1 << 24, (1 << 25) + 32,
                       (1 << 32) - 32):
            plan = ops.scratch_plan(lanes, rows, m_bits, k)
            assert 1 <= plan.buckets <= ops.MAX_BUCKETS
            assert (plan.buckets - 1) << plan.shift < m_bits \
                <= plan.buckets << plan.shift
            sizes.add(plan.nbytes)
        header = lanes * (3 * ops.MAX_BUCKETS + 1)
        listed = lanes * rows * (2 + -(-k // 32))
        assert sizes == {8 * lanes * rows * k + 4 * (
            header + header % 2 + listed + listed % 2)}
    lane_shape = ops.scratch_plan(8, 2048 * 49, 1 << 24, 17).nbytes
    assert 4 * lane_shape < 8 * 4 * (1 << 24)
    assert ops.scratch_plan(1, 2048, 1 << 24, 17).shift == 12
    # the most buckets of one position, then the first buckets of two
    assert (ops.scratch_plan(1, 1, 1 << 12, 1).shift,
            ops.scratch_plan(1, 1, 1 << 12, 1).buckets) == (0, 4096)
    assert (ops.scratch_plan(1, 1, (1 << 12) + 32, 1).shift,
            ops.scratch_plan(1, 1, (1 << 12) + 32, 1).buckets) == (1, 2064)
