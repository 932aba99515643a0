"""Port parity: exact sort dedup and compaction (repro_torch.core.dedup).

The sort must be unsigned lexicographic: words >= 2^31 are negative as
int32, and the all-ones sentinel (-1) must still sort last, or which rows
survive an overflow changes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dedup as ref_dedup
from repro_torch.core import backend, bitset, dedup


def _rows(seed, m, w, high=True, dup=0.3):
    rng = np.random.RandomState(seed)
    top = 2 ** 32 if high else 2 ** 31
    rows = rng.randint(0, top, size=(m, w), dtype=np.uint64).astype(np.uint32)
    # small-alphabet words so that lexicographic ties reach later words
    rows[:, 0] = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000,
                                      0xFFFFFFFE], dtype=np.uint32), size=m)
    n_dup = int(m * dup)
    if n_dup:
        src = rng.randint(0, m, size=n_dup)
        dst = rng.randint(0, m, size=n_dup)
        rows[dst] = rows[src]
    valid = rng.rand(m) < 0.8
    return rows, valid


def _t(rows):
    return bitset.to_words(rows, "cpu")


CASES = [(s, m, w) for s, (m, w) in enumerate(
    [(1, 1), (7, 1), (50, 2), (200, 2), (129, 3), (300, 4)])]


@pytest.mark.parametrize("seed,m,w", CASES)
def test_sort_states_and_unique_mask_match_reference(seed, m, w):
    rows, valid = _rows(seed, m, w)
    want_k, want_v = ref_dedup.sort_states(jnp.asarray(rows),
                                           jnp.asarray(valid))
    got_k, got_v = dedup.sort_states(_t(rows), torch.from_numpy(valid))
    np.testing.assert_array_equal(bitset.from_words(got_k),
                                  np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    want_u = ref_dedup.unique_mask(want_k, want_v)
    got_u = dedup.unique_mask(got_k, got_v)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


def test_sentinel_sorts_last_under_unsigned_order():
    rows = np.array([[0xFFFFFFFE, 5], [0x80000000, 0], [3, 0xFFFFFFFF],
                     [3, 0x80000001], [0, 0]], dtype=np.uint32)
    valid = np.array([True, False, True, True, True])
    got_k, got_v = dedup.sort_states(_t(rows), torch.from_numpy(valid))
    keys = bitset.from_words(got_k)
    np.testing.assert_array_equal(
        keys, np.array([[0, 0], [3, 0x80000001], [3, 0xFFFFFFFF],
                        [0xFFFFFFFE, 5], [0xFFFFFFFF, 0xFFFFFFFF]],
                       dtype=np.uint32))
    assert got_v.tolist() == [True, True, True, True, False]


@pytest.mark.parametrize("seed,m,w", CASES)
@pytest.mark.parametrize("cap_frac", [2.0, 0.5, 0.1])
def test_dedup_compact_matches_reference_with_overflow(seed, m, w, cap_frac):
    rows, valid = _rows(seed + 50, m, w)
    cap = max(1, int(m * cap_frac))
    want_buf, want_n, want_drop = ref_dedup.dedup_compact(
        jnp.asarray(rows), jnp.asarray(valid), cap)
    got_buf, got_n, got_drop = dedup.dedup_compact(_t(rows),
                                                   torch.from_numpy(valid),
                                                   cap)
    assert got_buf.shape == (cap, w)
    np.testing.assert_array_equal(bitset.from_words(got_buf),
                                  np.asarray(want_buf))
    assert int(got_n) == int(want_n) and int(got_drop) == int(want_drop)


@pytest.mark.parametrize("offset", [0, 5, 40, 64])
def test_compact_with_offset_matches_reference(offset):
    rows, _ = _rows(9, 60, 2)
    keep = np.random.RandomState(3).rand(60) < 0.6
    cap = 64
    want_buf, want_n, want_drop = ref_dedup.compact(
        jnp.asarray(rows), jnp.asarray(keep), cap, offset)
    got_buf, got_n, got_drop = dedup.compact(_t(rows),
                                             torch.from_numpy(keep), cap,
                                             offset)
    np.testing.assert_array_equal(bitset.from_words(got_buf),
                                  np.asarray(want_buf))
    assert (int(got_n), int(got_drop)) == (int(want_n), int(want_drop))


def test_sort_dedup_op_is_registered_for_both_backends():
    rows, valid = _rows(4, 40, 2)
    outs = [backend.get_op("sort_dedup", b)(_t(rows),
                                            torch.from_numpy(valid))
            for b in backend.BACKENDS]
    for skeys, keep in outs[1:]:
        assert torch.equal(skeys, outs[0][0]) and torch.equal(keep,
                                                              outs[0][1])
