"""Port parity: bitsets and graphs (repro_torch.core.{bitset,graph}).

``Graph.packed()`` bytes must equal the reference's for every registry
entry, the oracle factories and seeded random graphs; the torch bit ops
over int32 words must agree with the reference's uint32 ops, including
words with bit 31 set.
"""
import numpy as np
import pytest
import torch

import oracle
from repro.core import bitset as ref_bitset
from repro.core import graph as ref_graph
from repro_torch.core import bitset, graph


def _pairs():
    out = [(name, ref_graph.REGISTRY[name], graph.REGISTRY[name])
           for name in sorted(ref_graph.REGISTRY)]
    port_factories = {
        "path10": lambda: graph.path(10),
        "cycle12": lambda: graph.cycle(12),
        "complete7": lambda: graph.complete(7),
        "bipartite4_6": lambda: graph.complete_bipartite(4, 6),
        "star9": lambda: graph.star(9),
        "grid4x5": lambda: graph.grid(4, 5),
        "grid3x7": lambda: graph.grid(3, 7),
        "grid5x5": lambda: graph.grid(5, 5),
        "tree20_7": lambda: graph.random_tree(20, 7),
    }
    assert set(port_factories) == set(oracle.FACTORIES)
    out += [(name, oracle.FACTORIES[name], port_factories[name])
            for name in sorted(oracle.FACTORIES)]
    for n, p, seed in [(9, 0.3, 0), (33, 0.25, 1), (64, 0.1, 2),
                       (70, 0.2, 3)]:
        out.append((f"gnp_{n}_{p}_{seed}",
                    lambda n=n, p=p, s=seed: ref_graph.gnp(n, p, s),
                    lambda n=n, p=p, s=seed: graph.gnp(n, p, s)))
    out += [("ba_50_3", lambda: ref_graph.barabasi_albert(50, 3, 7),
             lambda: graph.barabasi_albert(50, 3, 7)),
            ("ktree", lambda: ref_graph.random_partial_ktree(30, 4, .2, 5),
             lambda: graph.random_partial_ktree(30, 4, .2, 5))]
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("name,ref_make,port_make", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_packed_bytes_equal(name, ref_make, port_make):
    want, got = ref_make(), port_make()
    assert got.name == want.name and got.n == want.n
    np.testing.assert_array_equal(got.adj, want.adj)
    assert got.packed().dtype == np.uint32
    assert got.packed().tobytes() == want.packed().tobytes()


@pytest.mark.parametrize("name", ["petersen", "queen5_5", "myciel3"])
def test_dimacs_round_trip(name, tmp_path):
    g = graph.REGISTRY[name]()
    path = str(tmp_path / f"{name}.gr")
    graph.write_dimacs(g, path)
    back = graph.read_dimacs(path)
    np.testing.assert_array_equal(back.adj, g.adj)
    ref = ref_graph.read_dimacs(path)
    assert back.packed().tobytes() == ref.packed().tobytes()


def test_dimacs_tolerant_parse_matches_reference(tmp_path):
    path = tmp_path / "messy.col"
    path.write_text("c comment\n% other\n\np edge 5 4\nn 1 3\n"
                    "e 1 2\n2 3\ne 3 4\n\n4 5\ne 2 2\n")
    got = graph.read_dimacs(str(path))
    want = ref_graph.read_dimacs(str(path))
    assert got.n == want.n == 5
    np.testing.assert_array_equal(got.adj, want.adj)


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 70])
def test_np_helpers_match_reference(n):
    rng = np.random.RandomState(n)
    sets = [set(rng.choice(n, size=rng.randint(0, n + 1), replace=False))
            for _ in range(6)]
    packed = bitset.np_pack(sets, n)
    np.testing.assert_array_equal(packed, ref_bitset.np_pack(sets, n))
    for row, s in zip(packed, sets):
        assert bitset.np_unpack(row, n) == s == ref_bitset.np_unpack(row, n)
    skip = sorted(sets[0])[:3]
    np.testing.assert_array_equal(bitset.np_allowed(n, skip),
                                  ref_bitset.np_allowed(n, skip))
    np.testing.assert_array_equal(bitset.np_allowed(n, skip, w=4),
                                  ref_bitset.np_allowed(n, skip, w=4))
    assert bitset.n_words(n) == ref_bitset.n_words(n)


@pytest.mark.parametrize("n", [3, 31, 32, 33, 63, 64, 96])
def test_torch_bit_ops_on_high_bit_words(n):
    rng = np.random.RandomState(100 + n)
    words = rng.randint(0, 2 ** 32, size=(9, bitset.n_words(n)),
                        dtype=np.uint64).astype(np.uint32)
    # keep bits < n only, and force the highest valid bit on in some rows
    mask = bitset.np_full(n)
    words &= mask
    words[::2, (n - 1) >> 5] |= np.uint32(1) << np.uint32((n - 1) & 31)
    t = bitset.to_words(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(bitset.from_words(t), words)
    bits = bitset.unpack(t, n).numpy()
    want_bits = np.array([[(int(r[i >> 5]) >> (i & 31)) & 1
                           for i in range(n)] for r in words], dtype=bool)
    np.testing.assert_array_equal(bits, want_bits)
    np.testing.assert_array_equal(bitset.popcount(t).numpy(),
                                  want_bits.sum(axis=1))
    np.testing.assert_array_equal(
        bitset.from_words(bitset.pack(torch.from_numpy(want_bits), n)),
        words)
    for i in (0, n // 2, n - 1):
        np.testing.assert_array_equal(bitset.get_bit(t, i).numpy(),
                                      want_bits[:, i])
    eye = bitset.from_words(bitset.eye_words(n, bitset.n_words(n), "cpu"))
    np.testing.assert_array_equal(
        eye, bitset.np_pack([{i} for i in range(n)], n))
