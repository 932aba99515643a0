"""The frozen inputs: instance builders, the pools a seed draws, the
reference's Bloom filter, and the plain reference's known treewidths."""
import pytest
import torch

from twbench import drivers, instances
from twbench.reference import search
from twbench.reference import solve as ref

MIX = {"instances": ["queen5_5", "myciel4", "petersen"], "pool_seed": 7}


def test_pool_repeats_from_one_seed():
    a, oa = drivers._pool(MIX, 2 ** 33 + 17)
    b, ob = drivers._pool(MIX, 2 ** 33 + 17)
    c, oc = drivers._pool(MIX, 5)
    assert oa == ob and sorted(oa) == [0, 1, 2]
    # the seed moves the order, never the instances
    for x, y, z in zip(a, b, c):
        assert (x.adj == y.adj).all() and (x.adj == z.adj).all()


@pytest.mark.parametrize("w,n,m_bits,k", [
    (1, 30, 1 << 10, 3), (2, 49, 1 << 24, 17), (2, 62, 1 << 12, 17)])
def test_reference_bloom_is_the_programs_filter(w, n, m_bits, k):
    """The reference's probes and row-order rule give the program's
    ``was_new`` bit for bit, across two calls on one filter, with
    duplicate rows and (in the small filters) colliding probes."""
    from repro_torch.kernels.bloom import ops
    g = torch.Generator().manual_seed(n)
    masks = torch.randint(0, 1 << n, (400,), generator=g, dtype=torch.int64)
    masks = torch.cat([masks, masks[:50]])
    words = search.mask_words(masks, w)
    rows = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)
    valid = torch.ones(len(masks), dtype=torch.bool)
    fw = ops.make_filter_words(m_bits)
    filt = torch.zeros(m_bits, dtype=torch.bool)
    pos = search.probe_positions(words, m_bits, k)
    for part in (slice(0, 200), slice(200, None)):
        want, _ = ops.bloom_insert_ref(fw, rows[part], valid[part],
                                       m_bits=m_bits, k_hashes=k)
        got = search.first_claims(pos[part], filt)
        filt[pos[part].reshape(-1)] = True
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,n,m", [
    ("petersen", 10, 15), ("myciel3", 11, 20), ("myciel4", 23, 71),
    ("queen5_5", 25, 160), ("queen7_7", 49, 476), ("mcgee", 24, 36),
    ("dyck", 32, 48), ("desargues", 20, 30), ("grid6x6", 36, 60)])
def test_instance_sizes(name, n, m):
    g = instances.REGISTRY[name]()
    assert g.n == n and int(g.adj.sum()) // 2 == m


def test_relabelling_is_a_seeded_isomorphism():
    a = instances.relabelled("queen5_5", 2 ** 40 + 3)
    b = instances.relabelled("queen5_5", 2 ** 40 + 3)
    c = instances.relabelled("queen5_5", 9)
    assert (a.adj == b.adj).all() and not (a.adj == c.adj).all()
    assert sorted(a.degrees()) == sorted(instances.queen(5).degrees())


@pytest.mark.parametrize("name,tw", [
    ("petersen", 4), ("myciel3", 5), ("myciel4", 10), ("queen5_5", 18),
    ("queen6_6", 25)])
def test_reference_treewidth(name, tw):
    r = ref.solve(instances.relabelled(name, 3))
    assert r["width"] == tw and r["exact"]
