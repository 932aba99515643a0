"""The port's canonical labeling and cache keys against the reference's.

Twins of ``tests/test_canon.py``: for the same graph, both packages give
the same canonical bytes and perm, the same ``graph_key`` digest, and the
same ``config_blob`` and ``cache_key`` digest and perm for the same
config dict, over relabelings, random graphs, the named instances and
the Shrikhande/rook pair that 1-WL refinement alone cannot separate.  The
port's keys are stable across processes and hash seeds, as the
reference's are.
"""
import os
import random
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import canon as ref_canon
from repro.core import graph as ref_graph
from repro_torch.core import canon, graph


def _shuffled(g, seed):
    return g.relabel(np.random.RandomState(seed).permutation(g.n))


def _twin(g):
    """The reference graph with ``g``'s adjacency."""
    return ref_graph.Graph(g.n, g.adj.copy(), g.name)


def _assert_same_keys(g, cfgs=({"mode": "sort", "cap": 1 << 12},)):
    r = _twin(g)
    assert canon.canonical_form(g) == ref_canon.canonical_form(r)
    assert canon.graph_key(g) == ref_canon.graph_key(r)
    for cfg in cfgs:
        for canonical in (True, False):
            assert canon.cache_key(g, cfg, canonical=canonical) == \
                ref_canon.cache_key(r, cfg, canonical=canonical)


@given(st.integers(0, 10_000))
@settings(max_examples=8, deadline=None)
def test_property_keys_equal_reference_and_perm_invariant(seed):
    rng = random.Random(seed)
    n = rng.randint(2, 14)
    g = graph.gnp(n, rng.choice([0.2, 0.4, 0.6]), seed=seed)
    _assert_same_keys(g)
    b0, p0 = canon.canonical_form(g)
    cg = g.relabel(np.array(p0))
    assert canon._canon_bytes(n, canon._adj_masks(cg),
                              list(range(n))) == b0
    for k in range(3):
        h = _shuffled(g, seed * 7 + k)
        _assert_same_keys(h)
        assert canon.canonical_form(h)[0] == b0


@pytest.mark.parametrize("name", ["petersen", "myciel3", "desargues",
                                  "queen5_5", "grid6x6"])
def test_named_instances_equal_reference_under_relabelings(name):
    g = graph.REGISTRY[name]()
    _assert_same_keys(g)
    b0, _ = canon.canonical_form(g)
    for k in range(2):
        h = _shuffled(g, 100 + k)
        _assert_same_keys(h)
        assert canon.canonical_form(h)[0] == b0


def _rook4x4(G):
    def vid(a, b):
        return 4 * a + b
    edges = [(vid(a, b), vid(c, d)) for a in range(4) for b in range(4)
             for c in range(4) for d in range(4)
             if (a, b) < (c, d) and (a == c or b == d)]
    return G.from_edges(16, edges, "rook4x4")


def _shrikhande(G):
    def vid(a, b):
        return 4 * a + b
    diffs = {(1, 0), (3, 0), (0, 1), (0, 3), (1, 1), (3, 3)}
    edges = [(vid(a, b), vid(c, d)) for a in range(4) for b in range(4)
             for c in range(4) for d in range(4)
             if vid(a, b) < vid(c, d) and ((a - c) % 4, (b - d) % 4) in diffs]
    return G.from_edges(16, edges, "shrikhande")


def test_shrikhande_rook_pair_beyond_1wl():
    rook, shri = _rook4x4(graph), _shrikhande(graph)
    for g in (rook, shri, _shuffled(shri, 3), _shuffled(rook, 4)):
        _assert_same_keys(g)
    for g in (rook, shri):
        assert len(set(canon._refine(g.n, canon._adj_masks(g),
                                     [0] * g.n))) == 1
    assert canon.canonical_form(rook)[0] != canon.canonical_form(shri)[0]
    assert canon.graph_key(rook) != canon.graph_key(shri)
    assert canon.canonical_form(_shuffled(shri, 3))[0] == \
        canon.canonical_form(shri)[0]


def test_non_iso_same_degree_sequence_and_golden_n20():
    def cyc(n, off=0):
        return [(off + i, off + (i + 1) % n) for i in range(n)]
    c6 = graph.from_edges(6, cyc(6), "C6")
    c33 = graph.from_edges(6, cyc(3) + cyc(3, 3), "2C3")
    for g in (c6, c33):
        _assert_same_keys(g)
    assert canon.graph_key(c6) != canon.graph_key(c33)
    gs = [graph.grid(4, 5), graph.desargues(), graph.random_tree(20, 7)]
    for g in gs:
        _assert_same_keys(g)
    assert len({canon.graph_key(g) for g in gs}) == 3


def test_empty_and_tiny():
    for n in (0, 1):
        g = graph.from_edges(n, [], "tiny")
        _assert_same_keys(g)
    assert canon.canonical_form(graph.from_edges(0, [], "e")) == (b"", ())
    assert canon.canonical_form(graph.from_edges(1, [], "o"))[1] == (0,)


def test_config_blob_and_cache_key_equal_reference():
    g = graph.myciel(3)
    base = {"mode": "sort", "cap": 1 << 12, "use_mmw": True, "seed": 0,
            "budget_bytes": None, "ratio": 0.5, "backend": "torch",
            "schedule": "doubling", "start_k": None}
    cfgs = [base] + [dict(base, **{k: v}) for k, v in [
        ("mode", "bloom"), ("cap", 1 << 13), ("use_mmw", False),
        ("seed", 1)]]
    _assert_same_keys(g, cfgs)
    for cfg in cfgs:
        assert canon.config_blob(cfg) == ref_canon.config_blob(cfg)
    keys = {canon.cache_key(g, c)[0] for c in cfgs}
    assert len(keys) == len(cfgs)
    assert canon.graph_key(g) not in keys
    assert canon.config_blob({"a": 1, "b": "x", "c": None}) == \
        canon.config_blob({"c": None, "b": "x", "a": 1})
    for bad in ({"a": 1}, object(), {1, 2}, b"bytes"):
        with pytest.raises(TypeError):
            canon.config_blob({"k": bad})
    h = _shuffled(graph.petersen(), 5)
    cfg = {"mode": "sort", "cap": 1 << 12}
    assert canon.cache_key(graph.petersen(), cfg)[0] == \
        canon.cache_key(h, cfg)[0]
    raw = canon.cache_key(h, cfg, canonical=False)
    assert raw[0] != canon.cache_key(graph.petersen(), cfg,
                                     canonical=False)[0]
    assert raw[1] == tuple(range(10))


def test_port_keys_stable_across_processes_and_equal_reference():
    prog = ("from repro_torch.core import canon, graph;"
            "g = graph.petersen();"
            "print(canon.graph_key(g));"
            "print(canon.cache_key(g, {'mode': 'sort', 'cap': 4096})[0])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = []
    for hs in ("0", "1"):
        env = {"PYTHONHASHSEED": hs, "PATH": "/usr/bin:/bin",
               "PYTHONPATH": os.path.join(root, "src")}
        r = subprocess.run([sys.executable, "-c", prog], env=env, cwd=root,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]
    g = ref_graph.petersen()
    assert outs[0] == ref_canon.graph_key(g) + "\n" + \
        ref_canon.cache_key(g, {"mode": "sort", "cap": 4096})[0] + "\n"
