"""Sparsification tests (reference: iterator.rs, knn_graph.rs unit tests)."""

import numpy as np
import pytest

from allwave.core.types import (
    AutoSparsification,
    ConnectivitySparsification,
    NoSparsification,
    RandomSparsification,
    Sequence,
    TreeSampling,
)
from allwave.sparsify.knn import (
    build_knn_graph,
    estimate_knn_pair_count,
    estimate_tree_pair_count,
    extract_knn_pairs,
    extract_tree_pairs,
)
from allwave.sparsify.nj import TreeNode, extract_tree_pairs as nj_pairs, neighbor_joining
from allwave.sparsify.pairs import (
    build_pairs,
    compute_connectivity_probability,
    generate_all_pairs,
    parse_sparsification,
)


def _seqs(n, length=40):
    rng = np.random.RandomState(1)
    out = []
    for i in range(n):
        s = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=length).tobytes()
        out.append(Sequence(f"seq{i}", s))
    return out


def test_all_pairs_directed():
    pairs = generate_all_pairs(4, exclude_self=True)
    assert pairs.shape == (12, 2)  # n(n-1) directed
    assert [tuple(p) for p in pairs[:4]] == [(0, 1), (0, 2), (0, 3), (1, 0)]
    pairs_self = generate_all_pairs(3, exclude_self=False)
    assert pairs_self.shape == (9, 2)


def test_connectivity_probability_small_n_table():
    # reference: iterator.rs:306-317
    assert compute_connectivity_probability(0, 0.95) == 1.0
    assert compute_connectivity_probability(1, 0.95) == 1.0
    assert compute_connectivity_probability(2, 0.95) == 1.0
    assert compute_connectivity_probability(3, 0.95) == 0.8
    assert compute_connectivity_probability(4, 0.95) == 0.7
    assert compute_connectivity_probability(5, 0.95) == 0.6
    for n in range(6, 11):
        assert compute_connectivity_probability(n, 0.95) == 0.5


def test_connectivity_probability_formula():
    import math

    n, x = 100, 0.95
    c = -math.log(-math.log(x))
    expected = (math.log(n) + c) / n
    assert abs(compute_connectivity_probability(n, x) - expected) < 1e-12
    # clamping
    assert compute_connectivity_probability(10**9, 0.5) == 0.001
    assert compute_connectivity_probability(11, 0.99999) == compute_connectivity_probability(11, 0.999)


def test_random_sparsification_deterministic():
    seqs = _seqs(20)
    p1 = build_pairs(seqs, RandomSparsification(0.5))
    p2 = build_pairs(seqs, RandomSparsification(0.5))
    assert np.array_equal(p1, p2)
    total = 20 * 19
    assert 0.3 * total < p1.shape[0] < 0.7 * total
    # order-independence: permuting sequence order keeps the same ID pairs
    perm = list(reversed(range(20)))
    seqs_perm = [seqs[i] for i in perm]
    p3 = build_pairs(seqs_perm, RandomSparsification(0.5))
    set1 = {(seqs[i].id, seqs[j].id) for i, j in p1}
    set3 = {(seqs_perm[i].id, seqs_perm[j].id) for i, j in p3}
    assert set1 == set3


def test_random_keeps_all_at_one():
    seqs = _seqs(6)
    p = build_pairs(seqs, RandomSparsification(1.0))
    assert p.shape[0] == 30


def test_auto_uses_giant_095():
    seqs = _seqs(12)
    auto = build_pairs(seqs, AutoSparsification())
    giant = build_pairs(seqs, ConnectivitySparsification(0.95))
    assert np.array_equal(auto, giant)


def test_build_knn_graph_nearest():
    d = np.array(
        [[0.0, 0.1, 0.9], [0.1, 0.0, 0.8], [0.9, 0.8, 0.0]]
    )
    pairs = build_knn_graph(d, 1, False)
    assert pairs.shape == (3, 2)
    pl = {tuple(p) for p in pairs}
    assert (0, 1) in pl and (1, 0) in pl
    assert (2, 0) in pl or (2, 1) in pl


def test_build_knn_graph_farthest():
    d = np.array(
        [[0.0, 0.1, 0.9], [0.1, 0.0, 0.8], [0.9, 0.8, 0.0]]
    )
    pairs = build_knn_graph(d, 1, True)
    pl = {tuple(p) for p in pairs}
    assert (0, 2) in pl and (1, 2) in pl


def test_knn_k2():
    d = np.array(
        [
            [0.0, 0.1, 0.5, 0.9],
            [0.1, 0.0, 0.6, 0.8],
            [0.5, 0.6, 0.0, 0.2],
            [0.9, 0.8, 0.2, 0.0],
        ]
    )
    pairs = build_knn_graph(d, 2, False)
    assert pairs.shape == (8, 2)


def test_knn_tie_break_stable_smaller_j():
    # equal distances: the reference's stable sort yields smaller j first
    d = np.array([[0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]])
    pairs = build_knn_graph(d, 1, False)
    assert [tuple(p) for p in pairs] == [(0, 1), (1, 0), (2, 0)]


def test_extract_tree_pairs_dedup_sorted():
    seqs = [
        Sequence("seq1", b"ATCGATCGATCGATCG"),
        Sequence("seq2", b"ATCGATCGATCGATCG"),
        Sequence("seq3", b"GGGGGGGGGGGGGGGG"),
    ]
    pairs = extract_tree_pairs(seqs, 1, 1, 0.0, 15)
    assert 4 <= pairs.shape[0] <= 6
    as_tuples = [tuple(p) for p in pairs]
    assert as_tuples == sorted(set(as_tuples))  # sorted + deduped


def test_tree_empty_and_single():
    assert extract_knn_pairs([], 1, 0.0, 15).shape[0] == 0
    assert extract_knn_pairs([Sequence("s", b"ACGT")], 1, 0.0, 15).shape[0] == 0


def test_estimates():
    assert estimate_knn_pair_count(4, 1, 0.0) == 4
    assert estimate_knn_pair_count(4, 2, 0.0) == 8
    assert estimate_tree_pair_count(4, 1, 1, 0.0) == 8
    assert estimate_tree_pair_count(4, 2, 1, 0.0) == 12
    assert estimate_tree_pair_count(4, 3, 3, 1.0) == 12  # capped at n(n-1)


def test_parse_sparsification():
    assert isinstance(parse_sparsification("none"), NoSparsification)
    assert isinstance(parse_sparsification("auto"), AutoSparsification)
    s = parse_sparsification("random:0.5")
    assert isinstance(s, RandomSparsification) and s.keep_fraction == 0.5
    s = parse_sparsification("giant:0.99")
    assert isinstance(s, ConnectivitySparsification) and s.connectivity_prob == 0.99
    s = parse_sparsification("connectivity:0.9")
    assert isinstance(s, ConnectivitySparsification)
    s = parse_sparsification("tree:2:1:0.1")
    assert s == TreeSampling(2, 1, 0.1, None)
    s = parse_sparsification("tree:2:1:0.1:11")
    assert s == TreeSampling(2, 1, 0.1, 11)
    for bad in [
        "bogus",
        "random:0",
        "random:1.5",
        "giant:0",
        "giant:1.0",
        "tree:0:0:0.1",
        "tree:1:1:2.0",
        "tree:1:1:0.1:2",
        "tree:1:1:0.1:40",
        "tree:1:1",
    ]:
        with pytest.raises(ValueError):
            parse_sparsification(bad)


def test_neighbor_joining_basic():
    d = np.array(
        [
            [0.0, 0.2, 0.7, 0.8],
            [0.2, 0.0, 0.6, 0.7],
            [0.7, 0.6, 0.0, 0.3],
            [0.8, 0.7, 0.3, 0.0],
        ]
    )
    tree = neighbor_joining(d)
    assert tree is not None
    assert sorted(tree.get_leaves()) == [0, 1, 2, 3]
    edges = tree.get_edges()
    assert len(edges) > 0
    pairs = nj_pairs(tree, 1.0)
    assert pairs.shape[0] > 0


def test_neighbor_joining_two():
    tree = neighbor_joining(np.array([[0.0, 0.4], [0.4, 0.0]]))
    assert tree is not None
    assert tree.left.branch_length == 0.2
    assert neighbor_joining(np.zeros((1, 1))) is None


def test_parse_sparsification_legacy_connectivity():
    """The legacy `connectivity:<p>` spelling parses like `giant:<p>`
    (reference main.rs sparsification parser keeps both)."""
    from allwave.sparsify.pairs import parse_sparsification

    a = parse_sparsification("connectivity:0.95")
    b = parse_sparsification("giant:0.95")
    assert type(a) is type(b)
    assert a == b
