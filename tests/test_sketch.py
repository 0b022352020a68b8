"""MinHash sketching / mash distance tests (reference: mash.rs:186-260)."""

import math

import numpy as np

from allwave.core.types import Sequence
from allwave.sketch.minhash import (
    KmerSketch,
    compute_distance_matrix,
    compute_distance_matrix_with_params,
    format_distance_matrix,
    jaccard,
    mash_distance_from_jaccard,
    sketch_canonical,
    sketch_stranded,
)


def test_kmer_sketch_basic():
    sketch = KmerSketch.from_sequence(b"ATCGATCGATCG", k=4, sketch_size=10)
    assert sketch.minimizers.size > 0
    assert sketch.k == 4
    assert sketch.length == 12


def test_jaccard_identical():
    s1 = KmerSketch.from_sequence(b"ATCGATCGATCG", 4, 10)
    s2 = KmerSketch.from_sequence(b"ATCGATCGATCG", 4, 10)
    assert abs(s1.jaccard(s2) - 1.0) < 1e-10


def test_mash_distance_identical():
    s1 = KmerSketch.from_sequence(b"ATCGATCGATCG", 4, 10)
    s2 = KmerSketch.from_sequence(b"ATCGATCGATCG", 4, 10)
    assert s1.mash_distance(s2) < 1e-10


def test_jaccard_mismatched_k():
    s1 = KmerSketch.from_sequence(b"ATCGATCGATCG", 4, 10)
    s2 = KmerSketch.from_sequence(b"ATCGATCGATCG", 5, 10)
    assert s1.jaccard(s2) == 0.0


def test_distance_matrix():
    seqs = [
        Sequence("seq1", b"ATCGATCGATCGATCG"),
        Sequence("seq2", b"ATCGATCGATCGATCG"),
        Sequence("seq3", b"GGGGGGGGGGGGGGGG"),
    ]
    m = compute_distance_matrix(seqs)
    assert m.shape == (3, 3)
    assert m[0, 0] < 1e-6 and m[1, 1] < 1e-6
    assert m[0, 1] < 1e-6 and m[1, 0] < 1e-6
    assert m[0, 2] > 0.0 and m[2, 0] > 0.0


def test_canonical_strand_invariance():
    # canonical sketch of a sequence == canonical sketch of its revcomp
    rng = np.random.RandomState(3)
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=300).tobytes()
    comp = {65: 84, 84: 65, 67: 71, 71: 67}
    rc = bytes(comp[b] for b in reversed(seq))
    s1 = sketch_canonical(seq, 15, 100)
    s2 = sketch_canonical(rc, 15, 100)
    assert np.array_equal(s1, s2)


def test_stranded_is_strand_specific():
    rng = np.random.RandomState(4)
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=300).tobytes()
    comp = {65: 84, 84: 65, 67: 71, 71: 67}
    rc = bytes(comp[b] for b in reversed(seq))
    s1 = sketch_stranded(seq, 15, 100)
    s2 = sketch_stranded(rc, 15, 100)
    assert not np.array_equal(s1, s2)


def test_non_acgt_kmers_skipped():
    # 'N' windows are dropped entirely
    seq = b"ACGTNACGT"
    s = sketch_stranded(seq, 4, 100)
    # valid windows: ACGT (pos 0) and ACGT (pos 5) — identical hash, kept twice
    assert s.size == 2
    assert s[0] == s[1]


def test_short_sequence_empty_sketch():
    assert sketch_stranded(b"ACG", 15, 100).size == 0
    assert sketch_canonical(b"ACG", 15, 100).size == 0


def test_case_sensitivity_of_hash_but_not_validity():
    # lowercase bases are valid DNA but hash differently (raw bytes hashed)
    upper = sketch_stranded(b"ACGTACGTACGTACGT", 8, 100)
    lower = sketch_stranded(b"acgtacgtacgtacgt", 8, 100)
    assert upper.size == lower.size > 0
    assert not np.array_equal(upper, lower)


def test_mash_distance_formula():
    k = 15
    j = 0.5
    d = mash_distance_from_jaccard(j, k)
    assert abs(d - (-(1.0 / k) * math.log(2 * j / (1 + j)))) < 1e-12
    assert mash_distance_from_jaccard(0.0, k) == 1.0


def test_format_distance_matrix():
    seqs = [Sequence("a", b"ACGTACGTACGTACGTAC"), Sequence("b", b"ACGTACGTACGTACGTAC")]
    m = compute_distance_matrix_with_params(seqs, 4, 10)
    text = format_distance_matrix(seqs, m)
    lines = text.strip().split("\n")
    assert lines[0] == "sequence\ta\tb"
    assert lines[1].startswith("a\t0.000000\t")


def test_distance_matrix_bitmap_matches_per_pair():
    """The bitmap-intersection distance matrix must produce the exact
    float64 values of the per-pair jaccard path."""
    import numpy as np
    from allwave.core.types import Sequence
    from allwave.sketch.minhash import (
        compute_distance_matrix_with_params,
        jaccard,
        mash_distance_from_jaccard,
        sketch_canonical,
    )

    rng = np.random.RandomState(8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = []
    for i in range(7):
        s = rng.choice(bases, rng.randint(60, 300)).tobytes()
        seqs.append(Sequence(f"s{i}", s))
    seqs.append(Sequence("tiny", b"ACG"))  # below k: empty sketch
    k, size = 15, 1000
    got = compute_distance_matrix_with_params(seqs, k, size)
    for i in range(len(seqs)):
        for j in range(len(seqs)):
            if i == j:
                continue
            si = sketch_canonical(seqs[i].seq, k, size)
            sj = sketch_canonical(seqs[j].seq, k, size)
            want = mash_distance_from_jaccard(jaccard(si, sj), k)
            assert got[i, j] == want, (i, j)


def test_intersection_counts_device_matches_numpy():
    """The device membership-matmul intersection path must produce the
    exact integer counts of the bitmap path (downstream f64 mash values
    are then bit-identical)."""
    import numpy as np

    from allwave.sketch.minhash import (
        _intersection_counts_device,
        pairwise_intersection_counts,
        sketch_canonical,
    )

    rng = np.random.RandomState(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    root = rng.choice(bases, 400)
    sketches = []
    for i in range(9):
        t = root.copy()
        mut = rng.rand(400) < rng.uniform(0.0, 0.6)
        t[mut] = bases[rng.randint(0, 4, mut.sum())]
        sketches.append(np.unique(sketch_canonical(t.tobytes(), 15, 1000)))
    sizes = np.array([s.size for s in sketches], dtype=np.int64)
    want = pairwise_intersection_counts(sketches)
    got = _intersection_counts_device(sketches, sizes)
    np.testing.assert_array_equal(want, got)


def test_bottom_k_matches_full_sort():
    """The np.partition bottom-k path must be bit-identical to a full
    stable sort + truncate (the reference semantics, mash.rs:103-106):
    duplicates kept, ascending, every length regime (n < k, n == k,
    n >> k), with N-runs and lowercase bases in the sequence."""
    from allwave.sketch.minhash import (
        _IS_DNA,
        _KMER_COMP,
        _valid_window_mask,
        sketch_canonical,
        sketch_stranded,
    )
    from allwave.hashing.siphash import hash_kmers

    rng = np.random.RandomState(11)
    alpha = np.frombuffer(b"ACGTacgtNn", np.uint8)
    for trial in range(60):
        L = int(rng.randint(5, 2500))
        seq = rng.choice(alpha, L).astype(np.uint8)
        b = seq.tobytes()
        for size in (7, 1000):
            got_s = sketch_stranded(b, 15, size)
            got_c = sketch_canonical(b, 15, size)
            if L < 15:
                assert got_s.size == 0 and got_c.size == 0
                continue
            valid = _valid_window_mask(seq, 15)
            fwd = hash_kmers(seq, 15)
            rc = np.ascontiguousarray(_KMER_COMP[seq][::-1])
            canon = np.minimum(fwd, hash_kmers(rc, 15)[::-1])
            np.testing.assert_array_equal(
                got_s, np.sort(fwd[valid], kind="stable")[:size]
            )
            np.testing.assert_array_equal(
                got_c, np.sort(canon[valid], kind="stable")[:size]
            )
