"""Library-facade parity tests: the reference's public API shapes exist
and behave (lib.rs re-exports, alignment.rs align_pair, wfa.rs
align_sequences)."""

import numpy as np
import pytest

import allwave as aw
from allwave.core.types import AlignmentMode, AlignmentParams, Sequence
from allwave.wfa.simple import (
    SimplePenalties,
    align_pair,
    align_sequences,
)


def test_facade_exports():
    for name in (
        "Sequence",
        "AlignmentParams",
        "AlignmentResult",
        "AlignmentError",
        "AlignmentMode",
        "alignment_to_paf",
        "cigar_bytes_to_string",
        "parse_scores",
        "reverse_complement",
        "process_alignments_with_callback",
        "AllPairIterator",
        "align_pair",
        "KmerSketch",
    ):
        assert hasattr(aw, name), name


def test_align_pair_forward():
    q = Sequence("q", b"ACGTACGTACGTACGTACGT")
    t = Sequence("t", b"ACGTACGTTCGTACGTACGT")
    res = align_pair(q, t, 0, 1, AlignmentParams.default())
    assert res.query_idx == 0 and res.target_idx == 1
    assert not res.is_reverse
    assert res.num_matches == 19
    assert res.alignment_length == 20
    assert res.query_end == 20 and res.target_end == 20


def test_align_pair_reverse_orientation():
    from allwave.orient.orientation import reverse_complement

    rng = np.random.RandomState(0)
    t = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400).tobytes()
    q = reverse_complement(t)
    res = align_pair(Sequence("q", q), Sequence("t", t), 0, 1, AlignmentParams.default())
    assert res.is_reverse
    assert res.num_matches == 400


def test_align_pair_wfa_orientation():
    from allwave.orient.orientation import reverse_complement

    rng = np.random.RandomState(1)
    t = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200).tobytes()
    q = reverse_complement(t)
    res = align_pair(
        Sequence("q", q),
        Sequence("t", t),
        0,
        1,
        AlignmentParams.default(),
        use_mash_orientation=False,
    )
    assert res.is_reverse


def test_align_sequences_legacy():
    pen = SimplePenalties(mismatch=5, gap_opening1=8, gap_extension1=2)
    res = align_sequences(
        b"ACGTACGTAC", b"ACGTTCGTAC", pen, AlignmentMode.SINGLE_PIECE_AFFINE
    )
    assert res.score == 5
    assert res.cigar == "4=1X5="
    assert res.matches == 9
    assert res.mismatches == 1
    assert res.alignment_length == 10


def test_align_sequences_standard_ins_del():
    pen = SimplePenalties(mismatch=5, gap_opening1=8, gap_extension1=2)
    # pattern longer => standard 'insertions' (consume query)
    res = align_sequences(
        b"ACGTAAACGT", b"ACGTCGT", pen, AlignmentMode.SINGLE_PIECE_AFFINE
    )
    assert res.insertions == 3
    assert res.deletions == 0


def test_all_pair_iterator_alias():
    seqs = [Sequence("a", b"ACGTACGTACGTACGT"), Sequence("b", b"ACGTACGTACGTACGT")]
    from allwave.core.types import NoSparsification

    it = aw.AllPairIterator.with_options(
        seqs, AlignmentParams.edit_distance(), True, True, NoSparsification()
    )
    assert it.pair_count() == 2
    results = list(it)
    assert len(results) == 2
    for r in results:
        assert r.num_matches == 16
    # with_orientation_params chains
    it2 = aw.AllPairIterator.with_options(
        seqs, AlignmentParams.edit_distance(), True, True, NoSparsification()
    ).with_orientation_params(AlignmentParams.edit_distance())
    assert it2.pair_count() == 2
