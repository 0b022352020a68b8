"""Wavefront oracle correctness: scores vs an independent dense DP, CIGAR
validity, and exact-count behavior on hand-placed mutations."""

import numpy as np
import pytest

from allwave.core.cigar import (
    cigar_bytes_to_string,
    count_cigar_operations,
    validate_cigar,
)
from allwave.core.scores import parse_scores
from allwave.testing.dense import cigar_score, dense_score
from allwave.wfa.params import resolve_penalties
from allwave.wfa.reference_impl import wfa_align

EDIT = resolve_penalties(parse_scores("0,1,1,1"))
AFFINE = resolve_penalties(parse_scores("0,5,8,2"))
TWOPIECE = resolve_penalties(parse_scores("0,5,8,2,24,1"))
ALL_PENALTIES = [EDIT, AFFINE, TWOPIECE]


def _random_dna(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def _mutate(rng, seq, n_snp=0, n_ins=0, n_del=0):
    s = bytearray(seq)
    for _ in range(n_snp):
        i = rng.randint(0, len(s))
        old = s[i]
        choices = [b for b in b"ACGT" if b != old]
        s[i] = choices[rng.randint(0, 3)]
    for _ in range(n_ins):
        i = rng.randint(0, len(s))
        ins = _random_dna(rng, rng.randint(1, 10))
        s[i:i] = ins
    for _ in range(n_del):
        if len(s) > 20:
            i = rng.randint(0, len(s) - 10)
            del s[i : i + rng.randint(1, 10)]
    return bytes(s)


@pytest.mark.parametrize("pen", ALL_PENALTIES, ids=["edit", "affine", "2piece"])
def test_identical(pen):
    seq = b"ACGTACGTACGTACGT"
    score, cigar = wfa_align(seq, seq, pen)
    assert score == 0
    assert cigar_bytes_to_string(cigar) == "16="


@pytest.mark.parametrize("pen", ALL_PENALTIES, ids=["edit", "affine", "2piece"])
def test_single_mismatch(pen):
    q = b"ACGTACGTAC"
    t = b"ACGTTCGTAC"
    score, cigar = wfa_align(q, t, pen)
    assert score == pen.x
    assert cigar_bytes_to_string(cigar) == "4=1X5="


def test_single_insertion_affine():
    # target has 2 extra bases vs query => WFA2 'I' ops (consume target)
    q = b"ACGTACGTACGT"
    t = b"ACGTACTTGTACGT"  # TT inserted after ACGTAC
    score, cigar = wfa_align(q, t, AFFINE)
    assert score == AFFINE.o1 + 2 * AFFINE.e1
    validate_cigar(cigar, q, t)


def test_two_piece_prefers_long_gap_piece():
    # A 30-base gap: piece1 costs 8+30*2=68, piece2 costs 24+30*1=54.
    q = b"ACGTACGTACGTACGTACGT"
    ins = b"TTTTTTTTTTGGGGGGGGGGCCCCCCCCCC"
    t = q[:10] + ins + q[10:]
    score, cigar = wfa_align(q, t, TWOPIECE)
    assert score == min(
        TWOPIECE.o1 + 30 * TWOPIECE.e1, TWOPIECE.o2 + 30 * TWOPIECE.e2
    )
    validate_cigar(cigar, q, t)


def test_empty_sequences():
    score, cigar = wfa_align(b"", b"", EDIT)
    assert score == 0 and cigar.size == 0
    # one side empty: pure gap
    score, cigar = wfa_align(b"", b"ACG", AFFINE)
    assert score == AFFINE.o1 + 3 * AFFINE.e1
    assert cigar_bytes_to_string(cigar) == "3D"  # consumes target only
    score, cigar = wfa_align(b"ACG", b"", AFFINE)
    assert cigar_bytes_to_string(cigar) == "3I"


@pytest.mark.parametrize("pen", ALL_PENALTIES, ids=["edit", "affine", "2piece"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_vs_dense(pen, seed):
    rng = np.random.RandomState(seed)
    q = _random_dna(rng, 60 + seed * 17)
    t = _mutate(rng, q, n_snp=3, n_ins=1, n_del=1)
    score, cigar = wfa_align(q, t, pen)
    expected = dense_score(q, t, pen)
    assert score == expected
    validate_cigar(cigar, q, t)
    assert cigar_score(cigar, pen) == score


@pytest.mark.parametrize("seed", range(8))
def test_random_unrelated_vs_dense_edit(seed):
    # unrelated sequences, different lengths — stress bounds/trim logic
    rng = np.random.RandomState(100 + seed)
    q = _random_dna(rng, rng.randint(1, 40))
    t = _random_dna(rng, rng.randint(1, 40))
    score, cigar = wfa_align(q, t, EDIT)
    assert score == dense_score(q, t, EDIT)
    validate_cigar(cigar, q, t)
    assert cigar_score(cigar, EDIT) == score


@pytest.mark.parametrize("seed", range(4))
def test_random_unrelated_vs_dense_affine(seed):
    rng = np.random.RandomState(200 + seed)
    q = _random_dna(rng, rng.randint(1, 30))
    t = _random_dna(rng, rng.randint(1, 30))
    for pen in (AFFINE, TWOPIECE):
        score, cigar = wfa_align(q, t, pen)
        assert score == dense_score(q, t, pen), (q, t)
        validate_cigar(cigar, q, t)
        assert cigar_score(cigar, pen) == score


def test_exact_mutation_counts():
    # reference: integration_tests.rs:599-672 — hand-placed mutations must
    # yield exactly the right op counts.
    rng = np.random.RandomState(42)
    base = _random_dna(rng, 200)
    s = bytearray(base)
    # 2 SNPs at fixed positions
    for pos in (50, 120):
        old = s[pos]
        s[pos] = [b for b in b"ACGT" if b != old][0]
    # 1 insertion of 5 bases at 80 (target longer => 'I' in WFA2 conv)
    s[80:80] = b"TTTTT" if base[79:80] != b"T" else b"GGGGG"
    t = bytes(s)
    score, cigar = wfa_align(base, t, TWOPIECE)
    validate_cigar(cigar, base, t)
    ops = cigar.tobytes()
    assert ops.count(b"X") == 2
    assert ops.count(b"I") == 5  # one 5-base target-consuming gap


def test_100kb_smoke_edit():
    # long-pair smoke (reference tests 100kb; oracle keeps it smaller)
    rng = np.random.RandomState(7)
    q = _random_dna(rng, 3000)
    t = _mutate(rng, q, n_snp=10, n_ins=2, n_del=2)
    score, cigar = wfa_align(q, t, TWOPIECE)
    validate_cigar(cigar, q, t)
    assert cigar_score(cigar, TWOPIECE) == score
