"""Validator tests (reference: validation*.rs unit tests)."""

import numpy as np
import pytest

from allwave.core.types import Sequence
from allwave.validation import (
    AlignmentStats,
    PafRecord,
    calculate_alignment_stats,
    detect_large_indels,
    parse_cigar,
    validate_alignment,
    validate_paf_record,
    verify_cigar_alignment,
)


def test_parse_cigar():
    assert parse_cigar("4=") == [(4, "=")]
    assert parse_cigar("2=1X1=") == [(2, "="), (1, "X"), (1, "=")]
    assert parse_cigar("") == []
    with pytest.raises(ValueError):
        parse_cigar("4")
    with pytest.raises(ValueError):
        parse_cigar("=4")
    with pytest.raises(ValueError):
        parse_cigar("4=x")


def test_stats():
    s = calculate_alignment_stats("10=2X3I4D1I")
    assert s.matches == 10
    assert s.mismatches == 2
    assert s.insertions == 4
    assert s.deletions == 4
    assert s.gap_opens == 3  # I run, D run, I run
    assert abs(s.identity - 10 / 12) < 1e-12


def test_verify_micro_cases():
    # reference: validation_correct.rs:135-176
    verify_cigar_alignment("4=", b"ACGT", b"ACGT")
    verify_cigar_alignment("2=1X1=", b"ACGT", b"ACTT")
    verify_cigar_alignment("2=2D2=", b"ACGT", b"ACTTGT")  # D consumes target
    verify_cigar_alignment("2=2I2=", b"ACTTGT", b"ACGT")  # I consumes query
    with pytest.raises(ValueError):
        verify_cigar_alignment("4=", b"ACGT", b"ACTT")  # '=' over mismatch
    with pytest.raises(ValueError):
        verify_cigar_alignment("3=", b"ACGT", b"ACGT")  # under-consumption


def _mk_record(**kw):
    base = dict(
        query_name="q",
        query_len=4,
        query_start=0,
        query_end=4,
        strand="+",
        target_name="t",
        target_len=4,
        target_start=0,
        target_end=4,
        num_matches=4,
        block_len=4,
        mapq=60,
        identity=1.0,
        cigar="4=",
    )
    base.update(kw)
    return PafRecord(**base)


def test_validate_paf_record_ok():
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    validate_paf_record(_mk_record(), seqs)


def test_validate_paf_record_reverse():
    # '-' strand: coords refer to the RC'd query
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    validate_paf_record(_mk_record(strand="-"), seqs)  # rc(ACGT)=ACGT


def test_validate_paf_record_bad_matches():
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    with pytest.raises(ValueError, match="num_matches"):
        validate_paf_record(_mk_record(num_matches=3), seqs)


def test_validate_paf_record_parse_roundtrip():
    line = "q\t4\t0\t4\t+\tt\t4\t0\t4\t4\t4\t60\tgi:f:1.000000\tcg:Z:4="
    rec = PafRecord.parse(line)
    assert rec.query_name == "q"
    assert rec.identity == 1.0
    assert rec.cigar == "4="
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    validate_paf_record(rec, seqs)


def test_validate_alignment_coverage():
    seqs = {"q": Sequence("q", b"ACGTACGTAC"), "t": Sequence("t", b"ACGT")}
    rec = _mk_record(query_len=10, query_end=4)
    result = validate_alignment(rec, seqs, min_coverage=0.95)
    assert not result.valid
    assert any("coverage" in e for e in result.errors)
    assert abs(result.coverage - 0.4) < 1e-12


def test_detect_large_indels():
    assert detect_large_indels("100=2000D50=", min_len=1000) == [("D", 2000)]
    assert detect_large_indels("100=500D50=", min_len=1000) == []
