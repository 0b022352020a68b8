"""Core types / CIGAR / PAF / scores tests.

Mirrors the reference's in-module unit tests (lib.rs:155-193,
validation_correct.rs:135-176) plus extra coverage of the PAF contract.
"""

import numpy as np
import pytest

from allwave.core.cigar import (
    cigar_bytes_to_string,
    cigar_string_to_bytes,
    count_cigar_operations,
    parse_cigar_lengths,
    run_length_encode,
    validate_cigar,
)
from allwave.core.paf import alignment_to_paf
from allwave.core.scores import parse_ani_preset, parse_scores
from allwave.core.types import (
    AlignmentMode,
    AlignmentParams,
    AlignmentResult,
    OP_D,
    OP_I,
    OP_M,
    OP_X,
    Sequence,
)


def test_parse_scores_edit_distance():
    params = parse_scores("0,1,1,1")
    assert params.match_score == 0
    assert params.mismatch_penalty == 1
    assert params.gap_open == 1
    assert params.gap_extend == 1
    assert params.gap2_open is None
    assert AlignmentMode.from_params(params) == AlignmentMode.EDIT_DISTANCE


def test_parse_scores_two_piece():
    params = parse_scores("0,5,8,2,24,1")
    assert (params.gap2_open, params.gap2_extend) == (24, 1)
    assert AlignmentMode.from_params(params) == AlignmentMode.TWO_PIECE_AFFINE


def test_parse_scores_single_affine():
    params = parse_scores("0,3,4,1")
    assert AlignmentMode.from_params(params) == AlignmentMode.SINGLE_PIECE_AFFINE


def test_parse_scores_invalid_count():
    with pytest.raises(ValueError, match="Expected 4 or 6"):
        parse_scores("0,1,1")


def test_parse_scores_whitespace():
    params = parse_scores(" 0 , 5 , 8 , 2 ")
    assert params.gap_open == 8


def test_default_params_match_reference():
    p = AlignmentParams.default()
    assert (
        p.match_score,
        p.mismatch_penalty,
        p.gap_open,
        p.gap_extend,
        p.gap2_open,
        p.gap2_extend,
    ) == (0, 5, 8, 2, 24, 1)


def test_ani_presets():
    # reference: main.rs:113-122
    assert parse_ani_preset("95%") == "0,7,12,2,36,1"
    assert parse_ani_preset("0.95") == "0,7,12,2,36,1"
    assert parse_ani_preset("90") == "0,5,8,2,24,1"
    assert parse_ani_preset("80%") == "0,4,6,2,18,1"
    assert parse_ani_preset("70") == "0,3,4,1"
    assert parse_ani_preset("55") == "0,1,1,1"
    with pytest.raises(ValueError):
        parse_ani_preset("40")
    with pytest.raises(ValueError):
        parse_ani_preset("1.5")


def _cig(s: str) -> np.ndarray:
    """Build WFA2-convention cigar bytes from a compact spec like 'MMXID'."""
    return np.frombuffer(s.encode(), dtype=np.uint8).copy()


def test_cigar_counts():
    c = _cig("MMMMXMID")
    matches, alen = count_cigar_operations(c)
    assert matches == 5
    assert alen == 6  # gaps excluded (reference: alignment.rs:292-310)


def test_cigar_lengths_id_swap():
    # WFA2 'I' consumes target, 'D' consumes query
    c = _cig("MMIID")
    qlen, tlen = parse_cigar_lengths(c)
    assert qlen == 3  # M,M,D
    assert tlen == 4  # M,M,I,I


def test_cigar_to_string_swap():
    c = _cig("MMXXMIID")
    assert cigar_bytes_to_string(c) == "2=2X1=2D1I"


def test_cigar_roundtrip():
    c = _cig("MMXXMIIDDDM")
    s = cigar_bytes_to_string(c)
    back = cigar_string_to_bytes(s)
    assert np.array_equal(back, c)


def test_rle_empty():
    ops, counts = run_length_encode(np.zeros(0, dtype=np.uint8))
    assert ops.size == 0 and counts.size == 0
    assert cigar_bytes_to_string(np.zeros(0, dtype=np.uint8)) == ""


def test_validate_cigar_micro_cases():
    # reference: validation_correct.rs:135-176 micro cases (standard conv):
    # 4=, 2=1X1=, 2=2D2=, 2=2I2= — here in WFA2 bytes.
    validate_cigar(_cig("MMMM"), b"ACGT", b"ACGT")
    validate_cigar(_cig("MMXM"), b"ACGT", b"ACTT")
    # 2=2D2= standard: D consumes target => WFA2 'I'
    validate_cigar(_cig("MMIIMM"), b"ACGT", b"ACTTGT")
    # 2=2I2= standard: I consumes query => WFA2 'D'
    validate_cigar(_cig("MMDDMM"), b"ACTTGT", b"ACGT")
    with pytest.raises(ValueError):
        validate_cigar(_cig("MMM"), b"ACGT", b"ACGT")  # under-consumption
    with pytest.raises(ValueError):
        validate_cigar(_cig("MMXM"), b"ACGT", b"ACGT")  # X over equal bases


def test_paf_format():
    seqs = [Sequence("q", b"ACGTACGT"), Sequence("t", b"ACGTACGTAA")]
    # q aligned to t: 8 matches then 2 target-consuming gaps (WFA2 'I')
    cigar = _cig("MMMMMMMMII")
    result = AlignmentResult(
        query_idx=0,
        target_idx=1,
        query_start=0,
        query_end=8,
        target_start=0,
        target_end=10,
        is_reverse=False,
        cigar_bytes=cigar,
        score=10,
        num_matches=8,
        alignment_length=8,
    )
    line = alignment_to_paf(result, seqs)
    fields = line.split("\t")
    assert fields[0] == "q"
    assert fields[1] == "8"
    assert fields[2] == "0"
    assert fields[3] == "8"
    assert fields[4] == "+"
    assert fields[5] == "t"
    assert fields[6] == "10"
    assert fields[7] == "0"
    assert fields[8] == "10"
    assert fields[9] == "8"
    assert fields[10] == "10"  # block_len = max(8, 10)
    assert fields[11] == "60"
    assert fields[12] == "gi:f:1.000000"
    assert fields[13] == "cg:Z:8=2D"


def test_paf_failed_alignment():
    # Failed pairs still emit records (reference: alignment.rs:49-64)
    seqs = [Sequence("a", b"ACGT"), Sequence("b", b"TTTT")]
    result = AlignmentResult.failed(0, 1, is_reverse=True)
    line = alignment_to_paf(result, seqs)
    fields = line.split("\t")
    assert fields[2:5] == ["0", "0", "-"]
    assert fields[12] == "gi:f:0.000000"
    assert fields[13] == "cg:Z:"


def test_alignment_mode_edge_cases():
    # gap2 set => two-piece even if edit-like (order matters, types.rs:105-117)
    p = parse_scores("0,1,1,1,24,1")
    assert AlignmentMode.from_params(p) == AlignmentMode.TWO_PIECE_AFFINE


def test_telemetry_counters():
    from allwave.utils.telemetry import EngineCounters, counters

    c = EngineCounters()
    c.add(pairs=4, cells=1000, device_seconds=0.5)
    c.add(pairs=2, cells=500, device_seconds=0.5)
    snap = c.snapshot()
    assert snap["pairs"] == 6 and snap["cells"] == 1500
    assert snap["dispatches"] == 2 and snap["cells_per_sec"] == 1500
    c.reset()
    assert c.snapshot()["pairs"] == 0
    # the process-wide instance accumulates from engine dispatches
    import numpy as np
    from allwave.core.scores import parse_scores
    from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig
    from allwave.wfa.params import resolve_penalties

    counters.reset()
    rng = np.random.RandomState(2)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = rng.choice(bases, 80).tobytes()
    al = DenseBandAligner(
        resolve_penalties(parse_scores("0,5,8,2,24,1")),
        DenseConfig(),
    )
    al.align_pairs([(q, q)])
    snap = counters.snapshot()
    assert snap["pairs"] >= 1 and snap["cells"] > 0
