"""Golden conformance tests for the WFA2 engine conventions.

The reference pins its DP-engine semantics with a set of debug binaries
(reference tests/debug/, documented in tests/debug/README.md:48-54).
Each test here quotes one of those binaries' facts and asserts it
END-TO-END through this framework's `align_pair` / `align_sequences` /
PAF path, so a behavioral drift in any engine breaks a named test.

Facts encoded (reference file -> fact):
  * debug_cigar.rs:1-7, test_cigar_interpretation.rs — WFA2's CIGAR
    convention swaps I/D vs standard: byte 'I' consumes TARGET, byte 'D'
    consumes QUERY; the PAF serializer swaps back (alignment.rs:347-376).
  * check_wfa_ops.rs — the engine distinguishes exact matches ('M'
    bytes) from mismatches ('X'); no generic-match ops.
  * test_wfa_order.rs — parameter order is align(query=pattern,
    target=text): the CIGAR consumes len(query) pattern bases and
    len(target) text bases.
  * verify_memory_mode.rs:24-59 — constructor penalty orders
    (match, mismatch, gap_open, gap_ext[, gap2_open, gap2_ext]) select
    single-piece vs two-piece affine; allwave always uses the
    low-memory mode (biWFA) without changing results — here: the
    segmented O(s)-memory engine must be bit-identical to one-shot.
"""

import numpy as np
import pytest

from allwave.core.cigar import (
    cigar_bytes_to_string,
    parse_cigar_lengths,
    validate_cigar,
)
from allwave.core.paf import alignment_to_paf
from allwave.core.scores import parse_scores
from allwave.core.types import (
    OP_D,
    OP_I,
    OP_M,
    OP_X,
    AlignmentMode,
    Sequence,
)
from allwave.wfa.simple import (
    SimplePenalties,
    align_pair,
    align_sequences,
)

# The exact sequences used by the reference's debug bins.
SEQ12 = b"ACGTACGTACGT"  # debug_cigar.rs seq1 (12 bases)
SEQ10 = b"ACGTACGTAC"  # debug_cigar.rs seq2 (10 bases)
MM_Q = b"ACGTACGTACGT"  # check_wfa_ops.rs query
MM_T = b"ACGTACGTTCGT"  # check_wfa_ops.rs reference (A->T at pos 8)

TWO_PIECE = parse_scores("0,5,8,2,24,1")


def _bytes(res):
    return np.asarray(res.cigar_bytes, dtype=np.uint8)


class TestIDSwap:
    """debug_cigar.rs: 12bp query vs 10bp target, two-piece penalties
    (0,5,8,2,24,1). Global alignment must consume both fully; the two
    surplus QUERY bases are WFA2 'D' bytes, printed as standard 'I'."""

    def test_long_query_surplus_is_wfa2_D(self):
        res = align_pair(
            Sequence("q", SEQ12), Sequence("t", SEQ10), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        # full end-to-end consumption, exactly as debug_cigar.rs prints
        assert parse_cigar_lengths(c) == (12, 10)
        assert res.query_end == 12 and res.target_end == 10
        # surplus query bases -> 'D' bytes in WFA2 convention
        assert int(np.count_nonzero(c == OP_D)) == 2
        assert int(np.count_nonzero(c == OP_I)) == 0
        validate_cigar(c, SEQ12, SEQ10)
        # ... and the printed CIGAR swaps back to standard 'I'
        s = cigar_bytes_to_string(c)
        assert "I" in s and "D" not in s

    def test_long_target_surplus_is_wfa2_I(self):
        res = align_pair(
            Sequence("q", SEQ10), Sequence("t", SEQ12), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        assert parse_cigar_lengths(c) == (10, 12)
        assert int(np.count_nonzero(c == OP_I)) == 2
        assert int(np.count_nonzero(c == OP_D)) == 0
        validate_cigar(c, SEQ10, SEQ12)
        s = cigar_bytes_to_string(c)
        assert "D" in s and "I" not in s

    def test_paf_record_swaps_back(self):
        """The PAF cg:Z: tag is standard convention: 'I' consumes query.
        (lib.rs:71-112 + alignment.rs:347-376)."""
        res = align_pair(
            Sequence("q", SEQ12), Sequence("t", SEQ10), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        paf = alignment_to_paf(
            res, [Sequence("q", SEQ12), Sequence("t", SEQ10)]
        )
        fields = paf.split("\t")
        assert fields[1] == "12" and fields[3] == "12"  # qlen, qend
        assert fields[6] == "10" and fields[8] == "10"  # tlen, tend
        cg = [f for f in fields if f.startswith("cg:Z:")][0][5:]
        # 10 matching bases + 2 query-only bases as standard 'I'
        assert "I" in cg and "D" not in cg
        tot_i = sum(
            int(n)
            for n, op in __import__("re").findall(r"(\d+)([=XID])", cg)
            if op == "I"
        )
        assert tot_i == 2


class TestOpCodes:
    """check_wfa_ops.rs: one substitution must appear as exactly one 'X'
    byte among 'M's — never a generic match op."""

    def test_single_mismatch_counts(self):
        res = align_pair(
            Sequence("q", MM_Q), Sequence("t", MM_T), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        assert int(np.count_nonzero(c == OP_M)) == 11
        assert int(np.count_nonzero(c == OP_X)) == 1
        assert int(np.count_nonzero(c == OP_I)) == 0
        assert int(np.count_nonzero(c == OP_D)) == 0
        # the X sits at position 8, as check_wfa_ops.rs's diagram shows
        assert int(np.flatnonzero(c == OP_X)[0]) == 8
        assert cigar_bytes_to_string(c) == "8=1X3="
        validate_cigar(c, MM_Q, MM_T)

    def test_identical_sequences_all_M(self):
        res = align_pair(
            Sequence("q", MM_Q), Sequence("t", MM_Q), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        assert np.all(c == OP_M) and c.size == 12
        assert res.score == 0


class TestParamOrder:
    """test_wfa_order.rs: align(seq1, seq2) treats seq1 as the
    pattern/query and seq2 as the text/target — swapping the arguments
    swaps which sequence the surplus ops consume."""

    @pytest.mark.parametrize(
        "q,t,wfa_op",
        [(SEQ12, SEQ10, OP_D), (SEQ10, SEQ12, OP_I)],
        ids=["q12_t10", "q10_t12"],
    )
    def test_order(self, q, t, wfa_op):
        res = align_sequences(
            q,
            t,
            SimplePenalties(5, 8, 2, 24, 1),
            AlignmentMode.TWO_PIECE_AFFINE,
        )
        # SimpleAlignmentResult reports standard-convention counts
        # (wfa.rs:84-103): insertions consume query.
        if wfa_op == OP_D:
            assert res.insertions == 2 and res.deletions == 0
        else:
            assert res.deletions == 2 and res.insertions == 0
        assert res.matches == 10 and res.mismatches == 0

    def test_lower_score_is_better(self):
        """types.rs:30: score is a penalty — 0 for identity, positive
        otherwise."""
        perfect = align_sequences(
            SEQ12, SEQ12, SimplePenalties(5, 8, 2), AlignmentMode.SINGLE_PIECE_AFFINE
        )
        gapped = align_sequences(
            SEQ12, SEQ10, SimplePenalties(5, 8, 2), AlignmentMode.SINGLE_PIECE_AFFINE
        )
        assert perfect.score == 0
        assert gapped.score > perfect.score


class TestPenaltyConstructors:
    """verify_memory_mode.rs:24-59: the 4-penalty constructor selects
    single-piece affine, the 6-penalty one two-piece; allwave's
    always-on Ultralow (biWFA) memory mode must not change results."""

    def test_mode_inference(self):
        assert (
            AlignmentMode.from_params(parse_scores("0,5,8,2"))
            == AlignmentMode.SINGLE_PIECE_AFFINE
        )
        assert (
            AlignmentMode.from_params(parse_scores("0,5,8,2,24,1"))
            == AlignmentMode.TWO_PIECE_AFFINE
        )
        assert (
            AlignmentMode.from_params(parse_scores("0,1,1,1"))
            == AlignmentMode.EDIT_DISTANCE
        )

    def test_two_piece_changes_long_gap_cost(self):
        """With (8,2) vs (24,1) pieces, a long gap's cost must follow the
        cheaper second piece: cost(n) = min(8+2n, 24+n)."""
        q = b"ACGT" * 12  # 48
        t = b"ACGT" * 6  # 24: one 24-base gap
        res1 = align_sequences(
            q, t, SimplePenalties(5, 8, 2), AlignmentMode.SINGLE_PIECE_AFFINE
        )
        res2 = align_sequences(
            q, t, SimplePenalties(5, 8, 2, 24, 1), AlignmentMode.TWO_PIECE_AFFINE
        )
        n = 24
        assert res1.score == 8 + 2 * n
        assert res2.score == min(8 + 2 * n, 24 + n)

    @pytest.mark.slow
    def test_segmented_low_memory_bit_equal(self):
        """The O(s)-memory segmented engine (the biWFA-Ultralow analog,
        SURVEY §5) returns the identical score and CIGAR bytes as the
        one-shot dense engine on the same pair."""
        from allwave.wfa.dense_engine import DenseBandAligner
        from allwave.wfa.segmented import SegmentedConfig, SegmentedDenseAligner
        from allwave.wfa.params import resolve_penalties

        rng = np.random.RandomState(7)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        q = rng.choice(bases, 700).astype(np.uint8)
        t = q.copy()
        mut = rng.rand(700) < 0.05
        t[mut] = rng.choice(bases, int(mut.sum()))
        q_b, t_b = q.tobytes(), t.tobytes()
        pen = resolve_penalties(TWO_PIECE)
        dense = DenseBandAligner(pen).align_pairs([(q_b, t_b)])[0]
        seg = SegmentedDenseAligner(
            pen, SegmentedConfig(ckpt_every=256)
        ).align_pairs([(q_b, t_b)])[0]
        assert dense is not None and seg is not None
        assert dense[0] == seg[0]
        np.testing.assert_array_equal(
            np.asarray(dense[1]), np.asarray(seg[1])
        )
