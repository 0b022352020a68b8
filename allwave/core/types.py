"""Core types for the allwave framework.

Re-design of the reference's core contracts
(reference: src/types.rs:6-117). These are the *host-side*
types; on-device state lives in packed JAX arrays (see allwave.wfa).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Union

import numpy as np


@dataclass
class Sequence:
    """A named DNA sequence (reference: types.rs:7-10).

    ``seq`` is raw bytes (ASCII); case and non-ACGT bytes are preserved
    exactly as read, matching the reference's behavior.
    """

    id: str
    seq: bytes

    def __len__(self) -> int:
        return len(self.seq)


@dataclass
class AlignmentParams:
    """Scoring parameters (reference: types.rs:37-59).

    All penalties are non-negative; lower alignment score is better.
    ``gap2_*`` set => two-piece affine gap model.
    ``max_divergence`` is accepted for API parity but unused (dead in the
    reference too, verified by grep).
    """

    match_score: int = 0
    mismatch_penalty: int = 5
    gap_open: int = 8
    gap_extend: int = 2
    gap2_open: Optional[int] = 24
    gap2_extend: Optional[int] = 1
    max_divergence: Optional[float] = None

    @staticmethod
    def default() -> "AlignmentParams":
        return AlignmentParams()

    @staticmethod
    def edit_distance() -> "AlignmentParams":
        """Edit-distance preset (reference: types.rs:63-73).

        Note: like the reference, this still runs the gap-affine engine with
        o=e=x (a length-l gap costs x + l*x), it is not a true unit-cost
        Levenshtein gap model.
        """
        return AlignmentParams(
            match_score=0,
            mismatch_penalty=1,
            gap_open=1,
            gap_extend=1,
            gap2_open=None,
            gap2_extend=None,
        )

    def key(self) -> tuple:
        """Hashable identity used for aligner/kernel caching."""
        return (
            self.match_score,
            self.mismatch_penalty,
            self.gap_open,
            self.gap_extend,
            self.gap2_open,
            self.gap2_extend,
        )


class AlignmentMode(Enum):
    """Alignment mode inferred from params (reference: types.rs:105-117)."""

    EDIT_DISTANCE = "edit_distance"
    SINGLE_PIECE_AFFINE = "single_piece_affine"
    TWO_PIECE_AFFINE = "two_piece_affine"

    @staticmethod
    def from_params(params: AlignmentParams) -> "AlignmentMode":
        # Order matters and matches the reference exactly: gap2 wins, then
        # the go==ge==x edit-distance test, else single-piece affine.
        if params.gap2_open is not None and params.gap2_extend is not None:
            return AlignmentMode.TWO_PIECE_AFFINE
        if (
            params.gap_open == params.gap_extend
            and params.gap_open == params.mismatch_penalty
        ):
            return AlignmentMode.EDIT_DISTANCE
        return AlignmentMode.SINGLE_PIECE_AFFINE


# --- Sparsification strategies (reference: types.rs:78-95) ---------------


@dataclass(frozen=True)
class NoSparsification:
    pass


@dataclass(frozen=True)
class RandomSparsification:
    keep_fraction: float


@dataclass(frozen=True)
class AutoSparsification:
    pass


@dataclass(frozen=True)
class ConnectivitySparsification:
    """Erdos-Renyi giant-component edge probability model."""

    connectivity_prob: float


@dataclass(frozen=True)
class TreeSampling:
    k_nearest: int
    k_farthest: int
    random_fraction: float
    kmer_size: Optional[int] = None


SparsificationStrategy = Union[
    NoSparsification,
    RandomSparsification,
    AutoSparsification,
    ConnectivitySparsification,
    TreeSampling,
]


# CIGAR op codes, *WFA2 byte convention* (reference: alignment.rs:320-344):
#   M = exact match, X = mismatch,
#   I = consumes TARGET (standard 'D'), D = consumes QUERY (standard 'I').
OP_M = ord("M")
OP_X = ord("X")
OP_I = ord("I")
OP_D = ord("D")

#: Score assigned to failed alignments (reference: alignment.rs:49-64 uses
#: i32::MAX).
FAILED_SCORE = 2**31 - 1


class AlignmentResult:
    """Result of one pairwise alignment (reference: types.rs:14-33).

    ``cigar_bytes`` is a uint8 numpy array of per-base ops in the WFA2 byte
    convention above (one byte per aligned base, NOT run-length encoded).

    Internally the CIGAR may be carried as RUN-LENGTH pairs
    (``cigar_runs=(ops, lens)``, start->end order, same WFA2 op bytes) —
    the engines emit runs and the PAF serializer consumes runs, so the
    per-base expansion only materializes if ``cigar_bytes`` is actually
    read (API parity with the reference's byte-level field)."""

    __slots__ = (
        "query_idx",
        "target_idx",
        "query_start",
        "query_end",
        "target_start",
        "target_end",
        "is_reverse",
        "score",
        "num_matches",
        "alignment_length",
        "_cigar_bytes",
        "_cigar_runs",
    )

    def __init__(
        self,
        query_idx: int,
        target_idx: int,
        query_start: int,
        query_end: int,
        target_start: int,
        target_end: int,
        is_reverse: bool,
        cigar_bytes: Optional[np.ndarray] = None,
        score: int = FAILED_SCORE,
        num_matches: int = 0,
        alignment_length: int = 0,
        cigar_runs=None,
    ):
        self.query_idx = query_idx
        self.target_idx = target_idx
        self.query_start = query_start
        self.query_end = query_end
        self.target_start = target_start
        self.target_end = target_end
        self.is_reverse = is_reverse
        self.score = score
        self.num_matches = num_matches
        self.alignment_length = alignment_length
        self._cigar_bytes = cigar_bytes
        self._cigar_runs = cigar_runs
        if cigar_bytes is None and cigar_runs is None:
            self._cigar_bytes = np.zeros(0, dtype=np.uint8)

    @property
    def cigar_bytes(self) -> np.ndarray:
        if self._cigar_bytes is None:
            ops, lens = self._cigar_runs
            self._cigar_bytes = np.repeat(
                np.asarray(ops, dtype=np.uint8),
                np.asarray(lens, dtype=np.int64),
            )
        return self._cigar_bytes

    @cigar_bytes.setter
    def cigar_bytes(self, value: np.ndarray) -> None:
        self._cigar_bytes = value
        self._cigar_runs = None

    @property
    def cigar_runs(self):
        """(ops, lens) run pairs if the result was built from runs, else
        None (callers fall back to cigar_bytes)."""
        return self._cigar_runs

    def __repr__(self) -> str:
        return (
            f"AlignmentResult(query_idx={self.query_idx}, "
            f"target_idx={self.target_idx}, score={self.score}, "
            f"num_matches={self.num_matches}, "
            f"alignment_length={self.alignment_length}, "
            f"is_reverse={self.is_reverse})"
        )

    @staticmethod
    def failed(query_idx: int, target_idx: int, is_reverse: bool) -> "AlignmentResult":
        """Empty result for a failed alignment (reference: alignment.rs:49-64)."""
        return AlignmentResult(
            query_idx=query_idx,
            target_idx=target_idx,
            query_start=0,
            query_end=0,
            target_start=0,
            target_end=0,
            is_reverse=is_reverse,
            cigar_bytes=np.zeros(0, dtype=np.uint8),
            score=FAILED_SCORE,
            num_matches=0,
            alignment_length=0,
        )


class AlignmentError(Exception):
    """Error type for alignment operations (reference: types.rs:120-131)."""
