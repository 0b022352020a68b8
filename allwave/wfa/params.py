"""Penalty resolution for the wavefront engines.

Mirrors how the reference instantiates its DP engine
(reference: src/alignment.rs:263-289):

* EDIT_DISTANCE       -> gap-affine with o = e = x  (so a length-l gap
                         costs x + l*x — the reference's "edit distance"
                         is NOT unit-cost Levenshtein; we replicate it).
* SINGLE_PIECE_AFFINE -> gap-affine (x, o1, e1).
* TWO_PIECE_AFFINE    -> gap-affine-2p (x, o1, e1, o2, e2); a length-l gap
                         costs min(o1 + l*e1, o2 + l*e2).

Score semantics: match = 0, all penalties positive, lower score better.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.types import AlignmentMode, AlignmentParams


@dataclass(frozen=True)
class Penalties:
    """Resolved penalties for the wavefront DP. two_piece=False means the
    I2/D2 components are absent."""

    x: int  # mismatch
    o1: int  # gap1 open
    e1: int  # gap1 extend
    o2: int  # gap2 open (unused when two_piece=False)
    e2: int  # gap2 extend
    two_piece: bool

    @property
    def max_lookback(self) -> int:
        """Largest score offset any recurrence reaches back to."""
        cands = [self.x, self.o1 + self.e1, self.e1]
        if self.two_piece:
            cands += [self.o2 + self.e2, self.e2]
        return max(cands)


def resolve_penalties(params: AlignmentParams) -> Penalties:
    mode = AlignmentMode.from_params(params)
    if params.match_score != 0:
        raise ValueError(
            "match_score must be 0 (the wavefront DP assumes zero-cost matches; "
            "the reference behaves the same — all its presets use 0)"
        )
    if params.mismatch_penalty <= 0:
        raise ValueError("mismatch_penalty must be positive")
    if mode == AlignmentMode.EDIT_DISTANCE:
        x = params.mismatch_penalty
        return Penalties(x=x, o1=x, e1=x, o2=0, e2=0, two_piece=False)
    if mode == AlignmentMode.SINGLE_PIECE_AFFINE:
        if params.gap_extend <= 0:
            raise ValueError("gap_extend must be positive")
        return Penalties(
            x=params.mismatch_penalty,
            o1=params.gap_open,
            e1=params.gap_extend,
            o2=0,
            e2=0,
            two_piece=False,
        )
    # two-piece
    if params.gap_extend <= 0 or (params.gap2_extend or 0) <= 0:
        raise ValueError("gap extends must be positive")
    return Penalties(
        x=params.mismatch_penalty,
        o1=params.gap_open,
        e1=params.gap_extend,
        o2=params.gap2_open if params.gap2_open is not None else params.gap_open,
        e2=params.gap2_extend if params.gap2_extend is not None else params.gap_extend,
        two_piece=True,
    )
