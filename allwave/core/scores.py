"""Score-string and ANI-preset parsing.

Reference: src/lib.rs:116-153 (parse_scores) and
src/main.rs:83-124 (ANI presets).
"""

from __future__ import annotations

from .types import AlignmentParams


def parse_scores(scores_str: str) -> AlignmentParams:
    """Parse "match,mismatch,gap_open,gap_ext[,gap_open2,gap_ext2]".

    Raises ValueError with reference-compatible messages.
    """
    try:
        scores = [int(s.strip()) for s in scores_str.split(",")]
    except ValueError as e:
        raise ValueError(f"Failed to parse scores: {e}") from e

    if len(scores) == 4:
        return AlignmentParams(
            match_score=scores[0],
            mismatch_penalty=scores[1],
            gap_open=scores[2],
            gap_extend=scores[3],
            gap2_open=None,
            gap2_extend=None,
        )
    if len(scores) == 6:
        return AlignmentParams(
            match_score=scores[0],
            mismatch_penalty=scores[1],
            gap_open=scores[2],
            gap_extend=scores[3],
            gap2_open=scores[4],
            gap2_extend=scores[5],
        )
    raise ValueError(
        f"Invalid number of scores: {len(scores)}. Expected 4 or 6 values."
    )


def parse_ani_preset(preset: str) -> str:
    """Map an ANI preset string to a scores string
    (reference: main.rs:83-124).

    Accepts "95%", "95", or "0.95". Returns the scores string.
    """
    if "." in preset:
        try:
            value = float(preset)
        except ValueError:
            value = -1.0
        if not (0.0 < value <= 1.0):
            raise ValueError(f"Invalid ANI value: {preset}. Use 0.5-1.0 or 50%-100%")
        ani_percent = value * 100.0
    elif preset.endswith("%"):
        try:
            value = float(preset[:-1])
        except ValueError:
            value = -1.0
        if not (50.0 <= value <= 100.0):
            raise ValueError(f"Invalid ANI percentage: {preset}. Use 50%-100%")
        ani_percent = value
    else:
        try:
            value = float(preset)
        except ValueError:
            value = -1.0
        if not (50.0 <= value <= 100.0):
            raise ValueError(
                f"Invalid ANI percentage: {preset}. Use 50%-100% or 50-100"
            )
        ani_percent = value

    # Preset table (reference: main.rs:113-122).
    if ani_percent >= 95.0:
        return "0,7,12,2,36,1"
    if ani_percent >= 85.0:
        return "0,5,8,2,24,1"
    if ani_percent >= 75.0:
        return "0,4,6,2,18,1"
    if ani_percent >= 65.0:
        return "0,3,4,1"
    return "0,1,1,1"
