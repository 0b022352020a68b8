"""CIGAR utilities (WFA2 byte convention).

Vectorized NumPy equivalents of the reference's CIGAR post-processing
(reference: src/alignment.rs:292-376). Every alignment's
CIGAR is a uint8 array with one byte per aligned base:

    M = exact match, X = mismatch,
    I = consumes target (prints as standard 'D'),
    D = consumes query (prints as standard 'I').
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .types import OP_D, OP_I, OP_M, OP_X

# Output characters after the WFA2 -> standard I/D swap
# (reference: alignment.rs:363-369).
_OP_CHAR = {OP_M: "=", OP_X: "X", OP_I: "D", OP_D: "I"}


def count_cigar_operations(cigar_bytes: np.ndarray) -> Tuple[int, int]:
    """(num_matches, alignment_length) — gaps excluded from both
    (reference: alignment.rs:292-310)."""
    if cigar_bytes.size == 0:
        return 0, 0
    matches = int(np.count_nonzero(cigar_bytes == OP_M))
    mismatches = int(np.count_nonzero(cigar_bytes == OP_X))
    return matches, matches + mismatches


def parse_cigar_lengths(cigar_bytes: np.ndarray) -> Tuple[int, int]:
    """(query_len, target_len) consumed by the CIGAR
    (reference: alignment.rs:320-344; note the WFA2 I/D swap)."""
    if cigar_bytes.size == 0:
        return 0, 0
    m = int(np.count_nonzero(cigar_bytes == OP_M))
    x = int(np.count_nonzero(cigar_bytes == OP_X))
    i = int(np.count_nonzero(cigar_bytes == OP_I))  # consumes target
    d = int(np.count_nonzero(cigar_bytes == OP_D))  # consumes query
    return m + x + d, m + x + i


def batch_cigar_stats(cigars) -> np.ndarray:
    """Vectorized stats for a list of CIGAR byte arrays: one (n, 4)
    int64 array of [num_matches, alignment_length, query_len,
    target_len] rows — same semantics as count_cigar_operations +
    parse_cigar_lengths, computed with two passes over ONE concatenated
    buffer instead of 2n small reductions (the per-record loop showed up
    at ~0.8 s per 16k records in the pipeline profile)."""
    n = len(cigars)
    out = np.zeros((n, 4), dtype=np.int64)
    if n == 0:
        return out
    lens = np.fromiter((c.size for c in cigars), np.int64, n)
    cat = (
        np.concatenate([np.asarray(c, dtype=np.uint8) for c in cigars])
        if lens.sum()
        else np.zeros(0, np.uint8)
    )
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])

    def seg_count(mask):
        csum = np.concatenate([[0], np.cumsum(mask, dtype=np.int64)])
        return csum[offs[1:]] - csum[offs[:-1]]

    m = seg_count(cat == OP_M)
    x = seg_count(cat == OP_X)
    i = seg_count(cat == OP_I)  # consumes target
    d = seg_count(cat == OP_D)  # consumes query
    out[:, 0] = m
    out[:, 1] = m + x
    out[:, 2] = m + x + d
    out[:, 3] = m + x + i
    return out


def edit_distance_from_cigar(cigar_bytes: np.ndarray) -> int:
    """Number of X/I/D ops (reference: alignment.rs:312-317)."""
    if cigar_bytes.size == 0:
        return 0
    return int(np.count_nonzero(cigar_bytes != OP_M))


def run_length_encode(cigar_bytes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RLE of the op-byte array -> (ops uint8, counts int64)."""
    c = np.ascontiguousarray(cigar_bytes, dtype=np.uint8)
    if c.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    boundaries = np.flatnonzero(np.diff(c)) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [c.size]))
    return c[starts], (ends - starts).astype(np.int64)


def cigar_bytes_to_string(cigar_bytes: np.ndarray) -> str:
    """Run-length-encoded standard CIGAR string with the WFA2 I/D swap
    (reference: alignment.rs:347-376): M->'=', X->'X', I->'D', D->'I'."""
    ops, counts = run_length_encode(np.asarray(cigar_bytes, dtype=np.uint8))
    parts = []
    for op, count in zip(ops.tolist(), counts.tolist()):
        parts.append(f"{count}{_OP_CHAR.get(op, '?')}")
    return "".join(parts)


def runs_to_cigar_string(ops, lens) -> str:
    """Run-length CIGAR string straight from (op, len) run pairs — same
    output bytes as cigar_bytes_to_string(expanded) without ever
    materializing the per-base array. Adjacent same-op runs (the device
    run buffers cap a run at 255, so a 300-base match arrives as
    255+45) are merged, preserving byte-equality with the reference's
    encoder (alignment.rs:347-376)."""
    parts = []
    prev_op = -1
    acc = 0
    for o, l in zip(np.asarray(ops).tolist(), np.asarray(lens).tolist()):
        if l == 0:
            continue
        if o == prev_op:
            acc += l
        else:
            if acc:
                parts.append(f"{acc}{_OP_CHAR.get(prev_op, '?')}")
            prev_op = o
            acc = l
    if acc:
        parts.append(f"{acc}{_OP_CHAR.get(prev_op, '?')}")
    return "".join(parts)


def cigar_string_to_bytes(cigar: str) -> np.ndarray:
    """Inverse of :func:`cigar_bytes_to_string`: parse a standard CIGAR
    string (with '='/'X'/'I'/'D') back into WFA2-convention op bytes.

    Used by validators and tests to replay PAF records.
    """
    out = []
    count = 0
    # standard char -> WFA2 byte (reverse of the swap)
    rev = {"=": OP_M, "M": OP_M, "X": OP_X, "D": OP_I, "I": OP_D}
    for ch in cigar:
        if ch.isdigit():
            count = count * 10 + ord(ch) - 48
        else:
            if ch not in rev:
                raise ValueError(f"Invalid CIGAR operation: {ch}")
            if count == 0:
                raise ValueError("CIGAR op with zero count")
            out.append(np.full(count, rev[ch], dtype=np.uint8))
            count = 0
    if count != 0:
        raise ValueError("trailing count in CIGAR string")
    if not out:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(out)


def validate_cigar(cigar_bytes: np.ndarray, query: bytes, target: bytes) -> None:
    """Replay the CIGAR against both sequences, checking bounds and full
    end-to-end consumption (reference: wfa.rs:105-176, WFA2 convention).

    Raises ValueError on any inconsistency.
    """
    qlen, tlen = parse_cigar_lengths(np.asarray(cigar_bytes, dtype=np.uint8))
    if qlen != len(query):
        raise ValueError(f"CIGAR doesn't cover full query: {qlen} vs {len(query)}")
    if tlen != len(target):
        raise ValueError(f"CIGAR doesn't cover full target: {tlen} vs {len(target)}")
    # Verify M runs are exact matches and X runs are mismatches.
    c = np.asarray(cigar_bytes, dtype=np.uint8)
    consumes_q = (c == OP_M) | (c == OP_X) | (c == OP_D)
    consumes_t = (c == OP_M) | (c == OP_X) | (c == OP_I)
    q_pos = np.cumsum(consumes_q) - consumes_q.astype(np.int64)
    t_pos = np.cumsum(consumes_t) - consumes_t.astype(np.int64)
    q_arr = np.frombuffer(query, dtype=np.uint8)
    t_arr = np.frombuffer(target, dtype=np.uint8)
    both = (c == OP_M) | (c == OP_X)
    if np.any(both):
        eq = q_arr[q_pos[both]] == t_arr[t_pos[both]]
        is_m = c[both] == OP_M
        if np.any(is_m & ~eq):
            raise ValueError("CIGAR 'M' op over mismatching bases")
        if np.any(~is_m & eq):
            raise ValueError("CIGAR 'X' op over matching bases")
