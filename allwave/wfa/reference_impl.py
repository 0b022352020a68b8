"""Scalar wavefront-alignment oracle (NumPy, per-score vectorized over
diagonals).

This is the framework's single source of truth for WFA semantics: exact
gap-affine / two-piece-affine global alignment with full traceback, written
fresh from the wavefront recurrences (Marco-Sola et al. 2021/2023). Every
other engine (the C++ oracle in csrc/wfa_oracle.cpp, the batched JAX
engines) must agree with this implementation byte-for-byte on scores AND
CIGARs.

Conventions (matching the reference's use of its DP engine — see
reference src/alignment.rs:226-236 and SURVEY.md §2.2):

* pattern = query (index v), text = target (index h);
  diagonal k = h - v in [-plen, tlen]; wavefront offsets store h.
* CIGAR bytes use the WFA2 convention: M = exact match, X = mismatch,
  'I' consumes TARGET (h advances), 'D' consumes QUERY (v advances).
* global end-to-end alignment, exact (no heuristics), lower score better.

Tie-breaking: the optimal score is unique but the optimal alignment is
not; the CIGAR depends on the backtrace's preference order at equal
offsets. The order is defined ONCE here (`TIEBREAK_M`, `TIEBREAK_GAP`) and
replicated by all other engines. The reference's engine does not document
its order; if golden outputs from the reference binary become available,
recalibrate by editing these two constants only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.types import OP_D, OP_I, OP_M, OP_X
from .params import Penalties

NULL = np.int32(-(2**30))

# Backtrace preference at the M wavefront when several predecessors reach
# the same pre-extension offset: mismatch first, then gap closes.
TIEBREAK_M: Tuple[str, ...] = ("X", "I1", "I2", "D1", "D2")
# Inside a gap wavefront: prefer continuing the gap over opening it.
TIEBREAK_GAP: Tuple[str, ...] = ("ext", "open")


class _Wavefront:
    """One score level: per-component offset arrays over diagonals
    [lo, hi]."""

    __slots__ = ("lo", "hi", "m", "i1", "d1", "i2", "d2")

    def __init__(self, lo: int, hi: int, two_piece: bool):
        width = hi - lo + 1
        self.lo = lo
        self.hi = hi
        self.m = np.full(width, NULL, dtype=np.int32)
        self.i1 = np.full(width, NULL, dtype=np.int32)
        self.d1 = np.full(width, NULL, dtype=np.int32)
        if two_piece:
            self.i2 = np.full(width, NULL, dtype=np.int32)
            self.d2 = np.full(width, NULL, dtype=np.int32)
        else:
            self.i2 = None
            self.d2 = None

    def get(self, comp: str, k: int) -> int:
        if self.lo <= k <= self.hi:
            arr = getattr(self, comp)
            if arr is not None:
                return int(arr[k - self.lo])
        return int(NULL)


def _component_slice(
    wf: Optional[_Wavefront], comp: str, lo: int, hi: int
) -> np.ndarray:
    """Offsets of wf.comp over diagonals [lo, hi], NULL outside."""
    out = np.full(hi - lo + 1, NULL, dtype=np.int32)
    if wf is None:
        return out
    arr = getattr(wf, comp)
    if arr is None:
        return out
    s_lo = max(lo, wf.lo)
    s_hi = min(hi, wf.hi)
    if s_lo > s_hi:
        return out
    out[s_lo - lo : s_hi - lo + 1] = arr[s_lo - wf.lo : s_hi - wf.lo + 1]
    return out


def _extend(
    offsets: np.ndarray, lo: int, pattern: np.ndarray, text: np.ndarray
) -> np.ndarray:
    """Greedy match-run extension along each diagonal (scalar inner loop —
    this is the oracle, not the fast path)."""
    plen, tlen = pattern.size, text.size
    out = offsets.copy()
    for idx in range(out.size):
        h = int(out[idx])
        if h <= int(NULL):
            continue
        k = lo + idx
        v = h - k
        while v < plen and h < tlen and pattern[v] == text[h]:
            v += 1
            h += 1
        out[idx] = h
    return out


def _trim_invalid(offsets: np.ndarray, lo: int, plen: int, tlen: int) -> np.ndarray:
    """NULL out offsets beyond the sequence ends (h > min(tlen, plen+k))
    or off the valid diagonal band."""
    ks = lo + np.arange(offsets.size, dtype=np.int64)
    h_max = np.minimum(tlen, plen + ks)
    bad = (offsets > h_max) | (ks < -plen) | (ks > tlen)
    out = offsets.copy()
    out[bad & (out > NULL)] = NULL
    return out


def wfa_align(
    pattern: bytes | np.ndarray,
    text: bytes | np.ndarray,
    pen: Penalties,
    max_score: Optional[int] = None,
) -> Tuple[int, np.ndarray]:
    """Exact global wavefront alignment with full traceback.

    Returns (score, cigar_bytes) where cigar_bytes is uint8 in the WFA2
    convention. Raises RuntimeError if max_score is exceeded.
    """
    p = np.frombuffer(pattern, dtype=np.uint8) if isinstance(pattern, (bytes, bytearray)) else np.asarray(pattern, dtype=np.uint8)
    t = np.frombuffer(text, dtype=np.uint8) if isinstance(text, (bytes, bytearray)) else np.asarray(text, dtype=np.uint8)
    plen, tlen = int(p.size), int(t.size)
    k_end = tlen - plen

    if plen == 0 and tlen == 0:
        return 0, np.zeros(0, dtype=np.uint8)

    if max_score is None:
        # loose upper bound: mismatch everything + one full gap
        max_score = (
            pen.x * min(plen, tlen)
            + pen.o1
            + pen.e1 * (abs(plen - tlen) + 1)
            + max(pen.x, pen.o1 + pen.e1, (pen.o2 + pen.e2) if pen.two_piece else 0)
            + 1
        )

    history: List[Optional[_Wavefront]] = []

    # Score 0: M[0] = 0, extended.
    wf0 = _Wavefront(0, 0, pen.two_piece)
    wf0.m[0] = 0
    wf0.m = _extend(wf0.m, 0, p, t)
    wf0.m = _trim_invalid(wf0.m, 0, plen, tlen)
    history.append(wf0)
    if wf0.get("m", k_end) == tlen:
        cigar = _backtrace(history, 0, k_end, p, t, pen)
        return 0, cigar

    s = 0
    while True:
        s += 1
        if s > max_score:
            raise RuntimeError(f"alignment exceeded max_score={max_score}")
        wf = _compute_next(history, s, p, t, pen)
        history.append(wf)
        if wf is not None and wf.get("m", k_end) == tlen:
            cigar = _backtrace(history, s, k_end, p, t, pen)
            return s, cigar


def _prev(history: List[Optional[_Wavefront]], s: int) -> Optional[_Wavefront]:
    if s < 0 or s >= len(history):
        return None
    return history[s]


def _compute_next(
    history: List[Optional[_Wavefront]],
    s: int,
    p: np.ndarray,
    t: np.ndarray,
    pen: Penalties,
) -> Optional[_Wavefront]:
    plen, tlen = int(p.size), int(t.size)
    wx = _prev(history, s - pen.x)
    wo1 = _prev(history, s - pen.o1 - pen.e1)
    we1 = _prev(history, s - pen.e1)
    wo2 = _prev(history, s - pen.o2 - pen.e2) if pen.two_piece else None
    we2 = _prev(history, s - pen.e2) if pen.two_piece else None

    sources = [w for w in (wx, wo1, we1, wo2, we2) if w is not None]
    if not sources:
        return None
    lo = min(w.lo for w in sources) - 1
    hi = max(w.hi for w in sources) + 1
    lo = max(lo, -plen)
    hi = min(hi, tlen)
    if lo > hi:
        return None

    wf = _Wavefront(lo, hi, pen.two_piece)

    # I1[s][k] = max(M[s-o1-e1][k-1], I1[s-e1][k-1]) + 1
    src_open = _component_slice(wo1, "m", lo - 1, hi - 1)
    src_ext = _component_slice(we1, "i1", lo - 1, hi - 1)
    i1 = np.maximum(src_open, src_ext)
    i1 = np.where(i1 > NULL, i1 + 1, NULL)
    wf.i1 = _trim_invalid(i1.astype(np.int32), lo, plen, tlen)

    # D1[s][k] = max(M[s-o1-e1][k+1], D1[s-e1][k+1])
    src_open = _component_slice(wo1, "m", lo + 1, hi + 1)
    src_ext = _component_slice(we1, "d1", lo + 1, hi + 1)
    d1 = np.maximum(src_open, src_ext)
    wf.d1 = _trim_invalid(d1.astype(np.int32), lo, plen, tlen)

    best = np.maximum(wf.i1, wf.d1)

    if pen.two_piece:
        src_open = _component_slice(wo2, "m", lo - 1, hi - 1)
        src_ext = _component_slice(we2, "i2", lo - 1, hi - 1)
        i2 = np.maximum(src_open, src_ext)
        i2 = np.where(i2 > NULL, i2 + 1, NULL)
        wf.i2 = _trim_invalid(i2.astype(np.int32), lo, plen, tlen)

        src_open = _component_slice(wo2, "m", lo + 1, hi + 1)
        src_ext = _component_slice(we2, "d2", lo + 1, hi + 1)
        d2 = np.maximum(src_open, src_ext)
        wf.d2 = _trim_invalid(d2.astype(np.int32), lo, plen, tlen)

        best = np.maximum(best, np.maximum(wf.i2, wf.d2))

    # M via mismatch: M[s-x][k] + 1
    mis = _component_slice(wx, "m", lo, hi)
    mis = np.where(mis > NULL, mis + 1, NULL).astype(np.int32)
    mis = _trim_invalid(mis, lo, plen, tlen)
    # Mismatch also requires the step to land on an actual cell (the +1
    # consumes one base of each sequence) — _trim_invalid covers the
    # bounds; a mismatch from offset h needs v=h-k < plen and h < tlen,
    # i.e. new offset <= min(tlen, plen + k), which is exactly the trim.
    m_pre = np.maximum(best, mis)

    wf.m = _extend(m_pre.astype(np.int32), lo, p, t)
    wf.m = _trim_invalid(wf.m, lo, plen, tlen)

    if (
        np.all(wf.m <= NULL)
        and np.all(wf.i1 <= NULL)
        and np.all(wf.d1 <= NULL)
        and (not pen.two_piece or (np.all(wf.i2 <= NULL) and np.all(wf.d2 <= NULL)))
    ):
        # keep an empty placeholder so score indexing stays aligned
        return wf
    return wf


def _backtrace(
    history: List[Optional[_Wavefront]],
    s_final: int,
    k_end: int,
    p: np.ndarray,
    t: np.ndarray,
    pen: Penalties,
) -> np.ndarray:
    """Reconstruct the CIGAR from the full wavefront history using the
    documented tie-break order."""

    def get(s: int, comp: str, k: int) -> int:
        wf = _prev(history, s)
        if wf is None:
            return int(NULL)
        return wf.get(comp, k)

    ops_rev: List[int] = []  # built backwards
    s = s_final
    k = k_end
    comp = "m"
    h = get(s, "m", k)
    assert h == t.size

    while True:
        if comp == "m":
            if s == 0:
                # At score 0 only M[0][0] exists; its offset equals the
                # number of leading matches on the main diagonal.
                assert k == 0
                ops_rev.extend([OP_M] * h)
                break
            # candidate pre-extension offsets
            cand = {}
            mis = get(s - pen.x, "m", k)
            cand["X"] = mis + 1 if mis > int(NULL) else int(NULL)
            cand["I1"] = get(s, "i1", k)
            cand["D1"] = get(s, "d1", k)
            if pen.two_piece:
                cand["I2"] = get(s, "i2", k)
                cand["D2"] = get(s, "d2", k)
            else:
                cand["I2"] = int(NULL)
                cand["D2"] = int(NULL)
            pre = max(cand.values())
            if pre <= int(NULL):
                raise AssertionError("backtrace: no predecessor at M")
            # matches appended during extension
            n_match = h - pre
            if n_match > 0:
                ops_rev.extend([OP_M] * n_match)
            h = pre
            for choice in TIEBREAK_M:
                if cand[choice] == pre:
                    break
            else:
                raise AssertionError("backtrace: tie-break found no candidate")
            if choice == "X":
                ops_rev.append(OP_X)
                s -= pen.x
                h -= 1
                # k unchanged, comp stays "m"
            elif choice in ("I1", "I2"):
                comp = "i1" if choice == "I1" else "i2"
            else:
                comp = "d1" if choice == "D1" else "d2"
        elif comp in ("i1", "i2"):
            o, e = (pen.o1, pen.e1) if comp == "i1" else (pen.o2, pen.e2)
            ext = get(s - e, comp, k - 1)
            opn = get(s - o - e, "m", k - 1)
            ops_rev.append(OP_I)
            chosen = None
            for g in TIEBREAK_GAP:
                if g == "ext" and ext > int(NULL) and ext + 1 == h:
                    chosen = "ext"
                    break
                if g == "open" and opn > int(NULL) and opn + 1 == h:
                    chosen = "open"
                    break
            if chosen is None:
                raise AssertionError("backtrace: no gap predecessor (I)")
            h -= 1
            k -= 1
            if chosen == "ext":
                s -= e
            else:
                s -= o + e
                comp = "m"
        else:  # d1 / d2
            o, e = (pen.o1, pen.e1) if comp == "d1" else (pen.o2, pen.e2)
            ext = get(s - e, comp, k + 1)
            opn = get(s - o - e, "m", k + 1)
            ops_rev.append(OP_D)
            chosen = None
            for g in TIEBREAK_GAP:
                if g == "ext" and ext > int(NULL) and ext == h:
                    chosen = "ext"
                    break
                if g == "open" and opn > int(NULL) and opn == h:
                    chosen = "open"
                    break
            if chosen is None:
                raise AssertionError("backtrace: no gap predecessor (D)")
            k += 1
            if chosen == "ext":
                s -= e
            else:
                s -= o + e
                comp = "m"

    return np.array(ops_rev[::-1], dtype=np.uint8)
