"""Score-axis checkpoint–replay WAVEFRONT alignment for long pairs.

The segmented DENSE engine (segmented.py) sweeps all 2L anti-diagonals
of the band regardless of how similar the pair is — O(L*K) cells. For
long, low-divergence pairs (the pangenome norm: 100 kb haplotypes at
<1% divergence) the wavefront DP does O(s*K) work instead, where s is
the alignment score (s << L): a 100 kb pair at score ~1500 costs ~400x
fewer cell updates. This module gives the wavefront engine (batch.py)
the same O(score/C) memory trick segmented.py gives the dense engine:

1. SWEEP: score-only wavefront DP in C-score segments, snapshotting the
   rolling D-plane buffer (D = max penalty lookback + 1) at each segment
   boundary — no O(s*K) history planes;
2. REPLAY backwards: per segment, re-run the C score levels from the
   checkpoint with full history for just that span, and advance the
   on-device traceback walkers through it (walkers pause at the segment
   floor and resume in the next-earlier segment).

Arithmetic, extension, and tie-breaks are ``batch.py``'s exactly (same
`_wavefront_step`), and the traceback is a segment-windowed twin of
``wavefront_traceback`` — so scores AND CIGARs are bit-identical to the
one-shot wavefront engine, which is itself fuzz-checked against the
oracle and the dense engines (tests/test_fuzz_cross_engine.py).

This replaces the role of biWFA (MemoryMode::Ultralow) in the
reference (src/alignment.rs:265-287): same O(s)-memory
goal, but met by checkpoint–replay instead of a forward/reverse meet —
a true biWFA breakpoint split can return ANY co-optimal alignment,
which would break this framework's bit-exact cross-engine contract.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .params import Penalties
from .batch import (
    NULL,
    _OP_M,
    _OP_X,
    _OP_I,
    _OP_D,
    _band_geometry,
    _make_masks,
    expand_runs_to_cigar,
)

_C_M, _C_I1, _C_D1, _C_I2, _C_D2 = 0, 1, 2, 3, 4
_COMPS = ("m", "i1", "d1", "i2", "d2")


# ---------------------------------------------------------------------------
# Mismatch-bitmap extension index
# ---------------------------------------------------------------------------
#
# The wavefront's greedy match-run extension is, per score level, a
# data-dependent loop of random-access reads q[v] / t[h] at per-diagonal
# offsets. Each iteration is a dependent batched gather, and the loop
# runs until the LONGEST run in the batch finishes — on low-divergence
# 100 kb pairs that is ~44 dependent gathers per score level. The fix:
# precompute, once per group,
#
#   mmw[b, c, w]  (B, K, L/32) uint32 — bit h%32 of word h//32 set iff
#                 extension must STOP at target offset h on band
#                 diagonal c (mismatch, or q/t exhausted);
#   nxw[b, c, w]  int32 — smallest w' >= w with mmw[b, c, w'] != 0
#                 (suffix scan; L/32 where none).
#
# Extension then needs a FIXED three gathers per score level, with no
# data-dependent loop: the current word (masked below h), the next
# mismatch word index, and that word — first-set-bit arithmetic does the
# rest. Bit-for-bit identical offsets to the quad-packed loop in
# batch._extend (both stop at min(first mismatch, h_max)).


@functools.partial(jax.jit, static_argnames=("k_width",))
def build_mismatch_index(qs, ts, qlens, tlens, k0, k_width: int):
    """Precompute (mmw, nxw) for a padded batch. qs/ts: (B, L) uint8,
    k0: (B,) int32 band origin; diagonals c cover k = k0 + c."""
    B, L = qs.shape
    K = k_width
    LW = L // 32
    # qk0[b, i] = q[b, i - k0[b]]  (zero fill; validity handled by masks)
    # q_sh[b, j] = q[b, j - K - k0[b]] over j in [0, L+K): diagonal c's
    # read qc[h] = q[h - k0 - c] = q_sh[h + K - c] stays in range for
    # every h in [0, L) and c in [0, K) (out-of-range v is masked below)
    pos_ext = (
        jnp.arange(L + K, dtype=jnp.int32)[None, :] - K - k0[:, None]
    )
    q_sh = jnp.take_along_axis(
        jnp.pad(qs, ((0, 0), (0, 1))),  # row sentinel for clipped reads
        jnp.clip(pos_ext, 0, L),
        axis=1,
    )
    v0 = jnp.arange(L, dtype=jnp.int32)[None, :] - k0[:, None]
    h_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    bitw = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]

    def one_diag(c):
        qc = jax.lax.dynamic_slice_in_dim(q_sh, K - c, L, axis=1)
        v = v0 - c
        stop = (
            (v < 0)
            | (v >= qlens[:, None])
            | (h_idx >= tlens[:, None])
            | (qc != ts)
        )
        words = jnp.sum(
            jnp.where(stop.reshape(B, LW, 32), bitw, jnp.uint32(0)),
            axis=2,
            dtype=jnp.uint32,
        )
        return words  # (B, LW)

    mmw = jax.lax.map(one_diag, jnp.arange(K, dtype=jnp.int32))  # (K, B, LW)
    mmw = jnp.transpose(mmw, (1, 0, 2))  # (B, K, LW)
    warange = jnp.arange(LW, dtype=jnp.int32)[None, None, :]
    cand = jnp.where(mmw != 0, warange, jnp.int32(LW))
    nxw = jax.lax.cummin(cand, axis=2, reverse=True)
    return mmw, nxw


def _extend_bm(h, h_max, mmw, nxw, l_pad):
    """Bitmap-index extension: h (B, K) offsets -> extended offsets.
    Fixed three gathers, no data-dependent loop. Matches batch._extend
    exactly: lanes with NULL or h > h_max pass through unchanged."""
    LW = l_pad // 32
    ok = (h > NULL) & (h <= h_max)
    hc = jnp.clip(h, 0, l_pad - 1)
    w0 = hc >> 5
    r = (hc & 31).astype(jnp.uint32)
    word0 = jnp.take_along_axis(mmw, w0[:, :, None], axis=2)[:, :, 0]
    m0 = word0 & (jnp.uint32(0xFFFFFFFF) << r)
    have0 = m0 != 0

    def ctz(x):
        return jax.lax.population_count((x & (~x + jnp.uint32(1))) - jnp.uint32(1))

    w1 = jnp.take_along_axis(
        nxw, jnp.minimum(w0 + 1, LW - 1)[:, :, None], axis=2
    )[:, :, 0]
    w1c = jnp.clip(w1, 0, LW - 1)
    word1 = jnp.take_along_axis(mmw, w1c[:, :, None], axis=2)[:, :, 0]
    pos0 = (w0 << 5) + ctz(m0).astype(jnp.int32)
    pos1 = (w1c << 5) + ctz(word1).astype(jnp.int32)
    have1 = (w1 < LW) & (w1 > w0) & (word1 != 0)
    pos = jnp.where(have0, pos0, jnp.where(have1, pos1, jnp.int32(l_pad)))
    return jnp.where(ok, jnp.minimum(pos, h_max), h)


def _wf_step_bm(pen: Penalties, s, buf, ks, h_max, mmw, nxw, l_pad):
    """_wavefront_step with bitmap extension (transitions identical)."""
    from .batch import _shift_left, _shift_right

    D = buf["m"].shape[0]

    def src(comp, ds):
        idx = jnp.mod(s - ds, D)
        plane = jax.lax.dynamic_index_in_dim(buf[comp], idx, axis=0, keepdims=False)
        return jnp.where(s >= ds, plane, NULL)

    trim = lambda a: jnp.where(a > h_max, NULL, a)
    i1_src = jnp.maximum(
        _shift_right(src("m", pen.o1 + pen.e1)), _shift_right(src("i1", pen.e1))
    )
    i1 = trim(jnp.where(i1_src > NULL, i1_src + 1, NULL))
    d1 = trim(
        jnp.maximum(
            _shift_left(src("m", pen.o1 + pen.e1)), _shift_left(src("d1", pen.e1))
        )
    )
    best = jnp.maximum(i1, d1)
    if pen.two_piece:
        i2_src = jnp.maximum(
            _shift_right(src("m", pen.o2 + pen.e2)), _shift_right(src("i2", pen.e2))
        )
        i2 = trim(jnp.where(i2_src > NULL, i2_src + 1, NULL))
        d2 = trim(
            jnp.maximum(
                _shift_left(src("m", pen.o2 + pen.e2)), _shift_left(src("d2", pen.e2))
            )
        )
        best = jnp.maximum(best, jnp.maximum(i2, d2))
    else:
        i2 = jnp.full_like(i1, NULL)
        d2 = jnp.full_like(i1, NULL)
    mis = src("m", pen.x)
    mis = trim(jnp.where(mis > NULL, mis + 1, NULL))
    m_pre = jnp.maximum(best, mis)
    m = _extend_bm(m_pre, h_max, mmw, nxw, l_pad)
    m = trim(m)
    return m, i1, d1, i2, d2


# ---------------------------------------------------------------------------
# jitted pieces
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("pen", "k_width"))
def wf_init(qs, ts, qlens, tlens, pen: Penalties, k_width: int):
    """Score-0 state: mismatch-bitmap extension index, band geometry,
    the rolling buffer with M[0] extended, and done/scores after
    score 0."""
    B, L = qs.shape
    K = k_width
    D = pen.max_lookback + 1
    k_end, k0 = _band_geometry(qlens, tlens, K)
    ks, h_max = _make_masks(qlens, tlens, k0, K)
    c_end = jnp.clip(k_end - k0, 0, K - 1).astype(jnp.int32)
    feasible = jnp.abs(k_end) <= (K - 1)

    mmw, nxw = build_mismatch_index(qs, ts, qlens, tlens, k0, K)

    buf = {c: jnp.full((D, B, K), NULL, dtype=jnp.int32) for c in _COMPS}
    c_zero = (-k0).astype(jnp.int32)
    m0 = jnp.where(
        jnp.arange(K, dtype=jnp.int32)[None, :] == c_zero[:, None], 0, NULL
    ).astype(jnp.int32)
    m0 = _extend_bm(m0, h_max, mmw, nxw, L)
    m0 = jnp.where(m0 > h_max, NULL, m0)
    buf["m"] = buf["m"].at[0].set(m0)

    at_end0 = jnp.take_along_axis(m0, c_end[:, None], axis=1)[:, 0]
    done0 = (at_end0 == tlens) & feasible
    scores0 = jnp.where(done0, 0, -1).astype(jnp.int32)
    return mmw, nxw, ks, h_max, c_end, feasible, buf, done0, scores0


@functools.partial(jax.jit, static_argnames=("pen", "n_steps", "with_history"))
def wf_span(
    mmw,
    nxw,
    ks,
    h_max,
    c_end,
    tlens,
    feasible,
    s_lo,  # traced scalar: span covers scores s_lo+1 .. s_lo+n_steps
    buf,
    done,
    scores,
    pen: Penalties,
    n_steps: int,
    with_history: bool,
):
    """Advance the rolling buffer n_steps score levels. Returns
    (buf, done, scores, hist|None); hist planes are (n_steps, B, K) per
    component, row j holding score s_lo + j + 1."""
    D = buf["m"].shape[0]
    l_pad = mmw.shape[2] * 32

    def step(carry, j):
        buf, done, scores = carry
        s = s_lo + j + 1
        m, i1, d1, i2, d2 = _wf_step_bm(pen, s, buf, ks, h_max, mmw, nxw, l_pad)
        slot = jnp.mod(s, D)
        buf = {
            "m": buf["m"].at[slot].set(m),
            "i1": buf["i1"].at[slot].set(i1),
            "d1": buf["d1"].at[slot].set(d1),
            "i2": buf["i2"].at[slot].set(i2),
            "d2": buf["d2"].at[slot].set(d2),
        }
        at_end = jnp.take_along_axis(m, c_end[:, None], axis=1)[:, 0]
        done_now = (at_end == tlens) & feasible & jnp.logical_not(done)
        scores = jnp.where(done_now, s, scores)
        done = done | done_now
        ys = (m, i1, d1, i2, d2) if with_history else 0
        return (buf, done, scores), ys

    (buf, done, scores), ys = jax.lax.scan(
        step,
        (buf, done, scores),
        jnp.arange(n_steps, dtype=jnp.int32),
    )
    hist = (
        dict(zip(_COMPS, ys)) if with_history else None
    )
    return buf, done, scores, hist


@functools.partial(
    jax.jit, static_argnames=("pen", "n_steps", "run_cap")
)
def wf_replay_traceback(
    mmw,
    nxw,
    ks,
    h_max,
    tlens,
    buf_ckpt,  # rolling buffer at score s_lo (scores s_lo-D+1 .. s_lo)
    s_lo,  # traced scalar: segment floor (replay covers s_lo+1..s_lo+n_steps)
    walk,  # (s, c, h, comp, active) each (B,)
    bufs,  # (ops (B,run_cap) u8, lens (B,run_cap) i32, nrun (B,) i32, overflow (B,) bool)
    pen: Penalties,
    n_steps: int,
    run_cap: int,
):
    """Replay one score segment from its checkpoint and advance the
    traceback walkers through it.

    The traceback window covers absolute scores
    [s_lo - D + 1, s_lo + n_steps]: the checkpoint's own D planes plus
    the replayed n_steps planes. Transition rules are identical to
    batch.wavefront_traceback; walkers whose score falls to <= s_lo
    pause (the next-earlier segment resumes them), except at score 0
    where the origin emit happens."""
    D = buf_ckpt["m"].shape[0]
    B, K = ks.shape
    C = n_steps
    W = D + C
    rows = jnp.arange(B, dtype=jnp.int32)

    # replay (cheap relative to sweep: one segment)
    dummy_done = jnp.zeros((B,), jnp.bool_)
    dummy_scores = jnp.full((B,), -1, jnp.int32)
    c_end_dummy = jnp.zeros((B,), jnp.int32)
    feas_dummy = jnp.zeros((B,), jnp.bool_)
    _, _, _, hist = wf_span(
        mmw,
        nxw,
        ks,
        h_max,
        c_end_dummy,
        tlens,
        feas_dummy,
        s_lo,
        buf_ckpt,
        dummy_done,
        dummy_scores,
        pen=pen,
        n_steps=n_steps,
        with_history=True,
    )
    return _traceback_window(
        hist, buf_ckpt, s_lo, walk, bufs, pen=pen, n_steps=n_steps,
        run_cap=run_cap,
    )


def _traceback_window(hist, buf_ckpt, s_lo, walk, bufs, *, pen, n_steps, run_cap):
    D = buf_ckpt["m"].shape[0]
    B, K = buf_ckpt["m"].shape[1:]
    C = n_steps
    W = D + C
    rows = jnp.arange(B, dtype=jnp.int32)

    # ordered window: row r <-> absolute score s_lo - D + 1 + r
    order = jnp.mod(s_lo - D + 1 + jnp.arange(D, dtype=jnp.int32), D)
    svals = s_lo - D + 1 + jnp.arange(D, dtype=jnp.int32)
    window = {}
    for comp in _COMPS:
        head = jnp.take(buf_ckpt[comp], order, axis=0)
        head = jnp.where(svals[:, None, None] >= 0, head, NULL)
        window[comp] = jnp.concatenate([head, hist[comp]], axis=0)

    s_base = s_lo - D + 1  # absolute score of window row 0

    # ONE gather per hop instead of nine: all nine window reads share a
    # single advanced-indexing take over the stacked (5, W, B, K)
    # window, so the per-gather overhead is paid once per hop.
    w5 = jnp.stack([window[comp] for comp in _COMPS])
    #              m    i1  d1  i2  d2  i1e i2e d1e d2e
    _fcomp = jnp.array([0, 1, 2, 3, 4, 1, 3, 2, 4], jnp.int32)[:, None]

    def fetch9(s, c):
        fs = jnp.stack(
            [s - pen.x, s, s, s, s,
             s - pen.e1, s - pen.e2, s - pen.e1, s - pen.e2]
        )  # (9, B)
        fc = jnp.stack([c, c, c, c, c, c - 1, c - 1, c + 1, c + 1])
        r = fs - s_base
        ok = (r >= 0) & (r < W) & (fs >= 0) & (fc >= 0) & (fc < K)
        rr = jnp.clip(r, 0, W - 1)
        cc = jnp.clip(fc, 0, K - 1)
        B_ = s.shape[0]
        vals = w5[
            jnp.broadcast_to(_fcomp, (9, B_)),
            rr,
            jnp.broadcast_to(rows[None, :], (9, B_)),
            cc,
        ]
        return jnp.where(ok, vals, NULL)

    s0, c0, h0, comp0, active0 = walk
    ops, lens, nrun, overflow = bufs

    # Chunked hops (same trick as segmented.traceback_segment): a plain
    # one-hop-per-while-iteration walk pays the while overhead plus
    # three output scatters PER HOP. Here CHUNK hops run inside a
    # lax.scan emitting dense per-hop logs — up to two entries per hop, slot 0 the
    # M-run/I/D emit and slot 1 the X emit, preserving the original
    # emit order — and ONE batched scatter per chunk packs them into
    # the run buffers (positions strictly increase per pair, so
    # indices are unique).
    CHUNK = 16

    def stepping_of(s, active):
        return active & ((s > s_lo) | (s == 0))

    def hop(carry, _):
        s, c, h, comp, active = carry
        stepping = stepping_of(s, active)

        is_m = comp == _C_M
        at_origin = is_m & (s == 0)

        # ----- M state (identical to batch.wavefront_traceback) -----
        (
            mis_v,
            cand_i1,
            cand_d1,
            cand_i2,
            cand_d2,
            i1_ext,
            i2_ext,
            d1_ext,
            d2_ext,
        ) = fetch9(s, c)
        cand_x = jnp.where(mis_v > NULL, mis_v + 1, NULL)
        pre = jnp.maximum(
            jnp.maximum(jnp.maximum(cand_x, cand_i1), jnp.maximum(cand_d1, cand_i2)),
            cand_d2,
        )
        choice = jnp.where(
            cand_x == pre,
            _C_M,
            jnp.where(
                cand_i1 == pre,
                _C_I1,
                jnp.where(
                    cand_i2 == pre,
                    _C_I2,
                    jnp.where(cand_d1 == pre, _C_D1, _C_D2),
                ),
            ),
        )
        n_match = jnp.where(at_origin, h, h - pre)

        # ----- gap states: extend preferred over open -----
        i1_ext_ok = (i1_ext > NULL) & (i1_ext + 1 == h)
        i2_ext_ok = (i2_ext > NULL) & (i2_ext + 1 == h)
        d1_ext_ok = (d1_ext > NULL) & (d1_ext == h)
        d2_ext_ok = (d2_ext > NULL) & (d2_ext == h)

        is_i = (comp == _C_I1) | (comp == _C_I2)
        is_d = (comp == _C_D1) | (comp == _C_D2)
        gap_e = jnp.where((comp == _C_I1) | (comp == _C_D1), pen.e1, pen.e2)
        gap_oe = jnp.where(
            (comp == _C_I1) | (comp == _C_D1), pen.o1 + pen.e1, pen.o2 + pen.e2
        )
        ext_ok = jnp.where(
            comp == _C_I1,
            i1_ext_ok,
            jnp.where(
                comp == _C_I2,
                i2_ext_ok,
                jnp.where(comp == _C_D1, d1_ext_ok, d2_ext_ok),
            ),
        )

        # ----- emit log (slot 0: M-run / I / D; slot 1: X) -----
        e1_op = jnp.where(
            is_m,
            jnp.uint8(_OP_M),
            jnp.where(is_i, jnp.uint8(_OP_I), jnp.uint8(_OP_D)),
        )
        e1_cnt = jnp.where(is_m, n_match, 1)
        e1_do = stepping & (e1_cnt > 0)
        mismatch_step = stepping & is_m & (~at_origin) & (choice == _C_M)
        e2_do = mismatch_step

        # ----- transitions -----
        m_new_s = jnp.where(choice == _C_M, s - pen.x, s)
        m_new_h = jnp.where(choice == _C_M, pre - 1, pre)
        m_new_comp = choice
        g_new_comp = jnp.where(ext_ok, comp, _C_M)
        g_new_s = jnp.where(ext_ok, s - gap_e, s - gap_oe)
        g_new_c = jnp.where(is_i, c - 1, c + 1)
        g_new_h = jnp.where(is_i, h - 1, h)

        new_s = jnp.where(is_m, m_new_s, g_new_s)
        new_h = jnp.where(is_m, m_new_h, g_new_h)
        new_c = jnp.where(is_m, c, g_new_c)
        new_comp = jnp.where(is_m, m_new_comp, g_new_comp)

        finished = stepping & at_origin
        active = active & (~finished)

        moved = stepping & (~at_origin)
        s = jnp.where(moved, new_s, s)
        h = jnp.where(moved, new_h, h)
        c = jnp.where(moved, new_c, c)
        comp = jnp.where(moved, new_comp, comp)
        return (s, c, h, comp, active), (e1_do, e1_op, e1_cnt, e2_do)

    max_chunks = (3 * run_cap + 8) // CHUNK + 2

    def cond(carry):
        (s, _, _, _, active, _, _, _, _, it) = carry
        return jnp.any(stepping_of(s, active)) & (it < max_chunks)

    def body(carry):
        (s, c, h, comp, active, ops, lens, nrun, overflow, it) = carry
        (s, c, h, comp, active), (e1_do, e1_op, e1_cnt, e2_do) = jax.lax.scan(
            hop, (s, c, h, comp, active), None, length=CHUNK
        )
        # interleave slots hop-major: row 2k = hop k's slot-0 emit,
        # row 2k+1 its X emit
        flags = jnp.stack([e1_do, e2_do], axis=1).reshape(2 * CHUNK, B)
        ops_log = jnp.stack(
            [e1_op, jnp.full_like(e1_op, jnp.uint8(_OP_X))], axis=1
        ).reshape(2 * CHUNK, B)
        cnt_log = jnp.stack(
            [e1_cnt, jnp.ones_like(e1_cnt)], axis=1
        ).reshape(2 * CHUNK, B)
        inc = flags.astype(jnp.int32)
        pos = nrun[None, :] + jnp.cumsum(inc, axis=0) - inc
        oob = flags & (pos >= run_cap)
        idx = jnp.where(flags & (pos < run_cap), pos, run_cap)
        rows2 = jnp.broadcast_to(rows[None, :], idx.shape)
        ops = ops.at[rows2, idx].set(ops_log, mode="drop")
        lens = lens.at[rows2, idx].set(cnt_log, mode="drop")
        nrun = nrun + inc.sum(0)
        new_over = jnp.any(oob, axis=0)
        overflow = overflow | new_over
        active = active & jnp.logical_not(new_over)
        return (s, c, h, comp, active, ops, lens, nrun, overflow, it + 1)

    carry = (s0, c0, h0, comp0, active0, ops, lens, nrun, overflow, jnp.int32(0))
    carry = jax.lax.while_loop(cond, body, carry)
    (s, c, h, comp, active, ops, lens, nrun, overflow, _) = carry
    return (s, c, h, comp, active), (ops, lens, nrun, overflow)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


@dataclass
class WfSegConfig:
    k_initial: int = 128
    #: band ceiling of this engine; wider pairs take the exact dense
    #: segmented fallback. Not derived from this engine's memory use:
    #: the XLA sweep's planes at K=6144 fit the budget below many times
    #: over, and raising the ceiling is a measured change of its own
    k_max: int = 6144
    #: score levels per checkpoint segment
    ckpt_every: int = 256
    #: initial score cap when no hint is available
    s_cap_initial: int = 512
    #: growth factor for score-cap escalation
    s_cap_growth: int = 4
    #: absolute score cap: pairs needing more fall back to the dense
    #: segmented engine (high divergence; s no longer << L)
    s_cap_max: int = 1 << 14
    #: memory budget for one group's checkpoints + bitmap + one
    #: segment's replay planes (fragmenting a workload into small
    #: batches costs more in fixed dispatch + fetch latency than the
    #: headroom is worth)
    budget_bytes: int = 6 << 30
    max_batch: int = 256


class WavefrontSegmentedAligner:
    """Long-pair aligner with O(s*K) compute and O(s/C * D * K) memory.

    align_pairs returns [(score, cigar) | None | DENSE_FALLBACK]: the
    sentinel marks pairs whose score cap or band exceeded the configured
    ceilings — the caller (UnifiedAligner) reroutes those to the dense
    segmented engine rather than failing them."""

    DENSE_FALLBACK = "dense"

    def __init__(self, pen: Penalties, config: Optional[WfSegConfig] = None):
        from ..utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.pen = pen
        self.config = config or WfSegConfig()

    @staticmethod
    def _next_pow2(n: int) -> int:
        return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 1)

    K_LADDER = sorted({128 << i for i in range(8)} | {384 << i for i in range(6)})

    def _round_k(self, k: int) -> int:
        for v in self.K_LADDER:
            if v >= k:
                return v
        return self.K_LADDER[-1]

    def _k_for_score(self, sigma: int, kend_abs: int) -> int:
        """Same exit-and-return band bound as the dense engines."""
        t = sigma // 2 + 1
        n = max(1, -(-(t - self.pen.o1) // self.pen.e1))
        if self.pen.two_piece:
            n = max(n, -(-(t - self.pen.o2) // self.pen.e2))
        w = n - 1
        k = kend_abs + 2 * max(w, 0) + 3
        return self._round_k(max(k, self.config.k_initial))

    @staticmethod
    def _quantize_hint(hint: int) -> int:
        """Round a mash score hint UP to a quarter-pow2 grid point
        {2^i, 1.25*2^i, 1.5*2^i, 1.75*2^i}. Band width and score cap
        derive from the QUANTIZED hint only, so a pair's (K, s_cap)
        round key is a pure function of the pair itself — PAF bytes
        cannot depend on batch/chunk composition (the previous
        bucket-max-K coalescing made co-optimal CIGAR tie-breaks
        batch-dependent) — while near-identical hints still share one
        round key and batch together."""
        if hint <= 16:
            return 16
        p = 1 << (hint.bit_length() - 1)  # 2^i <= hint
        for num in (5, 6, 7, 8):
            v = p * num // 4
            if v >= hint:
                return v
        return 2 * p

    def _s_cap_for_hint(self, hint: int) -> int:
        """Score cap from a mash-derived estimate: headroom for hint
        noise, rounded UP TO A POWER OF TWO so that near-identical hints
        share one (K, s_cap) round — fine-grained caps fragmented a
        12-pair workload into batch-of-4 dispatches (measured 3x the
        wall time). The sweep early-exits once every pair is done, so a
        generous cap costs only checkpoint-memory budget, not compute."""
        C = self.config.ckpt_every
        want = max(self.config.s_cap_initial, 2 * hint + C)
        return min(
            self._round_up_seg(self._next_pow2(want)), self.config.s_cap_max
        )

    def _round_up_seg(self, s: int) -> int:
        C = self.config.ckpt_every
        return ((s + C - 1) // C) * C

    def align_pairs(
        self, pairs: List[Tuple[bytes, bytes]], sigma_hint=None
    ):
        n = len(pairs)
        results: List[object] = [None] * n
        if n == 0:
            return results
        cfg = self.config
        # rounds keyed by (K, s_cap)
        rounds: Dict[Tuple[int, int], List[int]] = {}
        for i, (q, t) in enumerate(pairs):
            kend_abs = abs(len(t) - len(q))
            if sigma_hint is not None:
                hint = int(sigma_hint[i])
                hq = self._quantize_hint(hint)
                si = self._s_cap_for_hint(hq)
                # K is sized from s_cap/2, NOT the raw hint, for two
                # reasons. (1) Margin: certification needs K ~ actual
                # score (the exit-and-return bound is ~2*(o2 + K/2*e2)),
                # while the hint models divergence as pure mismatches
                # and so UNDERestimates whenever indels contribute —
                # sizing K from the raw hint made every low-divergence
                # 100 kb pair sweep twice (cert fail -> one rung up);
                # s_cap/2 >= hint certifies anything up to ~2x the hint
                # in one sweep. (2) Coalescing: s_cap is pow2-bucketed,
                # so pairs with nearby hints get the SAME (K, s_cap)
                # round key and batch together instead of dispatching
                # in fragments.
                ki = self._k_for_score(si // 2, kend_abs)
                # certifying the HINTED score itself needs
                # _k_for_score(hint); if even that exceeds the band
                # ceiling, the sweep is guaranteed to end in a
                # cert-failure escalation -> fallback, so skip the
                # whole sweep (a 2%-divergence 100 kb pair otherwise
                # burns the full s_cap sweep before conceding)
                if self._k_for_score(hint, kend_abs) > cfg.k_max:
                    results[i] = self.DENSE_FALLBACK
                    continue
            else:
                ki = self._round_k(max(cfg.k_initial, kend_abs + 2))
                si = self._round_up_seg(cfg.s_cap_initial)
            if ki > cfg.k_max or si > cfg.s_cap_max:
                results[i] = self.DENSE_FALLBACK
                continue
            rounds.setdefault((ki, si), []).append(i)

        while rounds:
            (k, s_cap) = min(rounds)
            idxs = rounds.pop((k, s_cap))
            if k > cfg.k_max or s_cap > cfg.s_cap_max:
                for i in idxs:
                    results[i] = self.DENSE_FALLBACK
                continue
            # batch size from the memory budget, per pair:
            #   checkpoints — n_seg rolling buffers of 5 x D planes
            #   + one segment's replay history and traceback window
            #   + the mismatch bitmap and its next-word index
            D = self.pen.max_lookback + 1
            C = cfg.ckpt_every
            n_seg = s_cap // C
            l_est = self._next_pow2(
                max(max(max(len(pairs[i][0]), len(pairs[i][1])) for i in idxs), 4)
            )
            per_pair = 4 * 5 * k * (n_seg * D + 2 * C + D) + k * l_est // 4
            bsz = int(max(1, min(cfg.budget_bytes // per_pair, cfg.max_batch)))
            idxs = sorted(idxs, key=lambda i: len(pairs[i][0]) + len(pairs[i][1]))
            for lo in range(0, len(idxs), bsz):
                group = idxs[lo : lo + bsz]
                esc = self._run_group(pairs, group, results, k, s_cap)
                for i, key in esc:
                    if key is None:
                        results[i] = self.DENSE_FALLBACK
                    else:
                        rounds.setdefault(key, []).append(i)
        return results

    def _run_group(self, pairs, group, results, k, s_cap):
        cfg = self.config
        C = cfg.ckpt_every
        B = self._next_pow2(len(group))
        l_pad = self._next_pow2(
            max(max(max(len(q), len(t)) for q, t in (pairs[i] for i in group)), 4)
        )
        qs = np.zeros((B, l_pad), np.uint8)
        ts = np.zeros((B, l_pad), np.uint8)
        qlens = np.zeros((B,), np.int32)
        tlens = np.zeros((B,), np.int32)
        for j, i in enumerate(group):
            q, t = pairs[i]
            qs[j, : len(q)] = np.frombuffer(q, dtype=np.uint8)
            ts[j, : len(t)] = np.frombuffer(t, dtype=np.uint8)
            qlens[j] = len(q)
            tlens[j] = len(t)
        qs, ts = jnp.asarray(qs), jnp.asarray(ts)
        qlens_d, tlens_d = jnp.asarray(qlens), jnp.asarray(tlens)

        mmw, nxw, ks, h_max, c_end, feasible, buf, done, scores = wf_init(
            qs, ts, qlens_d, tlens_d, self.pen, k
        )

        # ---- sweep with checkpoints ----
        n_seg = s_cap // C
        ckpts = [buf]
        top_seg = n_seg  # first segment index NOT swept
        for seg in range(n_seg):
            if bool(np.asarray(jnp.all(done))):
                top_seg = seg
                break
            buf, done, scores, _ = wf_span(
                mmw,
                nxw,
                ks,
                h_max,
                c_end,
                tlens_d,
                feasible,
                jnp.int32(seg * C),
                buf,
                done,
                scores,
                pen=self.pen,
                n_steps=C,
                with_history=False,
            )
            ckpts.append(buf)

        scores_h = np.asarray(scores)
        done_h = np.asarray(done)

        # ---- certificate: same exit-and-return bound as the dense path ----
        k_end = tlens.astype(np.int64) - qlens.astype(np.int64)
        slack = (k - 1 - np.abs(k_end)) // 2
        nn = np.maximum(slack, 0) + 1
        esc_bound = 2 * np.minimum(
            self.pen.o1 + nn * self.pen.e1,
            (self.pen.o2 + nn * self.pen.e2)
            if self.pen.two_piece
            else self.pen.o1 + nn * self.pen.e1,
        )
        k0_h = np.minimum(0, k_end) - slack
        full_cover = (k0_h <= -qlens) & (k0_h + (k - 1) >= tlens)
        cert = done_h & ((scores_h < esc_bound) | full_cover)

        escalate: List[Tuple[int, Optional[Tuple[int, int]]]] = []
        any_good = False
        for j, i in enumerate(group):
            if not done_h[j]:
                ns = s_cap * cfg.s_cap_growth
                if ns > cfg.s_cap_max:
                    escalate.append((i, None))
                else:
                    escalate.append((i, (k, ns)))
            elif not cert[j]:
                nk = max(self._k_for_score(int(scores_h[j]), int(abs(k_end[j]))), 2 * k)
                if nk > cfg.k_max:
                    escalate.append((i, None))
                else:
                    escalate.append((i, (nk, self._round_up_seg(s_cap))))
            else:
                any_good = True
        if not any_good:
            return escalate

        # ---- backward replay + traceback ----
        run_cap = self._run_cap(scores_h, done_h)
        walk = (
            jnp.asarray(np.where(cert, scores_h, -1).astype(np.int32)),
            c_end,
            tlens_d,
            jnp.zeros((B,), jnp.int32),
            jnp.asarray(cert) & (tlens_d + qlens_d > 0),
        )
        bufs = (
            jnp.zeros((B, run_cap), jnp.uint8),
            jnp.zeros((B, run_cap), jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.bool_),
        )
        # at least one pass even when everything finished at score 0
        # (the origin M-run emit happens inside a segment traceback)
        top = max(1, min(top_seg, len(ckpts) - 1))
        for seg in range(top - 1, -1, -1):
            walk, bufs = wf_replay_traceback(
                mmw,
                nxw,
                ks,
                h_max,
                tlens_d,
                ckpts[seg],
                jnp.int32(seg * C),
                walk,
                bufs,
                pen=self.pen,
                n_steps=C,
                run_cap=run_cap,
            )

        from ..utils.telemetry import counters

        counters.add(
            pairs=len(group),
            cells=len(group) * 2 * top * C * k,
            dispatches=2 * top,
        )

        ops, lens, nrun, overflow = (np.asarray(b) for b in bufs)
        still_active = np.asarray(walk[4])
        overflow = overflow | still_active
        for j, i in enumerate(group):
            if not cert[j]:
                continue
            if overflow[j]:
                # pathological run counts: dense path has bigger buffers
                escalate.append((i, None))
                continue
            cigar = expand_runs_to_cigar(ops[j], lens[j].astype(np.int64), int(nrun[j]))
            results[i] = (int(scores_h[j]), cigar)
        return escalate

    @staticmethod
    def _run_cap(scores_h, done_h) -> int:
        """Run-buffer capacity: each scored unit adds at most ~3 runs
        (X or gap open/extend closes), plus match runs between them.
        Rounded up to a power of two — run_cap is a static jit argument
        of wf_replay_traceback, and a raw 4*smax+64 forced a fresh
        multi-second kernel compile for nearly every group."""
        smax = int(scores_h[done_h].max()) if done_h.any() else 0
        want = max(512, 4 * smax + 64)
        return 1 << (want - 1).bit_length()
