"""Segmented (checkpoint–replay) dense-band alignment for LONG pairs.

The reference keeps 100 kb+ pairs feasible with biWFA's O(s) memory
(reference: alignment.rs:265-287, MemoryMode::Ultralow). The
equivalent here keeps the dense banded engine's zero-gather hot loop and
bounds memory by NOT materializing the (2L, B, K) choice planes at once:

1. SWEEP: one score-only banded pass over all 2L anti-diagonals that
   snapshots the five DP band vectors every `ckpt_every` steps —
   O(B * K * 2L/C) checkpoint memory, no choice planes;
2. REPLAY, backwards segment by segment: re-run the DP for one
   C-step span from its checkpoint, with choice/run-length planes for
   just that span (O(C * B * K)), and advance the on-device traceback
   walkers through it. Identical per-cell arithmetic and tie-breaks to
   the one-shot engine, so scores and CIGARs are bit-exact; total
   compute is ~2x the single sweep.

The only intentional divergence from the one-shot planes: the
match-run-length plane resets at segment boundaries (checkpoints do not
carry it), so a match run crossing a boundary is emitted as two runs —
the expanded per-base CIGAR (and therefore the PAF string) is identical.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .params import Penalties
from .dense import (
    INF,
    S_DIAG_MATCH,
    S_DIAG_MISMATCH,
    S_I1,
    S_I2,
    S_D1,
    S_D2,
    _band_geometry,
)
from .batch import expand_runs_to_cigar

_OP_M = ord("M")
_OP_X = ord("X")
_OP_I = ord("I")
_OP_D = ord("D")


# ---------------------------------------------------------------------------
# XLA span primitives
# ---------------------------------------------------------------------------


def _base_registers(qs, ts, qlens, k0, K, l_pad, d):
    """Band base registers at anti-diagonal d (same clip formulas as
    dense.dense_forward so every active cell agrees bit-for-bit)."""
    ks = k0[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    idx = jnp.arange(l_pad, dtype=jnp.int32)[None, :]
    rev_idx = jnp.clip(qlens[:, None] - 1 - idx, 0, l_pad - 1)
    rq = jnp.take_along_axis(qs, rev_idx, axis=1)
    qi = jnp.clip(qlens[:, None] - ((d - ks) >> 1), 0, l_pad - 1)
    ti = jnp.clip(((d + ks) >> 1) - 1, 0, l_pad - 1)
    qb = jnp.take_along_axis(rq, qi, axis=1)
    tb = jnp.take_along_axis(ts, ti, axis=1)
    return rq, qb, tb


def init_state(B: int, K: int, k0) -> Tuple[jnp.ndarray, ...]:
    """DP band state at d=0: (S, I1, D1, I2, D2) each (B, K) int32."""
    ks = k0[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    s0 = jnp.where(ks == 0, 0, INF).astype(jnp.int32)
    gap0 = jnp.full((B, K), INF, jnp.int32)
    return (s0, gap0, gap0, gap0, gap0)


@functools.partial(
    jax.jit,
    static_argnames=("pen", "k_width", "l_pad", "n_steps", "with_choices"),
)
def dense_span_xla(
    qs,
    ts,
    qlens,
    tlens,
    pen: Penalties,
    k_width: int,
    l_pad: int,
    d_lo,  # traced scalar: span covers anti-diagonals d_lo+1 .. d_lo+n_steps
    n_steps: int,
    state,  # (S, I1, D1, I2, D2) each (B, K) int32
    with_choices: bool,
):
    """Run n_steps anti-diagonal steps from `state` at d_lo. Returns
    (state_out, (choices, runs) | None). Identical cell arithmetic to
    dense.dense_forward (same tie-break contract)."""
    B = qs.shape[0]
    K = k_width
    k_end, k0, slack = _band_geometry(qlens, tlens, K)
    ks = k0[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    rq, qb, tb = _base_registers(qs, ts, qlens, k0, K, l_pad, d_lo)

    run0 = jnp.zeros((B, K), jnp.uint8)
    o1e1 = jnp.int32(pen.o1 + pen.e1)
    e1 = jnp.int32(pen.e1)
    o2e2 = jnp.int32(pen.o2 + pen.e2) if pen.two_piece else jnp.int32(0)
    e2 = jnp.int32(pen.e2) if pen.two_piece else jnp.int32(0)
    x = jnp.int32(pen.x)
    k0_col = k0

    def step(carry, d):
        s_prev, i1, d1, i2, d2, qb, tb, runlen = carry

        qi_head = jnp.clip(qlens - ((d - k0_col) >> 1), 0, l_pad - 1)
        q_head = jnp.take_along_axis(rq, qi_head[:, None], axis=1)
        qb = jnp.concatenate([q_head, qb[:, :-1]], axis=1)
        ti_tail = jnp.clip(((d + k0_col + (K - 1)) >> 1) - 1, 0, l_pad - 1)
        t_tail = jnp.take_along_axis(ts, ti_tail[:, None], axis=1)
        tb = jnp.concatenate([tb[:, 1:], t_tail], axis=1)

        v = (d - ks) >> 1
        h = (d + ks) >> 1
        parity_ok = ((d - ks) & 1) == 0
        in_matrix = (
            (v >= 0) & (v <= qlens[:, None]) & (h >= 0) & (h <= tlens[:, None])
        )
        active = parity_ok & in_matrix

        def sd(a):  # shift down: out[c] = a[c-1]
            return jnp.concatenate(
                [jnp.full((B, 1), INF, a.dtype), a[:, :-1]], 1
            )

        def su(a):  # shift up: out[c] = a[c+1]
            return jnp.concatenate(
                [a[:, 1:], jnp.full((B, 1), INF, a.dtype)], 1
            )

        s_km1 = sd(s_prev)
        s_kp1 = su(s_prev)
        i1_ext_v = sd(i1) + e1
        i1_opn_v = s_km1 + o1e1
        i1_new = jnp.minimum(i1_opn_v, i1_ext_v)
        i1_ext = i1_ext_v <= i1_opn_v
        d1_ext_v = su(d1) + e1
        d1_opn_v = s_kp1 + o1e1
        d1_new = jnp.minimum(d1_opn_v, d1_ext_v)
        d1_ext = d1_ext_v <= d1_opn_v
        best_gap = jnp.minimum(i1_new, d1_new)
        if pen.two_piece:
            i2_ext_v = sd(i2) + e2
            i2_opn_v = s_km1 + o2e2
            i2_new = jnp.minimum(i2_opn_v, i2_ext_v)
            i2_ext = i2_ext_v <= i2_opn_v
            d2_ext_v = su(d2) + e2
            d2_opn_v = s_kp1 + o2e2
            d2_new = jnp.minimum(d2_opn_v, d2_ext_v)
            d2_ext = d2_ext_v <= d2_opn_v
            best_gap = jnp.minimum(best_gap, jnp.minimum(i2_new, d2_new))
        else:
            i2_new, d2_new = i2, d2
            i2_ext = jnp.zeros_like(i1_ext)
            d2_ext = jnp.zeros_like(d1_ext)

        is_match = qb == tb
        sub_cost = jnp.where(is_match, 0, x)
        diag_ok = (v > 0) & (h > 0)
        diag = jnp.where(diag_ok, s_prev + sub_cost, INF)
        s_new = jnp.minimum(diag, best_gap)

        if with_choices:
            diag_hit = (diag == s_new) & diag_ok
            choice = jnp.full((B, K), S_DIAG_MATCH, jnp.uint8)
            if pen.two_piece:
                choice = jnp.where(d2_new == s_new, jnp.uint8(S_D2), choice)
            choice = jnp.where(d1_new == s_new, jnp.uint8(S_D1), choice)
            if pen.two_piece:
                choice = jnp.where(i2_new == s_new, jnp.uint8(S_I2), choice)
            choice = jnp.where(i1_new == s_new, jnp.uint8(S_I1), choice)
            choice = jnp.where(
                diag_hit & jnp.logical_not(is_match),
                jnp.uint8(S_DIAG_MISMATCH),
                choice,
            )
            packed = (
                choice
                | (i1_ext.astype(jnp.uint8) << 3)
                | (d1_ext.astype(jnp.uint8) << 4)
                | (i2_ext.astype(jnp.uint8) << 5)
                | (d2_ext.astype(jnp.uint8) << 6)
            )
            is_run = choice == jnp.uint8(S_DIAG_MATCH)
            inc = jnp.minimum(runlen, jnp.uint8(254)) + jnp.uint8(1)
            new_run = jnp.where(is_run, inc, jnp.uint8(0))
            y = (packed, new_run)
        else:
            new_run = runlen
            y = (jnp.zeros((B, 1), jnp.uint8), jnp.zeros((B, 1), jnp.uint8))

        clamp = lambda a: jnp.minimum(a, INF)
        s_out = jnp.where(active, clamp(s_new), s_prev)
        i1_out = jnp.where(active, clamp(i1_new), i1)
        d1_out = jnp.where(active, clamp(d1_new), d1)
        i2_out = jnp.where(active, clamp(i2_new), i2)
        d2_out = jnp.where(active, clamp(d2_new), d2)
        run_out = jnp.where(active, new_run, runlen) if with_choices else runlen
        return (s_out, i1_out, d1_out, i2_out, d2_out, qb, tb, run_out), y

    s0, i10, d10, i20, d20 = state
    ds = d_lo + 1 + jnp.arange(n_steps, dtype=jnp.int32)
    carry, (choices, runs) = jax.lax.scan(
        step, (s0, i10, d10, i20, d20, qb, tb, run0), ds, unroll=4
    )
    state_out = carry[:5]
    return state_out, ((choices, runs) if with_choices else None)


def dense_sweep_ckpt(
    qs,
    ts,
    qlens,
    tlens,
    pen: Penalties,
    k_width: int,
    l_pad: int,
    ckpt_every: int,
    n_seg: Optional[int] = None,
):
    """Full score-only sweep with band-state checkpoints.

    Returns (scores, certificate, ckpts) where ckpts is a tuple of five
    (n_seg, B, K) int32 arrays of component states at
    d = seg*ckpt_every (seg 0 is the d=0 init).

    n_seg bounds the sweep: every score lives at d = qlen+tlen, so
    segments past ceil(max(q+t)/C) never influence a score or a
    traceback and are skipped (callers pass the group's actual bound;
    default covers the padded matrix, 2*l_pad/C).

    Deliberately NOT jitted as a whole: the python loop reuses ONE
    compiled span kernel n_seg times (jitting the sweep would inline
    n_seg copies of the scan and explode compile time)."""
    B = qs.shape[0]
    K = k_width
    D2 = 2 * l_pad
    assert D2 % ckpt_every == 0
    n_seg_full = D2 // ckpt_every
    n_seg = n_seg_full if n_seg is None else min(n_seg, n_seg_full)
    n_seg = max(n_seg, 1)
    k_end, k0, slack = _band_geometry(qlens, tlens, K)

    state = init_state(B, K, k0)
    ckpts = [state]
    for seg in range(n_seg):
        state, _ = dense_span_xla(
            qs,
            ts,
            qlens,
            tlens,
            pen,
            K,
            l_pad,
            jnp.int32(seg * ckpt_every),
            ckpt_every,
            state,
            False,
        )
        if seg < n_seg - 1:
            ckpts.append(state)

    s_final = state[0]
    c_end = jnp.clip(k_end - k0, 0, K - 1)
    scores = jnp.take_along_axis(s_final, c_end[:, None], axis=1)[:, 0]
    feasible = (jnp.abs(k_end) <= (K - 1)) & (
        qlens + tlens <= n_seg * ckpt_every
    )
    scores = jnp.where(feasible, jnp.minimum(scores, INF), INF)

    w = jnp.maximum(slack, 0)
    # exit-and-return bound: a band-escaping global path needs >= W+1
    # gap bases on the way out AND >= W+1 on the way back, each side
    # costing at least g(W+1) = min(o1+(W+1)e1, o2+(W+1)e2) no matter
    # how the bases split into runs (more runs = more opens)
    n = w + 1
    esc = 2 * jnp.minimum(
        pen.o1 + n * pen.e1,
        (pen.o2 + n * pen.e2) if pen.two_piece else pen.o1 + n * pen.e1,
    )
    # full-matrix band == unbanded DP: certify unconditionally
    full_cover = (k0 <= -qlens) & (k0 + (K - 1) >= tlens)
    certificate = ((scores < esc) | full_cover) & feasible & (scores < INF)

    stacked = tuple(
        jnp.stack([c[comp] for c in ckpts], axis=0) for comp in range(5)
    )
    return scores, certificate, stacked


# ---------------------------------------------------------------------------
# Resumable traceback over one replayed segment
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("pen", "run_cap"))
def traceback_segment(
    choices_runs,  # ((n_steps, B, K) u8 choices, (n_steps, B, K) u8 runs)
    d_lo,  # traced scalar: plane row r holds anti-diagonal d_lo + r + 1
    walk,  # (d, c, comp, active, cur_op, cur_len) each (B,)
    bufs,  # (ops (B, run_cap) u8, lens (B, run_cap) u8, nrun (B,) i32, overflow (B,) bool)
    qlens,
    tlens,
    pen: Penalties,
    run_cap: int,
):
    """Advance the traceback walkers through one segment's choice
    planes (same transition rules as dense.dense_traceback). Walkers
    pause when they step to d <= d_lo (resumed with the previous
    segment) and finish at d <= 0.

    Chunked-hop structure (same as dense.dense_traceback): a plain
    one-hop-per-while-iteration loop pays the while overhead plus three
    output scatters per hop, which dominates the whole 100 kb replay
    chain. Here CHUNK hops run inside a lax.scan per while iteration,
    completed
    runs stream out as dense logs, and ONE batched scatter per chunk
    packs them into the run buffers. The run being built rides the walk
    carry (cur_op, cur_len) and therefore survives segment boundaries;
    the orchestrator flushes the final open run host-side. Run
    SPLITTING may differ from the per-hop version, the expanded
    per-base CIGAR cannot (expand_runs_to_cigar re-expands)."""
    choices, runlens = choices_runs
    NS, B, K = choices.shape
    rows = jnp.arange(B, dtype=jnp.int32)
    CHUNK = 32

    d0, c0, comp0, alive0, cur_op0, cur_len0 = walk
    ops, lens, nrun, overflow = bufs

    def fetch(d, c):
        # 3D advanced indexing, NOT a flattened take: NS*B*K exceeds
        # int32 for large banded batches and x64 is disabled
        r = d - d_lo - 1
        r_ok = (r >= 0) & (r < NS)
        c_ok = (c >= 0) & (c < K)
        rr = jnp.clip(r, 0, NS - 1)
        cc = jnp.clip(c, 0, K - 1)
        byte = jnp.where(r_ok & c_ok, choices[rr, rows, cc], jnp.uint8(0))
        run = jnp.where(r_ok & c_ok, runlens[rr, rows, cc], jnp.uint8(0))
        return byte, run

    def hop(carry, _):
        d, c, comp, active, cur_op, cur_len = carry
        stepping = active & (d > d_lo)
        byte, run = fetch(d, c)
        src = (byte & 7).astype(jnp.int32)

        is_s = comp == 0
        is_match_run = is_s & (src == S_DIAG_MATCH)
        is_x = is_s & (src == S_DIAG_MISMATCH)
        run_i = jnp.maximum(run.astype(jnp.int32), 1)

        to_gap = jnp.where(
            src == S_I1, 1, jnp.where(src == S_D1, 2, jnp.where(src == S_I2, 3, 4))
        )
        is_i = (comp == 1) | (comp == 3)
        is_d = (comp == 2) | (comp == 4)
        ext_bit = jnp.where(
            comp == 1,
            (byte >> 3) & 1,
            jnp.where(
                comp == 2,
                (byte >> 4) & 1,
                jnp.where(comp == 3, (byte >> 5) & 1, (byte >> 6) & 1),
            ),
        ).astype(jnp.bool_)

        emit_op = jnp.where(
            is_match_run,
            jnp.uint8(_OP_M),
            jnp.where(
                is_x,
                jnp.uint8(_OP_X),
                jnp.where(is_i, jnp.uint8(_OP_I), jnp.uint8(_OP_D)),
            ),
        )
        emit_len = jnp.where(is_match_run, run_i, 1).astype(jnp.int32)
        do_emit = stepping & (is_match_run | is_x | is_i | is_d)

        # merge into the carried run; a completed run flushes to the log
        same = (cur_len > 0) & (cur_op == emit_op) & (cur_len + emit_len <= 255)
        flush = do_emit & (cur_len > 0) & jnp.logical_not(same)
        log_op, log_len = cur_op, cur_len
        cur_op = jnp.where(do_emit, emit_op, cur_op)
        cur_len = jnp.where(
            do_emit, jnp.where(same, cur_len + emit_len, emit_len), cur_len
        )

        d_s = jnp.where(is_match_run, d - 2 * run_i, jnp.where(is_x, d - 2, d))
        comp_s = jnp.where(is_match_run | is_x, 0, to_gap)
        d_g = d - 1
        c_g = jnp.where(is_i, c - 1, c + 1)
        comp_g = jnp.where(ext_bit, comp, 0)

        new_d = jnp.where(is_s, d_s, d_g)
        new_c = jnp.where(is_s, c, c_g)
        new_comp = jnp.where(is_s, comp_s, comp_g)

        finished = stepping & (new_d <= 0)
        active = active & jnp.logical_not(finished)
        d = jnp.where(stepping, new_d, d)
        c = jnp.where(stepping, new_c, c)
        comp = jnp.where(stepping, new_comp, comp)
        return (d, c, comp, active, cur_op, cur_len), (flush, log_op, log_len)

    max_chunks = (2 * int(NS) + 8) // CHUNK + 2

    def cond(carry):
        d, _, _, active, _, _, _, _, _, overflow, it = carry
        return jnp.any(active & (d > d_lo)) & (it < max_chunks)

    def body(carry):
        d, c, comp, active, cur_op, cur_len, ops, lens, nrun, overflow, it = carry
        (d, c, comp, active, cur_op, cur_len), (fl, fo, fln) = jax.lax.scan(
            hop, (d, c, comp, active, cur_op, cur_len), None, length=CHUNK
        )
        # pack the chunk's flushed runs: one batched scatter (positions
        # strictly increase per pair, so indices are unique)
        inc = fl.astype(jnp.int32)  # (CHUNK, B)
        pos = nrun[None, :] + jnp.cumsum(inc, axis=0) - inc
        oob = fl & (pos >= run_cap)
        idx = jnp.where(fl & (pos < run_cap), pos, run_cap)  # run_cap = dropped
        rows2 = jnp.broadcast_to(rows[None, :], idx.shape)
        ops = ops.at[rows2, idx].set(fo, mode="drop")
        lens = lens.at[rows2, idx].set(fln.astype(jnp.uint8), mode="drop")
        nrun = nrun + inc.sum(0)
        new_over = jnp.any(oob, axis=0)
        overflow = overflow | new_over
        active = active & jnp.logical_not(new_over)
        return (d, c, comp, active, cur_op, cur_len, ops, lens, nrun, overflow, it + 1)

    carry = (
        d0, c0, comp0, alive0, cur_op0, cur_len0,
        ops, lens, nrun, overflow, jnp.int32(0),
    )
    carry = jax.lax.while_loop(cond, body, carry)
    d, c, comp, active, cur_op, cur_len, ops, lens, nrun, overflow, _ = carry
    return (d, c, comp, active, cur_op, cur_len), (ops, lens, nrun, overflow)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


@dataclass
class SegmentedConfig:
    k_initial: int = 128
    k_max: int = 24576
    #: anti-diagonal steps per checkpoint segment: balances sweep
    #: dispatch count against checkpoint memory (5 planes x K per
    #: segment) and one segment's replay planes (C x K per pair)
    ckpt_every: int = 2048
    #: memory budget for one segment's choice+run planes
    seg_budget_bytes: int = 2 << 30
    max_batch: int = 256


class SegmentedDenseAligner:
    """Long-pair aligner: bit-exact dense banded alignment in O(K * 2L/C)
    checkpoint memory instead of O(2L * K) choice planes."""

    def __init__(self, pen: Penalties, config: Optional[SegmentedConfig] = None):
        from ..utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.pen = pen
        self.config = config or SegmentedConfig()

    @staticmethod
    def _next_pow2(n: int) -> int:
        return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 1)

    #: top rung 24576: without it, ~9%-divergence 100 kb pairs (score
    #: past the 16384 certificate) emitted failed-pair records the
    #: reference would have aligned
    K_LADDER = sorted(
        {128 << i for i in range(8)} | {384 << i for i in range(7)}
    )

    def _round_k(self, k: int) -> int:
        """Smallest accepted band width >= k (see DenseBandAligner)."""
        for v in self.K_LADDER:
            if v >= k:
                return v
        return self.K_LADDER[-1]

    def _k_for_score(self, sigma: int, kend_abs: int) -> int:
        """Smallest accepted band width whose exit-and-return
        certificate holds for a banded score sigma: the bound is
        2*g(W+1) with g(n) = min(o1+n*e1, o2+n*e2), so we need the
        minimal n with g(n) >= sigma//2 + 1 on BOTH pieces."""
        t = sigma // 2 + 1
        n = max(1, -(-(t - self.pen.o1) // self.pen.e1))
        if self.pen.two_piece:
            n = max(n, -(-(t - self.pen.o2) // self.pen.e2))
        w = n - 1
        k = kend_abs + 2 * max(w, 0) + 3
        return min(
            self._round_k(max(k, self.config.k_initial)), self.config.k_max
        )

    def _build_pool(self, pairs: List[Tuple[bytes, bytes]], l_pad: int):
        """One device-resident unique-sequence pool per align_pairs
        call: long-pair batches otherwise upload megabytes of
        duplicated rows per dispatch group (each sequence appears
        ~2(n-1) times in an all-pairs run)."""
        pool_map: Dict[bytes, int] = {}
        for q, t in pairs:
            for sq in (q, t):
                if sq not in pool_map:
                    pool_map[sq] = len(pool_map)
        p_pad = self._next_pow2(max(len(pool_map), 1))
        pool = np.zeros((p_pad, l_pad), dtype=np.uint8)
        for sq, r in pool_map.items():
            pool[r, : len(sq)] = np.frombuffer(sq, dtype=np.uint8)
        qidx = np.array([pool_map[q] for q, _ in pairs], dtype=np.int32)
        tidx = np.array([pool_map[t] for _, t in pairs], dtype=np.int32)
        qlens = np.array([len(q) for q, _ in pairs], dtype=np.int32)
        tlens = np.array([len(t) for _, t in pairs], dtype=np.int32)
        return (jnp.asarray(pool), qidx, tidx, qlens, tlens)

    def align_pairs(
        self, pairs: List[Tuple[bytes, bytes]], sigma_hint=None
    ) -> List[Optional[Tuple[int, np.ndarray]]]:
        """sigma_hint: optional per-pair estimated scores (mash-derived);
        long pairs then start at the band their divergence implies
        instead of probing narrow and escalating through full sweeps."""
        n = len(pairs)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        if n == 0:
            return results
        max_len = max(max(len(q), len(t)) for q, t in pairs)
        l_pad = self._next_pow2(max(max_len, 4))
        self._pool = self._build_pool(pairs, l_pad)
        C = min(self.config.ckpt_every, 2 * l_pad)
        max_kend = max(abs(len(t) - len(q)) for q, t in pairs)

        k0 = max(
            self._round_k(self.config.k_initial), self._round_k(max_kend + 2)
        )
        k_full = self._round_k(
            max(max(len(q) + len(t) for q, t in pairs) + 1, 2)
        )
        k0 = min(k0, k_full)
        cap0 = self._run_cap(l_pad)
        full_cap = 2 * l_pad + 8
        if sigma_hint is None:
            rounds: Dict[Tuple[int, int], List[int]] = {
                (k0, cap0): list(range(n))
            }
        else:
            rounds = {}
            for i in range(n):
                kend_abs = abs(len(pairs[i][1]) - len(pairs[i][0]))
                # mash hints skew HIGH at the divergences this engine
                # serves (k-mer Jaccard saturates: measured 16.5k hints
                # vs 11.9k true scores on 4%-divergent 100 kb pairs);
                # shave 25% for initial band sizing — an under-shave
                # only costs one escalation sweep, exactness unchanged
                hint = int(sigma_hint[i])
                ki = max(
                    self._k_for_score(hint - hint // 4, kend_abs),
                    self._round_k(self.config.k_initial),
                    self._round_k(kend_abs + 2),
                )
                ki = min(
                    ki,
                    self._round_k(len(pairs[i][0]) + len(pairs[i][1]) + 1),
                )
                rounds.setdefault((ki, cap0), []).append(i)
        while rounds:
            k, cap = min(rounds)
            idxs = rounds.pop((k, cap))
            if k > self.config.k_max:
                continue
            per_pair = 2 * C * k  # one segment's choices+runs
            bsz = int(
                max(
                    1,
                    min(
                        self.config.seg_budget_bytes // per_pair,
                        self.config.max_batch,
                    ),
                )
            )
            idxs = sorted(idxs, key=lambda i: len(pairs[i][0]) + len(pairs[i][1]))
            for lo in range(0, len(idxs), bsz):
                group = idxs[lo : lo + bsz]
                esc = self._run_group(
                    pairs, group, results, k, l_pad, C, cap, full_cap
                )
                for i, key in esc:
                    rounds.setdefault(key, []).append(i)
        return results

    def _run_group(
        self, pairs, group, results, k, l_pad, C, run_cap=None, full_cap=None
    ) -> List[Tuple[int, Tuple[int, int]]]:
        b_pad = self._next_pow2(len(group))
        pool_dev, qidx, tidx, qlens_a, tlens_a = self._pool
        gi = np.asarray(group, dtype=np.int64)
        pad = b_pad - len(group)
        # padded rows point at pool row 0 with length 0
        qi = np.concatenate([qidx[gi], np.zeros(pad, np.int32)])
        ti = np.concatenate([tidx[gi], np.zeros(pad, np.int32)])
        qlens = np.concatenate([qlens_a[gi], np.zeros(pad, np.int32)])
        tlens = np.concatenate([tlens_a[gi], np.zeros(pad, np.int32)])
        # the sweep only matters up to the last anti-diagonal any score
        # or walker can live at (d = q+t); segments past that are dead
        # work — a 100 kb batch in a pow2-padded matrix saves ~24%
        max_qt = int((qlens + tlens).max()) if b_pad else 0
        n_seg_eff = max(1, -(-max_qt // C)) if max_qt else 1
        n_seg_eff = min(n_seg_eff, (2 * l_pad) // C)

        qs = jnp.take(pool_dev, jnp.asarray(qi), axis=0)
        ts = jnp.take(pool_dev, jnp.asarray(ti), axis=0)
        qlens = jnp.asarray(qlens)
        tlens = jnp.asarray(tlens)
        B = b_pad
        K = k

        scores_d, cert_d, ckpts = dense_sweep_ckpt(
            qs, ts, qlens, tlens, self.pen, K, l_pad, C, n_seg=n_seg_eff
        )
        scores = np.asarray(scores_d)
        cert = np.asarray(cert_d)

        if run_cap is None:
            run_cap = self._run_cap(l_pad)
        if full_cap is None:
            full_cap = 2 * l_pad + 8

        escalate: List[Tuple[int, Tuple[int, int]]] = []
        any_good = False
        for j, i in enumerate(group):
            if not cert[j]:
                kend_abs = abs(len(pairs[i][1]) - len(pairs[i][0]))
                # strict widening = the next LADDER rung, not 2*k: with a
                # known banded score, k_for_score may land exactly one
                # rung up, and doubling instead can overshoot k_max and
                # drop a pair the next rung would have certified
                nup = self._round_k(k + 1)
                if nup <= k:  # already at the widest rung: failed pair
                    continue
                if scores[j] < INF:
                    nk = max(self._k_for_score(int(scores[j]), kend_abs), nup)
                else:
                    # no banded score to size from: jump ~2x, on-ladder
                    nk = max(self._round_k(2 * k), nup)
                k_full = self._round_k(
                    len(pairs[i][0]) + len(pairs[i][1]) + 1
                )
                nk = min(nk, max(k_full, nup))
                escalate.append((i, (nk, run_cap)))
            else:
                any_good = True
        if not any_good:
            return escalate

        # walkers: start at the end cell of each certified pair
        k_end, k0_arr, _ = _band_geometry(qlens, tlens, K)
        d = (qlens + tlens).astype(jnp.int32)
        c = jnp.clip(k_end - k0_arr, 0, K - 1).astype(jnp.int32)
        comp = jnp.zeros((B,), jnp.int32)
        alive = jnp.asarray(cert_d) & (d > 0)
        ops = jnp.zeros((B, run_cap), jnp.uint8)
        lens = jnp.zeros((B, run_cap), jnp.uint8)
        nrun = jnp.zeros((B,), jnp.int32)
        overflow = jnp.zeros((B,), jnp.bool_)
        walk = (
            d, c, comp, alive,
            jnp.zeros((B,), jnp.uint8),  # carried run op
            jnp.zeros((B,), jnp.int32),  # carried run length
        )
        bufs = (ops, lens, nrun, overflow)

        # segments above every walker's START position can never be
        # visited (walkers only move to smaller d) — computable on the
        # host up front, so the replay loop runs WITHOUT any per-segment
        # device->host sync
        d0_max = int(np.asarray(d).max()) if B else 0
        top_seg = min(n_seg_eff - 1, max(0, (d0_max - 1)) // C)
        for seg in range(top_seg, -1, -1):
            d_lo = seg * C
            state = tuple(comp_arr[seg] for comp_arr in ckpts)
            _, planes = dense_span_xla(
                qs,
                ts,
                qlens,
                tlens,
                self.pen,
                K,
                l_pad,
                jnp.int32(d_lo),
                C,
                state,
                True,
            )
            walk, bufs = traceback_segment(
                planes,
                jnp.int32(d_lo),
                walk,
                bufs,
                qlens,
                tlens,
                self.pen,
                run_cap,
            )

        from ..utils.telemetry import counters

        counters.add(
            pairs=len(group),
            cells=len(group) * 2 * (n_seg_eff * C) * k,  # sweep + replay
            dispatches=2 * n_seg_eff,
        )
        ops, lens, nrun, overflow = (np.asarray(b) for b in bufs)
        ops = ops.copy()
        lens = lens.copy()
        nrun = nrun.copy()
        still_active = np.asarray(walk[3])
        overflow = overflow | still_active
        # flush the carried (still-open) run of each finished walker
        cur_op = np.asarray(walk[4])
        cur_len = np.asarray(walk[5])
        for j in range(B):
            if cur_len[j] > 0 and not overflow[j]:
                if nrun[j] < run_cap:
                    ops[j, nrun[j]] = cur_op[j]
                    lens[j, nrun[j]] = cur_len[j]
                    nrun[j] += 1
                else:
                    overflow[j] = True
        for j, i in enumerate(group):
            if not cert[j]:
                continue
            if overflow[j]:
                # run buffer too small (huge structural gaps / extreme
                # run counts): retry this pair at the full cap instead
                # of failing it
                if run_cap < full_cap:
                    escalate.append((i, (k, full_cap)))
                else:
                    results[i] = None
                continue
            cigar = expand_runs_to_cigar(
                ops[j], lens[j].astype(np.int64), int(nrun[j])
            )
            results[i] = (int(scores[j]), cigar)
        return escalate

    def _run_cap(self, l_pad: int) -> int:
        # every <=255-base match stretch is one run; mutations add runs.
        # 2L/64 covers pure-match CIGARs 16x over; generous but small
        # (uint8 buffers)
        return max(2048, (2 * l_pad) // 64)
