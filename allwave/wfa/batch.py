"""Batched wavefront alignment on JAX/XLA — the device compute path.

Design (batched for an accelerator, not a translation of the reference's
per-pair C calls):

* A batch of B pairs is aligned simultaneously. Per pair, the wavefront
  state is one int32 offset per diagonal per component (M/I1/D1 [+I2/D2]),
  laid out as (B, K) arrays — diagonals on the minor (lane) axis.
* The score loop is a single `lax.while_loop`; all shapes are static
  (bucketed by K = 2*S_cap+1 and padded length), so XLA compiles one
  kernel per bucket and reuses it.
* Greedy match-run extension uses quad-packed bases: Q4[b, i] packs
  q[i..i+4) into a uint32, so one gather + XOR extends up to 4 bases per
  lane per inner iteration.
* Two passes per batch:
    1. score-only (rolling window of `lookback+1` wavefronts) -> exact
       score s* per pair; used for bucketing and as the biWFA building
       block.
    2. full-history pass (5 planes, (S_cap+1, B, K)) + ON-DEVICE
       traceback over B lanes that emits compact (op, run-length)
       buffers — only those tiny buffers are ever copied to the host.
* Tie-breaking matches allwave.wfa.reference_impl exactly:
  M-candidates in order X, I1, I2, D1, D2; gap chains prefer extend over
  open (see TIEBREAK_* there).

Conventions identical to the oracle: pattern=query (v), text=target (h),
diagonal k = h - v, offsets store h; CIGAR ops in WFA2 byte convention.
(reference behavior being replicated: src/alignment.rs:
201-261; engine itself is new.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .params import Penalties

NULL = -(2**30)

# op codes used in the device run buffers (match core.types byte values)
_OP_M = ord("M")
_OP_X = ord("X")
_OP_I = ord("I")
_OP_D = ord("D")


def pack_quads(seqs: jnp.ndarray) -> jnp.ndarray:
    """(B, L) uint8 -> (B, L) uint32 where out[b, i] packs bytes
    seq[b, i..i+4) little-endian (past-the-end bytes read as the pad that
    the caller appended)."""
    b0 = seqs.astype(jnp.uint32)
    b1 = jnp.pad(seqs[:, 1:], ((0, 0), (0, 1)), constant_values=0).astype(jnp.uint32)
    b2 = jnp.pad(seqs[:, 2:], ((0, 0), (0, 2)), constant_values=0).astype(jnp.uint32)
    b3 = jnp.pad(seqs[:, 3:], ((0, 0), (0, 3)), constant_values=0).astype(jnp.uint32)
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def _shift_right(a: jnp.ndarray) -> jnp.ndarray:
    """Along the last (diagonal) axis: out[..., c] = a[..., c-1], NULL in."""
    return jnp.concatenate(
        [jnp.full(a.shape[:-1] + (1,), NULL, a.dtype), a[..., :-1]], axis=-1
    )


def _shift_left(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate(
        [a[..., 1:], jnp.full(a.shape[:-1] + (1,), NULL, a.dtype)], axis=-1
    )


def _extend(h, k, h_max, q4, t4):
    """Greedy match-run extension of offsets ``h`` (B, K) along diagonals.

    q4/t4: (B, Lq)/(B, Lt) uint32 quad-packed sequences (padded so that
    reads at any clipped index are safe; h_max clamps semantics).

    SAFETY: the loop carries an iteration bound (ceil(L/4)+2) so a logic
    bug can never hang the device — a runaway while_loop wedges it.
    """
    B, K = h.shape
    lq = q4.shape[1]
    lt = t4.shape[1]
    max_iters = min(lq, lt) // 4 + 2

    def cond(state):
        _, cont, it = state
        return jnp.any(cont) & (it < max_iters)

    def body(state):
        h, cont, it = state
        v = h - k
        sv = jnp.clip(v, 0, lq - 1)
        sh = jnp.clip(h, 0, lt - 1)
        wq = jnp.take_along_axis(q4, sv, axis=1)
        wt = jnp.take_along_axis(t4, sh, axis=1)
        x = wq ^ wt
        n = (
            ((x & 0xFF) == 0).astype(jnp.int32)
            + ((x & 0xFFFF) == 0).astype(jnp.int32)
            + ((x & 0xFFFFFF) == 0).astype(jnp.int32)
            + (x == 0).astype(jnp.int32)
        )
        allowed = h_max - h
        step = jnp.minimum(n, allowed)
        step = jnp.where(cont & (step > 0), step, 0)
        h2 = h + step
        cont2 = cont & (n >= 4) & (allowed > 4)
        return h2, cont2, it + 1

    cont0 = (h > NULL) & (h < h_max)
    h_out, _, _ = jax.lax.while_loop(cond, body, (h, cont0, jnp.int32(0)))
    return h_out


class ForwardResult(NamedTuple):
    scores: jnp.ndarray  # (B,) int32; -1 where not finished within s_cap
    done: jnp.ndarray  # (B,) bool


def _wavefront_step(pen: Penalties, s, buf, k, h_max, q4, t4):
    """Compute the 5 wavefront components at score s from the rolling
    buffer ``buf`` (dict comp -> (D, B, K)), returning new (B, K) planes.

    Slot convention: buf[comp][s' % D] holds score s' for the last D
    scores.
    """
    D = buf["m"].shape[0]

    def src(comp, ds):
        """buf[comp] at score s-ds, NULL-filled if s-ds < 0."""
        idx = jnp.mod(s - ds, D)
        plane = jax.lax.dynamic_index_in_dim(buf[comp], idx, axis=0, keepdims=False)
        return jnp.where(s >= ds, plane, NULL)

    trim = lambda a: jnp.where(a > h_max, NULL, a)

    # I1[s][k] = max(M[s-o1-e1][k-1], I1[s-e1][k-1]) + 1
    i1_src = jnp.maximum(
        _shift_right(src("m", pen.o1 + pen.e1)), _shift_right(src("i1", pen.e1))
    )
    i1 = trim(jnp.where(i1_src > NULL, i1_src + 1, NULL))
    # D1[s][k] = max(M[s-o1-e1][k+1], D1[s-e1][k+1])
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
    m = _extend(m_pre, k, h_max, q4, t4)
    m = trim(m)
    return m, i1, d1, i2, d2


def _band_geometry(qlens, tlens, K):
    """Per-pair band origin k0 and derived index arrays.

    The band covers diagonals [k0, k0+K); it always contains 0 and
    k_end = tlen - qlen, with the slack split evenly.
    """
    k_end = tlens - qlens
    slack = (K - 1 - jnp.abs(k_end)) // 2
    k0 = jnp.minimum(0, k_end) - slack
    return k_end, k0


def _make_masks(qlens, tlens, k0, K):
    ks = k0[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    h_max = jnp.minimum(tlens[:, None], qlens[:, None] + ks)
    valid = (ks >= -qlens[:, None]) & (ks <= tlens[:, None])
    h_max = jnp.where(valid, h_max, -1)
    return ks, h_max


@functools.partial(
    jax.jit, static_argnames=("pen", "s_cap", "k_width", "with_history")
)
def wavefront_forward(
    qs: jnp.ndarray,
    ts: jnp.ndarray,
    qlens: jnp.ndarray,
    tlens: jnp.ndarray,
    pen: Penalties,
    s_cap: int,
    k_width: int,
    with_history: bool = False,
):
    """Run the batched wavefront DP until every pair terminates or s_cap.

    Returns (scores, done, history) — history is a dict of
    (s_cap+1, B, K) planes when with_history, else None.
    """
    B = qs.shape[0]
    K = k_width
    D = pen.max_lookback + 1

    q4 = pack_quads(qs)
    t4 = pack_quads(ts)
    k_end, k0 = _band_geometry(qlens, tlens, K)
    ks, h_max = _make_masks(qlens, tlens, k0, K)
    c_end = (k_end - k0).astype(jnp.int32)  # band index of final diagonal
    # pairs whose |len diff| exceeds the band can never finish here; the
    # scheduler must route them to a wider bucket (scores stay -1)
    feasible = jnp.abs(k_end) <= (K - 1)
    c_end = jnp.clip(c_end, 0, K - 1)

    comps = ("m", "i1", "d1", "i2", "d2")
    buf = {c: jnp.full((D, B, K), NULL, dtype=jnp.int32) for c in comps}

    # score 0: M[0] = 0 on diagonal 0 (band index -k0), extended
    c_zero = (-k0).astype(jnp.int32)
    m0 = jnp.where(
        jnp.arange(K, dtype=jnp.int32)[None, :] == c_zero[:, None], 0, NULL
    ).astype(jnp.int32)
    m0 = _extend(m0, ks, h_max, q4, t4)
    m0 = jnp.where(m0 > h_max, NULL, m0)
    buf["m"] = buf["m"].at[0].set(m0)

    if with_history:
        hist = {
            c: jnp.full((s_cap + 1, B, K), NULL, dtype=jnp.int32) for c in comps
        }
        hist["m"] = hist["m"].at[0].set(m0)
    else:
        hist = {c: jnp.zeros((1, 1, 1), dtype=jnp.int32) for c in comps}

    at_end0 = jnp.take_along_axis(m0, c_end[:, None], axis=1)[:, 0]
    done0 = (at_end0 == tlens) & feasible
    scores0 = jnp.where(done0, 0, -1).astype(jnp.int32)

    def cond(carry):
        s, buf, hist, done, scores = carry
        return (s < s_cap) & jnp.logical_not(jnp.all(done))

    def body(carry):
        s, buf, hist, done, scores = carry
        s = s + 1
        m, i1, d1, i2, d2 = _wavefront_step(pen, s, buf, ks, h_max, q4, t4)
        slot = jnp.mod(s, D)
        buf = {
            "m": buf["m"].at[slot].set(m),
            "i1": buf["i1"].at[slot].set(i1),
            "d1": buf["d1"].at[slot].set(d1),
            "i2": buf["i2"].at[slot].set(i2),
            "d2": buf["d2"].at[slot].set(d2),
        }
        if with_history:
            hist = {
                "m": hist["m"].at[s].set(m),
                "i1": hist["i1"].at[s].set(i1),
                "d1": hist["d1"].at[s].set(d1),
                "i2": hist["i2"].at[s].set(i2),
                "d2": hist["d2"].at[s].set(d2),
            }
        at_end = jnp.take_along_axis(m, c_end[:, None], axis=1)[:, 0]
        done_now = (at_end == tlens) & feasible & jnp.logical_not(done)
        scores = jnp.where(done_now, s, scores)
        done = done | done_now
        return s, buf, hist, done, scores

    _, _, hist, done, scores = jax.lax.while_loop(
        cond, body, (jnp.int32(0), buf, hist, done0, scores0)
    )
    return scores, done, (hist if with_history else None)


# --------------------------------------------------------------------------
# On-device traceback from full history
# --------------------------------------------------------------------------

# component codes in the traceback state machine
_C_M, _C_I1, _C_D1, _C_I2, _C_D2 = 0, 1, 2, 3, 4


@functools.partial(jax.jit, static_argnames=("pen", "run_cap"))
def wavefront_traceback(
    hist: dict,
    scores: jnp.ndarray,
    qlens: jnp.ndarray,
    tlens: jnp.ndarray,
    pen: Penalties,
    run_cap: int,
):
    """Vectorized-over-pairs backtrace emitting (op, run-length) buffers.

    hist planes: (S+1, B, K) int32. Returns (ops (B, run_cap) uint8,
    lens (B, run_cap) int32, n_runs (B,) int32). Runs are emitted in
    REVERSE alignment order (end -> start); the host reverses and merges.
    Lanes whose score is < 0 (unfinished) emit nothing.
    """
    S1, B, K = hist["m"].shape
    k_end, k0 = _band_geometry(qlens, tlens, K)
    c_end = (k_end - k0).astype(jnp.int32)

    def fetch(plane, s, c):
        """plane[(s, b, c)] per lane b, NULL when s<0 or c out of band."""
        s_ok = (s >= 0) & (s < S1)
        c_ok = (c >= 0) & (c < K)
        ss = jnp.clip(s, 0, S1 - 1)
        cc = jnp.clip(c, 0, K - 1)
        flat = (ss * B + jnp.arange(B, dtype=jnp.int32)) * K + cc
        val = jnp.take(plane.reshape(-1), flat)
        return jnp.where(s_ok & c_ok, val, NULL)

    ops0 = jnp.zeros((B, run_cap), dtype=jnp.uint8)
    lens0 = jnp.zeros((B, run_cap), dtype=jnp.int32)
    nrun0 = jnp.zeros((B,), dtype=jnp.int32)

    s0 = scores
    c0 = c_end
    h0 = tlens.astype(jnp.int32)
    comp0 = jnp.full((B,), _C_M, dtype=jnp.int32)
    active0 = scores >= 0
    overflow0 = jnp.zeros((B,), dtype=jnp.bool_)

    def emit(ops, lens, nrun, active, op, count):
        """Append a run per active lane where count > 0."""
        do = active & (count > 0)
        idx = jnp.clip(nrun, 0, run_cap - 1)
        ops = ops.at[jnp.arange(B), idx].set(
            jnp.where(do, op, ops[jnp.arange(B), idx])
        )
        lens = lens.at[jnp.arange(B), idx].set(
            jnp.where(do, count, lens[jnp.arange(B), idx])
        )
        nrun = nrun + do.astype(jnp.int32)
        return ops, lens, nrun

    # SAFETY: hard iteration bound — each backtrace step either emits a
    # run or transitions M->gap, so > 3*run_cap iterations means a logic
    # bug; never risk hanging the chip.
    max_iters = 3 * run_cap + 8

    def cond(carry):
        (s, c, h, comp, active, ops, lens, nrun, overflow, it) = carry
        return jnp.any(active) & (it < max_iters)

    def body(carry):
        (s, c, h, comp, active, ops, lens, nrun, overflow, it) = carry

        is_m = comp == _C_M
        at_origin = is_m & (s == 0)

        # ----- M state -----
        mis_v = fetch(hist["m"], s - pen.x, c)
        cand_x = jnp.where(mis_v > NULL, mis_v + 1, NULL)
        cand_i1 = fetch(hist["i1"], s, c)
        cand_d1 = fetch(hist["d1"], s, c)
        cand_i2 = fetch(hist["i2"], s, c)
        cand_d2 = fetch(hist["d2"], s, c)
        pre = jnp.maximum(
            jnp.maximum(jnp.maximum(cand_x, cand_i1), jnp.maximum(cand_d1, cand_i2)),
            cand_d2,
        )
        # tie-break order X, I1, I2, D1, D2 (reference_impl.TIEBREAK_M)
        choice = jnp.where(
            cand_x == pre,
            _C_M,  # mismatch: stay in M at s-x
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

        # ----- gap states: prefer extend over open (TIEBREAK_GAP) -----
        # I1: ext = I1[s-e1][k-1]+1, open = M[s-o1-e1][k-1]+1
        i1_ext = fetch(hist["i1"], s - pen.e1, c - 1)
        i1_ext_ok = (i1_ext > NULL) & (i1_ext + 1 == h)
        i2_ext = fetch(hist["i2"], s - pen.e2, c - 1)
        i2_ext_ok = (i2_ext > NULL) & (i2_ext + 1 == h)
        d1_ext = fetch(hist["d1"], s - pen.e1, c + 1)
        d1_ext_ok = (d1_ext > NULL) & (d1_ext == h)
        d2_ext = fetch(hist["d2"], s - pen.e2, c + 1)
        d2_ext_ok = (d2_ext > NULL) & (d2_ext == h)

        is_i = (comp == _C_I1) | (comp == _C_I2)
        is_d = (comp == _C_D1) | (comp == _C_D2)
        gap_e = jnp.where(
            (comp == _C_I1) | (comp == _C_D1), pen.e1, pen.e2
        )
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

        # ----- emit runs -----
        ops, lens, nrun = emit(
            ops, lens, nrun, active & is_m, _OP_M, jnp.where(is_m, n_match, 0)
        )
        mismatch_step = active & is_m & (~at_origin) & (choice == _C_M)
        ops, lens, nrun = emit(
            ops, lens, nrun, mismatch_step, _OP_X, jnp.where(mismatch_step, 1, 0)
        )
        i_step = active & is_i
        ops, lens, nrun = emit(ops, lens, nrun, i_step, _OP_I, jnp.where(i_step, 1, 0))
        d_step = active & is_d
        ops, lens, nrun = emit(ops, lens, nrun, d_step, _OP_D, jnp.where(d_step, 1, 0))

        # ----- state transitions -----
        # M state
        m_new_s = jnp.where(choice == _C_M, s - pen.x, s)
        m_new_h = jnp.where(choice == _C_M, pre - 1, pre)
        m_new_comp = choice
        # gap states
        g_new_comp = jnp.where(ext_ok, comp, _C_M)
        g_new_s = jnp.where(ext_ok, s - gap_e, s - gap_oe)
        g_new_c = jnp.where(is_i, c - 1, c + 1)
        g_new_h = jnp.where(is_i, h - 1, h)

        new_s = jnp.where(is_m, m_new_s, g_new_s)
        new_h = jnp.where(is_m, m_new_h, g_new_h)
        new_c = jnp.where(is_m, c, g_new_c)
        new_comp = jnp.where(is_m, m_new_comp, g_new_comp)

        finished = active & at_origin
        overflow = overflow | (active & (nrun >= run_cap))
        active = active & (~at_origin) & (~overflow)

        s = jnp.where(active, new_s, s)
        h = jnp.where(active, new_h, h)
        c = jnp.where(active, new_c, c)
        comp = jnp.where(active, new_comp, comp)
        return (s, c, h, comp, active, ops, lens, nrun, overflow, it + 1)

    carry = (s0, c0, h0, comp0, active0, ops0, lens0, nrun0, overflow0, jnp.int32(0))
    carry = jax.lax.while_loop(cond, body, carry)
    (_, _, _, _, active, ops, lens, nrun, overflow, _) = carry
    # lanes still active at the bound hit a logic bug: flag as overflow
    overflow = overflow | active
    return ops, lens, nrun, overflow


def expand_runs_to_cigar(
    ops_row: np.ndarray, lens_row: np.ndarray, n: int
) -> np.ndarray:
    """Host-side: reverse the device's end->start runs and expand to the
    per-base WFA2-convention cigar byte array."""
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    ops = ops_row[:n][::-1]
    lens = lens_row[:n][::-1]
    keep = lens > 0
    return np.repeat(ops[keep], lens[keep]).astype(np.uint8)


def expand_runs_batch(ops, lens, nruns):
    """Batched expand_runs_to_cigar: ONE np.repeat over the whole
    (B, run_cap) buffers instead of B small ones (the per-record loop
    cost ~15 ms per 2048-pair batch in the pipeline profile).

    Returns a list of per-pair cigar byte arrays (views into one
    backing buffer)."""
    B, cap = ops.shape
    valid = np.arange(cap, dtype=np.int32)[None, :] < np.asarray(nruns)[:, None]
    l64 = lens.astype(np.int64) * valid
    # reverse run order per row (device emits end->start)
    ops_r = ops[:, ::-1]
    lens_r = l64[:, ::-1]
    flat_lens = lens_r.ravel()
    expanded = np.repeat(ops_r.ravel(), flat_lens)
    row_sizes = lens_r.sum(axis=1)
    offs = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(row_sizes, out=offs[1:])
    return [expanded[offs[i] : offs[i + 1]] for i in range(B)]
