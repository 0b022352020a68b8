"""Dense banded anti-diagonal alignment engine (gather-free).

The second device engine, complementary to batch.py's wavefront engine:
a classic Gotoh DP swept over ANTI-diagonals in diagonal coordinates.
Design:

* zero per-lane gathers and zero data-dependent inner loops — each step
  is a handful of shifted elementwise min/add ops on a (B, K) band,
  swept by one `lax.scan` of static length;
* the substitution bases ride along as SHIFT REGISTERS: as d advances,
  q[v-1] along the band is exactly the previous step's register shifted
  by one lane (one scalar insert per pair per step), same for t[h-1] in
  the other direction — no addressing at all in the hot loop;
* choice bits for the traceback stream out as scan outputs (one uint16
  plane per step), so the backtrace is O(1) lookups per step.

Cost is L*K/2 cells instead of the wavefront's ~s*K/2, but every step
is dense elementwise work. Long pairs run the same DP through the
segmented checkpoint-replay engine (segmented.py).

Band correctness: with band half-width slack W beyond the [0, k_end]
hull, any alignment leaving the band must contain net indels of more
than W diagonals, costing more than min_piece(o + e*(W+1)). If the
banded score sigma < that bound, the result is provably the unbanded
optimum; otherwise the caller escalates K (same escalation frame as the
wavefront engine).

Parity bookkeeping: on anti-diagonal d only lanes with (d - k) even hold
cells. Inactive lanes carry their previous values, which by parity are
exactly the d-2 values the next step's diagonal term needs — so a single
S array serves as both S_{d-1} (for gap terms, read at k-+1) and S_{d-2}
(for the diagonal term, read at k).

Tie-break policy (documented contract, mirrors reference_impl.TIEBREAK_*
in spirit): S-state prefers diagonal (match/mismatch) over gap closes,
gap closes in order I1, I2, D1, D2; gap states prefer extend over open.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .params import Penalties

INF = 2**29  # plain int: a module-level jnp constant would commit to the
# default backend at import time

# choice-plane encoding
# bits 0-2: S source: 0=diag-match, 1=diag-mismatch, 2=I1, 3=I2, 4=D1, 5=D2
# bit 3: I1 extend (vs open); bit 4: D1; bit 5: I2; bit 6: D2
S_DIAG_MATCH = 0
S_DIAG_MISMATCH = 1
S_I1 = 2
S_I2 = 3
S_D1 = 4
S_D2 = 5


def _shift_up(a, fill):  # out[..., c] = a[..., c+1]
    return jnp.concatenate(
        [a[..., 1:], jnp.full(a.shape[:-1] + (1,), fill, a.dtype)], -1
    )


def _shift_down(a, fill):  # out[..., c] = a[..., c-1]
    return jnp.concatenate(
        [jnp.full(a.shape[:-1] + (1,), fill, a.dtype), a[..., :-1]], -1
    )


def _band_geometry(qlens, tlens, K):
    """Band window [k0, k0+K-1] around the [0, k_end] hull.

    k0 is EVEN-aligned (shifted one diagonal left when odd), which fixes
    where each band sits and therefore which co-optimal path a band's
    tie-breaks select; the returned slack is the true min(left, right)
    margin between hull and band edge — the escape-certificate width."""
    k_end = tlens - qlens
    slack = (K - 1 - jnp.abs(k_end)) // 2
    k0 = jnp.minimum(0, k_end) - slack
    k0 = k0 - (k0 & 1)
    w_l = jnp.minimum(0, k_end) - k0
    w_r = (k0 + (K - 1)) - jnp.maximum(0, k_end)
    return k_end, k0, jnp.minimum(w_l, w_r)


@functools.partial(
    jax.jit, static_argnames=("pen", "k_width", "l_pad", "with_choices")
)
def dense_forward(
    qs: jnp.ndarray,
    ts: jnp.ndarray,
    qlens: jnp.ndarray,
    tlens: jnp.ndarray,
    pen: Penalties,
    k_width: int,
    l_pad: int,
    with_choices: bool = False,
):
    """Banded Gotoh sweep over anti-diagonals d = 1 .. 2*l_pad.

    qs/ts: (B, l_pad) uint8. Returns (scores (B,) int32 — >= INF if the
    end cell is unreachable within the band, certificate (B,) bool —
    True iff the banded result is provably the global optimum, choices
    (2*l_pad, B, K) uint8 or None).
    """
    B = qs.shape[0]
    K = k_width

    k_end, k0, slack = _band_geometry(qlens, tlens, K)
    ks = k0[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]  # (B, K)

    # reversed query (one-time): rq[i] = q[qlen-1-i]
    idx = jnp.arange(l_pad, dtype=jnp.int32)[None, :]
    rev_idx = jnp.clip(qlens[:, None] - 1 - idx, 0, l_pad - 1)
    rq = jnp.take_along_axis(qs, rev_idx, axis=1)

    # base shift registers at d=0 (formula shared with the per-step
    # inserts so floor-shift semantics agree lane-for-lane):
    #   qb_d[k] = rq[qlen - ((d - k) >> 1)], tb_d[k] = t[((d + k) >> 1) - 1]
    qi0 = jnp.clip(qlens[:, None] - ((0 - ks) >> 1), 0, l_pad - 1)
    ti0 = jnp.clip(((0 + ks) >> 1) - 1, 0, l_pad - 1)
    qb = jnp.take_along_axis(rq, qi0, axis=1)
    tb = jnp.take_along_axis(ts, ti0, axis=1)

    s0 = jnp.where(ks == 0, 0, INF).astype(jnp.int32)
    gap0 = jnp.full((B, K), INF, jnp.int32)
    run0 = jnp.zeros((B, K), jnp.uint8)  # diag-match run lengths (sat. 255)

    o1e1 = jnp.int32(pen.o1 + pen.e1)
    e1 = jnp.int32(pen.e1)
    o2e2 = jnp.int32(pen.o2 + pen.e2) if pen.two_piece else jnp.int32(0)
    e2 = jnp.int32(pen.e2) if pen.two_piece else jnp.int32(0)
    x = jnp.int32(pen.x)
    k0_col = k0  # (B,)

    def step(carry, d):
        s_prev, i1, d1, i2, d2, qb, tb, runlen = carry

        # advance base shift registers
        qi_head = jnp.clip(qlens - ((d - k0_col) >> 1), 0, l_pad - 1)
        q_head = jnp.take_along_axis(rq, qi_head[:, None], axis=1)
        qb = jnp.concatenate([q_head, qb[:, :-1]], axis=1)
        ti_tail = jnp.clip(((d + k0_col + (K - 1)) >> 1) - 1, 0, l_pad - 1)
        t_tail = jnp.take_along_axis(ts, ti_tail[:, None], axis=1)
        tb = jnp.concatenate([tb[:, 1:], t_tail], axis=1)

        v = (d - ks) >> 1
        h = (d + ks) >> 1
        parity_ok = ((d - ks) & 1) == 0
        in_matrix = (v >= 0) & (v <= qlens[:, None]) & (h >= 0) & (h <= tlens[:, None])
        active = parity_ok & in_matrix

        # gap states read S_{d-1} / gaps_{d-1} at k-+1
        s_km1 = _shift_down(s_prev, INF)
        s_kp1 = _shift_up(s_prev, INF)
        i1_ext_v = _shift_down(i1, INF) + e1
        i1_opn_v = s_km1 + o1e1
        i1_new = jnp.minimum(i1_opn_v, i1_ext_v)
        i1_ext = i1_ext_v <= i1_opn_v  # tie -> extend
        d1_ext_v = _shift_up(d1, INF) + e1
        d1_opn_v = s_kp1 + o1e1
        d1_new = jnp.minimum(d1_opn_v, d1_ext_v)
        d1_ext = d1_ext_v <= d1_opn_v
        best_gap = jnp.minimum(i1_new, d1_new)
        if pen.two_piece:
            i2_ext_v = _shift_down(i2, INF) + e2
            i2_opn_v = s_km1 + o2e2
            i2_new = jnp.minimum(i2_opn_v, i2_ext_v)
            i2_ext = i2_ext_v <= i2_opn_v
            d2_ext_v = _shift_up(d2, INF) + e2
            d2_opn_v = s_kp1 + o2e2
            d2_new = jnp.minimum(d2_opn_v, d2_ext_v)
            d2_ext = d2_ext_v <= d2_opn_v
            best_gap = jnp.minimum(best_gap, jnp.minimum(i2_new, d2_new))
        else:
            i2_new, d2_new = i2, d2
            i2_ext = jnp.zeros_like(i1_ext)
            d2_ext = jnp.zeros_like(d1_ext)

        # diagonal term reads S_{d-2} at k — which is s_prev[k] by parity
        is_match = qb == tb
        sub_cost = jnp.where(is_match, 0, x)
        diag_ok = (v > 0) & (h > 0)
        diag = jnp.where(diag_ok, s_prev + sub_cost, INF)

        s_new = jnp.minimum(diag, best_gap)

        if with_choices:
            # Preference order replicating the wavefront oracle's
            # tie-break exactly (see reference_impl.TIEBREAK_M and the
            # derivation in tests/test_dense.py): a gap close that ties S
            # corresponds to a zero-length match pop in the wavefront
            # backtrace, so diag-MATCH is the *last* resort while
            # diag-MISMATCH (the X candidate) is checked first.
            # Last write wins: build lowest -> highest priority.
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
            # diag-match run length (for bulk skipping in the traceback):
            # runlen[k] counts consecutive DIAG_MATCH choices along the
            # path ending here; saturates at 255 (longer runs take
            # multiple traceback hops). Parity: the predecessor run value
            # lives at the same lane (d-2), which is runlen[k] pre-update.
            is_run = choice == jnp.uint8(S_DIAG_MATCH)
            inc = jnp.minimum(runlen, jnp.uint8(254)) + jnp.uint8(1)
            new_run = jnp.where(is_run, inc, jnp.uint8(0))
            # ONE merged u16 plane (low byte: packed choice/ext bits,
            # high byte: run length): the traceback pays one random
            # device-memory gather per hop instead of two
            y = packed.astype(jnp.uint16) | (
                new_run.astype(jnp.uint16) << 8
            )
        else:
            new_run = runlen
            y = jnp.zeros((B, 1), jnp.uint16)

        clamp = lambda a: jnp.minimum(a, INF)
        s_out = jnp.where(active, clamp(s_new), s_prev)
        i1_out = jnp.where(active, clamp(i1_new), i1)
        d1_out = jnp.where(active, clamp(d1_new), d1)
        i2_out = jnp.where(active, clamp(i2_new), i2)
        d2_out = jnp.where(active, clamp(d2_new), d2)
        run_out = jnp.where(active, new_run, runlen) if with_choices else runlen

        return (s_out, i1_out, d1_out, i2_out, d2_out, qb, tb, run_out), y

    ds = jnp.arange(1, 2 * l_pad + 1, dtype=jnp.int32)
    # unroll to amortize per-step loop overhead (dominant at small B*K)
    carry, choices = jax.lax.scan(
        step, (s0, gap0, gap0, gap0, gap0, qb, tb, run0), ds, unroll=4
    )
    s_final = carry[0]

    c_end = jnp.clip(k_end - k0, 0, K - 1)
    scores = jnp.take_along_axis(s_final, c_end[:, None], axis=1)[:, 0]
    feasible = (jnp.abs(k_end) <= (K - 1)) & (qlens + tlens <= 2 * l_pad)
    scores = jnp.where(feasible, scores, INF)

    # Optimality certificate. A path that leaves the band must cross W+1
    # diagonals out AND return (start k=0 and end k_end both lie in the
    # hull), so it contains >= 2 gaps totalling >= 2*(W+1) indel bases:
    # cost >= 2*o_min + 2*(W+1)*e_min. If the banded score beats that,
    # the banded optimum is the global optimum.
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
    # a band covering every diagonal of the matrix IS the unbanded DP:
    # certify unconditionally (no path can leave the matrix)
    full_cover = (k0 <= -qlens) & (k0 + (K - 1) >= tlens)
    certificate = ((scores < esc) | full_cover) & feasible & (scores < INF)

    return scores, certificate, (choices if with_choices else None)


# --------------------------------------------------------------------------
# Traceback from the choice planes
# --------------------------------------------------------------------------

_OP_M = ord("M")
_OP_X = ord("X")
_OP_I = ord("I")
_OP_D = ord("D")


@functools.partial(
    jax.jit, static_argnames=("pen", "k_width", "l_pad", "run_cap")
)
def dense_align(qs, ts, qlens, tlens, pen, k_width, l_pad, run_cap):
    """Fused forward (with choices) + traceback in ONE compiled dispatch:
    the choice planes never leave the device and the host pays a single
    round trip per batch."""
    scores, cert, choices = dense_forward(
        qs, ts, qlens, tlens, pen, k_width, l_pad, True
    )
    ops, lens, nruns, overflow = dense_traceback(
        choices, scores, qlens, tlens, pen, run_cap
    )
    return scores, cert, ops, lens, nruns, overflow


@functools.partial(
    jax.jit,
    static_argnames=("pen", "k_width", "l_pad", "run_cap"),
)
def dense_align_packed(
    pool,
    qidx,
    tidx,
    qlens,
    tlens,
    pen,
    k_width,
    l_pad,
    run_cap,
):
    """Transfer-optimized fused alignment step.

    Every host<->device transfer has a fixed cost, so this entry point
    (a) takes a UNIQUE-sequence pool plus per-pair row indices — the
    batch rows are materialized on-device, uploading kilobytes instead
    of megabytes for all-pairs workloads — and (b) returns ONE uint8
    buffer per batch:

        out[b] = [score,nruns,cert,overflow,
                  num_matches,alignment_length,query_consumed,
                  target_consumed as 8x int32 LE | ops | lens]

    shape (B, 32 + 2*run_cap), fetched with a single transfer. The four
    PAF stat columns (reference: alignment.rs:292-344 semantics) are
    reduced from the run buffers ON DEVICE — the host-side (B, run_cap)
    masked reductions cost ~10s of ms per batch on slow hosts."""
    qs = jnp.take(pool, qidx, axis=0)
    ts = jnp.take(pool, tidx, axis=0)
    scores, cert, choices = dense_forward(
        qs, ts, qlens, tlens, pen, k_width, l_pad, True
    )
    ops, lens, nruns, overflow = dense_traceback(
        choices, scores, qlens, tlens, pen, run_cap
    )
    B = scores.shape[0]
    run_cap_n = ops.shape[1]
    valid = (
        jnp.arange(run_cap_n, dtype=jnp.int32)[None, :] < nruns[:, None]
    )
    l32 = jnp.where(valid, lens.astype(jnp.int32), 0)
    m_ct = jnp.sum(jnp.where(ops == _OP_M, l32, 0), axis=1)
    x_ct = jnp.sum(jnp.where(ops == _OP_X, l32, 0), axis=1)
    i_ct = jnp.sum(jnp.where(ops == _OP_I, l32, 0), axis=1)
    d_ct = jnp.sum(jnp.where(ops == _OP_D, l32, 0), axis=1)
    meta = jnp.stack(
        [
            scores.astype(jnp.int32),
            nruns.astype(jnp.int32),
            cert.astype(jnp.int32),
            overflow.astype(jnp.int32),
            m_ct,  # num_matches
            m_ct + x_ct,  # alignment_length (gaps excluded)
            m_ct + x_ct + d_ct,  # query bases consumed (WFA2 I/D swap)
            m_ct + x_ct + i_ct,  # target bases consumed
        ],
        axis=1,
    )  # (B, 8) int32
    meta_u8 = jax.lax.bitcast_convert_type(meta, jnp.uint8).reshape(B, 32)
    # ops are 2 bits of information (M/X/I/D): pack 4 per byte before
    # the device->host fetch, which halves the fetched bytes. Layout:
    #   [meta 32B | ops 2-bit-packed ceil(cap/4)B | lens capB]
    # (host unpack: dense_engine._OPS_UNPACK_LUT).
    if run_cap_n % 4:
        ops = jnp.pad(ops, ((0, 0), (0, 4 - run_cap_n % 4)))
    code = jnp.where(
        ops == _OP_M,
        jnp.uint8(0),
        jnp.where(
            ops == _OP_X,
            jnp.uint8(1),
            jnp.where(ops == _OP_I, jnp.uint8(2), jnp.uint8(3)),
        ),
    )
    ops_packed = (
        code[:, 0::4]
        | (code[:, 1::4] << 2)
        | (code[:, 2::4] << 4)
        | (code[:, 3::4] << 6)
    )
    return jnp.concatenate([meta_u8, ops_packed, lens], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("pen", "k_width", "l_pad", "run_cap"),
)
def dense_align_packed_groups(
    pool,
    qidx,
    tidx,
    qlens,
    tlens,
    pen,
    k_width,
    l_pad,
    run_cap,
):
    """dense_align_packed over G stacked sub-batches in ONE dispatch.

    qidx/tidx/qlens/tlens are (G, B). The sub-batches run sequentially
    inside the executable (lax.map), so the forward's choice planes are
    allocated for a single sub-batch at a time — same device-memory
    high-water mark as G separate dispatches — while the host pays ONE
    execute and fetch for the whole wave instead of G.

    Returns (G*B, 32 + ceil(run_cap/4) + run_cap) uint8, group-major."""

    def one(args):
        qi, ti, ql, tl = args
        return dense_align_packed(
            pool, qi, ti, ql, tl, pen, k_width, l_pad, run_cap
        )

    out = jax.lax.map(one, (qidx, tidx, qlens, tlens))
    return out.reshape(out.shape[0] * out.shape[1], out.shape[2])


@functools.partial(jax.jit, static_argnames=("pen", "run_cap"))
def dense_traceback(
    choices,  # (2*l_pad, B, K) u16: low byte choice/ext bits, high run length
    scores: jnp.ndarray,
    qlens: jnp.ndarray,
    tlens: jnp.ndarray,
    pen: Penalties,
    run_cap: int,
):
    """Walk the choice planes from (plen, tlen) back to (0, 0), emitting
    (op, len) runs in reverse order (host merges; same output contract as
    batch.wavefront_traceback).

    Match runs are skipped in bulk using the run-length plane (one
    traceback hop per <=255 matched bases), so iterations scale with the
    number of mutation events, not sequence length. One merged emit
    (single scatter) per iteration. Bounded — cannot hang."""
    D2, B, K = choices.shape
    k_end, k0, _ = _band_geometry(qlens, tlens, K)
    rows = jnp.arange(B, dtype=jnp.int32)

    def fetch(d, c):
        # 3D advanced indexing, NOT a flattened take: D2*B*K exceeds
        # int32 for large banded batches and x64 is disabled
        d_ok = (d >= 1) & (d <= D2)
        c_ok = (c >= 0) & (c < K)
        dd = jnp.clip(d - 1, 0, D2 - 1)
        cc = jnp.clip(c, 0, K - 1)
        v = jnp.where(d_ok & c_ok, choices[dd, rows, cc], jnp.uint16(0))
        byte = (v & 0xFF).astype(jnp.uint8)
        run = (v >> 8).astype(jnp.uint8)
        return byte, run

    # Walk state. The run being built rides the CARRY as (cur_op,
    # cur_len) instead of living in the buffers: a per-hop buffer
    # gather/scatter is a random device-memory access per pair, which
    # would dominate the whole traceback. Completed runs stream
    # out of a fixed-length inner scan as dense per-iteration logs and
    # are packed into the run buffers with ONE batched scatter per
    # CHUNK of hops.
    CHUNK = 32

    d0 = (qlens + tlens).astype(jnp.int32)
    c0 = jnp.clip(k_end - k0, 0, K - 1).astype(jnp.int32)
    comp0 = jnp.zeros((B,), jnp.int32)  # 0=S, 1=I1, 2=D1, 3=I2, 4=D2
    active0 = (scores < INF) & (d0 > 0)

    ops0 = jnp.zeros((B, run_cap), dtype=jnp.uint8)
    lens0 = jnp.zeros((B, run_cap), dtype=jnp.uint8)
    nrun0 = jnp.zeros((B,), dtype=jnp.int32)
    overflow0 = jnp.zeros((B,), jnp.bool_)
    cur_op0 = jnp.zeros((B,), jnp.uint8)
    cur_len0 = jnp.zeros((B,), jnp.int32)

    def hop(carry, _):
        d, c, comp, active, cur_op, cur_len = carry
        byte, run = fetch(d, c)
        src = (byte & 7).astype(jnp.int32)

        is_s = comp == 0
        is_match_run = is_s & (src == S_DIAG_MATCH)
        is_x = is_s & (src == S_DIAG_MISMATCH)
        run_i = jnp.maximum(run.astype(jnp.int32), 1)  # defensive: >= 1

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
        do_emit = active & (is_match_run | is_x | is_i | is_d)

        # merge into the carried run; a completed run flushes to the log
        same = (cur_len > 0) & (cur_op == emit_op) & (cur_len + emit_len <= 255)
        flush = do_emit & (cur_len > 0) & jnp.logical_not(same)
        log_op, log_len = cur_op, cur_len
        cur_op = jnp.where(do_emit, emit_op, cur_op)
        cur_len = jnp.where(
            do_emit, jnp.where(same, cur_len + emit_len, emit_len), cur_len
        )

        # state transitions
        d_s = jnp.where(is_match_run, d - 2 * run_i, jnp.where(is_x, d - 2, d))
        comp_s = jnp.where(is_match_run | is_x, 0, to_gap)
        d_g = d - 1
        c_g = jnp.where(is_i, c - 1, c + 1)
        comp_g = jnp.where(ext_bit, comp, 0)

        new_d = jnp.where(is_s, d_s, d_g)
        new_c = jnp.where(is_s, c, c_g)
        new_comp = jnp.where(is_s, comp_s, comp_g)

        finished = active & (new_d <= 0)
        active = active & jnp.logical_not(finished)
        d = jnp.where(active, new_d, d)
        c = jnp.where(active, new_c, c)
        comp = jnp.where(active, new_comp, comp)
        return (d, c, comp, active, cur_op, cur_len), (flush, log_op, log_len)

    max_chunks = (2 * int(D2) + 8 + CHUNK - 1) // CHUNK + 1

    def cond(carry):
        (_, _, _, active, _, _, _, _, _, _, it) = carry
        return jnp.any(active) & (it < max_chunks)

    def body(carry):
        d, c, comp, active, cur_op, cur_len, ops, lens, nrun, overflow, it = carry
        (d, c, comp, active, cur_op, cur_len), (fl, fo, fln) = jax.lax.scan(
            hop, (d, c, comp, active, cur_op, cur_len), None, length=CHUNK
        )
        # pack the chunk's flushed runs: one batched scatter (indices
        # are unique per pair — positions strictly increase)
        inc = fl.astype(jnp.int32)  # (CHUNK, B)
        pos = nrun[None, :] + jnp.cumsum(inc, axis=0) - inc
        oob = fl & (pos >= run_cap)
        idx = jnp.where(fl & (pos < run_cap), pos, run_cap)  # run_cap = dropped
        rows2 = jnp.broadcast_to(rows[None, :], idx.shape)
        ops = ops.at[rows2, idx].set(fo, mode="drop")
        lens = lens.at[rows2, idx].set(fln.astype(jnp.uint8), mode="drop")
        nrun = nrun + inc.sum(0)
        overflow = overflow | jnp.any(oob, axis=0)
        return (d, c, comp, active, cur_op, cur_len, ops, lens, nrun, overflow, it + 1)

    carry = (
        d0, c0, comp0, active0, cur_op0, cur_len0,
        ops0, lens0, nrun0, overflow0, jnp.int32(0),
    )
    carry = jax.lax.while_loop(cond, body, carry)
    (_, _, _, active, cur_op, cur_len, ops, lens, nrun, overflow, _) = carry

    # final flush of the carried (still-open) run
    has_cur = cur_len > 0
    fits = has_cur & (nrun < run_cap)
    idx = jnp.where(fits, nrun, run_cap)
    ops = ops.at[rows, idx].set(cur_op, mode="drop")
    lens = lens.at[rows, idx].set(cur_len.astype(jnp.uint8), mode="drop")
    nrun = nrun + fits.astype(jnp.int32)
    overflow = overflow | (has_cur & jnp.logical_not(fits)) | (nrun > run_cap)
    overflow = overflow | active
    return ops, lens, nrun, overflow
