"""The XLA engines against the C++ WFA oracle (csrc/wfa_oracle.cpp).

The dense anti-diagonal scan (wfa/dense.py), its fused traceback, the
dense segmented checkpoint-replay engine (wfa/segmented.py) and the
wavefront checkpoint-replay engine (wfa/wf_segmented.py) are the only
engines, on every backend. Every certified result must equal the
oracle's score AND CIGAR bit for bit (the shared tie-break contract,
docs/TIEBREAK.md), across penalty modes, band widths wider and narrower
than the matrix, batch/length padding and segment boundaries."""

import numpy as np
import pytest

import jax.numpy as jnp

from allwave import native
from allwave.core.cigar import validate_cigar
from allwave.core.scores import parse_scores
from allwave.wfa import dense as D_
from allwave.wfa.params import resolve_penalties

TWO_PIECE = "0,5,8,2,24,1"


def _oracle(q: bytes, t: bytes, pen):
    out = native.wfa_align_native(q, t, pen)
    assert out is not None, "the C++ oracle must build (make -C csrc)"
    return out


def _random_batch(rng, B, L, l_pad, div=0.05):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    qlens = rng.randint(L // 2, L + 1, B).astype(np.int32)
    tlens = (qlens + rng.randint(-6, 7, B)).clip(8, L).astype(np.int32)
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    for b in range(B):
        q = rng.choice(bases, qlens[b])
        if tlens[b] <= qlens[b]:
            t = q[: tlens[b]].copy()
        else:
            t = np.concatenate([q, rng.choice(bases, tlens[b] - qlens[b])])
        mut = rng.rand(tlens[b]) < div
        t[mut] = rng.choice(bases, mut.sum())
        qs[b, : qlens[b]] = q
        ts[b, : tlens[b]] = t
    return qs, ts, qlens, tlens


def _expand(ops, lens, nruns):
    """Reverse-order (op, len) run buffers -> per-base CIGAR bytes."""
    ops = ops[:nruns][::-1]
    lens = lens[:nruns][::-1].astype(np.int64)
    return np.repeat(ops, lens).astype(np.uint8)


def _check_dense_vs_oracle(scores_str, K, l_pad, L, div, seed, B=5):
    pen = resolve_penalties(parse_scores(scores_str))
    rng = np.random.RandomState(seed)
    qs, ts, qlens, tlens = _random_batch(rng, B, L, l_pad, div)
    args = tuple(map(jnp.asarray, (qs, ts, qlens, tlens)))
    scores, cert, choices = D_.dense_forward(*args, pen, K, l_pad, True)
    run_cap = 2 * l_pad + 8
    ops, lens, nruns, overflow = (
        np.asarray(x)
        for x in D_.dense_traceback(choices, scores, args[2], args[3], pen, run_cap)
    )
    scores, cert = np.asarray(scores), np.asarray(cert)
    n_cert = 0
    for b in range(B):
        q = qs[b, : qlens[b]].tobytes()
        t = ts[b, : tlens[b]].tobytes()
        want_score, want_cigar = _oracle(q, t, pen)
        assert scores[b] >= want_score  # a banded score never beats the optimum
        if not cert[b]:
            continue
        n_cert += 1
        assert not overflow[b]
        assert scores[b] == want_score
        got = _expand(ops[b], lens[b], nruns[b])
        np.testing.assert_array_equal(got, want_cigar)
        validate_cigar(got, q, t)
    assert n_cert > 0


@pytest.mark.parametrize("scores_str", [TWO_PIECE, "0,4,6,2", "0,1,1,1"])
def test_dense_forward_matches_oracle(scores_str):
    _check_dense_vs_oracle(scores_str, K=128, l_pad=128, L=96, div=0.05, seed=11)


@pytest.mark.parametrize("K,l_pad,div", [(384, 256, 0.15), (512, 128, 0.2)])
def test_dense_wide_band_matches_oracle(K, l_pad, div):
    """Bands wider than the escalation default, including one wider than
    the whole matrix (K=512 over l_pad=128, where the full-cover
    certificate fires)."""
    _check_dense_vs_oracle(
        TWO_PIECE, K=K, l_pad=l_pad, L=(l_pad * 3) // 4, div=div, seed=17
    )


@pytest.mark.parametrize(
    "scores_str,K,l_pad,div",
    [
        (TWO_PIECE, 128, 128, 0.05),
        (TWO_PIECE, 384, 256, 0.15),
        ("0,4,6,2", 256, 128, 0.2),
        ("0,1,1,1", 128, 96, 0.1),
    ],
)
def test_dense_band_grid_matches_oracle(scores_str, K, l_pad, div):
    """Penalty mode x band width x divergence grid, including a
    non-power-of-two l_pad (96)."""
    _check_dense_vs_oracle(
        scores_str, K=K, l_pad=l_pad, L=(l_pad * 3) // 4, div=div, seed=23
    )


def test_dense_pads_batch_and_length():
    """An odd batch (B=3) and a band wider than a short padded length
    (K=128 > l_pad=64)."""
    _check_dense_vs_oracle(TWO_PIECE, K=128, l_pad=64, L=48, div=0.05, seed=3, B=3)


def test_dense_align_packed_roundtrip():
    """The pooled, packed single-transfer entry point decodes to the
    same results as the unpacked path."""
    from allwave.wfa.dense_engine import _OPS_UNPACK_LUT

    pen = resolve_penalties(parse_scores(TWO_PIECE))
    rng = np.random.RandomState(5)
    l_pad = K = 128
    qs, ts, qlens, tlens = _random_batch(rng, 4, 100, l_pad)
    run_cap = 64

    pool = np.concatenate([qs, ts], 0)
    qidx = np.arange(4, dtype=np.int32)
    tidx = np.arange(4, 8, dtype=np.int32)
    packed = np.asarray(
        D_.dense_align_packed(
            jnp.asarray(pool),
            jnp.asarray(qidx),
            jnp.asarray(tidx),
            jnp.asarray(qlens),
            jnp.asarray(tlens),
            pen,
            K,
            l_pad,
            run_cap,
        )
    )
    meta = packed[:, :32].copy().view(np.int32).reshape(-1, 8)
    # traceback ops travel 2-bit packed (4 per byte); unpack like the
    # engine's collect path does
    cap4 = (run_cap + 3) // 4
    ops = _OPS_UNPACK_LUT[packed[:, 32 : 32 + cap4]].reshape(
        packed.shape[0], 4 * cap4
    )[:, :run_cap]
    lens = packed[:, 32 + cap4 :]

    args = tuple(map(jnp.asarray, (qs, ts, qlens, tlens)))
    scores, cert, ops2, lens2, nruns2, ovf2 = (
        np.asarray(x) for x in D_.dense_align(*args, pen, K, l_pad, run_cap)
    )
    np.testing.assert_array_equal(meta[:, 0], scores)
    np.testing.assert_array_equal(meta[:, 1], nruns2)
    np.testing.assert_array_equal(meta[:, 2], cert.astype(np.int32))
    np.testing.assert_array_equal(meta[:, 3], ovf2.astype(np.int32))
    # 2-bit packing has no spare code for "empty": positions past nruns
    # unpack to 'M' bytes — only the first nruns ops are meaningful
    valid = np.arange(run_cap)[None, :] < nruns2[:, None]
    np.testing.assert_array_equal(np.where(valid, ops, 0), np.where(valid, ops2, 0))
    np.testing.assert_array_equal(np.where(valid, lens, 0), np.where(valid, lens2, 0))
    # device-reduced PAF stat columns == host reductions over the runs
    l64 = lens2.astype(np.int64)
    m = np.where((ops2 == ord("M")) & valid, l64, 0).sum(1)
    x = np.where((ops2 == ord("X")) & valid, l64, 0).sum(1)
    i = np.where((ops2 == ord("I")) & valid, l64, 0).sum(1)
    d = np.where((ops2 == ord("D")) & valid, l64, 0).sum(1)
    np.testing.assert_array_equal(meta[:, 4], m)
    np.testing.assert_array_equal(meta[:, 5], m + x)
    np.testing.assert_array_equal(meta[:, 6], m + x + d)
    np.testing.assert_array_equal(meta[:, 7], m + x + i)


def test_engine_run_cap_escalation_matches_oracle():
    """DenseBandAligner end to end: a tiny initial run cap forces the
    overflow -> full-cap escalation path; results equal the default
    engine's and the oracle's."""
    from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig

    pen = resolve_penalties(parse_scores(TWO_PIECE))
    rng = np.random.RandomState(9)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(6):
        q = rng.choice(bases, rng.randint(60, 120)).tobytes()
        t = bytearray(q)
        for p in range(0, len(t), 17):
            t[p] = bases[rng.randint(4)]
        pairs.append((q, bytes(t)))
    out = DenseBandAligner(pen, DenseConfig(run_cap_initial=16)).align_pairs(pairs)
    ref = DenseBandAligner(pen).align_pairs(pairs)
    for (q, t), a, b in zip(pairs, out, ref):
        want_score, want_cigar = _oracle(q, t, pen)
        assert a[0] == b[0] == want_score
        np.testing.assert_array_equal(a[1], want_cigar)
        np.testing.assert_array_equal(b[1], want_cigar)


def _segmented_pairs(rng):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(3):
        L = rng.randint(380, 520)
        q = rng.choice(bases, L)
        t = q.copy()
        mut = rng.rand(L) < 0.03
        t[mut] = rng.choice(bases, mut.sum())
        t = np.concatenate([t[:100], t[103:]])  # deletion
        t = np.concatenate([t[:50], rng.choice(bases, 4), t[50:]])  # insert
        pairs.append((q.tobytes(), t.tobytes()))
    hi = rng.choice(bases, 450)
    pairs.append((hi.tobytes(), rng.choice(bases, 430).tobytes()))  # unrelated
    pairs.append((pairs[0][0], pairs[0][0]))  # identical
    return pairs


@pytest.mark.parametrize("scores_str", [TWO_PIECE, "0,4,6,2"])
def test_segmented_spans_match_oracle(scores_str):
    """The dense segmented engine (sweep checkpoints, per-segment replay
    spans, resumable traceback) across several 256-step segment
    boundaries, for both affine modes — including an unrelated pair
    (band escalation) and an identical pair (score 0)."""
    from allwave.wfa.segmented import SegmentedConfig, SegmentedDenseAligner

    pen = resolve_penalties(parse_scores(scores_str))
    pairs = _segmented_pairs(np.random.RandomState(31))
    seg = SegmentedDenseAligner(pen, SegmentedConfig(ckpt_every=256))
    for (q, t), r in zip(pairs, seg.align_pairs(pairs)):
        want_score, want_cigar = _oracle(q, t, pen)
        assert r is not None
        assert r[0] == want_score
        np.testing.assert_array_equal(r[1], want_cigar)


def _wf_batch(seed, L, div=0.03, B=4):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(B):
        ln = L - int(rng.integers(0, 40))
        s1 = alpha[rng.integers(0, 4, size=ln)]
        s2 = s1.copy()
        nmut = max(1, int(ln * div))
        idx = rng.integers(0, ln, size=nmut)
        s2[idx] = alpha[rng.integers(0, 4, size=nmut)]
        dele = int(rng.integers(1, 6))
        s2 = np.concatenate([s2[: ln // 2], s2[ln // 2 + dele :]])
        ins = alpha[rng.integers(0, 4, size=int(rng.integers(1, 5)))]
        s2 = np.concatenate([s2[: ln // 3], ins, s2[ln // 3 :]])[:L]
        pairs.append((s1.tobytes(), s2.tobytes()))
    return pairs


def test_wavefront_segmented_two_piece_matches_oracle():
    """The XLA wavefront checkpoint-replay engine under two-piece
    penalties, with segments (C=32) far shorter than the scores so the
    walkers cross many segment boundaries."""
    from allwave.wfa.wf_segmented import WavefrontSegmentedAligner, WfSegConfig

    pen = resolve_penalties(parse_scores(TWO_PIECE))
    pairs = _wf_batch(0, 500)
    al = WavefrontSegmentedAligner(pen, WfSegConfig(ckpt_every=32))
    out = al.align_pairs(pairs, sigma_hint=[120] * len(pairs))
    for (q, t), r in zip(pairs, out):
        want_score, want_cigar = _oracle(q, t, pen)
        assert r is not None and r is not al.DENSE_FALLBACK
        assert r[0] == want_score
        np.testing.assert_array_equal(r[1], want_cigar)


def test_wavefront_orchestrator_matches_oracle():
    """WavefrontSegmentedAligner end to end on longer pairs, including an
    identical pair (score 0: a pure origin-emit traceback from the seed
    checkpoint)."""
    from allwave.wfa.wf_segmented import WavefrontSegmentedAligner

    pen = resolve_penalties(parse_scores(TWO_PIECE))
    pairs = _wf_batch(3, 768)
    pairs[3] = (pairs[3][0], pairs[3][0])
    al = WavefrontSegmentedAligner(pen)
    out = al.align_pairs(pairs, sigma_hint=[120] * len(pairs))
    for (q, t), r in zip(pairs, out):
        want_score, want_cigar = _oracle(q, t, pen)
        assert r is not None and r is not al.DENSE_FALLBACK
        assert r[0] == want_score
        np.testing.assert_array_equal(r[1], want_cigar)
