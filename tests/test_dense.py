"""Dense banded engine vs the scalar oracle / dense DP: scores must match
exactly; CIGARs must be valid and score-consistent; and (checked, not
assumed) the dense tie-break should agree with the wavefront oracle's on
typical inputs."""

import numpy as np
import pytest

from allwave.core.cigar import validate_cigar
from allwave.core.scores import parse_scores
from allwave.testing.dense import cigar_score, dense_score
from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig, UnifiedAligner
from allwave.wfa.params import resolve_penalties
from allwave.wfa.reference_impl import wfa_align

EDIT = resolve_penalties(parse_scores("0,1,1,1"))
AFFINE = resolve_penalties(parse_scores("0,5,8,2"))
TWOPIECE = resolve_penalties(parse_scores("0,5,8,2,24,1"))


def _random_dna(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def _mutate(rng, seq, n_snp=0, n_ins=0, n_del=0, max_indel=10):
    s = bytearray(seq)
    for _ in range(n_snp):
        i = rng.randint(0, len(s))
        s[i] = [b for b in b"ACGT" if b != s[i]][rng.randint(0, 3)]
    for _ in range(n_ins):
        i = rng.randint(0, len(s))
        s[i:i] = _random_dna(rng, rng.randint(1, max_indel))
    for _ in range(n_del):
        if len(s) > 2 * max_indel:
            i = rng.randint(0, len(s) - max_indel)
            del s[i : i + rng.randint(1, max_indel)]
    return bytes(s)


def _suite(seed=0):
    rng = np.random.RandomState(seed)
    pairs = []
    q = _random_dna(rng, 64)
    pairs.append((q, q))  # identical
    q = _random_dna(rng, 100)
    pairs.append((q, _mutate(rng, q, n_snp=3)))
    q = _random_dna(rng, 130)
    pairs.append((q, _mutate(rng, q, n_ins=2, n_del=1)))
    q = _random_dna(rng, 200)
    pairs.append((q, _mutate(rng, q, n_snp=5, n_ins=2, n_del=2)))
    pairs.append((_random_dna(rng, 30), _random_dna(rng, 37)))  # unrelated
    q = _random_dna(rng, 90)
    pairs.append((q, q[:40]))  # big length skew
    pairs.append((b"", b"ACGTT"))
    pairs.append((b"ACG", b""))
    return pairs


@pytest.mark.parametrize("pen", [EDIT, AFFINE, TWOPIECE], ids=["edit", "affine", "2p"])
def test_dense_scores_and_validity(pen):
    pairs = _suite()
    eng = DenseBandAligner(pen)
    got = eng.align_pairs(pairs)
    for (q, t), res in zip(pairs, got):
        assert res is not None, (q, t)
        score, cigar = res
        o_score, _ = wfa_align(q, t, pen)
        assert score == o_score, (q, t)
        validate_cigar(cigar, q, t)
        assert cigar_score(cigar, pen) == score


@pytest.mark.parametrize("pen", [EDIT, AFFINE, TWOPIECE], ids=["edit", "affine", "2p"])
def test_dense_cigar_matches_wavefront_oracle(pen):
    """The dense backtrace preference order (diag-mismatch > I1 > I2 >
    D1 > D2 > diag-match; gap ext over open) provably replicates the
    wavefront oracle's tie-break: a gap close that ties S at a cell
    corresponds to a zero-length match pop in the wavefront backtrace
    (the gap wavefront's offset reaches the stored offset), an X tie
    corresponds to the mismatch candidate reaching it (impossible on
    matching bases since extension would have passed them), and matches
    are popped only when nothing else ties. Hence: byte equality."""
    pairs = _suite(seed=3)
    eng = DenseBandAligner(pen)
    got = eng.align_pairs(pairs)
    for (q, t), res in zip(pairs, got):
        o_score, o_cigar = wfa_align(q, t, pen)
        score, cigar = res
        assert score == o_score
        assert cigar.tobytes() == o_cigar.tobytes(), (q, t)


def test_band_escalation():
    # force a tiny initial band so escalation logic runs
    rng = np.random.RandomState(4)
    q = _random_dna(rng, 300)
    t = _mutate(rng, q, n_snp=20, n_ins=4, n_del=4, max_indel=20)
    pen = TWOPIECE
    eng = DenseBandAligner(pen, DenseConfig(k_initial=8))
    (res,) = eng.align_pairs([(q, t)])
    assert res is not None
    o_score, _ = wfa_align(q, t, pen)
    assert res[0] == o_score
    validate_cigar(res[1], q, t)


def test_unified_router():
    rng = np.random.RandomState(5)
    short_q = _random_dna(rng, 100)
    long_q = _random_dna(rng, 600)
    pairs = [
        (short_q, _mutate(rng, short_q, n_snp=2)),
        (long_q, _mutate(rng, long_q, n_snp=6, n_ins=1)),
    ]
    eng = UnifiedAligner(TWOPIECE, dense_max_len=256)
    got = eng.align_pairs(pairs)
    for (q, t), res in zip(pairs, got):
        assert res is not None
        o_score, _ = wfa_align(q, t, TWOPIECE)
        assert res[0] == o_score
        validate_cigar(res[1], q, t)


@pytest.mark.parametrize("seed", range(6))
def test_dense_random_vs_dense_dp(seed):
    rng = np.random.RandomState(300 + seed)
    q = _random_dna(rng, rng.randint(5, 80))
    t = _random_dna(rng, rng.randint(5, 80))
    for pen in (EDIT, TWOPIECE):
        eng = DenseBandAligner(pen)
        (res,) = eng.align_pairs([(q, t)])
        assert res is not None
        assert res[0] == dense_score(q, t, pen)
        validate_cigar(res[1], q, t)
        assert cigar_score(res[1], pen) == res[0]


def test_align_pairs_with_stats_matches_cigar_reductions():
    import numpy as np
    from allwave.core.cigar import batch_cigar_stats
    from allwave.core.scores import parse_scores
    from allwave.wfa.dense_engine import UnifiedAligner
    from allwave.wfa.params import resolve_penalties

    rng = np.random.RandomState(33)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(12):
        q = rng.choice(bases, rng.randint(50, 200))
        t = q.copy()
        for p in range(0, len(t), 13):
            t[p] = bases[rng.randint(4)]
        # an indel
        t = np.concatenate([t[:20], t[23:]])
        pairs.append((q.tobytes(), t.tobytes()))
    eng = UnifiedAligner(resolve_penalties(parse_scores("0,5,8,2,24,1")))
    results, stats = eng.align_pairs(pairs, with_stats=True)
    expect = batch_cigar_stats(
        [r[1] if r is not None else np.zeros(0, np.uint8) for r in results]
    )
    np.testing.assert_array_equal(stats, expect)


@pytest.mark.slow
def test_segmented_engine_matches_one_shot():
    """Checkpoint-replay segmented alignment (tiny segments to force
    many boundary crossings) is bit-exact vs the one-shot engine."""
    import numpy as np
    from allwave.core.scores import parse_scores
    from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig
    from allwave.wfa.params import resolve_penalties
    from allwave.wfa.segmented import (
        SegmentedConfig,
        SegmentedDenseAligner,
    )

    rng = np.random.RandomState(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for scores_str in ("0,5,8,2,24,1", "0,4,6,2"):
        pen = resolve_penalties(parse_scores(scores_str))
        pairs = []
        for _ in range(5):
            L = rng.randint(300, 900)
            q = rng.choice(bases, L)
            t = q.copy()
            mut = rng.rand(L) < 0.03
            t[mut] = rng.choice(bases, mut.sum())
            t = np.concatenate([t[:100], t[103:]])
            t = np.concatenate([t[:50], rng.choice(bases, 4), t[50:]])
            pairs.append((q.tobytes(), t.tobytes()))
        seg = SegmentedDenseAligner(
            pen, SegmentedConfig(ckpt_every=128)
        )
        one = DenseBandAligner(pen, DenseConfig())
        a = seg.align_pairs(pairs)
        b = one.align_pairs(pairs)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert x[0] == y[0]
                np.testing.assert_array_equal(x[1], y[1])


def test_full_cover_band_certifies():
    """A band covering the whole DP matrix must certify even when the
    score exceeds the exit-and-return bound (highly divergent pair)."""
    import numpy as np
    from allwave.core.scores import parse_scores
    from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig
    from allwave.wfa.params import resolve_penalties

    rng = np.random.RandomState(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = rng.choice(bases, 200).tobytes()
    t = rng.choice(bases, 190).tobytes()  # unrelated: score ~ L*x
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    al = DenseBandAligner(pen, DenseConfig())
    (res,) = al.align_pairs([(q, t)])
    assert res is not None
    from allwave.core.cigar import validate_cigar

    validate_cigar(res[1], q, t)


@pytest.mark.slow
def test_escalation_steps_to_next_ladder_rung():
    """A cert-failure escalation whose certified band is exactly one
    ladder rung up must step to that rung, not double past k_max and
    drop the pair (regression: a 2%-divergence 100 kb pair failed cert
    at K=12288, and 2*K=24576 > k_max skipped the 16384 rung that
    certifies it)."""
    import numpy as np
    from allwave.core.scores import parse_scores
    from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig
    from allwave.wfa.params import resolve_penalties
    from allwave.core.cigar import validate_cigar

    rng = np.random.RandomState(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = rng.choice(bases, 300).tobytes()
    t = rng.choice(bases, 300).tobytes()  # unrelated: banded score ~L*x
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    # start at rung 512; the only rung that can certify is 768 (=k_max);
    # the old 2*k rule jumped 512 -> 1024 > k_max and returned None
    al = DenseBandAligner(
        pen, DenseConfig(k_initial=512, k_max=768)
    )
    (res,) = al.align_pairs([(q, t)])
    assert res is not None, "pair dropped by escalation overshoot"
    validate_cigar(res[1], q, t)
    ref = DenseBandAligner(pen, DenseConfig()).align_pairs([(q, t)])[0]
    assert res[0] == ref[0]
    np.testing.assert_array_equal(res[1], ref[1])


def test_multi_group_wave_dispatch_matches_single(monkeypatch):
    """When a round splits into several dispatch groups and the wave
    size allows it (ALLWAVE_WAVE_G > 1), groups run as ONE device
    dispatch (lax.map over stacked sub-batches) — results must be
    identical to the unconstrained single-group path, including the
    padded final sub-group."""
    monkeypatch.setenv("ALLWAVE_WAVE_G", "3")
    rng = np.random.RandomState(9)
    pairs = []
    for _ in range(11):  # max_batch=4 -> G=3 with a short last group
        q = _random_dna(rng, 120)
        pairs.append((q, _mutate(rng, q, n_snp=3, n_ins=1, n_del=1)))
    wave = DenseBandAligner(TWOPIECE, DenseConfig(max_batch=4))
    single = DenseBandAligner(TWOPIECE, DenseConfig())
    got_w, stats_w = wave.align_pairs(pairs, with_stats=True)
    got_s, stats_s = single.align_pairs(pairs, with_stats=True)
    np.testing.assert_array_equal(stats_w, stats_s)
    for (q, t), rw, rs in zip(pairs, got_w, got_s):
        assert rw is not None and rs is not None
        assert rw[0] == rs[0]
        np.testing.assert_array_equal(rw[1], rs[1])
        validate_cigar(rw[1], q, t)
