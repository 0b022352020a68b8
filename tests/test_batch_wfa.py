"""Batched JAX wavefront engine vs the scalar oracle: scores AND CIGARs
must agree byte-for-byte (same tie-break)."""

import numpy as np
import pytest

from allwave.core.cigar import validate_cigar
from allwave.core.scores import parse_scores
from allwave.testing.dense import cigar_score, dense_score
from allwave.wfa.engine import BatchWavefrontAligner, EngineConfig
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
        old = s[i]
        s[i] = [b for b in b"ACGT" if b != old][rng.randint(0, 3)]
    for _ in range(n_ins):
        i = rng.randint(0, len(s))
        s[i:i] = _random_dna(rng, rng.randint(1, max_indel))
    for _ in range(n_del):
        if len(s) > 2 * max_indel:
            i = rng.randint(0, len(s) - max_indel)
            del s[i : i + rng.randint(1, max_indel)]
    return bytes(s)


def _pairs_suite(seed=0):
    rng = np.random.RandomState(seed)
    pairs = []
    # identical
    q = _random_dna(rng, 80)
    pairs.append((q, q))
    # SNPs only
    q = _random_dna(rng, 120)
    pairs.append((q, _mutate(rng, q, n_snp=4)))
    # indels
    q = _random_dna(rng, 150)
    pairs.append((q, _mutate(rng, q, n_ins=2, n_del=1)))
    # mixed
    q = _random_dna(rng, 200)
    pairs.append((q, _mutate(rng, q, n_snp=5, n_ins=2, n_del=2)))
    # unrelated short
    pairs.append((_random_dna(rng, 30), _random_dna(rng, 37)))
    # length-skewed
    q = _random_dna(rng, 90)
    pairs.append((q, q[:40]))
    pairs.append((q[10:70], q))
    # empty edge cases
    pairs.append((b"", b"ACGTT"))
    pairs.append((b"ACG", b""))
    return pairs


@pytest.mark.parametrize("pen", [EDIT, AFFINE, TWOPIECE], ids=["edit", "affine", "2p"])
def test_batch_matches_oracle(pen):
    pairs = _pairs_suite()
    eng = BatchWavefrontAligner(pen)
    got = eng.align_pairs(pairs)
    for (q, t), (score, cigar) in zip(pairs, got):
        o_score, o_cigar = wfa_align(q, t, pen)
        assert score == o_score, (q, t)
        validate_cigar(cigar, q, t)
        assert cigar.tobytes() == o_cigar.tobytes(), (
            q,
            t,
            cigar.tobytes(),
            o_cigar.tobytes(),
        )


def test_batch_scores_vs_dense_random():
    rng = np.random.RandomState(9)
    pairs = []
    for _ in range(12):
        q = _random_dna(rng, rng.randint(10, 120))
        t = _mutate(rng, q, n_snp=rng.randint(0, 5), n_ins=rng.randint(0, 2), n_del=rng.randint(0, 2))
        pairs.append((q, t))
    for pen in (EDIT, TWOPIECE):
        eng = BatchWavefrontAligner(pen)
        got = eng.align_pairs(pairs)
        for (q, t), (score, cigar) in zip(pairs, got):
            assert score == dense_score(q, t, pen)
            validate_cigar(cigar, q, t)
            assert cigar_score(cigar, pen) == score


def test_score_discovery_escalation():
    # a pair needing more than the initial cap forces escalation
    rng = np.random.RandomState(11)
    q = _random_dna(rng, 400)
    t = _mutate(rng, q, n_snp=40, n_ins=3, n_del=3)
    pen = TWOPIECE
    eng = BatchWavefrontAligner(
        pen, EngineConfig(s_cap_initial=16, s_cap_growth=4)
    )
    (score, cigar), = eng.align_pairs([(q, t)])
    o_score, o_cigar = wfa_align(q, t, pen)
    assert score == o_score
    assert cigar.tobytes() == o_cigar.tobytes()


def test_longer_sequences_smoke():
    rng = np.random.RandomState(21)
    q = _random_dna(rng, 2000)
    t = _mutate(rng, q, n_snp=20, n_ins=3, n_del=3)
    eng = BatchWavefrontAligner(TWOPIECE)
    (score, cigar), = eng.align_pairs([(q, t)])
    validate_cigar(cigar, q, t)
    assert cigar_score(cigar, TWOPIECE) == score
