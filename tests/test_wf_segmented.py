"""Wavefront checkpoint-replay engine (wfa/wf_segmented.py).

The long-pair analog of the reference's always-on biWFA low-memory mode
(reference src/alignment.rs:265-287): O(s*K) compute, O(s/C)
checkpoint memory, bit-exact scores AND CIGARs vs the dense engines.
Includes the 100 kb end-to-end case from the reference suite
(reference tests/integration_tests.rs:557-597).
"""

import os

import numpy as np
import pytest

from allwave.core.scores import parse_scores
from allwave.wfa.params import resolve_penalties
from allwave.wfa.dense_engine import DenseBandAligner, UnifiedAligner
from allwave.wfa.wf_segmented import (
    WavefrontSegmentedAligner,
    WfSegConfig,
)

TWOPIECE = resolve_penalties(parse_scores("0,5,8,2,24,1"))
AFFINE = resolve_penalties(parse_scores("0,5,8,2"))
EDIT = resolve_penalties(parse_scores("0,1,1,1"))

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutated_pair(rng, L, div, indel=0.002):
    q = rng.choice(_BASES, L).astype(np.uint8)
    t = q.copy()
    m = rng.rand(L) < div
    t[m] = rng.choice(_BASES, int(m.sum()))
    n_ind = max(1, int(L * indel))
    t = np.delete(t, rng.randint(0, len(t), n_ind))
    pos = rng.randint(0, len(t), n_ind)
    t = np.insert(t, pos, rng.choice(_BASES, n_ind))
    return q.tobytes(), t.tobytes()


@pytest.mark.parametrize(
    "pen",
    [
        pytest.param(EDIT, marks=pytest.mark.slow, id="edit"),
        pytest.param(AFFINE, marks=pytest.mark.slow, id="affine"),
        pytest.param(TWOPIECE, id="2p"),
    ],
)
def test_bit_exact_vs_dense(pen):
    rng = np.random.RandomState(11)
    pairs = [_mutated_pair(rng, L, d) for L, d in
             [(500, 0.0), (500, 0.02), (700, 0.06), (1100, 0.01)]]
    pairs.append((pairs[0][0], pairs[0][0]))  # identical
    dense = DenseBandAligner(pen).align_pairs(pairs)
    wf = WavefrontSegmentedAligner(
        pen, WfSegConfig(ckpt_every=64, s_cap_initial=128)
    ).align_pairs(pairs)
    for i, (d, w) in enumerate(zip(dense, wf)):
        assert not isinstance(w, str) and w is not None, f"pair {i}: {w}"
        assert d[0] == w[0], f"pair {i}: score {d[0]} vs {w[0]}"
        np.testing.assert_array_equal(np.asarray(d[1]), np.asarray(w[1]))


def test_escalation_from_bad_hint():
    """A hint far below the true score must escalate (s_cap growth) and
    still produce the exact result."""
    rng = np.random.RandomState(23)
    pairs = [_mutated_pair(rng, 800, 0.08)]
    dense = DenseBandAligner(TWOPIECE).align_pairs(pairs)
    wf = WavefrontSegmentedAligner(
        TWOPIECE, WfSegConfig(ckpt_every=64, s_cap_initial=64)
    ).align_pairs(pairs, sigma_hint=[4])
    assert wf[0][0] == dense[0][0]
    np.testing.assert_array_equal(np.asarray(wf[0][1]), np.asarray(dense[0][1]))


def test_dense_fallback_sentinel():
    """Pairs whose score cap exceeds the ceiling return the sentinel
    instead of a wrong/failed result."""
    rng = np.random.RandomState(31)
    q, t = _mutated_pair(rng, 600, 0.5, indel=0.02)  # ~50% divergence
    wf = WavefrontSegmentedAligner(
        TWOPIECE, WfSegConfig(ckpt_every=64, s_cap_initial=64, s_cap_max=128)
    ).align_pairs([(q, t)])
    assert wf[0] is WavefrontSegmentedAligner.DENSE_FALLBACK


@pytest.mark.slow
def test_unified_long_pair_routing():
    """The wavefront long-pair route (ALLWAVE_WFSEG=1) stays bit-exact
    vs the default dense-segmented route."""
    rng = np.random.RandomState(47)
    pairs = [
        _mutated_pair(rng, 20_000, 0.01),
        _mutated_pair(rng, 20_000, 0.002),
    ]
    os.environ["ALLWAVE_WFSEG"] = "1"  # wavefront-first routing
    try:
        ua = UnifiedAligner(TWOPIECE, dense_max_len=4096)
        out = ua.align_pairs(pairs)
    finally:
        del os.environ["ALLWAVE_WFSEG"]
    ua2 = UnifiedAligner(TWOPIECE, dense_max_len=4096)
    ref = ua2.align_pairs(pairs)
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a[0] == b[0], f"pair {i}"
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.mark.slow
def test_long_sequences_100kb():
    """Reference: tests/integration_tests.rs:557-597 — a 100 kb pair
    with SNPs + indels must align end-to-end with >95% coverage and a
    >95 kb alignment length."""
    from allwave.core.cigar import (
        count_cigar_operations,
        parse_cigar_lengths,
        validate_cigar,
    )
    from allwave.testing.synth import MutationConfig, make_test_case

    cfg = MutationConfig(
        snp_rate=0.002,
        insertion_rate=0.0001,
        deletion_rate=0.0001,
        n_microsatellites=1,
    )
    case = make_test_case(seed=300, n_sequences=2, length=100_000, cfg=cfg, gc=0.45)
    q = case.sequences[0].seq
    t = case.sequences[1].seq
    ua = UnifiedAligner(TWOPIECE)
    score, cigar = ua.align_pairs([(q, t)], sigma_hint=[2000])[0]
    validate_cigar(cigar, q, t)
    qlen, tlen = parse_cigar_lengths(cigar)
    assert qlen == len(q) and tlen == len(t)  # global: full consumption
    matches, aln_len = count_cigar_operations(cigar)
    assert aln_len > 95_000
    assert matches / aln_len > 0.95


def test_round_keys_coalesce_nearby_hints():
    """Nearby mash hints must land in ONE (K, s_cap) round: fine-grained
    s_cap keys fragmented a 12-pair 100 kb workload into batch-of-4
    dispatches (3x wall time), and a raw 4*smax+64 run_cap forced a
    fresh kernel compile per group."""
    wf = WavefrontSegmentedAligner(TWOPIECE)
    keys = set()
    for hint in (2534, 2577, 2636, 2669, 2726, 2773):
        si = wf._s_cap_for_hint(hint)
        ki = wf._k_for_score(si // 2, 0)
        keys.add((ki, si))
    assert len(keys) == 1, keys
    # s_cap and run_cap are pow2-bucketed (static jit args / round keys)
    si = next(iter(keys))[1]
    assert si & (si - 1) == 0
    cap = WavefrontSegmentedAligner._run_cap(
        np.array([2600, 2700]), np.array([True, True])
    )
    assert cap & (cap - 1) == 0


def test_k_margin_covers_hint_underestimate():
    """K sized from the raw hint fails certification whenever the actual
    score exceeds the hint (cert needs K ~ score); the 1.5x sigma margin
    must certify a score up to ~1.4x the hint in one sweep."""
    wf = WavefrontSegmentedAligner(TWOPIECE)
    hint = 2600
    k = wf._k_for_score(wf._s_cap_for_hint(hint) // 2, 0)
    # exit-and-return certificate bound at band k (same formula as
    # _run_group): score < 2*min(o1 + nn*e1, o2 + nn*e2)
    slack = (k - 1) // 2
    nn = slack + 1
    bound = 2 * min(
        TWOPIECE.o1 + nn * TWOPIECE.e1, TWOPIECE.o2 + nn * TWOPIECE.e2
    )
    assert bound > int(1.4 * hint)
