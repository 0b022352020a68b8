"""Seeded cross-engine fuzz: random penalty sets (edit-distance,
single-piece, two-piece), random mutation styles (identical, SNP+indel,
unrelated, tandem-repeat tie stress, N/lowercase bytes) — the XLA
engine, the batched pipeline path, and the native C++ oracle must agree
bit-for-bit on scores and CIGARs, and every CIGAR must replay."""

import numpy as np
import pytest

from allwave import native
from allwave.core.cigar import validate_cigar
from allwave.core.types import AlignmentParams
from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig
from allwave.wfa.params import resolve_penalties


def _rand_params(rng):
    mode = rng.randint(3)
    x = int(rng.randint(1, 9))
    if mode == 0:
        return AlignmentParams(0, x, x, x)
    go = int(rng.randint(1, 30))
    ge = int(rng.randint(1, 6))
    if mode == 1:
        return AlignmentParams(0, x, go, ge)
    go2 = int(rng.randint(go, 60))
    ge2 = max(1, ge - rng.randint(0, ge))
    return AlignmentParams(0, x, go, ge, go2, ge2)


def _rand_pair(rng, acgt, noisy):
    L = int(rng.choice([8, 40, 130, 400]))
    q = rng.choice(acgt, L)
    style = rng.randint(4)
    if style == 0:
        t = q.copy()
    elif style == 1:
        t = q.copy()
        mut = rng.rand(L) < rng.choice([0.02, 0.08, 0.3])
        t[mut] = rng.choice(noisy, mut.sum())
        for _ in range(rng.randint(0, 3)):
            p = rng.randint(0, max(1, len(t)))
            ln = rng.randint(1, 15)
            if rng.rand() < 0.5:
                t = np.concatenate([t[:p], t[p + ln :]])
            else:
                t = np.concatenate([t[:p], rng.choice(acgt, ln), t[p:]])
    elif style == 2:
        t = rng.choice(acgt, int(rng.randint(1, L + 20)))
    else:
        unit = rng.choice(acgt, rng.randint(1, 7))
        t = np.tile(unit, L // len(unit) + 1)[:L]
        q = np.tile(unit, (L + 12) // len(unit) + 1)[
            : L + rng.randint(-6, 12)
        ]
    return q.tobytes(), t.tobytes()


@pytest.mark.parametrize(
    "seed",
    [
        pytest.param(3, marks=pytest.mark.slow),
        17,
        pytest.param(41, marks=pytest.mark.slow),
    ],
)
def test_fuzz_engines_vs_oracle(seed):
    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    noisy = np.frombuffer(b"ACGTacgtNn", dtype=np.uint8)
    for _ in range(4):
        params = _rand_params(rng)
        pen = resolve_penalties(params)
        eng = DenseBandAligner(pen, DenseConfig())
        pairs = [_rand_pair(rng, acgt, noisy) for _ in range(3)]
        results = eng.align_pairs(pairs)
        for i, r in enumerate(results):
            assert r is not None
            score, cigar = r
            validate_cigar(cigar, pairs[i][0], pairs[i][1])
            o = native.wfa_align_native(pairs[i][0], pairs[i][1], pen)
            if o is not None:  # native lib is present in CI/dev images
                oscore, ocigar = o
                assert oscore == score, (params, i)
                np.testing.assert_array_equal(np.asarray(ocigar), cigar)
