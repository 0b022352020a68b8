"""Large seeded cross-engine fuzz battery (VERDICT r3 item 5).

Every case runs through the XLA dense engine and the native C++ oracle,
and (for in-range cases) the segmented dense engine and the XLA
wavefront checkpoint-replay engine — scores and CIGARs must agree
BIT-FOR-BIT and every CIGAR must replay cleanly. A single flipped
tie-break bit in any engine fails a shard.

Scale: 8 slow shards x ~130 cases + 1 fast shard = >1,000 generated
cases per full run (pytest tests/ -m "slow or not slow"), covering
- all three penalty modes (edit / single-affine / two-piece),
- lengths 8..2000 (2 kb cases kept low-divergence so the dense band
  stays narrow and the battery stays minutes, not hours),
- tie stress: tandem repeats, homopolymers, equal-cost gap placements,
- N / lowercase bytes (mismatch-only, same as the reference's
  reverse_complement contract),
- empty-ish and wildly length-mismatched pairs.

The default suite runs only shard 0 (fast tier); the full battery runs
under the `slow` marker.
"""

import numpy as np
import pytest

from allwave import native
from allwave.core.cigar import validate_cigar
from allwave.core.types import AlignmentParams
from allwave.wfa.dense_engine import DenseBandAligner, DenseConfig
from allwave.wfa.params import resolve_penalties
from allwave.wfa.segmented import SegmentedDenseAligner, SegmentedConfig
from allwave.wfa.wf_segmented import WavefrontSegmentedAligner, WfSegConfig

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
NOISY = np.frombuffer(b"ACGTacgtNn", dtype=np.uint8)


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


def _rand_pair(rng, fast=False):
    style = rng.randint(5 if fast else 6)
    if style == 5:  # long, low-divergence (the 2 kb tier)
        L = 2000
        q = rng.choice(ACGT, L)
        t = q.copy()
        mut = rng.rand(L) < 0.005
        t[mut] = rng.choice(NOISY, mut.sum())
        for _ in range(rng.randint(0, 3)):
            p = rng.randint(0, max(1, len(t)))
            ln = rng.randint(1, 12)
            if rng.rand() < 0.5:
                t = np.concatenate([t[:p], t[p + ln :]])
            else:
                t = np.concatenate([t[:p], rng.choice(ACGT, ln), t[p:]])
        return q.tobytes(), t.tobytes()
    L = int(rng.choice([8, 40, 130, 400] if fast else [8, 40, 130, 400, 700]))
    q = rng.choice(ACGT, L)
    if style == 0:  # identical
        t = q.copy()
    elif style == 1:  # SNPs + indels, with noisy bytes
        t = q.copy()
        mut = rng.rand(L) < rng.choice([0.02, 0.08, 0.3])
        t[mut] = rng.choice(NOISY, mut.sum())
        for _ in range(rng.randint(0, 4)):
            p = rng.randint(0, max(1, len(t)))
            ln = rng.randint(1, 15)
            if rng.rand() < 0.5:
                t = np.concatenate([t[:p], t[p + ln :]])
            else:
                t = np.concatenate([t[:p], rng.choice(ACGT, ln), t[p:]])
    elif style == 2:  # unrelated, mismatched lengths
        t = rng.choice(ACGT, int(rng.randint(1, min(L + 20, 240))))
        q = q[: rng.randint(1, L + 1)]
    elif style == 3:  # tandem repeats / homopolymers: tie-break stress
        unit = rng.choice(ACGT, rng.randint(1, 7))
        t = np.tile(unit, L // len(unit) + 1)[:L]
        q = np.tile(unit, (L + 12) // len(unit) + 1)[: L + rng.randint(-6, 12)]
        if rng.rand() < 0.3:  # drop a unit mid-way: equal-cost gap sites
            p = rng.randint(0, max(1, len(q) - len(unit)))
            q = np.concatenate([q[:p], q[p + len(unit) :]])
    else:  # style 4: one clean structural event in a clean background
        t = q.copy()
        p = rng.randint(0, max(1, L - 30))
        ln = rng.randint(15, 30)
        if rng.rand() < 0.5:
            t = np.concatenate([t[:p], t[p + ln :]])
        else:
            t = np.concatenate([t[:p], rng.choice(ACGT, ln), t[p:]])
    return q.tobytes(), t.tobytes()


def _check_dense_vs_oracle(pen, params, pairs):
    """Dense XLA engine vs native oracle, bit-for-bit; returns results."""
    dense = DenseBandAligner(pen, DenseConfig())
    res = dense.align_pairs(pairs)
    for i, r in enumerate(res):
        assert r is not None, (params, i)
        score, cigar = r
        validate_cigar(cigar, pairs[i][0], pairs[i][1])
        o = native.wfa_align_native(pairs[i][0], pairs[i][1], pen)
        assert o is not None
        assert o[0] == score, (params, i, o[0], score)
        np.testing.assert_array_equal(np.asarray(o[1]), cigar)
    return res


def _run_shard(seed, n_rounds, pairs_per_round, with_segmented=True, fast=False):
    """dense-vs-oracle across n_rounds random penalty sets, plus ONE
    segmented + wavefront cross-check round (their per-penalty jit
    compiles cost ~100 s each on CPU, so each shard pins one penalty
    set for them — the 8 slow shards together still cover 8 sets)."""
    import os

    rng = np.random.RandomState(seed)
    if not native.available():
        pytest.skip("native oracle unavailable")
    # single-device dispatch: the 8-virtual-device mesh path (covered by
    # test_parallel) multiplies every per-shape compile ~8x here
    os.environ["ALLWAVE_SINGLE_DEVICE"] = "1"
    try:
        n_checked = _run_shard_inner(
            rng, n_rounds, pairs_per_round, with_segmented, fast
        )
    finally:
        os.environ.pop("ALLWAVE_SINGLE_DEVICE", None)
    return n_checked


def _run_shard_inner(rng, n_rounds, pairs_per_round, with_segmented, fast):
    n_checked = 0
    for _ in range(n_rounds):
        params = _rand_params(rng)
        pen = resolve_penalties(params)
        pairs = [_rand_pair(rng, fast) for _ in range(pairs_per_round)]
        _check_dense_vs_oracle(pen, params, pairs)
        n_checked += len(pairs)
    if with_segmented:
        params = _rand_params(rng)
        pen = resolve_penalties(params)
        pairs = [_rand_pair(rng, fast) for _ in range(pairs_per_round)]
        res_d = _check_dense_vs_oracle(pen, params, pairs)
        seg = SegmentedDenseAligner(
            pen, SegmentedConfig(ckpt_every=512)
        )
        wf = WavefrontSegmentedAligner(
            pen,
            WfSegConfig(k_max=1024, s_cap_max=2048, ckpt_every=128),
        )
        res_s = seg.align_pairs(pairs)
        res_w = wf.align_pairs(pairs)
        for i, r in enumerate(res_d):
            score, cigar = r
            rs = res_s[i]
            assert rs is not None and rs[0] == score, (params, i)
            np.testing.assert_array_equal(rs[1], cigar)
            rw = res_w[i]
            if isinstance(rw, tuple):  # within the wf engine's caps
                assert rw[0] == score, (params, i)
                np.testing.assert_array_equal(rw[1], cigar)
        n_checked += len(pairs)
    return n_checked


def test_fuzz_battery_fast_shard():
    # dense-vs-oracle only: the seg/wf engines compile ~2 min of XLA
    # per penalty set on CPU and are covered by the slow shards
    assert _run_shard(1000, 6, 6, with_segmented=False, fast=True) == 36


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1001 + i for i in range(8)])
def test_fuzz_battery_slow_shard(seed):
    # 8 shards x (15 dense rounds + 1 all-engine round) x 8 pairs
    # = 1,024 slow-tier cases
    assert _run_shard(seed, 15, 8) == 128
