"""Native C++ components vs the Python oracles (bit/byte equality)."""

import numpy as np
import pytest

from allwave import native
from allwave.core.scores import parse_scores
from allwave.hashing.siphash import hash_kmers, siphash13
from allwave.wfa.params import resolve_penalties
from allwave.wfa.reference_impl import wfa_align

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def test_siphash_raw_matches():
    lib = native.get_lib()
    for msg in [b"", b"x", b"hello world", bytes(range(100))]:
        assert lib.siphash13_raw(msg, len(msg)) == siphash13(msg)


def test_kmer_hashes_match():
    rng = np.random.RandomState(0)
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=500)
    for k in (3, 15, 16, 31):
        expected = hash_kmers(seq, k)
        got = native.hash_kmers_native(seq, k)
        assert np.array_equal(got, expected), k


def test_wfa_matches_python_oracle():
    rng = np.random.RandomState(1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for pen_str in ("0,1,1,1", "0,5,8,2", "0,5,8,2,24,1"):
        pen = resolve_penalties(parse_scores(pen_str))
        for seed in range(6):
            r = np.random.RandomState(seed)
            q = r.choice(bases, size=r.randint(5, 150)).tobytes()
            t = bytearray(q)
            for _ in range(r.randint(0, 6)):
                i = r.randint(0, len(t))
                t[i] = bases[r.randint(0, 4)]
            if r.randint(0, 2):
                i = r.randint(0, len(t))
                t[i:i] = r.choice(bases, size=r.randint(1, 8)).tobytes()
            t = bytes(t)
            py_score, py_cigar = wfa_align(q, t, pen)
            nat_score, nat_cigar = native.wfa_align_native(q, t, pen)
            assert nat_score == py_score, (pen_str, seed)
            assert nat_cigar.tobytes() == py_cigar.tobytes(), (pen_str, seed)


def test_wfa_native_empty():
    pen = resolve_penalties(parse_scores("0,5,8,2"))
    score, cigar = native.wfa_align_native(b"", b"ACG", pen)
    assert score == pen.o1 + 3 * pen.e1
    assert cigar.tobytes() == b"III"


def test_pair_filter_native_edge_ids():
    """Native keep-filter vs the NumPy oracle on edge-case ids: empty
    id, 1-byte id, id far longer than a SipHash block."""
    import numpy as np

    import allwave.native as N
    from allwave.hashing import siphash as S

    if not N.available():
        import pytest

        pytest.skip("native library unavailable")
    ids = [b"", b"a", b"x" * 300, b"seq:with:colons", b"\xff\x00weird"]
    rng = np.random.RandomState(2)
    qi = rng.randint(0, len(ids), 200).astype(np.int64)
    ti = rng.randint(0, len(ids), 200).astype(np.int64)
    for frac in (0.0, 0.3, 0.9, 1.0):
        got = S.pair_keep_mask_pooled(ids, qi, ti, frac)
        lib, tried = N._lib, N._tried
        N._lib, N._tried = None, True  # force the NumPy path
        try:
            ref = S.pair_keep_mask_pooled(ids, qi, ti, frac)
        finally:
            N._lib, N._tried = lib, tried
        np.testing.assert_array_equal(got, ref)


def test_orient_pairs_native_short_sequences():
    """Sequences shorter than k have empty sketches: the native path
    must match the matrix path (ties -> forward, distance 1.0; the
    self-pair -0.0 quirk included)."""
    import numpy as np

    import allwave.native as N
    from allwave.core.types import Sequence
    from allwave.orient.orientation import OrientationIndex

    if not N.available() or not hasattr(N.get_lib(), "orient_pairs"):
        import pytest

        pytest.skip("native library unavailable")
    seqs = [
        Sequence("a", b"ACGTACGTACGTACGTACGTAC"),
        Sequence("b", b"ACGT"),  # < k: empty sketch
        Sequence("c", b"TTTT"),
    ]
    pairs = np.array([[0, 1], [1, 0], [1, 2], [0, 0]], np.int64)
    dec_n, dist_n = OrientationIndex(seqs)._orient_pairs_native(pairs)
    ref = OrientationIndex(seqs)
    dm = ref._decision_matrix()
    np.testing.assert_array_equal(dec_n, dm[pairs[:, 0], pairs[:, 1]])
    np.testing.assert_array_equal(
        dist_n, ref._distances[pairs[:, 0], pairs[:, 1]]
    )


def test_batch_rle_matches_per_pair():
    """wfa_align_batch_rle must be bit-identical to the per-pair native
    path (scores, expanded CIGARs, and op-count stats), across all
    three penalty modes."""
    import numpy as np
    import pytest

    import allwave.native as N
    from allwave.core.scores import parse_scores
    from allwave.testing.synth import MutationConfig, make_test_case
    from allwave.wfa.params import resolve_penalties

    if not N.available() or not hasattr(N.get_lib(), "wfa_align_batch_rle"):
        pytest.skip("native batch entry unavailable")
    for scores_str, seed in [
        ("0,1,1,1", 31),
        ("0,5,8,2", 32),
        ("0,5,8,2,24,1", 33),
    ]:
        cfg = MutationConfig(
            snp_rate=0.04, insertion_rate=0.002, deletion_rate=0.002
        )
        case = make_test_case(seed=seed, n_sequences=6, length=240, cfg=cfg)
        seqs = [s.seq for s in case.sequences]
        pen = resolve_penalties(parse_scores(scores_str))
        qidx, tidx = [], []
        for i in range(6):
            for j in range(6):
                if i != j:
                    qidx.append(i)
                    tidx.append(j)
        qidx, tidx = np.asarray(qidx), np.asarray(tidx)
        sc, ro, rl, off, st = N.wfa_align_batch_rle_native(
            seqs, qidx, tidx, pen
        )
        for p in range(len(qidx)):
            ref_score, ref_cigar = N.wfa_align_native(
                seqs[qidx[p]], seqs[tidx[p]], pen
            )
            got = np.repeat(
                ro[off[p] : off[p + 1]],
                rl[off[p] : off[p + 1]].astype(np.int64),
            )
            assert ref_score == sc[p]
            np.testing.assert_array_equal(ref_cigar, got)
            counts = [
                int(np.count_nonzero(ref_cigar == ord(c))) for c in "MXID"
            ]
            assert counts == st[p].tolist()


def test_host_route_results_identical():
    """The small-workload host router (UnifiedAligner._route_all_host)
    must produce the same results as the device/XLA path — forced on
    via ALLWAVE_HOST_ROUTE=1 on the CPU backend."""
    import os

    import numpy as np
    import pytest

    import allwave.native as N
    from allwave.core.scores import parse_scores
    from allwave.testing.synth import MutationConfig, make_test_case
    from allwave.wfa.dense_engine import UnifiedAligner
    from allwave.wfa.params import resolve_penalties

    if not N.available() or not hasattr(N.get_lib(), "wfa_align_batch_rle"):
        pytest.skip("native batch entry unavailable")
    cfg = MutationConfig(
        snp_rate=0.02, insertion_rate=0.0005, deletion_rate=0.0005
    )
    case = make_test_case(seed=41, n_sequences=8, length=300, cfg=cfg)
    seqs = [s.seq for s in case.sequences]
    pen = resolve_penalties(parse_scores("0,1,1,1"))
    qidx = np.asarray([i for i in range(8) for j in range(8) if i != j])
    tidx = np.asarray([j for i in range(8) for j in range(8) if i != j])
    hint = np.full(len(qidx), 40, np.int64)

    def run(route):
        os.environ["ALLWAVE_HOST_ROUTE"] = route
        try:
            eng = UnifiedAligner(pen)
            return eng.align_pairs_indexed(
                seqs, qidx, tidx, with_stats=True, sigma_hint=hint
            )
        finally:
            del os.environ["ALLWAVE_HOST_ROUTE"]

    res_host, st_host = run("1")
    res_dev, st_dev = run("0")
    np.testing.assert_array_equal(st_host, st_dev)
    for a, b in zip(res_host, res_dev):
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
