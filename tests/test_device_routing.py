"""Routing that does not depend on which accelerator JAX found, and
device errors that are never hidden.

With jax.default_backend() reporting "gpu", the dense engine runs the
XLA scan, long pairs go to the dense segmented engine, and no TPU-only
module is imported. A device error in the orientation or MinHash
matmul paths propagates; only the over-budget MemoryError those paths
raise themselves, before any dispatch, is served on the host."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from allwave import native
from allwave.core.scores import parse_scores
from allwave.core.types import Sequence
from allwave.wfa.params import resolve_penalties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEN = resolve_penalties(parse_scores("0,5,8,2,24,1"))


@pytest.fixture
def gpu_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _pairs(seed, n, length, every=17):
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(n):
        q = rng.choice(bases, length).tobytes()
        t = bytearray(q)
        for p in range(0, len(t), every):
            t[p] = bases[rng.randint(4)]
        pairs.append((q, bytes(t)))
    return pairs


def _seqs(seed, n, length=300):
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    root = rng.choice(bases, length)
    out = []
    for i in range(n):
        t = root.copy()
        mut = rng.rand(length) < rng.uniform(0.01, 0.3)
        t[mut] = bases[rng.randint(0, 4, mut.sum())]
        out.append(Sequence(f"s{i}", t.tobytes()))
    return out


def test_dense_engine_takes_xla_path_on_gpu(gpu_backend, monkeypatch):
    from allwave.wfa.dense_engine import DenseBandAligner

    calls = []
    orig = DenseBandAligner._dispatch_group

    def spy(self, group, *a, **kw):
        calls.append(len(group))
        return orig(self, group, *a, **kw)

    monkeypatch.setattr(DenseBandAligner, "_dispatch_group", spy)
    pairs = _pairs(4, 5, 90)
    out = DenseBandAligner(PEN).align_pairs(pairs)
    assert sum(calls) >= len(pairs)  # every pair went through a device dispatch
    for (q, t), r in zip(pairs, out):
        score, cigar = native.wfa_align_native(q, t, PEN)
        assert r[0] == score
        np.testing.assert_array_equal(r[1], cigar)


def test_long_pairs_go_to_dense_segmented_on_gpu(gpu_backend, monkeypatch):
    from allwave.wfa import dense_engine as DE
    from allwave.wfa.segmented import SegmentedDenseAligner
    from allwave.wfa.wf_segmented import WavefrontSegmentedAligner

    monkeypatch.delenv("ALLWAVE_WFSEG", raising=False)
    monkeypatch.setenv("ALLWAVE_HOST_ROUTE", "0")  # keep the tiny set on device
    seen = []
    orig = SegmentedDenseAligner.align_pairs

    def seg_spy(self, pairs, sigma_hint=None):
        seen.append(len(pairs))
        return orig(self, pairs, sigma_hint=sigma_hint)

    def wf_forbidden(self, *a, **kw):
        raise AssertionError("wavefront engine must not be the default route")

    monkeypatch.setattr(SegmentedDenseAligner, "align_pairs", seg_spy)
    monkeypatch.setattr(WavefrontSegmentedAligner, "align_pairs", wf_forbidden)
    pairs = _pairs(6, 3, 200, every=23)
    al = DE.UnifiedAligner(PEN, dense_max_len=128)
    out = al.align_pairs(pairs, sigma_hint=[80] * len(pairs))
    assert seen == [len(pairs)]
    for (q, t), r in zip(pairs, out):
        score, cigar = native.wfa_align_native(q, t, PEN)
        assert r[0] == score
        np.testing.assert_array_equal(r[1], cigar)


def test_no_tpu_kernels_anywhere():
    pkg = os.path.join(REPO, "allwave")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "pallas" not in text.lower(), name
                assert 'default_backend() == "tpu"' not in text, name
    code = (
        "import sys\n"
        "import allwave, allwave.cli, allwave.parallel.mesh\n"
        "from allwave.wfa import dense_engine, segmented, wf_segmented\n"
        "bad = [m for m in sys.modules if m.startswith('jax.experimental.pallas')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, check=True, timeout=300
    )


def _sketches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [
        np.unique(rng.randint(0, 5000, size=40).astype(np.uint64)) for _ in range(n)
    ]


def test_intersection_device_error_propagates(gpu_backend, monkeypatch):
    from allwave.sketch import minhash as M

    def broken(*a, **kw):
        raise RuntimeError("device failure")

    monkeypatch.setattr(M, "_membership_counts", broken)
    with pytest.raises(RuntimeError, match="device failure"):
        M.pairwise_intersection_counts(_sketches(M.DEVICE_MIN_N))


def test_intersection_over_budget_served_on_host(gpu_backend, monkeypatch):
    from allwave.sketch import minhash as M

    sk = _sketches(M.DEVICE_MIN_N, seed=1)
    sizes = np.array([s.size for s in sk], dtype=np.int64)

    def over_budget(*a, **kw):
        raise MemoryError("membership matrix over device budget")

    monkeypatch.setattr(M, "_intersection_counts_device", over_budget)
    np.testing.assert_array_equal(
        M.pairwise_intersection_counts(sk), M._intersection_counts_host(sk, sizes)
    )


def test_decision_device_error_propagates(gpu_backend, monkeypatch):
    from allwave.orient import orientation as O

    def broken(*a, **kw):
        raise RuntimeError("device failure")

    monkeypatch.setattr(O, "_decide_device", broken)
    seqs = _seqs(2, O.DEVICE_MIN_N)
    n = len(seqs)
    idx = [(i, j) for i in range(n) for j in range(n) if i != j]
    with pytest.raises(RuntimeError, match="device failure"):
        O.OrientationIndex(seqs).orient_batch(idx)


def test_decision_over_budget_served_on_host(gpu_backend, monkeypatch):
    from allwave.orient import orientation as O

    def never(*a, **kw):
        raise AssertionError("dispatched despite the budget check")

    monkeypatch.setattr(O, "_decide_device", never)
    monkeypatch.setattr(O.OrientationIndex, "DEVICE_MEMBERSHIP_MAX", 1)
    seqs = _seqs(3, O.DEVICE_MIN_N)
    n = len(seqs)
    idx = np.array([(i, j) for i in range(n) for j in range(n) if i != j])
    got = O.OrientationIndex(seqs).orient_batch(idx)
    want = O.OrientationIndex(seqs)._decision_matrix()[idx[:, 0], idx[:, 1]]
    np.testing.assert_array_equal(got, want)
