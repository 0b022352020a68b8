"""Phase-level profile of the bench.py end-to-end run.

Times orientation, device dispatch enqueue, collect (blocking transfer),
and host-side record emit separately by instrumenting the pipeline.
"""

import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import time
from collections import defaultdict

import numpy as np

from allwave.core.scores import parse_scores
from allwave.core.types import NoSparsification
from allwave.engine.pipeline import AllPairAligner
from allwave.testing.synth import MutationConfig, make_test_case
from allwave.wfa import dense_engine as DE

T = defaultdict(float)
C = defaultdict(int)


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        T[name] += time.perf_counter() - t0
        C[name] += 1
        return out

    return wrap


def main():
    n_seqs, length, div = 128, 1000, 0.02
    cfg = MutationConfig(snp_rate=div, insertion_rate=div / 40, deletion_rate=div / 40)
    case = make_test_case(seed=1234, n_sequences=n_seqs, length=length, cfg=cfg)
    seqs = case.sequences

    DE.DenseBandAligner._dispatch_group = timed(
        "dispatch_enqueue", DE.DenseBandAligner._dispatch_group
    )
    DE.DenseBandAligner._collect_group = timed(
        "collect(host unpack)", DE.DenseBandAligner._collect_group
    )
    DE.DenseBandAligner._build_pool_indexed = timed(
        "build_pool", DE.DenseBandAligner._build_pool_indexed
    )
    orig_orient = AllPairAligner._orient_chunk
    AllPairAligner._orient_chunk = timed("orient_chunk", orig_orient)
    orig_align_pairs = DE.UnifiedAligner.align_pairs_indexed
    DE.UnifiedAligner.align_pairs_indexed = timed(
        "unified_align_pairs", orig_align_pairs
    )
    orig_emit = AllPairAligner._emit_chunk
    AllPairAligner._emit_chunk = staticmethod(timed("emit_chunk", orig_emit))

    # split collect into the device wait/transfer (np.asarray) and the
    # host-side unpack that follows it
    import allwave.utils.telemetry as TEL

    orig_td = TEL.timed_dispatch

    class _TimedXfer:
        def __init__(self, *a):
            self._cm = orig_td(*a)

        def __enter__(self):
            self._t0 = time.perf_counter()
            self._cm.__enter__()
            return self

        def __exit__(self, *exc):
            out = self._cm.__exit__(*exc)
            T["collect:device+xfer"] += time.perf_counter() - self._t0
            C["collect:device+xfer"] += 1
            return out

    TEL.timed_dispatch = _TimedXfer  # dense_engine imports it at call time

    def run_once():
        aligner = AllPairAligner(
            seqs,
            parse_scores("0,5,8,2,24,1"),
            exclude_self=True,
            use_mash_orientation=True,
            sparsification=NoSparsification(),
        )
        out = []
        aligner.for_each_with_callback(out.append)
        return out

    t0 = time.perf_counter()
    run_once()
    print(f"warmup (incl compile): {time.perf_counter()-t0:.1f}s")
    T.clear()
    C.clear()

    best = float("inf")
    for it in range(2):
        T.clear()
        C.clear()
        t0 = time.perf_counter()
        out = run_once()
        dt = time.perf_counter() - t0
        print(f"\nrun {it}: total {dt*1000:.0f} ms, {len(out)/dt:.0f} aln/s")
        known = 0.0
        for k in sorted(T, key=lambda k: -T[k]):
            print(f"  {k:24s} {T[k]*1000:8.1f} ms  x{C[k]}")
        # breakdown inside unified: align = enqueue + xfer + unpack + pool + rest
        inner = (
            T["dispatch_enqueue"]
            + T["collect:device+xfer"]
            + T["collect(host unpack)"]
            + T["build_pool"]
        )
        print(f"  align_pairs other host   {(T['unified_align_pairs']-inner)*1000:8.1f} ms")
        print(f"  pipeline other           {(dt - T['orient_chunk'] - T['unified_align_pairs'])*1000:8.1f} ms (emit overlaps)")


if __name__ == "__main__":
    main()
