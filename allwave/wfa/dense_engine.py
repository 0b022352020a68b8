"""Host orchestration for the dense banded engine + the unified
length-routed aligner.

DenseBandAligner is TRACE-FIRST: one fused device dispatch per batch
runs forward + on-device traceback at the initial band width; pairs
whose banded score carries the optimality certificate are done, the
rest escalate to a wider band computed directly from their banded score
(banded >= true score, so the jump is conservative).  At pangenome
divergences almost every pair certifies at the first K, so the common
case costs exactly one device round trip.

The forward sweep is the XLA anti-diagonal scan (dense.dense_forward)
on every backend.

UnifiedAligner routes short pairs to the dense engine (L*K work, zero
gathers, single scan) and long pairs to the segmented checkpoint-replay
engines.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .params import Penalties
from . import dense as D_
from .batch import expand_runs_batch
from .engine import BatchWavefrontAligner, EngineConfig


@dataclass
class DenseConfig:
    k_initial: int = 128
    k_max: int = 1 << 14
    #: memory budget for the (2L, B, K) choice+runlen planes of one batch
    choices_budget_bytes: int = 4 << 30
    max_batch: int = 4096
    #: run buffer width fetched per pair; overflowing pairs (rare — more
    #: mutation events than this) rerun with the full 2L+8 cap
    run_cap_initial: int = 128


#: byte -> 4 WFA2 op chars, inverting dense_align_packed's 2-bit op
#: packing (code 0=M, 1=X, 2=I, 3=D; little-endian within the byte)
_OPS_UNPACK_LUT = np.empty((256, 4), np.uint8)
for _b in range(256):
    for _j in range(4):
        _OPS_UNPACK_LUT[_b, _j] = b"MXID"[(_b >> (2 * _j)) & 3]


class _AsyncResult:
    """Handle for an in-flight align call: the initial dispatches are
    already enqueued on the device; .finish() blocks on the transfers,
    runs any escalation rounds, and returns the results. finish() may
    be called exactly once."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def finish(self):
        return self._fn()


class _ReadyResult:
    """Degenerate handle for results that are already complete."""

    __slots__ = ("_res",)

    def __init__(self, res):
        self._res = res

    def finish(self):
        return self._res


class DenseBandAligner:
    def __init__(self, pen: Penalties, config: Optional[DenseConfig] = None):
        from ..utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.pen = pen
        self.config = config or DenseConfig()
        self._sharded_steps: Dict[Tuple[int, int, int], object] = {}
        self._mesh = None

    def _local_mesh(self):
        """Lazy ("data",) mesh over ALL local devices — the production
        intra-host fan-out (SURVEY §2.4: the reference saturates a host
        with rayon, main.rs:130-133; here every local chip gets a pair
        shard via shard_map with the sequence pool replicated)."""
        if self._mesh is None:
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh(diag=1)
        return self._mesh

    def _use_mesh(self) -> bool:
        if os.environ.get("ALLWAVE_SINGLE_DEVICE") == "1":
            return False
        import jax

        return jax.local_device_count() > 1

    def _sharded_fn(self, k: int, run_cap: int, l_pad: int):
        key = (k, run_cap, l_pad)
        fn = self._sharded_steps.get(key)
        if fn is None:
            from ..parallel.mesh import sharded_dense_step

            fn = sharded_dense_step(
                self._local_mesh(), self.pen, k, l_pad, run_cap
            )
            self._sharded_steps[key] = fn
        return fn

    @staticmethod
    def _next_pow2(n: int) -> int:
        return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 1)

    #: accepted band widths: a {1, 1.5} x pow2 ladder of 128-multiples
    #: (up to 25% less band work than pure powers of two) plus 192 and
    #: 320. A 2x rung step costs up to 2x band cells on hint-sized
    #: rounds (e.g. a 189-wide certified band forced onto K=256);
    #: 192/320 cut that worst-case overshoot to 1.5x at the cost of two
    #: more compiled shapes. Every rung is one compiled shape, so the
    #: ladder stays short.
    K_LADDER = sorted(
        {128 << i for i in range(8)} | {384 << i for i in range(6)} | {192, 320}
    )

    def _round_k(self, k: int) -> int:
        """Smallest accepted band width >= k."""
        for v in self.K_LADDER:
            if v >= k:
                return v
        return self.K_LADDER[-1]

    def _k_for_score(self, sigma: int, kend_abs: int) -> int:
        """Smallest accepted band width whose exit-and-return
        certificate holds for a banded score sigma: the bound is
        2*g(W+1) with g(n) = min(o1+n*e1, o2+n*e2), so we need the
        minimal n with g(n) >= sigma//2 + 1 on BOTH pieces."""
        t = sigma // 2 + 1
        n = max(1, -(-(t - self.pen.o1) // self.pen.e1))
        if self.pen.two_piece:
            n = max(n, -(-(t - self.pen.o2) // self.pen.e2))
        w = n - 1
        k = kend_abs + 2 * max(w, 0) + 3
        return min(
            self._round_k(max(k, self.config.k_initial)), self.config.k_max
        )

    def _round_ks(self, k: np.ndarray) -> np.ndarray:
        """Vectorized _round_k over an int64 array."""
        ladder = np.asarray(self.K_LADDER, dtype=np.int64)
        idx = np.searchsorted(ladder, k).clip(0, ladder.size - 1)
        return ladder[idx]

    def _k_for_scores(self, sigma: np.ndarray, kend_abs: np.ndarray) -> np.ndarray:
        """Vectorized _k_for_score (same formula element-for-element)."""
        t = sigma // 2 + 1
        n1 = np.maximum(1, -(-(t - self.pen.o1) // self.pen.e1))
        if self.pen.two_piece:
            n1 = np.maximum(n1, -(-(t - self.pen.o2) // self.pen.e2))
        w = n1 - 1
        k = kend_abs + 2 * np.maximum(w, 0) + 3
        return np.minimum(
            self._round_ks(np.maximum(k, self.config.k_initial)),
            self.config.k_max,
        )

    #: (id(pool_seqs), l_pad) -> (pool_seqs ref, device pool) — the
    #: streaming pipeline hands the SAME pool list to every chunk/bucket
    #: call, so the upload happens once per run instead of once per
    #: call. The strong list ref keeps the id() from being recycled.
    _POOL_CACHE: Dict[Tuple[int, int], Tuple[object, object]] = {}

    def _build_pool_indexed(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        l_pad: int,
        lens,
    ):
        """ONE device-resident sequence pool per call + per-pair row
        indices: all-pairs workloads reference each sequence ~2(n-1)
        times, so this uploads kilobytes instead of megabytes of
        duplicated rows, and every dispatch group of the call shares
        the same upload. The full pool is
        materialized and cached by (list identity, l_pad), so repeated
        calls with the same pool (the pipeline's chunks and length
        buckets) skip the upload entirely."""
        import jax.numpy as jnp

        qlens_all, tlens_all = lens
        key = (id(pool_seqs), l_pad)
        hit = self._POOL_CACHE.get(key)
        if hit is not None and hit[0] is pool_seqs:
            return (
                hit[1],
                qidx.astype(np.int32),
                tidx.astype(np.int32),
                qlens_all.astype(np.int32),
                tlens_all.astype(np.int32),
            )
        p_pad = self._next_pow2(max(len(pool_seqs), 1))
        pool = np.zeros((p_pad, l_pad), dtype=np.uint8)
        for r, sq in enumerate(pool_seqs):
            if len(sq) <= l_pad:
                pool[r, : len(sq)] = np.frombuffer(sq, dtype=np.uint8)
        pool_dev = jnp.asarray(pool)
        if len(self._POOL_CACHE) > 4:
            self._POOL_CACHE.clear()
        self._POOL_CACHE[key] = (pool_seqs, pool_dev)
        return (
            pool_dev,
            qidx.astype(np.int32),
            tidx.astype(np.int32),
            qlens_all.astype(np.int32),
            tlens_all.astype(np.int32),
        )

    def align_pairs(
        self,
        pairs: List[Tuple[bytes, bytes]],
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """[(score, cigar)] in input order (None = failed). With
        with_stats=True also returns an (n, 4) int64 array of
        [num_matches, alignment_length, query_len, target_len] (reduced
        ON DEVICE from the run buffers; zeros for failed rows).

        as_runs=True: each cigar comes back as (ops, lens) run pairs in
        start->end order instead of a per-base byte array — the
        streaming pipeline feeds these straight to the PAF serializer,
        skipping the expand-then-re-encode round trip.

        sigma_hint: optional per-pair estimated alignment scores (e.g.
        from mash distances) — each pair starts at the band width its
        estimate certifies instead of one global initial K. Wrong hints
        only cost an escalation round; results stay exact."""
        n = len(pairs)
        if n == 0:
            results: List[Optional[Tuple[int, np.ndarray]]] = []
            return (results, np.zeros((0, 4), np.int64)) if with_stats else results
        pool_map: Dict[bytes, int] = {}
        for q, t in pairs:
            for sq in (q, t):
                if sq not in pool_map:
                    pool_map[sq] = len(pool_map)
        pool_seqs = list(pool_map)
        qidx = np.fromiter(
            (pool_map[q] for q, _ in pairs), dtype=np.int64, count=n
        )
        tidx = np.fromiter(
            (pool_map[t] for _, t in pairs), dtype=np.int64, count=n
        )
        return self.align_pairs_indexed(
            pool_seqs,
            qidx,
            tidx,
            with_stats=with_stats,
            sigma_hint=sigma_hint,
            as_runs=as_runs,
        )

    def align_pairs_indexed(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """align_pairs with the pair list already in pooled-index form:
        pool_seqs is a list of byte strings and qidx/tidx are per-pair
        row indices into it. The streaming pipeline uses this entry
        point directly (it knows the indices), skipping the per-pair
        bytes hashing of the dict-based wrapper."""
        return self._align_async(
            pool_seqs, qidx, tidx, with_stats, sigma_hint, as_runs
        ).finish()

    def align_pairs_indexed_async(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """Non-blocking align_pairs_indexed: the initial rounds are
        DISPATCHED (enqueued on the device) before this returns, and
        the returned handle's .finish() blocks for transfers, runs any
        escalation rounds, and returns the same results as the sync
        call. The caller can orient/emit other chunks between dispatch
        and finish — the device computes through all of it."""
        return self._align_async(
            pool_seqs, qidx, tidx, with_stats, sigma_hint, as_runs
        )

    def _align_async(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        n = len(qidx)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        stats = np.zeros((n, 4), dtype=np.int64)
        if n == 0:
            return _ReadyResult((results, stats) if with_stats else results)

        pool_lens = np.fromiter(
            (len(b) for b in pool_seqs), dtype=np.int64, count=len(pool_seqs)
        )
        qlens_all = pool_lens[qidx]
        tlens_all = pool_lens[tidx]
        lens = (qlens_all, tlens_all)
        sum_lens = qlens_all + tlens_all
        kend_abs_all = np.abs(tlens_all - qlens_all)
        max_len = int(max(qlens_all.max(), tlens_all.max()))
        l_pad = self._next_pow2(max(max_len, 4))

        k0 = max(
            self._round_k(self.config.k_initial),
            self._round_k(int(kend_abs_all.max()) + 2),
        )
        # a band of k_full diagonals covers the whole matrix — widening
        # past it is pointless (the full-cover certificate always fires)
        k_full = self._round_k(max(int(sum_lens.max()) + 1, 2))
        k0 = min(k0, k_full)
        # run buffers must scale with length: a pure-match CIGAR already
        # needs L/255 runs, and event counts grow with L (a too-small cap
        # silently doubles work via the overflow->full-cap rerun)
        cap0 = min(
            max(self.config.run_cap_initial, l_pad // 8), 2 * l_pad + 8
        )
        # rounds keyed by (band, run_cap): trace-first at (k0, cap0);
        # certificate failures jump straight to the band their banded
        # score certifies (or double, if unreachable); run-buffer
        # overflows rerun at the full cap
        if sigma_hint is None:
            rounds: Dict[Tuple[int, int], List[int]] = {
                (k0, cap0): list(range(n))
            }
        else:
            # vectorized _k_for_score over the whole batch (the scalar
            # loop was ~25 ms at 16k pairs). The mash-derived hint is an
            # UPPER-ish estimate (sketch noise + fixed margin, see
            # pipeline._orient_chunk); sizing bands for the raw hint
            # pushes ~half the pairs one rung too wide (measured: hints
            # 215-299 vs true scores ~200-210 at 2% divergence). Shave
            # 12.5% for rung selection — pairs whose TRUE score exceeds
            # the narrower band's certificate escalate and stay exact.
            sig = np.asarray(sigma_hint, dtype=np.int64)
            ks = self._k_for_scores(sig - (sig >> 3), kend_abs_all)
            ks = np.maximum(ks, self._round_k(self.config.k_initial))
            ks = np.maximum(ks, self._round_ks(kend_abs_all + 2))
            ks = np.minimum(ks, self._round_ks(sum_lens + 1))
            rounds = {}
            order = np.argsort(ks, kind="stable")
            bounds = np.searchsorted(ks[order], np.unique(ks))
            uniq_ks = np.unique(ks)
            for b, kv in enumerate(uniq_ks):
                hi = bounds[b + 1] if b + 1 < len(bounds) else n
                rounds[(int(kv), cap0)] = order[bounds[b] : hi].tolist()
        pool = self._build_pool_indexed(pool_seqs, qidx, tidx, l_pad, lens)

        # coalesce small hint-rounds into the next wider band: a tiny
        # round costs a full dispatch chain and its own compiled shape
        # but only ~size/batch of extra compute when merged upward (wider
        # bands are always exact; certificates only get easier). A small
        # TOP round (no wider sibling) merges DOWN into the widest
        # sibling below it instead: its pairs were sized from extreme
        # hint noise, and any that genuinely need the wider band fail
        # the narrower certificate and escalate — still exact, and the
        # straggler round stops costing a dispatch every call.
        if len(rounds) > 1:
            for key in sorted(rounds):
                if key not in rounds or len(rounds) == 1:
                    continue
                if len(rounds[key]) >= 512:
                    continue
                siblings = [
                    kk
                    for kk in rounds
                    if kk[1] == key[1] and kk != key
                ]
                larger = [kk for kk in siblings if kk[0] > key[0]]
                if larger:
                    rounds[min(larger)].extend(rounds.pop(key))
                elif siblings:
                    rounds[max(siblings)].extend(rounds.pop(key))

        # dispatch ALL known rounds first, then drain: every dispatch is
        # already enqueued when the first blocking fetch starts, so the
        # device computes items i+1.. while item i transfers to the
        # host, and a 1-worker prefetch thread keeps the NEXT transfer
        # running while the main thread unpacks the current one. Waves
        # are capped at ALLWAVE_WAVE_G groups per dispatch (default 1;
        # >1 runs several groups in one lax.map dispatch, trading fetch
        # granularity for fewer executes).
        # inflight item = (sub-groups, device_buf, k, cap): buf holds
        # len(groups) blocks of buf.shape[0]//len(groups) rows,
        # group-major.
        inflight: List[tuple] = []

        def _drain_all():
            from concurrent.futures import ThreadPoolExecutor

            from ..utils.telemetry import timed_dispatch

            if not inflight:
                return
            items = list(inflight)
            inflight.clear()
            prof = os.environ.get("ALLWAVE_PROFILE_DRAIN") == "1"
            with ThreadPoolExecutor(1) as ex:
                futs = [ex.submit(np.asarray, it[1]) for it in items]
                for (groups_, buf, kk, cc), fut in zip(items, futs):
                    npairs = sum(len(g) for g in groups_)
                    cells = npairs * 2 * l_pad * kk
                    with timed_dispatch(npairs, cells):
                        if prof:
                            import sys as _sys
                            import time as _time

                            t0 = _time.perf_counter()
                            flat = fut.result()
                            print(
                                f"[drain] {npairs} pairs"
                                f" {flat.nbytes/1e6:.2f} MB"
                                f" wait+xfer {1e3*(_time.perf_counter()-t0):.1f} ms",
                                file=_sys.stderr,
                            )
                        else:
                            flat = fut.result()
                    blk = flat.shape[0] // len(groups_)
                    for gi, g in enumerate(groups_):
                        pk = flat[gi * blk : (gi + 1) * blk]
                        for i, key in self._collect_group(
                            g, pk, results, stats, kk, cc, l_pad,
                            lens, as_runs,
                        ):
                            rounds.setdefault(key, []).append(i)

        # small escalation rounds (at most native_max pairs) run on the
        # native C++ oracle instead of the device: each escalation rung
        # is a fresh (K, B) shape to compile and one more dispatch chain,
        # while <100 pairs take ~30 ms on the host — and the oracle is
        # cross-checked bit-exact against the device engines
        # (tests/test_wfa_oracle.py, tests/test_fuzz_cross_engine.py)
        native_max = int(os.environ.get("ALLWAVE_NATIVE_ESC", "96"))
        initial_keys = frozenset(rounds)  # escalations = keys added later

        # wall-clock budget for one host-oracle round: the oracle's cost
        # scales with divergence^2 (wavefront s^2), so a bases gate alone
        # misprices high-divergence pairs (tree "stranger" edges measured
        # ~0.3 s/pair vs ~0.6 ms for same-length 2%-div pairs). Leftovers
        # past the budget go back to the device — which also compiles the
        # shape, so later runs take the warm path instead of re-routing
        # to the oracle forever.
        native_budget_s = float(
            os.environ.get("ALLWAVE_NATIVE_BUDGET_S", "2.0")
        )

        def _native_round(idxs, budget_s=native_budget_s):
            """Align idxs on the host C++ oracle. Returns the suffix NOT
            aligned when the time budget runs out (empty list = all
            done), or None if the native path is unusable for this set."""
            import time as _time

            from .. import native as N
            from ..core.cigar import run_length_encode

            if not N.available():
                return None
            qlens_all, tlens_all = lens
            for i in idxs:
                if qlens_all[i] + tlens_all[i] > 1 << 15:
                    return None
            deadline = _time.perf_counter() + budget_s
            for pos, i in enumerate(idxs):
                q = pool_seqs[qidx[i]]
                t = pool_seqs[tidx[i]]
                out = N.wfa_align_native(q, t, self.pen)
                if out is None:
                    return idxs[pos:]
                score, cigar = out
                m = int(np.count_nonzero(cigar == ord("M")))
                x_ = int(np.count_nonzero(cigar == ord("X")))
                i_ = int(np.count_nonzero(cigar == ord("I")))
                d_ = int(np.count_nonzero(cigar == ord("D")))
                if as_runs:
                    ops_r, lens_r = run_length_encode(cigar)
                    results[i] = (score, (ops_r, lens_r))
                else:
                    results[i] = (score, cigar)
                stats[i] = (m, m + x_, m + x_ + d_, m + x_ + i_)
                if _time.perf_counter() > deadline:
                    return idxs[pos + 1 :]
            return []

        def dispatch_pending():
            """Pop every pending round and enqueue its dispatches (or
            run it on the host oracle); returns with `rounds` empty and
            the device busy."""
            while rounds:
                k, cap = min(rounds)
                idxs = rounds.pop((k, cap))
                if k > self.config.k_max:
                    continue  # overflow: left as None (failed pair contract)
                qlens_all, tlens_all = lens
                per_pair = 2 * (2 * max(l_pad, 128) * k)  # choices+runlen planes
                bsz = int(
                    max(
                        1,
                        min(
                            self.config.choices_budget_bytes // per_pair,
                            self.config.max_batch,
                        ),
                    )
                )
                # clamp to a power of two: groups pad to the next pow2, so a
                # non-pow2 bsz would allocate up to 2x the planned planes
                bsz = 1 << (bsz.bit_length() - 1)
                # floor the group pad at 512 (within the plane budget): each
                # distinct b_pad is a separate compile, so collapsing the
                # tiny/leftover group sizes onto one shape costs a little
                # padded compute and saves whole compiles
                b_floor = min(bsz, 512)
                limit = 0 if (k, cap) in initial_keys else native_max
                if 0 < len(idxs) <= limit:
                    rest = _native_round(idxs)
                    if rest is not None:
                        if not rest:
                            continue
                        idxs = rest  # budget hit: the device takes the rest
                ia = np.asarray(idxs, dtype=np.int64)
                idxs = ia[
                    np.argsort(
                        qlens_all[ia] + tlens_all[ia], kind="stable"
                    )
                ].tolist()
                groups = [
                    idxs[lo : lo + bsz] for lo in range(0, len(idxs), bsz)
                ]
                # a short trailing group pads to bsz inside the wave; when
                # the pow2 pad would be at most half that, dispatching it
                # separately costs one extra enqueue (~ms) but saves
                # (bsz - pow2(r)) rows of kernel compute and fetch bytes
                tail = None
                if (
                    len(groups) > 1
                    and self._next_pow2(len(groups[-1])) <= bsz // 2
                ):
                    tail = groups.pop()
                wave_g = max(
                    1, int(os.environ.get("ALLWAVE_WAVE_G", "1"))
                )
                if len(groups) > 1 and not self._use_mesh():
                    # one dispatch per wave of <= wave_g groups (lax.map)
                    for lo2 in range(0, len(groups), wave_g):
                        sub = groups[lo2 : lo2 + wave_g]
                        if len(sub) > 1:
                            buf = self._dispatch_groups(
                                sub, k, cap, l_pad, bsz, pool
                            )
                            inflight.append((sub, buf, k, cap))
                        else:
                            inflight.append(
                                (
                                    sub,
                                    self._dispatch_group(
                                        sub[0], k, cap, l_pad, pool, b_floor
                                    ),
                                    k,
                                    cap,
                                )
                            )
                else:
                    for group in groups:
                        dispatched = self._dispatch_group(
                            group, k, cap, l_pad, pool, b_floor
                        )
                        inflight.append(([group], dispatched, k, cap))
                if tail is not None:
                    inflight.append(
                        (
                            [tail],
                            self._dispatch_group(
                                tail, k, cap, l_pad, pool, b_floor
                            ),
                            k,
                            cap,
                        )
                    )

        def finish():
            while rounds or inflight:
                _drain_all()
                dispatch_pending()
            return (results, stats) if with_stats else results

        dispatch_pending()
        return _AsyncResult(finish)

    def _dispatch_groups(self, groups, k, run_cap, l_pad, bsz, pool):
        """Enqueue ONE dispatch covering len(groups) sub-batches of bsz
        pairs each (dense.dense_align_packed_groups: lax.map reuses one
        sub-batch's plane scratch across the wave); returns the
        in-flight (G*bsz, W) device buffer. Short sub-groups pad with
        pool-row-0/length-0 rows (same contract as _dispatch_group)."""
        import jax.numpy as jnp

        pool_dev, qidx, tidx, qlens, tlens = pool
        G = len(groups)
        qi = np.zeros((G, bsz), np.int32)
        ti = np.zeros((G, bsz), np.int32)
        ql = np.zeros((G, bsz), np.int32)
        tl = np.zeros((G, bsz), np.int32)
        for gi, g in enumerate(groups):
            a = np.asarray(g, dtype=np.int64)
            qi[gi, : len(g)] = qidx[a]
            ti[gi, : len(g)] = tidx[a]
            ql[gi, : len(g)] = qlens[a]
            tl[gi, : len(g)] = tlens[a]
        return D_.dense_align_packed_groups(
            pool_dev,
            jnp.asarray(qi),
            jnp.asarray(ti),
            jnp.asarray(ql),
            jnp.asarray(tl),
            self.pen,
            k,
            l_pad,
            run_cap,
        )

    def _dispatch_group(self, group, k, run_cap, l_pad, pool, b_floor=1):
        """Enqueue one fused forward+traceback dispatch (the sequence
        pool is already device-resident — see _build_pool); returns the
        in-flight device buffer (not yet transferred)."""
        import jax.numpy as jnp

        pool_dev, qidx, tidx, qlens, tlens = pool
        b_pad = max(self._next_pow2(len(group)), b_floor)
        gi = np.asarray(group, dtype=np.int64)
        pad = b_pad - len(group)
        # padded rows point at pool row 0 with length 0 (same contract
        # as the old empty-pair padding)
        qi = np.concatenate([qidx[gi], np.zeros(pad, np.int32)])
        ti = np.concatenate([tidx[gi], np.zeros(pad, np.int32)])
        ql = np.concatenate([qlens[gi], np.zeros(pad, np.int32)])
        tl = np.concatenate([tlens[gi], np.zeros(pad, np.int32)])
        args = (
            pool_dev,
            jnp.asarray(qi),
            jnp.asarray(ti),
            jnp.asarray(ql),
            jnp.asarray(tl),
        )
        if self._use_mesh():
            # fan the pair shard over every local device (pool
            # replicated, indices sharded; zero cross-device traffic in
            # the hot loop)
            return self._sharded_fn(k, run_cap, l_pad)(*args)
        return D_.dense_align_packed(*args, self.pen, k, l_pad, run_cap)

    def _collect_group(
        self, group, packed, results, stats, k, run_cap, l_pad,
        pair_lens, as_runs,
    ) -> List[Tuple[int, Tuple[int, int]]]:
        """Host-side unpack of one group's packed result rows (already
        fetched by the caller's _drain_all); fills certified results and
        returns [(pair_idx, (next_k, next_cap)), ...] for escalations."""
        meta = packed[:, :32].copy().view(np.int32).reshape(-1, 8)
        scores, nruns, cert, overflow = (meta[:, c] for c in range(4))
        cap4 = (run_cap + 3) // 4
        B_rows = packed.shape[0]
        ops = _OPS_UNPACK_LUT[packed[:, 32 : 32 + cap4]].reshape(
            B_rows, 4 * cap4
        )[:, :run_cap]
        lens = packed[:, 32 + cap4 :]
        good = (cert == 1) & (overflow == 0)
        full_cap = 2 * l_pad + 8

        if not as_runs:
            cigars = expand_runs_batch(ops, lens, nruns)
        ng = len(group)  # rows past ng are batch padding
        good_rows = np.flatnonzero(good[:ng])
        stats_block = meta[good_rows, 4:8].astype(np.int64)
        escalate: List[Tuple[int, Tuple[int, int]]] = []
        scores_l = scores.tolist()
        nruns_l = nruns.tolist()
        for row, j in enumerate(good_rows.tolist()):
            i = group[j]
            if as_runs:
                nr = nruns_l[j]
                if nr > 0:
                    runs = (ops[j, nr - 1 :: -1], lens[j, nr - 1 :: -1])
                else:
                    runs = (
                        np.zeros(0, np.uint8),
                        np.zeros(0, np.uint8),
                    )
                results[i] = (scores_l[j], runs)
            else:
                results[i] = (scores_l[j], cigars[j])
            stats[i] = stats_block[row]
        for j in np.flatnonzero(~good[:ng]).tolist():
            i = group[j]
            if cert[j] == 1:  # certified score, run buffer too small
                if run_cap < full_cap:
                    escalate.append((i, (k, full_cap)))
                # else: already at the full cap — cannot grow further, so
                # re-queueing would loop; leave as None (failed-pair
                # contract, same guard as segmented.py)
            else:
                kend_abs = abs(int(pair_lens[1][i] - pair_lens[0][i]))
                # strict widening = the next LADDER rung (doubling can
                # overshoot k_max and drop a pair the next rung would
                # certify); at the top rung the pair fails for good
                nup = self._round_k(k + 1)
                if nup <= k:
                    continue
                if scores[j] < D_.INF:
                    nk = self._k_for_score(int(scores[j]), kend_abs)
                    nk = max(nk, nup)
                else:
                    # no banded score to size from: jump ~2x, on-ladder
                    nk = max(self._round_k(2 * k), nup)
                k_full = self._round_k(
                    int(pair_lens[0][i] + pair_lens[1][i]) + 1
                )
                nk = min(nk, max(k_full, nup))
                escalate.append((i, (nk, run_cap)))
        return escalate


class UnifiedAligner:
    """Length-routed dispatcher: one-shot dense engine for short pairs,
    segmented (checkpoint-replay) dense engine for long pairs — the
    latter replaces the wavefront engine's full-history pass, whose
    O(s^2) planes made 100 kb pairs a batch-of-one (the reference covers
    this regime with biWFA's O(s) memory, alignment.rs:265-287). The
    wavefront engine remains available via `wavefront` for score-only
    discovery workloads."""

    def __init__(
        self,
        pen: Penalties,
        dense_max_len: int = 16384,
        dense_config: Optional[DenseConfig] = None,
        wavefront_config: Optional[EngineConfig] = None,
        segmented_config=None,
    ):
        from .segmented import SegmentedDenseAligner
        from .wf_segmented import WavefrontSegmentedAligner

        self.pen = pen
        self.dense_max_len = dense_max_len
        self.dense = DenseBandAligner(pen, dense_config)
        self.segmented = SegmentedDenseAligner(pen, segmented_config)
        self.wf_segmented = WavefrontSegmentedAligner(pen)
        self.wavefront = BatchWavefrontAligner(pen, wavefront_config)

    def align_pairs(
        self,
        pairs: List[Tuple[bytes, bytes]],
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        n = len(pairs)
        if n == 0:
            out: List[Optional[Tuple[int, np.ndarray]]] = []
            return (out, np.zeros((0, 4), np.int64)) if with_stats else out
        pool_map: Dict[bytes, int] = {}
        for q, t in pairs:
            for sq in (q, t):
                if sq not in pool_map:
                    pool_map[sq] = len(pool_map)
        pool_seqs = list(pool_map)
        qidx = np.fromiter(
            (pool_map[q] for q, _ in pairs), dtype=np.int64, count=n
        )
        tidx = np.fromiter(
            (pool_map[t] for _, t in pairs), dtype=np.int64, count=n
        )
        return self.align_pairs_indexed(
            pool_seqs,
            qidx,
            tidx,
            with_stats=with_stats,
            sigma_hint=sigma_hint,
            as_runs=as_runs,
        )

    def align_pairs_indexed(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """align_pairs in pooled-index form (see
        DenseBandAligner.align_pairs_indexed)."""
        return self.align_pairs_indexed_async(
            pool_seqs,
            qidx,
            tidx,
            with_stats=with_stats,
            sigma_hint=sigma_hint,
            as_runs=as_runs,
        ).finish()

    #: host-oracle cost model for the small-workload router (calibrated
    #: on the bench host's batch C++ oracle: 300 bp @2% edit measured
    #: ~5.7 us/pair at s~40, 1 kb @2% two-piece ~200 us/pair at s~130 —
    #: the model over-estimates both ~2x, which errs toward the device)
    HOST_CELL_NS = 8.0  # per wavefront cell (~2*s^2 cells per pair)
    HOST_BASE_NS = 5.0  # per base of match-run extension
    #: whole workloads estimated under this go to the host oracle: a
    #: device dispatch chain (upload, sweep, fetch, possible compile)
    #: costs at least this much wall time
    HOST_ROUTE_MAX_S = 0.010

    def _route_all_host(self, qlens, tlens, sigma_arr) -> bool:
        """True when the WHOLE workload is cheaper on the host C++
        oracle than one device dispatch chain (tiny workloads — e.g. a
        20-sequence FASTA — pay several dispatch and transfer round
        trips on the device path while a single core does them in
        milliseconds; reference alignment.rs:11-22 starts aligning
        instantly). Only meaningful on accelerator backends, where the
        dispatch+transfer fixed cost is real; decisions/PAF bytes are
        unchanged either way (the oracle is cross-checked bit-exact,
        tests/test_fuzz_battery.py)."""
        env = os.environ.get("ALLWAVE_HOST_ROUTE")
        if env == "0":
            return False
        if env != "1":
            import jax

            if jax.default_backend() == "cpu":
                return False  # the XLA path IS a host path here
        from .. import native as N

        if sigma_arr is None or not N.available():
            return False
        sum_lens = qlens + tlens
        if int(sum_lens.max()) > (1 << 15):
            return False  # beyond the oracle's small-pair regime
        cells = 2.0 * np.square(sigma_arr.astype(np.float64))
        est_s = float(
            (cells * self.HOST_CELL_NS * 1e-9).sum()
            + (sum_lens.astype(np.float64) * self.HOST_BASE_NS * 1e-9).sum()
        )
        return est_s < self.HOST_ROUTE_MAX_S

    def _align_all_host(
        self, pool_seqs, qidx, tidx, results, stats, as_runs
    ) -> bool:
        """Align every pair on the host C++ oracle via ONE batch FFI
        call (same result contract as the device paths; alignments are
        bit-identical — tests/test_fuzz_battery.py). Returns False if
        the native batch entry is unavailable (caller falls through to
        the device path with results untouched)."""
        from .. import native as N

        out = N.wfa_align_batch_rle_native(pool_seqs, qidx, tidx, self.pen)
        if out is None:
            return False
        scores, run_ops, run_lens, run_offs, st4 = out
        offs_l = run_offs.tolist()
        scores_l = scores.tolist()
        for pos in range(len(qidx)):
            score = scores_l[pos]
            if score < 0:
                continue  # failed-pair contract: results[pos] stays None
            lo, hi = offs_l[pos], offs_l[pos + 1]
            ops_r = run_ops[lo:hi]
            lens_r = run_lens[lo:hi]
            if as_runs:
                results[pos] = (score, (ops_r, lens_r))
            else:
                results[pos] = (
                    score,
                    np.repeat(ops_r, lens_r.astype(np.int64)),
                )
            m, x_, i_, d_ = st4[pos]
            stats[pos] = (m, m + x_, m + x_ + d_, m + x_ + i_)
        return True

    def align_pairs_indexed_async(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """Non-blocking align_pairs_indexed: every short-pair length
        bucket is DISPATCHED (device busy) before this returns; the
        handle's .finish() collects them, runs the long-pair segmented
        engines, and returns the same results as the sync call. The
        streaming pipeline uses this to orient/emit neighbouring chunks
        while the device computes."""
        n = len(qidx)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        stats = np.zeros((n, 4), dtype=np.int64)
        if n == 0:
            return _ReadyResult((results, stats) if with_stats else results)
        pool_lens = np.fromiter(
            (len(b) for b in pool_seqs), dtype=np.int64, count=len(pool_seqs)
        )
        max_lens = np.maximum(pool_lens[qidx], pool_lens[tidx])
        sigma_arr = (
            np.asarray(sigma_hint, dtype=np.int64)
            if sigma_hint is not None
            else None
        )
        if self._route_all_host(
            pool_lens[qidx], pool_lens[tidx], sigma_arr
        ) and self._align_all_host(
            pool_seqs, qidx, tidx, results, stats, as_runs
        ):
            return _ReadyResult((results, stats) if with_stats else results)
        short_mask = max_lens <= self.dense_max_len
        long_idx = np.flatnonzero(~short_mask).tolist()
        short_idx = np.flatnonzero(short_mask)
        handles: List[Tuple[np.ndarray, object]] = []
        if short_idx.size:
            # group by padded length (vectorized pow2 bucketing) to keep
            # scan lengths tight
            ml = np.maximum(max_lens[short_idx], 4)
            pads = 1 << np.frexp((ml - 1).astype(np.float64))[1]
            by_pad: Dict[int, List[int]] = {}
            for pad in np.unique(pads).tolist():
                by_pad[int(pad)] = short_idx[pads == pad].tolist()
            # coalesce tiny length-buckets into the next larger one: a
            # <256-pair bucket costs a full dispatch chain but only
            # ~2x the per-pair scan work when merged upward (the dense
            # engine re-derives l_pad from its own batch)
            if len(by_pad) > 1:
                for pad in sorted(by_pad):
                    if len(by_pad) == 1 or len(by_pad[pad]) >= 256:
                        continue
                    larger = [p for p in by_pad if p > pad]
                    if larger:
                        by_pad[min(larger)].extend(by_pad.pop(pad))
            for pad, idxs in sorted(by_pad.items()):
                ia = np.asarray(idxs, dtype=np.int64)
                hint = sigma_arr[ia] if sigma_arr is not None else None
                handles.append(
                    (
                        ia,
                        self.dense.align_pairs_indexed_async(
                            pool_seqs,
                            qidx[ia],
                            tidx[ia],
                            with_stats=True,
                            sigma_hint=hint,
                            as_runs=as_runs,
                        ),
                    )
                )

        def finish():
            for ia, h in handles:
                out, st = h.finish()
                for i, r in zip(ia.tolist(), out):
                    results[i] = r
                stats[ia] = st
            if long_idx:
                self._align_long(
                    pool_seqs, qidx, tidx, long_idx, sigma_arr,
                    results, stats,
                )
            return (results, stats) if with_stats else results

        return _AsyncResult(finish)

    def _align_long(
        self, pool_seqs, qidx, tidx, long_idx, sigma_arr, results, stats
    ):
        """Long-pair leg of align_pairs_indexed: O(s*K) wavefront
        checkpoint-replay first, dense segmented fallback. Fills
        results/stats in place."""
        from ..core.cigar import batch_cigar_stats

        sub = [
            (pool_seqs[qidx[i]], pool_seqs[tidx[i]]) for i in long_idx
        ]
        hint = (
            [int(sigma_arr[i]) for i in long_idx]
            if sigma_arr is not None
            else None
        )
        # Long-pair routing: the dense segmented engine by default. The
        # XLA wavefront engine does O(s*K) work per pair instead of
        # O(L*K), but its per-level gathers lost to the dense sweep on
        # the CPU backend; ALLWAVE_WFSEG=1 routes long pairs to it, with
        # pairs past its ceilings falling back to the dense segmented
        # engine via the DENSE_FALLBACK sentinel.
        from .wf_segmented import WavefrontSegmentedAligner as _W

        use_wf = os.environ.get("ALLWAVE_WFSEG") == "1"
        if not use_wf:
            out = self.segmented.align_pairs(sub, sigma_hint=hint)
        else:
            out = self.wf_segmented.align_pairs(sub, sigma_hint=hint)
            fb = [
                j
                for j, r in enumerate(out)
                if r is None or r is _W.DENSE_FALLBACK
            ]
            if fb:
                dense_out = self.segmented.align_pairs(
                    [sub[j] for j in fb],
                    sigma_hint=(
                        [hint[j] for j in fb] if hint is not None else None
                    ),
                )
                for j, r in zip(fb, dense_out):
                    out[j] = r
        st = batch_cigar_stats(
            [r[1] if r is not None else np.zeros(0, np.uint8) for r in out]
        )
        for row, (i, r) in enumerate(zip(long_idx, out)):
            results[i] = r
            stats[i] = st[row]
