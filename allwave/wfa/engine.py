"""Host orchestration of the batched device wavefront engine.

Role note: the PRODUCTION alignment path is the dense banded engine
(dense_engine.py / segmented.py), which is gather-free. This
score-sweep (WFA-style) engine remains as a second independent engine
for score-only discovery workloads and as a cross-check in the parity
suites; its extension step gathers per diagonal.

Pairs are aligned in two device passes (see batch.py):

1. score discovery with escalating score caps (64, 256, 1024, ...):
   a rolling score-only pass; unfinished pairs escalate to a 4x larger
   cap. Compute is geometric so the final cap dominates.
2. pairs bucketed by their exact score s*; each bucket runs the
   full-history pass + on-device traceback, sized so the history fits the
   memory budget.

The reference processes one pair per CPU task (iterator.rs:182-204); here
the unit of work is a (s_cap, k_width, B, L_pad)-shaped batch compiled
once and reused across the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .params import Penalties
from . import batch as B_


@dataclass
class EngineConfig:
    #: HBM budget for the history planes of one in-flight batch.
    history_budget_bytes: int = 4 << 30
    #: number of pairs per score-discovery chunk (lanes = B * K)
    prepass_lane_budget: int = 1 << 22
    #: initial score cap for discovery
    s_cap_initial: int = 64
    #: escalation factor between discovery rounds
    s_cap_growth: int = 4
    #: absolute cap — pairs needing more raise (until biWFA lands)
    s_cap_max: int = 1 << 15
    #: max pairs per history batch regardless of memory
    max_batch: int = 512


class BatchWavefrontAligner:
    """Aligns many (query, target) byte-string pairs on device."""

    def __init__(self, pen: Penalties, config: Optional[EngineConfig] = None):
        from ..utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.pen = pen
        self.config = config or EngineConfig()

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _pad_batch(seqs: List[bytes], pad_to: int) -> np.ndarray:
        out = np.zeros((len(seqs), pad_to), dtype=np.uint8)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        return out

    @staticmethod
    def _next_pow2(n: int) -> int:
        return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 1)

    def _run_forward(
        self,
        pairs: List[Tuple[bytes, bytes]],
        s_cap: int,
        with_history: bool,
    ):
        """One device invocation over a fixed batch.

        Shapes are normalized to powers of two (batch size and padded
        length) so XLA compiles a small, reusable set of kernels.
        """
        import jax.numpy as jnp

        K = 2 * s_cap + 1
        n_real = len(pairs)
        b_pad = self._next_pow2(n_real)
        pairs = pairs + [(b"", b"")] * (b_pad - n_real)
        qlens = np.array([len(q) for q, _ in pairs], dtype=np.int32)
        tlens = np.array([len(t) for _, t in pairs], dtype=np.int32)
        l_pad = self._next_pow2(max(int(max(qlens.max(), tlens.max(), 1)), 4))
        qs = self._pad_batch([q for q, _ in pairs], l_pad)
        ts = self._pad_batch([t for _, t in pairs], l_pad)
        scores, done, hist = B_.wavefront_forward(
            jnp.asarray(qs),
            jnp.asarray(ts),
            jnp.asarray(qlens),
            jnp.asarray(tlens),
            self.pen,
            s_cap,
            K,
            with_history,
        )
        return scores, done, hist, (qlens, tlens), n_real

    # -- pass 1: score discovery ------------------------------------------

    def discover_scores(self, pairs: List[Tuple[bytes, bytes]]) -> np.ndarray:
        """Exact score per pair (int64 array; -1 = exceeded s_cap_max).

        Pairs that exceed s_cap_max are reported as failures (-1); the
        pipeline turns them into the reference's zeroed PAF records
        (reference: alignment.rs:49-64).
        """
        n = len(pairs)
        scores = np.full(n, -1, dtype=np.int64)
        pending = list(range(n))
        s_cap = self.config.s_cap_initial
        while pending:
            if s_cap > self.config.s_cap_max:
                break  # remaining pairs stay at -1 (failed)
            K = 2 * s_cap + 1
            chunk = max(1, self.config.prepass_lane_budget // K)
            still = []
            for lo in range(0, len(pending), chunk):
                idxs = pending[lo : lo + chunk]
                sub = [pairs[i] for i in idxs]
                sc, done, _, _, _ = self._run_forward(sub, s_cap, with_history=False)
                sc = np.asarray(sc)
                done_np = np.asarray(done)
                for j, i in enumerate(idxs):
                    if done_np[j]:
                        scores[i] = int(sc[j])
                    else:
                        still.append(i)
            pending = still
            s_cap *= self.config.s_cap_growth
        return scores

    # -- pass 2: history + traceback --------------------------------------

    def _history_batch_size(self, s_cap: int) -> int:
        K = 2 * s_cap + 1
        bytes_per_pair = 5 * 4 * (s_cap + 1) * K
        b = self.config.history_budget_bytes // max(bytes_per_pair, 1)
        return int(max(1, min(b, self.config.max_batch)))

    def align_pairs(
        self, pairs: List[Tuple[bytes, bytes]]
    ) -> List[Optional[Tuple[int, np.ndarray]]]:
        """Returns [(score, cigar_bytes uint8)] in input order; None for
        pairs that failed (exceeded the score cap)."""
        import jax.numpy as jnp

        n = len(pairs)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        scores = self.discover_scores(pairs)

        # bucket by power-of-two score cap
        buckets: dict = {}
        for i in range(n):
            s = int(scores[i])
            if s < 0:
                continue  # failed pair -> None result
            cap = max(self.config.s_cap_initial, 1 << (max(s, 1) - 1).bit_length())
            buckets.setdefault(cap, []).append(i)

        for cap, idxs in sorted(buckets.items()):
            bsz = self._history_batch_size(cap)
            # batch similar-length pairs together to minimize padding
            idxs = sorted(idxs, key=lambda i: len(pairs[i][0]) + len(pairs[i][1]))
            for lo in range(0, len(idxs), bsz):
                group = idxs[lo : lo + bsz]
                sub = [pairs[i] for i in group]
                sc, done, hist, (qlens, tlens), _ = self._run_forward(
                    sub, cap, with_history=True
                )
                run_cap = 2 * cap + 16
                ops, lens, nruns, overflow = B_.wavefront_traceback(
                    hist,
                    sc,
                    jnp.asarray(qlens),
                    jnp.asarray(tlens),
                    self.pen,
                    run_cap,
                )
                ops = np.asarray(ops)
                lens = np.asarray(lens)
                nruns = np.asarray(nruns)
                overflow = np.asarray(overflow)
                sc = np.asarray(sc)
                for j, i in enumerate(group):
                    if overflow[j] or sc[j] < 0:
                        results[i] = None  # failed -> zeroed PAF upstream
                        continue
                    cigar = B_.expand_runs_to_cigar(ops[j], lens[j], int(nruns[j]))
                    results[i] = (int(sc[j]), cigar)
        return results
