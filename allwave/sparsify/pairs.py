"""Pair enumeration and sparsification strategies.

Reference: src/iterator.rs:40-77 (enumeration + dispatch),
:256-284 (deterministic random filter), :300-334 (giant-component edge
probability incl. the hard-coded small-n table and clamps).

All-pairs means DIRECTED n*(n-1): both (i,j) and (j,i) are aligned.
"""

from __future__ import annotations

import math
from typing import Sequence as PySequence

import numpy as np

from ..core.types import (
    AutoSparsification,
    ConnectivitySparsification,
    NoSparsification,
    RandomSparsification,
    Sequence,
    SparsificationStrategy,
    TreeSampling,
)
from ..hashing.siphash import pair_keep_mask
from ..sketch.minhash import DEFAULT_KMER_SIZE


def generate_all_pairs(n: int, exclude_self: bool = True) -> np.ndarray:
    """Directed ordered pairs in row-major enumeration order
    (reference: iterator.rs:40-46). Returns int64 array (P, 2)."""
    i = np.repeat(np.arange(n, dtype=np.int64), n)
    j = np.tile(np.arange(n, dtype=np.int64), n)
    pairs = np.stack([i, j], axis=1)
    if exclude_self:
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return pairs


def apply_random_sparsification(
    pairs: np.ndarray, keep_fraction: float, sequences: PySequence[Sequence]
) -> np.ndarray:
    """Keep pair (i,j) iff DefaultHasher("{id_i}:{id_j}") / u64::MAX <
    keep_fraction — deterministic and directed
    (reference: iterator.rs:256-284)."""
    if pairs.shape[0] == 0:
        return pairs
    from ..hashing.siphash import pair_keep_mask_pooled

    id_bytes = [s.id.encode("utf-8") for s in sequences]
    mask = pair_keep_mask_pooled(
        id_bytes,
        pairs[:, 0].astype(np.int64),
        pairs[:, 1].astype(np.int64),
        keep_fraction,
    )
    return pairs[mask]


def compute_connectivity_probability(n: int, connectivity_prob: float) -> float:
    """Erdos-Renyi giant-component edge probability
    (reference: iterator.rs:300-334).

    p = (ln n + c)/n with c = -ln(-ln(x)), x clamped to [0.001, 0.999],
    p clamped to [0.001, 1.0]; hard-coded table for n <= 10.
    """
    if n <= 1:
        return 1.0
    x = min(max(connectivity_prob, 0.001), 0.999)
    if n <= 10:
        return {2: 1.0, 3: 0.8, 4: 0.7, 5: 0.6}.get(n, 0.5)
    log_n = math.log(float(n))
    c = -math.log(-math.log(x))
    p = (log_n + c) / float(n)
    return min(max(p, 0.001), 1.0)


def build_pairs(
    sequences: PySequence[Sequence],
    strategy: SparsificationStrategy,
    exclude_self: bool = True,
) -> np.ndarray:
    """Full pair-selection pipeline (reference: iterator.rs:30-92).

    Returns int64 (P, 2) directed pairs in the same order the reference
    produces them: enumeration order for hash-filtered strategies,
    sorted+deduped for TreeSampling.
    """
    n = len(sequences)
    if isinstance(strategy, TreeSampling):
        from .knn import extract_tree_pairs

        return extract_tree_pairs(
            sequences,
            strategy.k_nearest,
            strategy.k_farthest,
            strategy.random_fraction,
            strategy.kmer_size if strategy.kmer_size is not None else DEFAULT_KMER_SIZE,
        )

    if isinstance(strategy, NoSparsification):
        return generate_all_pairs(n, exclude_self)
    if isinstance(strategy, RandomSparsification):
        keep = strategy.keep_fraction
    elif isinstance(strategy, AutoSparsification):
        # Auto => giant component model with 0.95 (reference: iterator.rs:54-58)
        keep = compute_connectivity_probability(n, 0.95)
    elif isinstance(strategy, ConnectivitySparsification):
        keep = compute_connectivity_probability(n, strategy.connectivity_prob)
    else:
        raise TypeError(f"Unknown sparsification strategy: {strategy!r}")

    # hash-filter in i-row blocks: materializing all n(n-1) candidate
    # pairs AND their id strings at once is O(n^2) memory (1.6 GB of
    # indices + 1e8 python strings at n=10k); the kept set is tiny
    # (~0.1% at giant:0.99, n=10k), so only flat index vectors are built
    # per block and the (P, 2) array is materialized for kept pairs
    # alone. Self pairs are masked after hashing (decisions are per-pair
    # independent), preserving the reference's i-major enumeration order.
    from ..hashing.siphash import pair_keep_mask_pooled

    id_bytes = [s.id.encode("utf-8") for s in sequences]
    block = max(1, 4_000_000 // max(n, 1))
    out = []
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        i = np.repeat(np.arange(lo, hi, dtype=np.int64), n)
        j = np.tile(np.arange(n, dtype=np.int64), hi - lo)
        mask = pair_keep_mask_pooled(id_bytes, i, j, keep)
        if exclude_self:
            mask &= i != j
        out.append(np.stack([i[mask], j[mask]], axis=1))
    return (
        np.concatenate(out, axis=0) if out else np.zeros((0, 2), np.int64)
    )


def parse_sparsification(s: str) -> SparsificationStrategy:
    """Parse the CLI sparsification mini-language
    (reference: main.rs:136-203):
    none | auto | random:<frac> | giant:<prob> | connectivity:<prob> |
    tree:<near>:<far>:<random>[:<kmer>]
    """
    if s == "none":
        return NoSparsification()
    if s == "auto":
        return AutoSparsification()
    if s.startswith("random:"):
        try:
            fraction = float(s[len("random:") :])
        except ValueError:
            raise ValueError("Invalid random fraction")
        if not (0.0 < fraction <= 1.0):
            raise ValueError("Random fraction must be between 0 and 1")
        return RandomSparsification(fraction)
    if s.startswith("giant:"):
        try:
            prob = float(s[len("giant:") :])
        except ValueError:
            raise ValueError("Invalid giant component probability")
        if not (0.0 < prob < 1.0):
            raise ValueError("Giant component probability must be between 0 and 1")
        return ConnectivitySparsification(prob)
    if s.startswith("connectivity:"):  # legacy spelling
        try:
            prob = float(s[len("connectivity:") :])
        except ValueError:
            raise ValueError("Invalid connectivity probability")
        if not (0.0 < prob < 1.0):
            raise ValueError("Connectivity probability must be between 0 and 1")
        return ConnectivitySparsification(prob)
    if s.startswith("tree:"):
        parts = s[len("tree:") :].split(":")
        if not (3 <= len(parts) <= 4):
            raise ValueError(
                "Invalid tree format. Use: "
                "tree:<k_nearest>:<k_farthest>:<random_fraction>[:<kmer_size>]"
            )
        try:
            k_nearest = int(parts[0])
        except ValueError:
            raise ValueError("Invalid k nearest count")
        try:
            k_farthest = int(parts[1])
        except ValueError:
            raise ValueError("Invalid k farthest count")
        try:
            random_frac = float(parts[2])
        except ValueError:
            raise ValueError("Invalid random fraction")
        if k_nearest == 0 and k_farthest == 0:
            raise ValueError(
                "At least one of k_nearest or k_farthest must be greater than 0"
            )
        if not (0.0 <= random_frac <= 1.0):
            raise ValueError("Random fraction must be between 0 and 1")
        kmer_size = None
        if len(parts) == 4:
            try:
                kmer_size = int(parts[3])
            except ValueError:
                raise ValueError("Invalid k-mer size")
            if not (3 <= kmer_size <= 31):
                raise ValueError("K-mer size must be between 3 and 31")
        return TreeSampling(k_nearest, k_farthest, random_frac, kmer_size)
    raise ValueError(
        "Invalid sparsification strategy. Use: none, auto, giant:<probability>, "
        "random:<fraction>, or tree:<near>:<far>:<random>[:<kmer>]"
    )
