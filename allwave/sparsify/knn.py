"""k-NN graph sparsification ("tree" strategy).

Reference: src/knn_graph.rs. Builds a mash-distance matrix
(sketch_size=1000), takes the k nearest and/or k farthest directed
neighbors per sequence, adds deterministic random pairs (same
DefaultHasher ID filter as random sparsification), then sorts and dedups
lexicographically (knn_graph.rs:47-51).

Tie-breaking parity: the reference sorts (distance, index) lists with a
STABLE sort built over ascending-j candidates, so equal distances resolve
to the smaller j first — replicated here with kind='stable' argsort.
"""

from __future__ import annotations

from typing import List, Sequence as PySequence, Tuple

import numpy as np

from ..core.types import Sequence
from ..sketch.minhash import compute_distance_matrix_with_params
from .pairs import apply_random_sparsification, generate_all_pairs


def build_knn_graph(
    distance_matrix: np.ndarray, k_neighbors: int, farthest: bool
) -> np.ndarray:
    """Directed k-nearest (or k-farthest) edges per node
    (reference: knn_graph.rs:112-143). Returns int64 (E, 2) in the
    reference's emission order (node-major)."""
    n = distance_matrix.shape[0]
    pairs: List[Tuple[int, int]] = []
    for i in range(n):
        others = np.array([j for j in range(n) if j != i], dtype=np.int64)
        if others.size == 0:
            continue
        dists = distance_matrix[i, others]
        key = -dists if farthest else dists
        order = np.argsort(key, kind="stable")
        k_actual = min(k_neighbors, others.size)
        for idx in order[:k_actual]:
            pairs.append((i, int(others[idx])))
    if not pairs:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array(pairs, dtype=np.int64)


def _dedup_sorted(pairs: np.ndarray) -> np.ndarray:
    """sort_unstable + dedup equivalent: lexicographic unique rows."""
    if pairs.shape[0] == 0:
        return pairs.reshape(0, 2).astype(np.int64)
    return np.unique(pairs, axis=0)


def extract_tree_pairs(
    sequences: PySequence[Sequence],
    k_nearest: int,
    k_farthest: int,
    random_fraction: float,
    kmer_size: int,
) -> np.ndarray:
    """Reference: knn_graph.rs:12-52. Returns sorted, deduped int64 (P, 2)."""
    if len(sequences) < 2:
        return np.zeros((0, 2), dtype=np.int64)

    distance_matrix = compute_distance_matrix_with_params(sequences, kmer_size, 1000)

    chunks = []
    if k_nearest > 0:
        chunks.append(build_knn_graph(distance_matrix, k_nearest, False))
    if k_farthest > 0:
        chunks.append(build_knn_graph(distance_matrix, k_farthest, True))
    if random_fraction > 0.0:
        all_pairs = generate_all_pairs(len(sequences), exclude_self=True)
        chunks.append(
            apply_random_sparsification(all_pairs, random_fraction, sequences)
        )
    if not chunks:
        return np.zeros((0, 2), dtype=np.int64)
    return _dedup_sorted(np.concatenate(chunks, axis=0))


def extract_tree_pairs_separated(
    sequences: PySequence[Sequence],
    k_nearest: int,
    k_farthest: int,
    random_fraction: float,
    kmer_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tree pairs first, then random pairs not already in the tree set
    (reference: knn_graph.rs:56-99)."""
    if len(sequences) < 2:
        z = np.zeros((0, 2), dtype=np.int64)
        return z, z

    distance_matrix = compute_distance_matrix_with_params(sequences, kmer_size, 1000)
    chunks = []
    if k_nearest > 0:
        chunks.append(build_knn_graph(distance_matrix, k_nearest, False))
    if k_farthest > 0:
        chunks.append(build_knn_graph(distance_matrix, k_farthest, True))
    tree_pairs = (
        _dedup_sorted(np.concatenate(chunks, axis=0))
        if chunks
        else np.zeros((0, 2), dtype=np.int64)
    )

    if random_fraction > 0.0:
        all_pairs = generate_all_pairs(len(sequences), exclude_self=True)
        random_pairs = apply_random_sparsification(
            all_pairs, random_fraction, sequences
        )
        if tree_pairs.shape[0] > 0 and random_pairs.shape[0] > 0:
            tree_keys = tree_pairs[:, 0] * len(sequences) + tree_pairs[:, 1]
            rand_keys = random_pairs[:, 0] * len(sequences) + random_pairs[:, 1]
            random_pairs = random_pairs[~np.isin(rand_keys, tree_keys)]
    else:
        random_pairs = np.zeros((0, 2), dtype=np.int64)

    return tree_pairs, random_pairs


def extract_knn_pairs(
    sequences: PySequence[Sequence],
    k_neighbors: int,
    random_fraction: float,
    kmer_size: int,
) -> np.ndarray:
    """Backward-compat shim (reference: knn_graph.rs:102-109)."""
    return extract_tree_pairs(sequences, k_neighbors, 0, random_fraction, kmer_size)


def estimate_tree_pair_count(
    n: int, k_nearest: int, k_farthest: int, random_fraction: float
) -> int:
    """Reference: knn_graph.rs:177-188."""
    nearest_pairs = n * min(k_nearest, max(n - 1, 0))
    farthest_pairs = n * min(k_farthest, max(n - 1, 0))
    total_possible = n * (n - 1)
    random_pairs = int(round(total_possible * random_fraction))
    return min(nearest_pairs + farthest_pairs + random_pairs, total_possible)


def estimate_knn_pair_count(n: int, k_neighbors: int, random_fraction: float) -> int:
    return estimate_tree_pair_count(n, k_neighbors, 0, random_fraction)
