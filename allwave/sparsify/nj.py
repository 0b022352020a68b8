"""Neighbor-joining tree construction (API parity).

Reference: src/neighbor_joining.rs. NOTE: in the reference
this module is exported but never called by the pipeline (the `tree:`
strategy uses knn_graph instead, iterator.rs:63-76) — it is implemented
here for API parity and kept off the hot path.

One deliberate divergence, documented: the reference iterates a Rust
HashMap (`active_nodes.keys()`), whose order is randomized per process, so
its NJ output is nondeterministic run-to-run. We use sorted node ids,
making ours deterministic (it is one of the valid orders the reference can
produce).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..hashing.siphash import siphash13


@dataclass
class TreeNode:
    """Reference: neighbor_joining.rs:10-89."""

    id: int
    sequence_index: Optional[int] = None
    left: Optional["TreeNode"] = None
    right: Optional["TreeNode"] = None
    branch_length: float = 0.0

    @staticmethod
    def leaf(node_id: int, sequence_index: int) -> "TreeNode":
        return TreeNode(id=node_id, sequence_index=sequence_index)

    @staticmethod
    def internal(node_id: int, left: "TreeNode", right: "TreeNode") -> "TreeNode":
        return TreeNode(id=node_id, left=left, right=right)

    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    def get_leaves(self) -> List[int]:
        if self.sequence_index is not None:
            return [self.sequence_index]
        leaves: List[int] = []
        if self.left is not None:
            leaves.extend(self.left.get_leaves())
        if self.right is not None:
            leaves.extend(self.right.get_leaves())
        return leaves

    def get_edges(self) -> List[Tuple[List[int], List[int]]]:
        edges: List[Tuple[List[int], List[int]]] = []
        if self.left is not None and self.right is not None:
            left_leaves = self.left.get_leaves()
            right_leaves = self.right.get_leaves()
            parent_leaves = self.get_leaves()
            edges.append((parent_leaves, left_leaves))
            edges.append((parent_leaves, right_leaves))
            edges.extend(self.left.get_edges())
            edges.extend(self.right.get_edges())
        return edges


def neighbor_joining(distance_matrix: np.ndarray) -> Optional[TreeNode]:
    """Classic NJ with the Q-criterion (reference: neighbor_joining.rs:92-229)."""
    d = np.asarray(distance_matrix, dtype=np.float64)
    n = d.shape[0]
    if n < 2:
        return None
    if n == 2:
        left = TreeNode.leaf(0, 0)
        right = TreeNode.leaf(1, 1)
        left.branch_length = d[0, 1] / 2.0
        right.branch_length = d[0, 1] / 2.0
        return TreeNode.internal(2, left, right)

    active = {i: TreeNode.leaf(i, i) for i in range(n)}
    size = n
    dist = np.zeros((2 * n, 2 * n), dtype=np.float64)
    dist[:n, :n] = d
    next_id = n

    while len(active) > 2:
        idxs = sorted(active.keys())
        m = len(idxs)
        sub = dist[np.ix_(idxs, idxs)]
        row_sums = sub.sum(axis=1)
        q = (m - 2.0) * sub - row_sums[:, None] - row_sums[None, :]
        np.fill_diagonal(q, np.inf)
        # Reference scans i<j keeping the first strict minimum; replicate by
        # scanning the upper triangle in the same order.
        min_q = np.inf
        min_i, min_j = 0, 1
        for i in range(m):
            for j in range(i + 1, m):
                if q[i, j] < min_q:
                    min_q = q[i, j]
                    min_i, min_j = i, j

        a, b = idxs[min_i], idxs[min_j]
        d_ij = dist[a, b]
        branch_i = d_ij / 2.0 + (row_sums[min_i] - row_sums[min_j]) / (2.0 * (m - 2.0))
        branch_j = d_ij - branch_i

        node_i = active.pop(a)
        node_j = active.pop(b)
        node_i.branch_length = max(branch_i, 0.0)
        node_j.branch_length = max(branch_j, 0.0)
        new_node = TreeNode.internal(next_id, node_i, node_j)

        for k in idxs:
            if k != a and k != b:
                dk = (dist[a, k] + dist[b, k] - d_ij) / 2.0
                dist[next_id, k] = dk
                dist[k, next_id] = dk

        active[next_id] = new_node
        next_id += 1

    (ia, na), (ib, nb) = sorted(active.items())
    final_distance = dist[ia, ib]
    na.branch_length = final_distance / 2.0
    nb.branch_length = final_distance / 2.0
    return TreeNode.internal(next_id, na, nb)


def _tuple_hash_usize(i: int, j: int) -> int:
    """Rust ``(usize, usize).hash`` through DefaultHasher: two 8-byte LE
    words, no length prefix (reference: neighbor_joining.rs:260-269)."""
    return siphash13(i.to_bytes(8, "little") + j.to_bytes(8, "little"))


def sample_with_probability(i: int, j: int, probability: float) -> bool:
    h = _tuple_hash_usize(i, j)
    return (h / float(2**64 - 1)) < probability


def extract_tree_pairs(tree: TreeNode, random_fraction: float) -> np.ndarray:
    """Sample pairs across tree edges (reference: neighbor_joining.rs:232-257)."""
    pairs = set()
    for group1, group2 in tree.get_edges():
        for i in group1:
            for j in group2:
                if i != j and sample_with_probability(i, j, random_fraction):
                    pairs.add((i, j))
    if not pairs:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array(sorted(pairs), dtype=np.int64)
