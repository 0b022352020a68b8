"""MinHash (mash) k-mer sketching — vectorized.

Replicates the reference's sketching semantics exactly
(reference: src/mash.rs:78-133 and
reference src/alignment.rs:97-149):

* k-mer hash = Rust DefaultHasher (SipHash-1-3, zero keys) over the RAW
  window bytes with the [u8] length-prefix discipline — case-sensitive.
* windows containing any non-ACGT (case-insensitive) byte are skipped.
* canonical sketch (distance matrices): per window take
  min(hash(fwd), hash(revcomp-uppercased)); the reference's k-mer reverse
  complement uppercases bases (mash.rs:122-133).
* stranded sketch (orientation detection): fwd hash only, no
  canonicalization (alignment.rs:97-122).
* bottom-k MinHash = sort ALL window hashes ascending (duplicates kept!)
  and truncate to sketch_size (mash.rs:103-106). Deduplication happens only
  inside Jaccard, which is set-based (mash.rs:40-56).

Unlike the reference — which re-sketches the target for every pair
(alignment.rs:78, an O(pairs * L) hot spot) — callers here sketch each
sequence once and reuse (see the orient and engine packages).
The results are identical because sketching is deterministic.
"""

from __future__ import annotations

import functools

import math
from typing import List, Sequence as PySequence

import numpy as np

import jax
import jax.numpy as jnp

from ..core.types import Sequence
from ..hashing.siphash import hash_kmers

DEFAULT_KMER_SIZE = 15  # reference: mash.rs:12
DEFAULT_SKETCH_SIZE = 1000  # reference: mash.rs:15

#: smallest sketch count for which pairwise_intersection_counts uses the
#: device membership matmul instead of the NumPy bitmap pass (the device
#: path pays a compile per shape bucket and a dispatch; the bitmap pass
#: grows ~n^2)
DEVICE_MIN_N = 128

# Per-byte tables ------------------------------------------------------------

# valid DNA base, case-insensitive (reference: mash.rs:117-119)
_IS_DNA = np.zeros(256, dtype=bool)
for _b in b"ACGTacgt":
    _IS_DNA[_b] = True

# k-mer complement: uppercase ACGT mapping, all other bytes preserved
# (reference: mash.rs:122-133)
_KMER_COMP = np.arange(256, dtype=np.uint8)
for _src, _dst in zip(b"ACGTacgt", b"TGCATGCA"):
    _KMER_COMP[_src] = _dst


def _valid_window_mask(seq: np.ndarray, k: int) -> np.ndarray:
    """Boolean mask over windows: True iff all k bases are ACGT (any case)."""
    bad = ~_IS_DNA[seq]
    if not bad.any():  # common case: pure ACGT, every window valid
        return np.ones(seq.size - k + 1, dtype=bool)
    csum = np.concatenate(([0], np.cumsum(bad.astype(np.int64))))
    return (csum[k:] - csum[:-k]) == 0


def _bottom_k_sorted(h: np.ndarray, sketch_size: int) -> np.ndarray:
    """Smallest ``sketch_size`` values of ``h``, ascending, duplicates
    kept — identical to ``np.sort(h)[:sketch_size]`` (values are plain
    uint64 scalars, so stability is unobservable) but O(n) via
    ``np.partition`` instead of a full O(n log n) sort. This is the
    orientation hot spot for long sequences (~8 ms -> ~1 ms per 100 kb
    sketch)."""
    if h.size > sketch_size:
        h = np.partition(h, sketch_size - 1)[:sketch_size]
    return np.sort(h, kind="stable")


def sketch_stranded(seq_bytes: bytes, k: int, sketch_size: int) -> np.ndarray:
    """Strand-specific MinHash sketch (reference: alignment.rs:97-122).

    Returns sorted uint64 hashes, truncated to sketch_size, duplicates kept.
    """
    seq = np.frombuffer(seq_bytes, dtype=np.uint8)
    if seq.size < k:
        return np.zeros(0, dtype=np.uint64)
    hashes = hash_kmers(seq, k)
    valid = _valid_window_mask(seq, k)
    return _bottom_k_sorted(hashes[valid], sketch_size)


def sketch_canonical(seq_bytes: bytes, k: int, sketch_size: int) -> np.ndarray:
    """Canonical MinHash sketch (reference: mash.rs:78-107).

    Per valid window: min(hash(fwd raw bytes), hash(revcomp window)), where
    the revcomp window is built with the uppercasing k-mer complement.
    """
    seq = np.frombuffer(seq_bytes, dtype=np.uint8)
    if seq.size < k:
        return np.zeros(0, dtype=np.uint64)
    fwd = hash_kmers(seq, k)
    # revcomp of window i of seq == window (L-k-i) of revcomp(seq)
    rc_seq = _KMER_COMP[seq][::-1]
    rev = hash_kmers(np.ascontiguousarray(rc_seq), k)[::-1]
    canonical = np.minimum(fwd, rev)
    valid = _valid_window_mask(seq, k)
    return _bottom_k_sorted(canonical[valid], sketch_size)


def jaccard(sketch1: np.ndarray, sketch2: np.ndarray) -> float:
    """Set-based Jaccard of two sketches (reference: mash.rs:40-56)."""
    s1 = np.unique(sketch1)
    s2 = np.unique(sketch2)
    inter = np.intersect1d(s1, s2, assume_unique=True).size
    union = s1.size + s2.size - inter
    if union == 0:
        return 0.0
    return inter / union


def mash_distance_from_jaccard(j: float, k: int) -> float:
    """Mash distance d = -(1/k) * ln(2J/(1+J)); J<=0 => 1.0
    (reference: mash.rs:59-74)."""
    if j <= 0.0:
        return 1.0
    ratio = (2.0 * j) / (1.0 + j)
    if ratio <= 0.0:
        return 1.0
    return (-1.0 / k) * math.log(ratio)


class KmerSketch:
    """API-parity wrapper mirroring the reference's KmerSketch
    (reference: mash.rs:19-75)."""

    def __init__(self, minimizers: np.ndarray, k: int, length: int):
        self.minimizers = minimizers
        self.k = k
        self.length = length

    @staticmethod
    def from_sequence(
        sequence: bytes, k: int = DEFAULT_KMER_SIZE, sketch_size: int = DEFAULT_SKETCH_SIZE
    ) -> "KmerSketch":
        return KmerSketch(sketch_canonical(sequence, k, sketch_size), k, len(sequence))

    def jaccard(self, other: "KmerSketch") -> float:
        if self.k != other.k:
            return 0.0
        return jaccard(self.minimizers, other.minimizers)

    def mash_distance(self, other: "KmerSketch") -> float:
        return mash_distance_from_jaccard(self.jaccard(other), self.k)


def pairwise_intersection_counts(sketches: List[np.ndarray]) -> np.ndarray:
    """(n, n) int64 intersection counts between deduplicated sketches.

    One global dense-id pass + a value->sketch bitmap (the same scheme
    as orient.OrientationIndex._decision_matrix): per sketch the counts
    against ALL others come from a row-take + unpackbits + column sum —
    no per-pair set operations (np.intersect1d per pair re-sorts both
    arrays every call and made tree: sparsification O(n^2) slow)."""
    n = len(sketches)
    counts = np.zeros((n, n), dtype=np.int64)
    if n == 0:
        return counts
    sizes = np.array([s.size for s in sketches], dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return counts
    # on the CPU backend the bitmap pass IS the host path; elsewhere the
    # device matmul takes over from DEVICE_MIN_N sketches on
    if n >= DEVICE_MIN_N and jax.default_backend() != "cpu":
        try:
            return _intersection_counts_device(sketches, sizes)
        except MemoryError:
            pass  # over the device budget (raised before any dispatch)
    return _intersection_counts_host(sketches, sizes)


def _intersection_counts_host(sketches, sizes) -> np.ndarray:
    """NumPy bitmap pass of pairwise_intersection_counts (the reference
    the device path is checked against)."""
    n = len(sketches)
    counts = np.zeros((n, n), dtype=np.int64)
    all_vals = np.concatenate(sketches)
    uniq, inv = np.unique(all_vals, return_inverse=True)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    nbytes = (n + 7) // 8
    bitmap = np.zeros((uniq.size, nbytes), dtype=np.uint8)
    for j in range(n):
        rows = inv[offs[j] : offs[j + 1]]
        np.bitwise_or.at(bitmap[:, j >> 3], rows, np.uint8(1 << (j & 7)))
    for i in range(n):
        rows = inv[offs[i] : offs[i + 1]]
        if rows.size == 0:
            continue
        bits = np.unpackbits(bitmap[rows], axis=1, count=n, bitorder="little")
        counts[i] = bits.sum(axis=0, dtype=np.int64)
    return counts


def compute_distance_matrix_with_params(
    sequences: PySequence[Sequence],
    k: int = DEFAULT_KMER_SIZE,
    sketch_size: int = DEFAULT_SKETCH_SIZE,
) -> np.ndarray:
    """All-vs-all symmetric mash distance matrix
    (reference: mash.rs:141-165). Same float64 Jaccard/distance values
    as the per-pair path, computed with one bitmap-intersection pass."""
    n = len(sequences)
    sketches: List[np.ndarray] = [
        np.unique(sketch_canonical(s.seq, k, sketch_size)) for s in sequences
    ]
    sizes = np.array([s.size for s in sketches], dtype=np.int64)
    inter = pairwise_intersection_counts(sketches)
    union = sizes[:, None] + sizes[None, :] - inter
    # vectorized mash formula — same float64 operations per element as
    # mash_distance_from_jaccard (the n^2 Python loop was ~1 s at n=1000)
    jac = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    ratio = (2.0 * jac) / (1.0 + jac)
    with np.errstate(divide="ignore"):
        matrix = np.where(
            (jac <= 0.0) | (ratio <= 0.0),
            1.0,
            (-1.0 / k) * np.log(np.maximum(ratio, 1e-300)),
        )
    np.fill_diagonal(matrix, 0.0)
    return matrix


def compute_distance_matrix(sequences: PySequence[Sequence]) -> np.ndarray:
    return compute_distance_matrix_with_params(
        sequences, DEFAULT_KMER_SIZE, DEFAULT_SKETCH_SIZE
    )


def format_distance_matrix(
    sequences: PySequence[Sequence], matrix: np.ndarray
) -> str:
    """TSV rendering (reference: mash.rs:168-184)."""
    lines = ["sequence" + "".join(f"\t{s.id}" for s in sequences)]
    for i, s in enumerate(sequences):
        row = "".join(f"\t{matrix[i, j]:.6f}" for j in range(len(sequences)))
        lines.append(f"{s.id}{row}")
    return "\n".join(lines) + "\n"


def _intersection_counts_device(sketches, sizes) -> np.ndarray:
    """Device twin of the bitmap pass: hashes remap to dense int32 codes
    (host), membership rows build on device by scatter, and all
    pairwise counts come from ONE (n x U) @ (U x n) int8 matmul with
    int32 accumulation — exact integers, so downstream float64
    Jaccard/mash values are bit-identical to the NumPy path. Static
    dims bucket (n to 64, U to 16384) so the jit cache survives across
    workloads. Raises MemoryError, before any dispatch, when the
    membership matrix is over the device budget."""
    from ..utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    n = len(sketches)
    all_vals = np.concatenate(sketches)
    uniq, inv = np.unique(all_vals, return_inverse=True)
    U = int(uniq.size)
    n_pad = -(-n // 64) * 64
    u_pad = -(-(U + 1) // 16384) * 16384
    if n_pad * (u_pad + 1) > (2 << 30):
        raise MemoryError("membership matrix over device budget")
    S = -(-max(int(sizes.max()), 1) // 256) * 256
    codes = np.full((n_pad, S), u_pad, dtype=np.int32)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    for r in range(n):
        codes[r, : offs[r + 1] - offs[r]] = inv[offs[r] : offs[r + 1]]
    counts = _membership_counts(jnp.asarray(codes), n_pad, u_pad)
    return np.asarray(counts)[:n, :n].astype(np.int64)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _membership_counts(codes_d, n_, U_):
    """(n, n) int32 pairwise intersection counts from padded dense-id
    code rows (sentinel U_ drops into the discarded padding column)."""
    rows = jnp.arange(n_, dtype=jnp.int32)[:, None]
    m = jnp.zeros((n_, U_ + 1), jnp.int8)
    m = m.at[rows, codes_d].set(1, mode="drop")
    m = m[:, :U_]
    return jax.lax.dot_general(
        m, m, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )
