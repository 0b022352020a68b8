"""The reference's 8-case mash-vs-WFA orientation agreement battery.

Mirrors reference tests/integration_tests.rs:865-1237
(`test_orientation_detection_comparison` + `create_orientation_test_cases`):
for each constructed case, BOTH orientation methods (MinHash stranded
sketches and WFA edit distance) must pick the same strand, and that
strand must match the construction. Case list (names follow the
reference):

  1 identical_sequences        (1 kb, expect forward)
  2 forward_with_mutations     (1 kb, 1% SNPs, forward)
  3 reverse_with_mutations     (1 kb revcomp, 1% SNPs, reverse)
  4 high_mutation_forward      (1 kb, 5% SNPs, forward)
  5 high_mutation_reverse      (1 kb revcomp, 5% SNPs, reverse)
  6 short_sequences_reverse    (100 bp revcomp, reverse)
  7 long_sequences_forward     (10 kb, 0.1% SNPs, forward)
  8 ambiguous_high_mutation    (500 bp, 20% SNPs, forward)

The RNG differs from the reference's StdRng (no Rust here); the cases'
structure, lengths, and rates are the contract being tested.
"""

import numpy as np
import pytest

from allwave.core.types import AlignmentParams
from allwave.orient.orientation import (
    determine_orientation_mash,
    reverse_complement,
)
from allwave.wfa.simple import _determine_orientation_wfa

_BASES = np.frombuffer(b"ATGC", dtype=np.uint8)


def _gen(rng, n):
    return rng.choice(_BASES, n).astype(np.uint8).tobytes()


def _mutate(seq: bytes, rate: float, rng) -> bytes:
    """SNP-only mutation, always to a different base
    (integration_tests.rs apply_test_mutations)."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    hit = np.flatnonzero(rng.rand(arr.size) < rate)
    for i in hit:
        choices = _BASES[_BASES != arr[i]]
        arr[i] = choices[rng.randint(3)]
    return arr.tobytes()


def _cases():
    rng = np.random.RandomState(12345)
    out = []
    r = _gen(rng, 1000)
    out.append(("identical_sequences", r, r, False))
    r = _gen(rng, 1000)
    out.append(("forward_with_mutations", r, _mutate(r, 0.01, rng), False))
    r = _gen(rng, 1000)
    out.append(
        ("reverse_with_mutations", r, _mutate(reverse_complement(r), 0.01, rng), True)
    )
    r = _gen(rng, 1000)
    out.append(("high_mutation_forward", r, _mutate(r, 0.05, rng), False))
    r = _gen(rng, 1000)
    out.append(
        ("high_mutation_reverse", r, _mutate(reverse_complement(r), 0.05, rng), True)
    )
    r = _gen(rng, 100)
    out.append(("short_sequences_reverse", r, reverse_complement(r), True))
    r = _gen(rng, 10000)
    out.append(("long_sequences_forward", r, _mutate(r, 0.001, rng), False))
    r = _gen(rng, 500)
    out.append(("ambiguous_high_mutation", r, _mutate(r, 0.2, rng), False))
    return out


@pytest.mark.parametrize(
    "name,reference,query,expected_reverse",
    _cases(),
    ids=[c[0] for c in _cases()],
)
def test_orientation_detection_comparison(name, reference, query, expected_reverse):
    _, mash_rev = determine_orientation_mash(query, reference)
    _, wfa_rev = _determine_orientation_wfa(
        query, reference, AlignmentParams.edit_distance()
    )
    assert mash_rev == wfa_rev, f"methods disagree for {name}"
    assert mash_rev == expected_reverse, f"mash wrong for {name}"
    assert wfa_rev == expected_reverse, f"wfa wrong for {name}"
