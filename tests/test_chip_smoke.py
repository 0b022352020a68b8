"""The pure helpers of chip_smoke.py (the on-card smoke test), and its
refusal to run without a GPU."""

import json
import os
import sys

import numpy as np

from allwave import native
from allwave.core.cigar import cigar_bytes_to_string
from allwave.core.scores import parse_scores
from allwave.wfa.params import resolve_penalties

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PEN = resolve_penalties(parse_scores(chip_smoke.SCORES))
SEQS = {
    "a": b"ACGTACGTACGTTTGACCA",
    "b": b"ACGTACCTACGTTTGACCA",
    "c": b"ACGTACGTACGTGACCA",
}


def _records():
    recs = []
    for q, t in (("a", "b"), ("b", "a"), ("a", "c")):
        _, cigar = native.wfa_align_native(SEQS[q], SEQS[t], PEN)
        recs.append(
            dict(qname=q, tname=t, strand="+", cigar=cigar_bytes_to_string(cigar))
        )
    return recs


def test_oracle_comparison_flags_changed_cigar():
    recs = _records()
    assert chip_smoke.oracle_mismatches(recs, SEQS, PEN) == []
    # a mismatch rewritten as an insertion plus a deletion: it consumes
    # the same bases but is another (costlier) CIGAR
    changed = [dict(r) for r in recs]
    changed[0]["cigar"] = changed[0]["cigar"].replace("1X", "1I1D", 1)
    bad = chip_smoke.oracle_mismatches(changed, SEQS, PEN)
    assert len(bad) == 1 and bad[0].startswith("a->b")


def test_oracle_comparison_requires_the_oracle():
    import pytest

    with pytest.raises(RuntimeError, match="oracle"):
        chip_smoke.oracle_mismatches(_records(), SEQS, PEN, oracle=lambda *a: None)


def test_replay_helper_flags_bad_cigar():
    recs = _records()
    assert chip_smoke.replay_failures(recs, SEQS) == []
    bad = [dict(recs[0], cigar="19=")]  # a->b has a mismatch
    assert len(chip_smoke.replay_failures(bad, SEQS)) == 1


def test_result_line_has_the_exact_shape():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }


def test_no_gpu_exits_nonzero_without_result_line(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_sample_is_seeded_and_bounded():
    recs = list(range(2000))
    a = chip_smoke.sample(recs, 512)
    assert a == chip_smoke.sample(recs, 512) and len(set(a)) == 512
    assert chip_smoke.sample(recs[:10], 512) == recs[:10]
    assert np.all(np.diff(a) > 0)
