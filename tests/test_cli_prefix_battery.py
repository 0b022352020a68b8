"""The reference's prefix-filtering CLI battery, with its exact fixtures.

Mirrors reference tests/integration_tests.rs:1240-1804
(`test_keep_prefixes_filtering`, `test_exclude_prefixes_filtering`,
`test_keep_prefixes_with_sparsification`): the same hand-written
sequence sets, the same flag spellings (long and short forms), the same
expected record counts, the whitespace-trimming of prefix lists, and
the stderr message contract ("Kept/Excluded sequences with prefixes:
N -> M", "No sequences match...", "All sequences were excluded...").
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# integration_tests.rs:1244-1251 — the 6-sequence prefix fixture
SIX = [
    ("human_seq1", "ATCGATCGATCGATCG"),
    ("human_seq2", "GCTAGCTAGCTAGCTA"),
    ("mouse_seq1", "TTAGCTAGCTAGCTAG"),
    ("mouse_seq2", "CCATAGCTAGCTAGCT"),
    ("plant_seq1", "GGAAGATCGATCGATC"),
    ("bacteria_seq", "TTTTGATCGATCGATC"),
]

# integration_tests.rs:1681-1690 — the 8-sequence grouped fixture
EIGHT = [
    ("group_A_seq1", "ATCGATCGATCGATCGATCGATCGATCGATCG"),
    ("group_A_seq2", "GCTAGCTAGCTAGCTAGCTAGCTAGCTAGCTA"),
    ("group_A_seq3", "TTAGCTAGCTAGCTAGCTAGCTAGCTAGCTAG"),
    ("group_B_seq1", "CCATAGCTAGCTAGCTAGCTAGCTAGCTAGCT"),
    ("group_B_seq2", "GGAAGATCGATCGATCGATCGATCGATCGATC"),
    ("group_B_seq3", "TTTTGATCGATCGATCGATCGATCGATCGATC"),
    ("other_seq1", "AAAAAAGATCGATCGATCGATCGATCGATCGA"),
    ("other_seq2", "CCCCCCGATCGATCGATCGATCGATCGATCGA"),
]


def _write(tmp_path, seqs, name="in.fa"):
    p = tmp_path / name
    with open(p, "w") as f:
        for sid, s in seqs:
            f.write(f">{sid}\n{s}\n")
    return str(p)


from tests.test_cli import run_cli  # in-process by default (shared helper)


def _ids(stdout):
    out = []
    for line in stdout.strip().splitlines():
        f = line.split("\t")
        if len(f) >= 6:
            out.append((f[0], f[5]))
    return out


class TestKeepPrefixes:
    """integration_tests.rs:1240-1409."""

    def test_single_prefix_long_form(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "--keep-prefixes", "human", "-p", "none"])
        pairs = _ids(proc.stdout)
        assert len(pairs) == 2  # human_seq1<->human_seq2, both directions
        assert all(q.startswith("human") and t.startswith("human") for q, t in pairs)

    def test_multiple_prefixes_short_form(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "-k", "human,mouse", "-p", "none"])
        pairs = _ids(proc.stdout)
        assert len(pairs) == 12  # 4 seqs x 3 others, directed
        ok = ("human", "mouse")
        assert all(q.startswith(ok) and t.startswith(ok) for q, t in pairs)

    def test_non_matching_prefix_fails(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "-k", "virus", "-p", "none"], check=False)
        assert proc.returncode != 0
        assert "No sequences match the specified keep prefixes" in proc.stderr

    def test_whitespace_trimmed(self, tmp_path):
        """' human , mouse ' behaves exactly like 'human,mouse'
        (main.rs:238 trims each prefix)."""
        fa = _write(tmp_path, SIX)
        proc = run_cli(
            ["--input", fa, "--keep-prefixes", " human , mouse ", "-p", "none"]
        )
        assert len(_ids(proc.stdout)) == 12


class TestExcludePrefixes:
    """integration_tests.rs:1411-1575."""

    def test_exclude_single(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "--exclude-prefixes", "human", "-p", "none"])
        pairs = _ids(proc.stdout)
        assert len(pairs) == 12  # 4 remaining seqs, directed
        assert all(
            not q.startswith("human") and not t.startswith("human")
            for q, t in pairs
        )

    def test_exclude_multiple_short_form(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "-e", "human,mouse", "-p", "none"])
        pairs = _ids(proc.stdout)
        assert len(pairs) == 2  # plant_seq1 <-> bacteria_seq
        ok = ("plant", "bacteria")
        assert all(q.startswith(ok) and t.startswith(ok) for q, t in pairs)

    def test_exclude_all_fails(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(
            ["--input", fa, "-e", "human,mouse,plant,bacteria", "-p", "none"],
            check=False,
        )
        assert proc.returncode != 0
        assert "All sequences were excluded" in proc.stderr

    def test_exclude_whitespace_trimmed(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(
            ["--input", fa, "--exclude-prefixes", " human , mouse ", "-p", "none"]
        )
        assert len(_ids(proc.stdout)) == 2


class TestWithSparsification:
    """integration_tests.rs:1677-1804 — filtering composes with
    sparsification, and the stderr count message is exact."""

    def test_keep_with_giant(self, tmp_path):
        fa = _write(tmp_path, EIGHT)
        proc = run_cli(["--input", fa, "-k", "group_A", "-p", "giant:0.99"])
        assert "Kept sequences with prefixes: 8 -> 3" in proc.stderr
        pairs = _ids(proc.stdout)
        assert pairs  # at least some alignments survive sparsification
        assert all(
            q.startswith("group_A") and t.startswith("group_A") for q, t in pairs
        )

    def test_exclude_with_giant(self, tmp_path):
        fa = _write(tmp_path, EIGHT)
        proc = run_cli(
            ["--input", fa, "--exclude-prefixes", "group_B,other", "-p", "giant:0.99"]
        )
        assert "Excluded sequences with prefixes: 8 -> 3" in proc.stderr
        pairs = _ids(proc.stdout)
        assert pairs
        assert all(
            q.startswith("group_A") and t.startswith("group_A") for q, t in pairs
        )
