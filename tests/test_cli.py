"""Integration tests — subprocess style, like the reference's
tests/integration_tests.rs: generate a seeded synthetic FASTA, run the
CLI, parse the PAF from stdout, replay every CIGAR against the inputs,
and assert on coverage / identity / exact mutation counts."""

import os
import subprocess
import sys

import numpy as np
import pytest

from allwave.core.cigar import cigar_string_to_bytes, validate_cigar
from allwave.core.types import Sequence
from allwave.engine.fasta import read_fasta, write_fasta
from allwave.testing.synth import MutationConfig, make_test_case, random_dna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, check=True, in_process=True):
    """Drive the CLI. In-process by default — a fresh subprocess pays a
    ~9 s jax import per test on this 1-core host (~90 s over the file),
    while main(argv) exercises the same argparse -> pipeline -> writer
    path. A couple of smoke tests keep in_process=False so the real
    entry point (python -m allwave.cli) stays covered."""
    if in_process:
        import io
        from contextlib import redirect_stderr, redirect_stdout

        from allwave import cli as _cli

        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            try:
                rc = _cli.main([str(a) for a in args])
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        proc = subprocess.CompletedProcess(
            list(args), rc, out.getvalue(), err.getvalue()
        )
    else:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        proc = subprocess.run(
            [sys.executable, "-m", "allwave.cli", *args],
            capture_output=True,
            text=True,
            cwd=REPO,
            env=env,
            timeout=900,
        )
    if check and proc.returncode != 0:
        raise AssertionError(
            f"CLI failed rc={proc.returncode}\nstderr:\n{proc.stderr}"
        )
    return proc


def parse_paf(text):
    records = []
    for line in text.strip().split("\n"):
        if not line:
            continue
        f = line.split("\t")
        rec = {
            "qname": f[0],
            "qlen": int(f[1]),
            "qstart": int(f[2]),
            "qend": int(f[3]),
            "strand": f[4],
            "tname": f[5],
            "tlen": int(f[6]),
            "tstart": int(f[7]),
            "tend": int(f[8]),
            "matches": int(f[9]),
            "block_len": int(f[10]),
            "mapq": int(f[11]),
        }
        for tag in f[12:]:
            if tag.startswith("gi:f:"):
                rec["identity"] = float(tag[5:])
            elif tag.startswith("cg:Z:"):
                rec["cigar"] = tag[5:]
        records.append(rec)
    return records


def _replay(rec, seqs_by_id):
    """Replay a PAF record's CIGAR against the sequences."""
    from allwave.orient.orientation import reverse_complement

    q = seqs_by_id[rec["qname"]].seq
    t = seqs_by_id[rec["tname"]].seq
    if rec["strand"] == "-":
        q = reverse_complement(q)
    cigar = cigar_string_to_bytes(rec["cigar"])
    validate_cigar(cigar, q, t)


@pytest.fixture(scope="module")
def basic_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fasta")
    case = make_test_case(
        seed=42,
        n_sequences=4,
        length=400,
        cfg=MutationConfig(snp_rate=0.01, insertion_rate=0.002, deletion_rate=0.002),
    )
    path = tmp / "basic.fa"
    case.write_fasta(str(path))
    return case, str(path)


def test_basic_all_pairs(basic_case):
    case, path = basic_case
    proc = run_cli(["-i", path, "-p", "none", "-t", "1", "--no-progress"])
    records = parse_paf(proc.stdout)
    n = len(case.sequences)
    assert len(records) == n * (n - 1)  # directed all-pairs
    seqs_by_id = {s.id: s for s in case.sequences}
    for rec in records:
        assert rec["qstart"] == 0 and rec["tstart"] == 0  # global
        assert rec["mapq"] == 60
        assert rec["identity"] > 0.9
        coverage = rec["qend"] / rec["qlen"]
        assert coverage > 0.95
        _replay(rec, seqs_by_id)


def test_identical_sequences(tmp_path):
    # reference: integration_tests.rs:216-260 — identical sequences give
    # exactly 100% identity, full coverage, no X/I/D
    rng = np.random.RandomState(5)
    seq = random_dna(rng, 300)
    seqs = [Sequence("a", seq), Sequence("b", seq)]
    path = tmp_path / "ident.fa"
    write_fasta(str(path), seqs)
    proc = run_cli(["-i", str(path), "-p", "none", "--no-progress"])
    records = parse_paf(proc.stdout)
    assert len(records) == 2
    for rec in records:
        assert rec["identity"] == 1.0
        assert rec["qend"] == 300 and rec["tend"] == 300
        assert rec["cigar"] == "300="
        assert rec["matches"] == 300


def test_exact_mutation_counts(tmp_path):
    # reference: integration_tests.rs:599-672 — hand-placed 2 SNPs + 1 ins
    # + 1 del must yield exactly 2X, and the right indel lengths
    rng = np.random.RandomState(77)
    base = bytearray(random_dna(rng, 500))
    mutated = bytearray(base)
    for pos in (100, 300):
        old = mutated[pos]
        mutated[pos] = [b for b in b"ACGT" if b != old][0]
    # insertion of 4 bases at 200 in the mutated copy
    mutated[200:200] = b"TTTT" if base[199:200] != b"T" else b"GGGG"
    # deletion of 3 bases at 400 (coords after insertion: 404)
    del mutated[404:407]
    seqs = [Sequence("orig", bytes(base)), Sequence("mut", bytes(mutated))]
    path = tmp_path / "exact.fa"
    write_fasta(str(path), seqs)
    proc = run_cli(["-i", str(path), "-p", "none", "--no-progress"])
    records = parse_paf(proc.stdout)
    seqs_by_id = {s.id: s for s in seqs}
    for rec in records:
        _replay(rec, seqs_by_id)
        cigar = rec["cigar"]
        # count op totals from the RLE string
        import re

        tot = {"X": 0, "I": 0, "D": 0, "=": 0}
        for count, op in re.findall(r"(\d+)([=XID])", cigar):
            tot[op] += int(count)
        assert tot["X"] == 2, cigar
        assert tot["I"] + tot["D"] == 7, cigar  # 4 ins + 3 del


def test_strand_detection(tmp_path):
    # reference: integration_tests.rs:443-555 — q and rc(q) vs target give
    # + and - with near-equal identity
    from allwave.orient.orientation import reverse_complement

    rng = np.random.RandomState(9)
    target = random_dna(rng, 600)
    fwd = bytearray(target)
    fwd[50] = ord("A") if fwd[50] != ord("A") else ord("C")
    rev = reverse_complement(bytes(fwd))
    seqs = [
        Sequence("target", target),
        Sequence("fwd", bytes(fwd)),
        Sequence("rev", rev),
    ]
    path = tmp_path / "strand.fa"
    write_fasta(str(path), seqs)
    proc = run_cli(["-i", str(path), "-p", "none", "--no-progress"])
    records = parse_paf(proc.stdout)
    by_pair = {(r["qname"], r["tname"]): r for r in records}
    assert by_pair[("fwd", "target")]["strand"] == "+"
    assert by_pair[("rev", "target")]["strand"] == "-"
    id_fwd = by_pair[("fwd", "target")]["identity"]
    id_rev = by_pair[("rev", "target")]["identity"]
    assert abs(id_fwd - id_rev) < 0.01
    seqs_by_id = {s.id: s for s in seqs}
    for rec in records:
        _replay(rec, seqs_by_id)


def test_pair_count_none_sparsification(basic_case):
    # reference: integration_tests.rs:755-836 — n(n-1) with -p none
    case, path = basic_case
    proc = run_cli(["-i", path, "-p", "none", "--no-progress"])
    assert len(parse_paf(proc.stdout)) == 4 * 3


def test_keep_prefixes(tmp_path, basic_case):
    case, path = basic_case
    proc = run_cli(
        ["-i", path, "-p", "none", "--no-progress", "-k", "seq1,seq2"]
    )
    assert "Kept sequences with prefixes: 4 -> 2 (prefixes: seq1,seq2)" in proc.stderr
    records = parse_paf(proc.stdout)
    names = {r["qname"] for r in records} | {r["tname"] for r in records}
    assert names == {"seq1", "seq2"}


def test_exclude_prefixes(basic_case):
    case, path = basic_case
    proc = run_cli(["-i", path, "-p", "none", "--no-progress", "-e", "seq0"])
    assert "Excluded sequences with prefixes: 4 -> 3 (prefixes: seq0)" in proc.stderr
    records = parse_paf(proc.stdout)
    assert len(records) == 3 * 2


def test_keep_exclude_conflict(basic_case):
    case, path = basic_case
    proc = run_cli(
        ["-i", path, "-k", "a", "-e", "b", "--no-progress"], check=False
    )
    assert proc.returncode != 0


def test_keep_prefix_no_match(basic_case):
    case, path = basic_case
    proc = run_cli(
        ["-i", path, "-k", "nomatch", "--no-progress"], check=False
    )
    assert proc.returncode != 0
    assert "No sequences match the specified keep prefixes" in proc.stderr


def test_preset_conflicts_with_scores(basic_case):
    case, path = basic_case
    proc = run_cli(
        ["-i", path, "-s", "0,1,1,1", "-x", "95%", "--no-progress"], check=False
    )
    assert proc.returncode != 0


def test_preset_message(basic_case):
    case, path = basic_case
    proc = run_cli(["-i", path, "-x", "95%", "-p", "none", "--no-progress"])
    assert "Using ANI preset 95% -> alignment scores: 0,7,12,2,36,1" in proc.stderr


def test_mash_matrix(basic_case):
    case, path = basic_case
    proc = run_cli(["-i", path, "--mash-matrix", "--no-progress"])
    lines = proc.stdout.strip().split("\n")
    assert lines[0].startswith("sequence\t")
    assert len(lines) == 5  # header + 4 rows
    # diagonal zeros
    for i, line in enumerate(lines[1:]):
        fields = line.split("\t")
        assert float(fields[1 + i]) == 0.0


def test_gzip_input(tmp_path, basic_case):
    import gzip as gz

    case, path = basic_case
    gz_path = tmp_path / "in.fa.gz"
    with open(path, "rb") as f, gz.open(gz_path, "wb") as g:
        g.write(f.read())
    proc = run_cli(["-i", str(gz_path), "-p", "none", "--no-progress"])
    assert len(parse_paf(proc.stdout)) == 12


def test_output_file(tmp_path, basic_case):
    case, path = basic_case
    out = tmp_path / "out.paf"
    run_cli(["-i", path, "-p", "none", "--no-progress", "-o", str(out)])
    records = parse_paf(out.read_text())
    assert len(records) == 12


def test_progress_lines(basic_case):
    case, path = basic_case
    proc = run_cli(["-i", path, "-p", "none"])
    assert "alignments/sec" in proc.stderr
    assert "Complete!" in proc.stderr


def test_invalid_sparsification(basic_case):
    case, path = basic_case
    proc = run_cli(["-i", path, "-p", "bogus", "--no-progress"], check=False)
    assert proc.returncode != 0
    assert "Invalid sparsification strategy" in proc.stderr


def test_edit_distance_scores(basic_case):
    # BASELINE config 1: all-pairs with 0,1,1,1
    case, path = basic_case
    proc = run_cli(
        ["-i", path, "-p", "none", "-s", "0,1,1,1", "--no-progress"]
    )
    records = parse_paf(proc.stdout)
    assert len(records) == 12
    seqs_by_id = {s.id: s for s in case.sequences}
    for rec in records:
        _replay(rec, seqs_by_id)


def test_wfa_orientation_flag(tmp_path):
    from allwave.orient.orientation import reverse_complement

    rng = np.random.RandomState(31)
    t = random_dna(rng, 200)
    seqs = [Sequence("t", t), Sequence("r", reverse_complement(t))]
    path = tmp_path / "wfa_orient.fa"
    write_fasta(str(path), seqs)
    proc = run_cli(
        ["-i", str(path), "-p", "none", "--no-progress", "--wfa-orientation"]
    )
    records = parse_paf(proc.stdout)
    by_pair = {(r["qname"], r["tname"]): r for r in records}
    assert by_pair[("r", "t")]["strand"] == "-"
    assert by_pair[("t", "r")]["strand"] == "-"


def test_cli_module_entry_smoke():
    """The real `python -m allwave.cli` entry point still parses
    args and fails cleanly — the one remaining subprocess rung, kept
    cheap by exiting at argparse (no alignment, no device work)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "allwave.cli", "--help"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "-i" in r.stdout and "--sparsification" in r.stdout


def test_resume_skips_done_pairs(tmp_path):
    """--resume appends only the missing pairs; the merged file covers
    every pair exactly once."""
    case = make_test_case(
        seed=77,
        n_sequences=4,
        length=100,
        cfg=MutationConfig(snp_rate=0.02),
    )
    fa = tmp_path / "resume.fa"
    case.write_fasta(str(fa))
    out = tmp_path / "out.paf"
    # full run to learn the expected record set
    r = run_cli(["-i", str(fa), "-p", "none", "-o", str(out), "--no-progress"])
    full = sorted(out.read_text().strip().splitlines())
    assert full
    # truncate to half and resume
    half = full[: len(full) // 2]
    out.write_text("\n".join(half) + "\n")
    r = run_cli(
        ["-i", str(fa), "-p", "none", "-o", str(out), "--no-progress",
         "--resume"]
    )
    assert "Resuming:" in r.stderr
    merged = sorted(out.read_text().strip().splitlines())
    keys = [(l.split("\t")[0], l.split("\t")[5]) for l in merged]
    want = [(l.split("\t")[0], l.split("\t")[5]) for l in full]
    assert sorted(keys) == sorted(want)
    assert len(keys) == len(set(keys))
