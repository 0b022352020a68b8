"""Smoke test of the FASTA -> PAF path on a GPU.

Drives the command-line entry point (`allwave.cli.main`) on seeded
synthetic data at full size and checks what comes out with the
repository's own references: every CIGAR replays against its sequences,
a sample of pairs (all of them for long pairs) matches the C++ WFA
oracle (csrc/wfa_oracle.cpp) exactly, strands match the host orientation
decision matrix, and the device matmul paths of orientation and MinHash
equal their NumPy twins. Each phase runs twice in this one process: the
first run includes compilation, the second is warm.

Usage, from the repository root on a machine with a GPU:

    python chip_smoke.py                # phases 1-3 on one card
    python chip_smoke.py --four-cards   # only the 4-card mesh phase

Earlier lines report the card (nvidia-smi name and power limit) and,
per phase, wall times, pairs/s, compile time and peak device memory.
The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

It exits non-zero, with no such line, when JAX finds no GPU or when any
phase fails. It never selects a JAX platform.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SCORES = "0,5,8,2,24,1"
#: bench.py's headline set: 128 x 1 kb at 2% divergence
HEADLINE = dict(
    seed=1234, n_sequences=128, length=1000, snp_rate=0.02, indel_rate=0.0005
)
#: mixed strands, sparsified: every odd sequence reverse-complemented
MIXED = dict(
    seed=2, n_sequences=500, length=2000, snp_rate=0.02, indel_rate=0.0005
)
#: 100 kb at 0.25% divergence (cell 5b's shape, 56 directed pairs)
LONG = dict(
    seed=18, n_sequences=8, length=100_000, snp_rate=0.0025, indel_rate=0.0001
)
ORACLE_SAMPLE = 512


# ---------------------------------------------------------------------------
# Pure helpers (no device)
# ---------------------------------------------------------------------------


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line this script prints on success."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def parse_paf(text: str):
    """PAF text -> list of dicts (the fields the checks read)."""
    recs = []
    for line in text.splitlines():
        if not line:
            continue
        f = line.split("\t")
        cigar = next((t[5:] for t in f[12:] if t.startswith("cg:Z:")), "")
        recs.append(dict(qname=f[0], strand=f[4], tname=f[5], cigar=cigar))
    return recs


def oriented_query(rec, seqs_by_id) -> bytes:
    from allwave.orient.orientation import reverse_complement

    q = seqs_by_id[rec["qname"]]
    return reverse_complement(q) if rec["strand"] == "-" else q


def replay_failures(recs, seqs_by_id):
    """Records whose CIGAR does not replay against its sequences."""
    from allwave.core.cigar import cigar_string_to_bytes, validate_cigar

    bad = []
    for r in recs:
        try:
            validate_cigar(
                cigar_string_to_bytes(r["cigar"]),
                oriented_query(r, seqs_by_id),
                seqs_by_id[r["tname"]],
            )
        except ValueError as e:
            bad.append(f"{r['qname']}->{r['tname']}: {e}")
    return bad


def oracle_mismatches(recs, seqs_by_id, pen, oracle=None):
    """Records whose CIGAR or score differs from the C++ oracle's on the
    same oriented pair. A missing oracle is an error, not a skip."""
    from allwave.core.cigar import cigar_bytes_to_string, cigar_string_to_bytes
    from allwave.testing.dense import cigar_score

    if oracle is None:
        from allwave.native import wfa_align_native as oracle
    bad = []
    for r in recs:
        out = oracle(oriented_query(r, seqs_by_id), seqs_by_id[r["tname"]], pen)
        if out is None:
            raise RuntimeError("the C++ oracle (csrc/) is unavailable")
        want_score, want_cigar = out
        got_score = cigar_score(cigar_string_to_bytes(r["cigar"]), pen)
        if cigar_bytes_to_string(want_cigar) != r["cigar"] or got_score != want_score:
            bad.append(
                f"{r['qname']}->{r['tname']}: score {got_score} vs {want_score}"
            )
    return bad


def sample(recs, n: int, seed: int = 0):
    if len(recs) <= n:
        return list(recs)
    pick = np.sort(np.random.default_rng(seed).choice(len(recs), n, replace=False))
    return [recs[i] for i in pick]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


# ---------------------------------------------------------------------------
# Device and run helpers
# ---------------------------------------------------------------------------


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def peak_bytes():
    import jax

    return [
        (d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.local_devices()
    ]


def make_seqs(seed, n_sequences, length, snp_rate, indel_rate, reverse_odd=False):
    from allwave.core.types import Sequence
    from allwave.orient.orientation import reverse_complement
    from allwave.testing.synth import MutationConfig, make_test_case

    cfg = MutationConfig(
        snp_rate=snp_rate, insertion_rate=indel_rate, deletion_rate=indel_rate
    )
    case = make_test_case(seed=seed, n_sequences=n_sequences, length=length, cfg=cfg)
    seqs = case.sequences
    if reverse_odd:
        seqs = [
            Sequence(s.id, reverse_complement(s.seq) if i % 2 else s.seq)
            for i, s in enumerate(seqs)
        ]
    return seqs


def run_cli(tmp: str, name: str, seqs, extra):
    """One CLI run: FASTA -> PAF file. Returns (PAF text, wall seconds)."""
    from allwave import cli
    from allwave.engine.fasta import write_fasta

    fasta = os.path.join(tmp, f"{name}.fa")
    if not os.path.exists(fasta):
        write_fasta(fasta, seqs)
    out = os.path.join(tmp, f"{name}.paf")
    t0 = time.perf_counter()
    rc = cli.main(["-i", fasta, "-o", out, "-s", SCORES, "--no-progress", *extra])
    wall = time.perf_counter() - t0
    _require(rc == 0, f"{name}: CLI exited {rc}")
    with open(out) as f:
        return f.read(), wall


def run_phase(tmp: str, name: str, seqs, extra):
    """Cold then warm CLI run; the two PAF outputs must be identical.
    Prints the phase's timings and returns the parsed records."""
    text_cold, cold = run_cli(tmp, name, seqs, extra)
    text, warm = run_cli(tmp, name, seqs, extra)
    _require(
        sorted(text_cold.splitlines()) == sorted(text.splitlines()),
        f"{name}: cold and warm runs differ",
    )
    recs = parse_paf(text)
    print(
        f"phase {name}: {len(recs)} pairs, cold {cold:.3f} s, warm {warm:.3f} s,"
        f" {len(recs) / warm:.1f} pairs/s warm, compile ~{cold - warm:.3f} s"
        f" (cold - warm), peak device bytes {peak_bytes()}",
        flush=True,
    )
    return recs


def check_records(name, recs, seqs, n_expected, oracle_recs):
    from allwave.core.scores import parse_scores
    from allwave.wfa.params import resolve_penalties

    seqs_by_id = {s.id: s.seq for s in seqs}
    _require(len(recs) == n_expected, f"{name}: {len(recs)} records, want {n_expected}")
    bad = replay_failures(recs, seqs_by_id)
    _require(not bad, f"{name}: {len(bad)} CIGARs fail to replay: {bad[:3]}")
    pen = resolve_penalties(parse_scores(SCORES))
    t0 = time.perf_counter()
    bad = oracle_mismatches(oracle_recs, seqs_by_id, pen)
    _require(not bad, f"{name}: {len(bad)} pairs differ from the oracle: {bad[:3]}")
    print(
        f"phase {name}: {len(recs)} CIGARs replay; {len(oracle_recs)} pairs equal"
        f" the C++ oracle ({time.perf_counter() - t0:.1f} s)",
        flush=True,
    )


def _best_of(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_headline(tmp: str, seqs=None) -> None:
    seqs = seqs or make_seqs(**HEADLINE)
    n = len(seqs)
    recs = run_phase(tmp, "headline", seqs, ["-p", "none"])
    check_records("headline", recs, seqs, n * (n - 1), sample(recs, ORACLE_SAMPLE))


def phase_mixed(tmp: str, seqs=None) -> None:
    from allwave.core.types import ConnectivitySparsification
    from allwave.orient.orientation import OrientationIndex
    from allwave.sketch import minhash as M
    from allwave.sparsify.pairs import build_pairs

    seqs = seqs or make_seqs(reverse_odd=True, **MIXED)
    n = len(seqs)
    recs = run_phase(tmp, "mixed", seqs, ["-p", "giant:0.99"])

    n_pairs = build_pairs(seqs, ConnectivitySparsification(0.99), True).shape[0]
    check_records("mixed", recs, seqs, n_pairs, sample(recs, ORACLE_SAMPLE))

    # strands against the host (NumPy) decision matrix
    index = {s.id: i for i, s in enumerate(seqs)}
    host = OrientationIndex(seqs)
    dec = host._decision_matrix()
    wrong = [
        r for r in recs
        if (r["strand"] == "-") != bool(dec[index[r["qname"]], index[r["tname"]]])
    ]
    _require(not wrong, f"mixed: {len(wrong)} strands differ from the host matrix")
    n_rev = sum(r["strand"] == "-" for r in recs)
    print(f"phase mixed: all {len(recs)} strands match ({n_rev} reverse)", flush=True)

    # the device matmul twins against their NumPy references, and the
    # host-vs-device timings the crossover constants come from
    dev = OrientationIndex(seqs)
    _require(
        np.array_equal(dev._decision_matrix_device(), dec),
        "mixed: device decision matrix differs from the host one",
    )
    sketches = [
        np.unique(M.sketch_canonical(s.seq, M.DEFAULT_KMER_SIZE, M.DEFAULT_SKETCH_SIZE))
        for s in seqs
    ]
    sizes = np.array([s.size for s in sketches], dtype=np.int64)
    _require(
        np.array_equal(
            M._intersection_counts_device(sketches, sizes),
            M._intersection_counts_host(sketches, sizes),
        ),
        "mixed: device intersection counts differ from the host ones",
    )
    print("phase mixed: device decision matrix and intersection counts equal"
          " the NumPy paths", flush=True)
    for m in sorted({32, 48, 64, 96, 128, 192, n}):
        if m > n:
            continue
        sub = seqs[:m]
        oi = OrientationIndex(sub)
        oi._ensure_sets(range(m))
        oi._decision_matrix_device()  # compile this shape bucket
        t_dev = _best_of(oi._decision_matrix_device)
        t_host = _best_of(oi._decision_matrix)
        sk, sz = sketches[:m], sizes[:m]
        M._intersection_counts_device(sk, sz)
        t_mdev = _best_of(lambda: M._intersection_counts_device(sk, sz))
        t_mhost = _best_of(lambda: M._intersection_counts_host(sk, sz))
        print(
            f"crossover n={m}: orientation host {1e3 * t_host:.3f} ms"
            f" device {1e3 * t_dev:.3f} ms; intersection counts host"
            f" {1e3 * t_mhost:.3f} ms device {1e3 * t_mdev:.3f} ms",
            flush=True,
        )


def phase_long(tmp: str, seqs=None) -> None:
    seqs = seqs or make_seqs(**LONG)
    n = len(seqs)
    if n < LONG["n_sequences"]:
        print(f"phase long: cut to {n} sequences", flush=True)
    recs = run_phase(tmp, "long", seqs, ["-p", "none"])
    check_records("long", recs, seqs, n * (n - 1), recs)


def phase_four_cards(tmp: str, seqs=None) -> None:
    """Headline set through the local ("data",) mesh that the dense
    engine turns on by itself with several devices, then again on one
    device; the PAF record sets must be equal."""
    import jax

    from allwave.wfa.dense_engine import DenseBandAligner

    seqs = seqs or make_seqs(**HEADLINE)
    n = len(seqs)
    share = {d.id: 0 for d in jax.local_devices()}
    orig = DenseBandAligner._dispatch_group

    def counted(self, group, *a, **kw):
        out = orig(self, group, *a, **kw)
        for sh in out.addressable_shards:
            rows = sh.index[0]
            lo = rows.start or 0
            hi = out.shape[0] if rows.stop is None else rows.stop
            share[sh.device.id] += max(0, min(hi, len(group)) - lo)
        return out

    DenseBandAligner._dispatch_group = counted
    try:
        text_mesh, t_mesh = run_cli(tmp, "four_cards", seqs, ["-p", "none"])
    finally:
        DenseBandAligner._dispatch_group = orig
    peaks = peak_bytes()
    os.environ["ALLWAVE_SINGLE_DEVICE"] = "1"
    try:
        text_one, t_one = run_cli(tmp, "four_cards", seqs, ["-p", "none"])
    finally:
        del os.environ["ALLWAVE_SINGLE_DEVICE"]
    mesh = sorted(text_mesh.splitlines())
    one = sorted(text_one.splitlines())
    _require(len(mesh) == n * (n - 1), f"four_cards: {len(mesh)} records")
    _require(mesh == one, "four_cards: mesh and single-device PAF records differ")
    total = sum(share.values())
    print(
        f"phase four_cards: {len(mesh)} records equal with and without the mesh;"
        f" mesh run {t_mesh:.3f} s (incl. compile), single-device run"
        f" {t_one:.3f} s (incl. compile); pairs per card {share}"
        f" (shares {[round(v / max(total, 1), 4) for v in share.values()]});"
        f" peak device bytes per card after the mesh run {peaks}",
        flush=True,
    )
    seqs_by_id = {s.id: s.seq for s in seqs}
    bad = replay_failures(parse_paf(text_mesh), seqs_by_id)
    _require(not bad, f"four_cards: {len(bad)} CIGARs fail to replay")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the 4-card mesh phase (needs 4 local GPUs)",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU found (JAX platform {devices[0].platform!r})",
            file=sys.stderr,
        )
        return 1
    for line in card_lines():
        print(f"card: {line}", flush=True)
    print(
        f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}",
        flush=True,
    )
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            if len(devices) != 4:
                print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
                      file=sys.stderr)
                return 1
            phase_four_cards(tmp)
        else:
            phase_headline(tmp)
            phase_mixed(tmp)
            phase_long(tmp)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(result_line(devices[0].platform, devices[0].device_kind, len(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
