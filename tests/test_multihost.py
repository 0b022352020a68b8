"""REAL multi-process distribution test: two OS processes coordinate
through `jax.distributed` on the CPU backend (SURVEY §4's test-strategy
implication (d): "multi-host tests via jax.distributed on CPU backend
with >= 2 simulated hosts" — the reference has nothing to copy here).

Each worker initializes the distributed runtime, takes its strided pair
shard via parallel.dist, aligns it with the normal pipeline, and writes
its own PAF shard; the parent merges the shards and requires the result
to equal a single-process run line-for-line (order-insensitive, the
reference's t>1 contract)."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import jax

jax.config.update("jax_platforms", "cpu")
coord, nproc, pid, fasta, prefix = sys.argv[1:6]

from allwave.parallel.dist import (
    DistributedAllPairAligner,
    init_distributed,
)

init_distributed(coord, int(nproc), int(pid))
assert jax.process_count() == int(nproc), jax.process_count()
assert jax.process_index() == int(pid), jax.process_index()

from allwave.core.scores import parse_scores
from allwave.core.types import NoSparsification
from allwave.engine.fasta import read_fasta

seqs = read_fasta(fasta)
al = DistributedAllPairAligner(
    seqs,
    parse_scores("0,5,8,2,24,1"),
    exclude_self=True,
    use_mash_orientation=True,
    sparsification=NoSparsification(),
)
path = al.run_to_paf_shard(prefix)
print(f"shard {pid}: {al.pair_count()} pairs -> {path}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_jax_distributed_matches_single(tmp_path):
    # shared input FASTA
    gen = (
        "from allwave.testing.synth import make_test_case; "
        f"make_test_case(seed=42, n_sequences=5, length=400).write_fasta(r'{tmp_path}/mh.fa')"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # workers use plain 1-device CPU backends
    subprocess.run(
        [sys.executable, "-c", gen], cwd=REPO, env=env, check=True, timeout=300
    )
    fasta = str(tmp_path / "mh.fa")
    prefix = str(tmp_path / "out")

    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                "-c",
                WORKER,
                coord,
                "2",
                str(pid),
                fasta,
                prefix,
            ],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    # merge shards
    from allwave.parallel.dist import merge_paf_shards

    merged = str(tmp_path / "merged.paf")
    merge_paf_shards(prefix, 2, merged)

    # single-process reference run (same process, CPU backend via conftest)
    from allwave.core.paf import alignment_to_paf
    from allwave.core.scores import parse_scores
    from allwave.core.types import NoSparsification
    from allwave.engine.fasta import read_fasta
    from allwave.engine.pipeline import AllPairAligner

    seqs = read_fasta(fasta)
    single = []
    AllPairAligner(
        seqs,
        parse_scores("0,5,8,2,24,1"),
        exclude_self=True,
        use_mash_orientation=True,
        sparsification=NoSparsification(),
    ).for_each_with_callback(
        lambda r: single.append(alignment_to_paf(r, seqs) + "\n")
    )

    merged_lines = sorted(open(merged))
    assert len(merged_lines) == 20  # n(n-1) directed pairs, 5 seqs
    assert merged_lines == sorted(single)
