"""Multi-host distribution: pair-shard scheduling + PAF shard merging.

The reference is a single-process tool (rayon threads + one mpsc
channel, main.rs:347-380). The scale-out here (SURVEY.md §2.4):

* one process per host, owning all of that host's devices (JAX reserves
  most of a card's memory per process, so a second process on the same
  card would fail for want of memory);
* every host loads the same FASTA (sequences replicated — pangenome
  sets fit in host RAM and device memory);
* the SPARSIFIED pair list is deterministic (SipHash-driven), so each
  host takes a strided slice of it with no coordination;
* each host runs the normal batched pipeline on its shard and streams
  its own PAF file; shards concatenate into the full output (record
  order is unspecified, exactly like the reference at t>1).

Under `jax.distributed` the per-host device mesh additionally spreads
each host's shard over its local devices via parallel.mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence as PySequence

import numpy as np

from ..core.types import AlignmentParams, Sequence, SparsificationStrategy


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for multi-host runs. No-op when the
    arguments are absent and the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) are
    not set. Nothing on a plain GPU host tells JAX of a cluster, so a
    multi-process run passes all three explicitly."""
    import os

    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_topology():
    """(process_index, process_count) — works with or without
    jax.distributed initialization."""
    import jax

    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_pairs(
    pairs: np.ndarray, proc: Optional[int] = None, nprocs: Optional[int] = None
) -> np.ndarray:
    """Strided slice of the (n_pairs, 2) pair list for this host.
    Strided (not blocked) so hosts see similar length mixes."""
    if proc is None or nprocs is None:
        proc, nprocs = process_topology()
    return pairs[proc::nprocs]


class DistributedAllPairAligner:
    """Per-host view of an all-pairs run: the same constructor surface
    as engine.pipeline.AllPairAligner, but for_each_with_callback only
    visits this host's pair shard."""

    def __init__(
        self,
        sequences: PySequence[Sequence],
        params: AlignmentParams,
        exclude_self: bool = True,
        use_mash_orientation: bool = True,
        sparsification: SparsificationStrategy = None,
        **kw,
    ):
        from ..engine.pipeline import AllPairAligner

        self._inner = AllPairAligner(
            sequences,
            params,
            exclude_self=exclude_self,
            use_mash_orientation=use_mash_orientation,
            sparsification=sparsification,
            **kw,
        )
        self.proc, self.nprocs = process_topology()
        self._inner.pairs = shard_pairs(
            self._inner.pairs, self.proc, self.nprocs
        )

    def pair_count(self) -> int:
        return self._inner.pair_count()

    def for_each_with_callback(self, callback: Callable) -> None:
        self._inner.for_each_with_callback(callback)

    def shard_path(self, output_prefix: str) -> str:
        return f"{output_prefix}.shard{self.proc:05d}.paf"

    def run_to_paf_shard(self, output_prefix: str) -> str:
        """Align this host's shard and stream it to its own PAF file."""
        from ..core.paf import alignment_to_paf

        path = self.shard_path(output_prefix)
        seqs = self._inner.sequences
        with open(path, "w") as out:
            self._inner.for_each_with_callback(
                lambda r: out.write(alignment_to_paf(r, seqs) + "\n")
            )
        return path


def merge_paf_shards(output_prefix: str, n_shards: int, dest: str) -> None:
    """Concatenate per-host shards (order-insensitive output contract)."""
    with open(dest, "w") as out:
        for p in range(n_shards):
            with open(f"{output_prefix}.shard{p:05d}.paf") as f:
                for line in f:
                    out.write(line)
