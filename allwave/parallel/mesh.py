"""Multi-chip sharding of the batched wavefront engine.

Parallelism map (SURVEY.md §2.4):

* data axis ("data"): the pair stream — each device owns a slice of the
  batch. This replaces the reference's rayon thread pool over pairs
  (iterator.rs:182-204).
* diagonal axis ("diag"): the wavefront band — the analog of sequence /
  context parallelism. The per-score ±1 diagonal shifts become halo
  exchanges; we annotate shardings and let XLA GSPMD insert the
  collective-permutes between devices.

Multi-host: under jax.distributed each host feeds its own pair shard and
writes its own PAF shard; nothing here assumes a single controller beyond
jax's own SPMD model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_mesh(n_devices: Optional[int] = None, diag: int = 1):
    """A ("data", "diag") mesh over the first n_devices devices."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % diag != 0:
        raise ValueError(f"n_devices={n} not divisible by diag={diag}")
    arr = np.array(devices[:n]).reshape(n // diag, diag)
    return Mesh(arr, ("data", "diag"))


def shard_forward_inputs(mesh, qs, ts, qlens, tlens):
    """Place the batch inputs with the pair axis sharded over "data"."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    s2 = NamedSharding(mesh, P("data", None))
    s1 = NamedSharding(mesh, P("data"))
    return (
        jax.device_put(qs, s2),
        jax.device_put(ts, s2),
        jax.device_put(qlens, s1),
        jax.device_put(tlens, s1),
    )


def sharded_alignment_step(mesh, pen, s_cap: int, k_width: int):
    """Build a jitted full alignment step (forward + traceback) whose
    batch axis is sharded over "data" and whose wavefront band is sharded
    over "diag". Returns fn(qs, ts, qlens, tlens) -> (scores, ops, lens,
    nruns, overflow)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..wfa import batch as B_

    run_cap = 2 * s_cap + 16

    def step(qs, ts, qlens, tlens):
        # constrain the band axis so GSPMD shards the wavefront planes
        # over "diag" and inserts halo exchanges for the k+-1 shifts
        scores, done, hist = B_.wavefront_forward(
            qs, ts, qlens, tlens, pen, s_cap, k_width, True
        )
        hist = {
            c: jax.lax.with_sharding_constraint(
                v, NamedSharding(mesh, P(None, "data", "diag"))
            )
            for c, v in hist.items()
        }
        ops, lens, nruns, overflow = B_.wavefront_traceback(
            hist, scores, qlens, tlens, pen, run_cap
        )
        return scores, ops, lens, nruns, overflow

    in_s2 = NamedSharding(mesh, P("data", None))
    in_s1 = NamedSharding(mesh, P("data"))
    out_s = (
        NamedSharding(mesh, P("data")),
        NamedSharding(mesh, P("data", None)),
        NamedSharding(mesh, P("data", None)),
        NamedSharding(mesh, P("data")),
        NamedSharding(mesh, P("data")),
    )
    return jax.jit(
        step,
        in_shardings=(in_s2, in_s2, in_s1, in_s1),
        out_shardings=out_s,
    )


def sharded_dense_step(mesh, pen, k_width: int, l_pad: int, run_cap: int):
    """Data-parallel dense alignment step over the mesh's "data" axis —
    the production parallelism plan of SURVEY.md §2.4: the unique-
    sequence pool is REPLICATED on every device (pangenome sets fit in
    device memory) and the pair-index stream is SHARDED, so each device
    runs the fused forward+traceback step on its own pair shard with zero
    inter-device traffic in the hot loop (the per-host PAF shards are
    merged downstream; see parallel.dist).

    Built with shard_map so each device runs the whole fused step on
    its own shard, with no collective inside it. Returns
    fn(pool, qidx, tidx, qlens, tlens) -> packed
    (B, 32 + ceil(run_cap/4) + run_cap) u8 rows in the
    dense_align_packed layout (meta | 2-bit-packed ops | lens).

    The batch size need NOT divide the mesh's "data" axis: the wrapper
    pads the index/length arrays to a multiple of it (padded rows point
    at pool row 0 with length 0 — the standard padding contract) and
    slices the packed output back to the true batch size."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..wfa import dense as D_

    def local(pool, qidx, tidx, qlens, tlens):
        return D_.dense_align_packed(
            pool, qidx, tidx, qlens, tlens, pen, k_width, l_pad, run_cap
        )

    fn = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(None, None),  # sequence pool: replicated
                P("data"),
                P("data"),
                P("data"),
                P("data"),
            ),
            out_specs=P("data", None),
            check_vma=False,
        )
    )
    data_n = int(mesh.shape["data"])

    def padded(pool, qidx, tidx, qlens, tlens):
        b0 = qidx.shape[0]
        pad = (-b0) % data_n
        if pad:
            z = jnp.zeros((pad,), jnp.int32)
            qidx = jnp.concatenate([jnp.asarray(qidx, jnp.int32), z])
            tidx = jnp.concatenate([jnp.asarray(tidx, jnp.int32), z])
            qlens = jnp.concatenate([jnp.asarray(qlens, jnp.int32), z])
            tlens = jnp.concatenate([jnp.asarray(tlens, jnp.int32), z])
        out = fn(pool, qidx, tidx, qlens, tlens)
        return out[:b0] if pad else out

    return padded
