"""Distributed partition exchange: the all_to_all radix shuffle.

The north-star exchange backend (BASELINE.json: "hash-partitions tables
across a pod slice with a distributed radix shuffle ... ICI all-to-all
exchange"; SURVEY.md §2.3 names `all_to_all` as the NCCL-equivalent for the
radix shuffle). No referent in the single-device reference — its closest
analog is cross-workgroup communication through global-memory counter
buffers between launches (`clo_sort_satradix.c:247-257`).

Protocol (each chip, inside shard_map):
  1. compute each local row's target partition (hash or range);
  2. stable-sort local rows by partition id (satradix-style local sort);
  3. place rows into fixed-capacity per-partition buckets (XLA scatter with
     drop semantics — static shapes are mandatory under jit, so `capacity`
     bounds rows per (src chip, dst partition) pair; overflow drops and is
     reported);
  4. `jax.lax.all_to_all` swaps bucket i of chip j with bucket j of chip i
     (NCCL over NVLink on GPUs);
  5. receivers compact their P incoming buckets with the per-bucket counts.

Deterministic: bucket order is fixed by mesh position, not arrival.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.parallel.mesh import DATA_AXIS, mesh_program, put_sharded


def partition_exchange(data, part_id, mesh: Mesh, *, capacity: int,
                       axis: str = DATA_AXIS, extra_cols=()):
    """Route rows to the chip owning their partition.

    Args:
      data: row-sharded 1-D array (length divisible by the mesh axis).
      part_id: row-sharded i32 array of target partitions in [0, n_chips).
      capacity: max rows any (source chip -> destination) bucket may carry;
        static (XLA shapes). Rows beyond capacity are dropped and counted.
      extra_cols: additional row-sharded columns routed along.

    Returns:
      (counts, dropped, out_data, *out_cols): per-chip `counts` is an
      (n_chips,)-shaped row count of valid rows received per source chip
      (sharded, one row per chip); `out_*` are (n_chips * capacity)-long
      per-chip buffers — rows from source chip s occupy
      [s*capacity, s*capacity + counts[s]).
    """
    n_chips = mesh.shape[axis]
    n = data.shape[0]
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")

    out_specs = (P(axis), P(axis), *([P(axis)] * (1 + len(extra_cols))))
    fn = mesh_program(_local_exchange, mesh, P(axis), out_specs,
                      n_chips=n_chips, capacity=capacity, axis=axis)
    args = [put_sharded(part_id.astype(jnp.int32), mesh, axis),
            put_sharded(data, mesh, axis)]
    args += [put_sharded(c, mesh, axis) for c in extra_cols]
    return fn(*args)


def _local_exchange(pid, *cols, n_chips, capacity, axis):
    """One chip's bucketing of its rows by partition, then the exchange."""
    pid = pid.reshape(-1)
    cols = tuple(c.reshape(-1) for c in cols)
    m = pid.shape[0]
    # Bucket layout: partition p occupies [p*capacity, (p+1)*capacity).
    # Stable rank within partition = satradix-style local ranking.
    order = jnp.argsort(pid, stable=True)
    spid = jnp.take(pid, order)
    pos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    part_start = jnp.searchsorted(spid, jnp.arange(
        n_chips, dtype=spid.dtype)).astype(jnp.int32)
    rank_in_part = pos - jnp.take(part_start, spid)
    dest = spid.astype(jnp.int32) * capacity + rank_in_part
    dest = jnp.where(rank_in_part < capacity, dest,
                     n_chips * capacity)  # overflow -> dropped
    counts_all = jnp.zeros((n_chips,), jnp.int32).at[pid].add(
        jnp.ones_like(pid, jnp.int32), mode="drop")
    sent = jnp.minimum(counts_all, capacity)
    dropped = jnp.sum(counts_all - sent)

    outs = []
    for c in cols:
        sc = jnp.take(c, order)
        buf = jnp.zeros((n_chips * capacity,), c.dtype).at[dest].set(
            sc, mode="drop", unique_indices=True)
        # all_to_all: split our buckets over chips, gather bucket-for-us
        buf = buf.reshape(n_chips, capacity)
        recv = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0,
                                  tiled=False)
        outs.append(recv.reshape(-1))
    recv_counts = jax.lax.all_to_all(sent.reshape(n_chips, 1), axis,
                                     split_axis=0, concat_axis=0,
                                     tiled=False).reshape(-1)
    return (recv_counts, dropped.reshape(1), *outs)
