"""Distributed group-by aggregate: hash-partition keys, aggregate locally.

North-star config ("GROUP BY over 256M rows, 1M groups", BASELINE.json),
scaled over the mesh: every key's rows land on one chip via the all_to_all
partition exchange, so per-chip local aggregation is exact and chips hold
disjoint group sets.

Skew safety: the shuffle's overflow counter is CHECKED (never silently
discarded) — overflow triggers the adaptive hash -> range-splitter ->
doubled-capacity re-plan of splitters.keyed_exchange_replan and raises if
rows would still drop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.parallel.mesh import DATA_AXIS, mesh_program, put_sharded
from cl_ops_tpu.parallel.splitters import (keyed_exchange_once,
                                           keyed_exchange_replan)
from cl_ops_tpu.utils.bits import is_po2


def dist_group_aggregate(keys, values, mesh: Mesh, *, num_groups: int,
                         capacity: int, agg: str = "sum",
                         axis: str = DATA_AXIS, partition: str = "hash",
                         max_replan: int = 3, samples_per_chip: int = 256,
                         check: str = "replan"):
    """Aggregate values by key across the mesh.

    num_groups bounds DISTINCT KEYS PER CHIP (local table capacity);
    capacity bounds rows per (source chip -> partition) shuffle bucket —
    overflow re-plans adaptively (see keyed_exchange_replan) and raises
    rather than ever dropping rows.

    check: "replan" (default) or "defer" — same contract as dist_hash_join;
      "defer" skips the host-synced overflow check (jit-traceable) and
      appends the shuffle's per-chip `dropped` counter to the outputs for
      the caller to verify asynchronously.

    Returns (group_keys, table, count) per chip, row-sharded: chip c's
    slice holds `count[c]` valid (key, aggregate) rows in ascending key
    order; group sets are disjoint across chips. With check="defer" a
    trailing `dropped` element is appended.
    """
    out = dist_group_aggregate_cols(
        keys, (values,), (agg,), mesh, num_groups=num_groups,
        capacity=capacity, axis=axis, partition=partition,
        max_replan=max_replan, samples_per_chip=samples_per_chip,
        check=check)
    if check == "defer":
        gk, tables, cnt, dropped = out
        return gk, tables[0], cnt, dropped
    gk, tables, cnt = out
    return gk, tables[0], cnt


def dist_group_aggregate_cols(keys, values, aggs, mesh: Mesh, *,
                              num_groups: int, capacity: int,
                              axis: str = DATA_AXIS,
                              partition: str = "hash", max_replan: int = 3,
                              samples_per_chip: int = 256,
                              check: str = "replan"):
    """Multi-measure distributed GROUP BY — the mesh-level
    group_aggregate_cols (the `SELECT sum(a), min(b), count(*)` shape).

    One all_to_all shuffle carries the key and EVERY measure column; each
    chip then sorts its partition ONCE by (validity, key, measures...) and
    reduces all (column, agg) pairs against one shared boundary scan.
    values: tuple of measure columns; aggs: matching tuple from
    sum/count/min/max/mean. Same skew/overflow contract as
    dist_group_aggregate (`check="replan"` re-plans and raises before
    dropping; `check="defer"` is jit-traceable and appends the per-chip
    `dropped` counter).

    Returns (group_keys, tables, count) per chip, row-sharded, tables a
    tuple aligned with `values`; group sets are disjoint across chips.
    """
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError("mesh axis size must be a power of 2")
    if check not in ("replan", "defer"):
        raise ValueError(f"unknown check {check!r}")
    if len(values) != len(aggs) or not values:
        raise ValueError("values and aggs must be equal-length, non-empty")
    from cl_ops_tpu.ops.exec.aggregate import _AGGS
    for a in aggs:
        if a not in _AGGS:
            raise ValueError(f"unknown agg {a!r}")
    # min/max gather-vs-resort decision per column: the first measure (and
    # any alias of it) becomes a secondary sort key. Decided HERE on real
    # arrays — tracer identity would not survive the shuffle anyway.
    key_ordered = tuple(i == 0 or v is values[0]
                        for i, v in enumerate(values))
    if check == "defer":
        (res,), (dropped,) = keyed_exchange_once(
            [(keys, tuple(values))], mesh, capacities=(capacity,),
            axis=axis, partition=partition,
            samples_per_chip=samples_per_chip)
        cap = capacity
    else:
        (res,), (cap,) = keyed_exchange_replan(
            [(keys, tuple(values))], mesh, capacities=(capacity,),
            axis=axis, partition=partition, max_replan=max_replan,
            samples_per_chip=samples_per_chip,
            op_name="dist_group_aggregate")
    counts, k, *vs = res

    out_specs = (P(axis), tuple(P(axis) for _ in values), P(axis))
    fn = mesh_program(_local_aggregate, mesh, P(axis), out_specs,
                      n_chips=n_chips, cap=cap, num_groups=num_groups,
                      aggs=tuple(aggs), key_ordered=key_ordered)
    out = fn(*(put_sharded(a, mesh, axis) for a in (counts, k, *vs)))
    return out + (dropped,) if check == "defer" else out


def _local_aggregate(c, kl, *vls, n_chips, cap, num_groups, aggs,
                     key_ordered):
    """One chip's aggregate over its received (n_chips, cap) buckets."""
    from cl_ops_tpu.ops.exec.aggregate import _boundary_reduce_cols
    c = c.reshape(-1)
    slot = jax.lax.broadcasted_iota(jnp.int32, (n_chips, cap), 1)
    valid = (slot < c[:, None]).reshape(-1)
    kf = kl.reshape(-1)
    vfs = [v.reshape(-1) for v in vls]
    # Sort with the INVERTED valid mask as primary key: valid rows form a
    # key-sorted prefix, invalid rows trail. Validity never enters key
    # space, so any real key value (incl. dtype extremes) aggregates
    # correctly; the boundary reduce ignores rows past n_valid.
    inv = jnp.logical_not(valid).astype(jnp.int32)
    out = jax.lax.sort([inv, kf, *vfs], num_keys=2 + len(vfs))
    sk, svs = out[1], list(out[2:])
    n_valid = jnp.sum(valid.astype(jnp.int32), dtype=jnp.int32)
    gkeys, tables, cnt = _boundary_reduce_cols(
        sk, tuple(svs), num_groups=num_groups, aggs=aggs,
        key_ordered=key_ordered, n_valid=n_valid)
    return gkeys, tables, cnt.reshape(1)
