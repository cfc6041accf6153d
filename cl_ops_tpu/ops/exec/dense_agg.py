"""Dense (small-cardinality) multi-measure GROUP BY: one scatter pass.

When group ids are dense ints in [0, num_groups) and num_groups is small,
sorting the rows to aggregate them into a few slots moves far more data
than the problem needs. Real query engines special-case this shape (TPC-H
Q1 has 4 groups) with a dense accumulator table; here that table is
`jax.ops.segment_sum` / `segment_min` / `segment_max`, which XLA runs as a
scatter into the (num_groups,) table.

Exactness: integer sums accumulate in wrapping i32 (u32 natively), so any
accumulation order is bit-identical to the sorted path's prefix-sum
differences mod 2^32; min/max/count are order-free. f32 columns support
min/max only — f32 SUMS would depend on the scatter's order and are
rejected.

The sorted path (`group_aggregate_cols`) remains the general form for
arbitrary keys / large num_groups; `group_aggregate_direct` is the
single-measure scatter form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["group_aggregate_dense_cols", "DENSE_MAX_GROUPS"]

# The cardinality this operator is meant for; past it the sorted
# group_aggregate_cols is the general form.
DENSE_MAX_GROUPS = 1024

_SEGMENT = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
            "max": jax.ops.segment_max}


def group_aggregate_dense_cols(group_ids, values, aggs, *, num_groups: int,
                               valid_mask=None):
    """Multi-measure GROUP BY over DENSE group ids — sort-free.

    Args:
      group_ids: 1-D int column of ids; rows with ids outside
        [0, num_groups) are dropped (group_aggregate_direct semantics).
      values: tuple of 1-D measure columns (4-byte integer dtypes or
        narrower; f32 for min/max only).
      aggs: matching tuple from sum/count/min/max/mean (list accepted,
        as in group_aggregate_cols).
      num_groups: dense id capacity (see DENSE_MAX_GROUPS).
      valid_mask: optional boolean mask — the fused WHERE form.

    Returns (group_keys, tables, count) in group_aggregate_cols layout:
    the first `count` rows hold one row per PRESENT group (>= 1 valid
    row), ascending by id; later rows are padding.
    """
    values = tuple(values)
    aggs = tuple(aggs)
    if len(values) != len(aggs) or not values:
        raise ValueError("values and aggs must be equal-length, non-empty")
    for v, a in zip(values, aggs):
        dt = jnp.dtype(v.dtype)
        if a not in ("sum", "count", "min", "max", "mean"):
            raise ValueError(f"unknown agg {a!r}")
        if dt == jnp.float32 and a in ("sum", "mean"):
            raise ValueError("dense aggregate: f32 sums are "
                             "order-dependent; use the sorted path")
        if dt.itemsize == 8:
            raise ValueError("dense aggregate: 64-bit columns need the "
                             "sorted path")
        if dt.kind not in "iuf":
            raise ValueError(f"dense aggregate: unsupported column dtype "
                             f"{dt}")
    return _dense_cols(group_ids, values, valid_mask, aggs=aggs,
                       num_groups=num_groups)


@functools.partial(jax.jit, static_argnames=("aggs", "num_groups"))
def _dense_cols(group_ids, values, valid_mask, *, aggs, num_groups: int):
    gid = group_ids.astype(jnp.int32)
    keep = (gid >= 0) & (gid < num_groups)
    if valid_mask is not None:
        keep = keep & valid_mask
    # dropped rows go to one extra segment, sliced off below
    gid = jnp.where(keep, gid, jnp.int32(num_groups))

    def reduce(kind, v):
        if kind == "sum" and jnp.dtype(v.dtype) != jnp.uint32:
            v = v.astype(jnp.int32)  # wrapping sums; narrow on the way out
        return _SEGMENT[kind](v, gid, num_segments=num_groups + 1,
                              indices_are_sorted=False)[:num_groups]

    counts = reduce("sum", jnp.ones_like(gid))
    present = counts > 0
    count = jnp.sum(present.astype(jnp.int32))
    gi1 = jax.lax.broadcasted_iota(jnp.int32, (num_groups,), 0)
    # compact present slots to the front, ascending (tiny num_groups sort)
    order = jnp.argsort(jnp.where(present, gi1, jnp.int32(num_groups)))
    group_keys = jnp.take(gi1, order).astype(group_ids.dtype)

    tables = []
    for v, a in zip(values, aggs):
        if a == "count":
            t = counts
        elif a == "mean":
            s = reduce("sum", v).astype(v.dtype)
            # same divide expression as _boundary_reduce_cols
            t = s / jnp.maximum(counts, 1).astype(s.dtype)
        else:
            t = reduce(a, v).astype(v.dtype)
        tables.append(jnp.take(t, order))
    return group_keys, tuple(tables), count
