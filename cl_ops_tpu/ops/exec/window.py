"""Window functions: per-partition running aggregates, ranks, lag/lead.

North-star query operator (SQL `agg(v) OVER (PARTITION BY k ORDER BY o)`).
No referent in the reference library; composes the framework's own
primitives — the multi-column sort (ops/exec/psort.py) and the
segmented scan (ops/scan/segmented.py) — the way satradix composes the
plain scan (`clo_sort_satradix.c:296-300`).

Pipeline (one sort for every requested window column):
  1. sort rows by (partition key, order, position) on normalized limbs;
     the unique position column makes the sort stable AND doubles as the
     restore permutation; measure columns ride behind it as inert payload
     (the established psort pattern — a unique key ahead of them means
     they never influence the order).
  2. partition-start flags from key-limb changes; one segmented scan per
     running aggregate; rank family from two segmented scans of ones.
  3. one batched restore sort (position, all outputs as payload) back to
     the input row order — or `sorted_output=True` to skip it and receive
     the row source permutation instead (the hash_join sorted_output
     fusion discipline: a consumer that re-sorts anyway shouldn't pay the
     restore, VERDICT r2 item 3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.exec import psort
from cl_ops_tpu.ops.scan.segmented import segmented_scan_1d
from cl_ops_tpu.ops.sort import keys as keymod

_RANK_AGGS = ("row_number", "rank", "dense_rank")
_VALUE_AGGS = ("sum", "mean", "count", "min", "max", "lag", "lead")
WINDOW_AGGS = _VALUE_AGGS + _RANK_AGGS


def _limb_change_flags(limbs):
    """Segment-start flags: any limb differs from its predecessor row."""
    n = limbs[0].shape[0]
    new = jnp.zeros((n,), jnp.bool_)
    for c in limbs:
        new = new | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), c[1:] != c[:-1]])
    return new.astype(jnp.int32)


def _seg_count(flags, n, exclusive):
    """Running row count within each segment: the distance from the
    segment's start (a scan of ones, without the constant XLA would try
    to fold at compile time)."""
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    start = jax.lax.cummax(jnp.where(flags > 0, pos, jnp.int32(0)), axis=0)
    return pos - start + (0 if exclusive else 1)


def window_cols(keys, order, values, aggs, *, exclusive=False,
                sorted_output=False):
    """Compute window columns over one partition sort.

    Args:
      keys: 1-D PARTITION BY column (any normalizable dtype).
      order: 1-D ORDER BY column, or None for unordered partitions
        (running aggregates then follow the stable input order; the rank
        family requires an order column).
      values: tuple of measure columns aligned with `aggs` (entries may be
        None for aggs that take no measure: count and the rank family).
      aggs: tuple from sum/mean/count/min/max/lag/lead/row_number/rank/
        dense_rank. lag/lead are offset-1 within the partition, filled
        with the measure dtype's zero at partition edges.
      exclusive: running aggregates exclude the current row (rank family
        and lag/lead are unaffected).
      sorted_output: skip the restore sort; outputs come partition-grouped
        (key, order)-ascending together with `row_src`, where row_src[i]
        is the input row index now at position i.

    Returns:
      tuple of per-row columns in input row order — or
      (tuple, row_src) when sorted_output=True.
    """
    aggs = tuple(aggs)
    values = tuple(values)
    if len(values) != len(aggs) or not aggs:
        raise ValueError("values and aggs must be equal-length, non-empty")
    for a, v in zip(aggs, values):
        if a not in WINDOW_AGGS:
            raise ValueError(f"unknown window agg {a!r}; "
                             f"known: {WINDOW_AGGS}")
        if a in _RANK_AGGS or a == "count":
            continue
        if v is None:
            raise ValueError(f"agg {a!r} needs a measure column")
    if order is None and any(a in ("rank", "dense_rank") for a in aggs):
        raise ValueError("rank/dense_rank require an order column")
    return _window_cols(keys, order, values, aggs=aggs, exclusive=exclusive,
                        sorted_output=sorted_output)


@functools.partial(jax.jit, static_argnames=("aggs", "exclusive",
                                             "sorted_output"))
def _window_cols(keys, order, values, *, aggs, exclusive, sorted_output):
    n = keys.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    kl = keymod.to_limbs(keys)
    ol = keymod.to_limbs(order) if order is not None else ()

    # Deduplicate measure columns by identity (host level — inside the jit
    # each tuple slot is a distinct tracer, same trick as
    # group_aggregate_cols) so repeated measures ride the sort once.
    uniq = []
    for v in values:
        if v is not None and not any(v is u for u in uniq):
            uniq.append(v)
    enc, spec = psort.cols_to_i32(tuple(uniq)) if uniq else ((), ())

    cols = (*kl, *ol, pos, *enc)
    # (key, order, pos) is a UNIQUE prefix, so the measure columns ride
    # as pure payload
    out = psort.sort_i32_cols(cols, num_keys=len(kl) + len(ol) + 1)
    skl = out[:len(kl)]
    sol = out[len(kl):len(kl) + len(ol)]
    row_src = out[len(kl) + len(ol)]
    svals_enc = out[len(kl) + len(ol) + 1:]
    suniq = psort.cols_from_i32(svals_enc, spec)

    def sorted_measure(v):
        for u, su in zip(uniq, suniq):
            if v is u:
                return su
        raise AssertionError("measure column lost in dedup")

    flags = _limb_change_flags(list(skl))
    seg_id = None  # lazily: cumsum of flags for lag/lead validity

    results = []
    rownum = None
    for a, v in zip(aggs, values):
        if a in ("row_number", "count"):
            if rownum is None:
                rownum = _seg_count(flags, n, False)
            res = rownum - 1 if (a == "count" and exclusive) else rownum
            results.append(res)
            continue
        if a in ("rank", "dense_rank"):
            tie = flags | _limb_change_flags(list(sol))
            if a == "dense_rank":
                results.append(segmented_scan_1d(
                    tie, flags, exclusive=False))
            else:
                if rownum is None:
                    rownum = _seg_count(flags, n, False)
                in_tie = _seg_count(tie, n, False)
                results.append(rownum - in_tie + 1)
            continue
        sv = sorted_measure(v)
        if a in ("lag", "lead"):
            if seg_id is None:
                seg_id = jnp.cumsum(flags)
            k = 1 if a == "lag" else -1
            shifted = jnp.roll(sv, k)
            same = jnp.roll(seg_id, k) == seg_id
            edge = (pos >= 1) if a == "lag" else (pos < n - 1)
            results.append(jnp.where(same & edge, shifted,
                                     jnp.zeros((), sv.dtype)))
            continue
        if a == "mean":
            s = segmented_scan_1d(sv, flags, sum_dtype=jnp.float32
                                  if sv.dtype.kind == "f" else None,
                                  exclusive=exclusive)
            if rownum is None:
                rownum = _seg_count(flags, n, False)
            cnt = rownum - 1 if exclusive else rownum
            results.append(s.astype(jnp.float32) /
                           jnp.maximum(cnt, 1).astype(jnp.float32))
            continue
        op = {"sum": "add", "min": "min", "max": "max"}[a]
        results.append(segmented_scan_1d(sv, flags, op=op,
                                         exclusive=exclusive))

    if sorted_output:
        return tuple(results), row_src

    # Batched restore: ONE sort keyed by the unique source position brings
    # every output column home together.
    renc, rspec = psort.cols_to_i32(tuple(results))
    rcols = (row_src, *renc)
    rout = psort.sort_i32_cols(rcols, num_keys=1)
    return psort.cols_from_i32(rout[1:], rspec)


def window_scan(keys, values, order=None, *, agg="sum", exclusive=False,
                sorted_output=False):
    """Single-measure window aggregate (see window_cols)."""
    out = window_cols(keys, order, (values,), (agg,), exclusive=exclusive,
                      sorted_output=sorted_output)
    if sorted_output:
        return out[0][0], out[1]
    return out[0]
