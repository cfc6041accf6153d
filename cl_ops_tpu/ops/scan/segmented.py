"""Segmented prefix scans: per-segment running sum/min/max over flag runs.

The reference ships only the unsegmented Blelloch scan
(`src/cl_ops/scan/clo_scan_blelloch.cl:49-211`); segmented scan is its
classic companion operator (the primitive Blelloch's scan model builds
group-wise aggregation from) and what the query layer needs for windowed
running aggregates: cumulative sums per group, row numbering, ranking
(`ops/exec/window.py` composes those from it the way satradix composes the
plain scan, `clo_sort_satradix.c:296-300`).

Plain XLA. Integer add: the global prefix sum minus the prefix sum at each
run's start (wrapping subtraction keeps integer sums exact mod 2^width).
Float add, min and max: `lax.associative_scan` of the pair operator

    (v1, f1) (x) (v2, f2) = (f2 ? v2 : v1 (+) v2,  f1 | f2)

which is associative for any associative (+).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["segmented_scan_1d", "flags_from_segment_ids"]

_OPS = {
    "add": jnp.add,
    "min": jnp.minimum,
    "max": jnp.maximum,
}


def _identity_scalar(op: str, dtype):
    dtype = jnp.dtype(dtype)
    if op == "add":
        return jnp.zeros((), dtype)
    if dtype.kind == "f":
        inf = jnp.asarray(jnp.inf, dtype)
        return inf if op == "min" else -inf
    info = jnp.iinfo(dtype)
    return jnp.asarray(info.max if op == "min" else info.min, dtype)


def _shift_exclusive(incl, x, flags, op: str, acc_dtype):
    """Exclusive from inclusive: identity at run starts, prev value else."""
    if op == "add":
        return incl - x.astype(acc_dtype)
    ident = _identity_scalar(op, acc_dtype)
    prev = jnp.concatenate([jnp.full((1,), ident), incl[:-1]])
    return jnp.where(flags > 0, ident, prev)


def _segmented_scan(x, flags, acc_dtype, op, exclusive):
    """Integer add: cumsum minus the cumsum gathered at each run's start
    (i32 index cummax + gather, n < 2^31). Float add, min and max:
    associative_scan of the pair operator (a float difference of global
    sums would cancel)."""
    xs = x.astype(acc_dtype)
    if op == "add" and jnp.dtype(acc_dtype).kind in "iu":
        incl = jnp.cumsum(xs, dtype=acc_dtype)
        n = x.shape[0]
        iota = jax.lax.iota(jnp.int32, n)
        start = jax.lax.cummax(jnp.where(flags > 0, iota, jnp.int32(0)),
                               axis=0)
        prev = jnp.where(start > 0,
                         jnp.take(incl, jnp.maximum(start - 1, 0)),
                         jnp.zeros_like(incl))
        incl = incl - prev
    else:
        combine_v = _OPS[op]

        def combine(a, b):
            av, af = a
            bv, bf = b
            return jnp.where(bf > 0, bv, combine_v(av, bv)), af | bf

        incl, _ = jax.lax.associative_scan(combine, (xs, flags))
    return _shift_exclusive(incl, x, flags, op, acc_dtype) if exclusive \
        else incl


def flags_from_segment_ids(ids):
    """Segment-start flags (i32 0/1) from a vector of segment ids.

    A segment starts wherever the id differs from its predecessor (ids need
    not be sorted — every change starts a run; SQL PARTITION BY semantics
    require pre-sorting by the id, which ops/exec/window.py does).
    """
    ids = jnp.asarray(ids)
    head = jnp.ones((1,), jnp.int32)
    rest = (ids[1:] != ids[:-1]).astype(jnp.int32)
    return jnp.concatenate([head, rest])


@functools.partial(jax.jit, static_argnames=("sum_dtype", "op", "exclusive"))
def segmented_scan_1d(x, flags, *, sum_dtype=None, op="add", exclusive=True):
    """Per-segment running sum/min/max over a 1-D array.

    Args:
      x: 1-D values, any length.
      flags: 1-D i32/bool, same length; nonzero marks a segment START (the
        scan restarts at that element). Position 0 implicitly starts a
        segment whether or not flagged. Build from segment ids with
        flags_from_segment_ids.
      sum_dtype: accumulator/output dtype; defaults to x.dtype (per-segment
        runs rarely need the widening the global scan defaults to).
      op: "add" (default), "min", or "max".
      exclusive: exclusive semantics (op identity at each segment start)
        like the reference's Blelloch default; False gives inclusive.
    """
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; known: {tuple(_OPS)}")
    sum_dtype = jnp.dtype(sum_dtype if sum_dtype is not None else x.dtype)
    flags = jnp.asarray(flags)
    if flags.shape != x.shape:
        raise ValueError(
            f"flags shape {flags.shape} != values shape {x.shape}")
    fi = (flags != 0).astype(jnp.int32)
    return _segmented_scan(x, fi, sum_dtype, op, exclusive)
