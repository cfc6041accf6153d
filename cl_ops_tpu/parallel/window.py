"""Distributed window functions: `agg(v) OVER (PARTITION BY k ORDER BY o)`
across the mesh.

The multi-chip sibling of ops/exec/window.py, composed from the
framework's distributed primitives the same way the single-chip operator
composes the local ones (the satradix composition discipline,
`src/cl_ops/sort/clo_sort_satradix.c:296-300`):

  1. ONE global hypercube sort of (partition limbs, order limbs, global
     position, measures) — dist_sort_i32_cols (parallel/sort.py);
  2. partition-start flags with chip-boundary correction (a ppermute of
     each chip's last key row — partitions freely straddle chips);
  3. per-aggregate distributed segmented scans (dist_segmented_scan's
     pair-operator carry exchange) and one-row global shifts for lag/lead;
  4. ONE restore sort back to input row order — or `sorted_output=True`
     to skip it (the hash_join fusion discipline, VERDICT r2 item 3).

Every step keeps rows sharded over the mesh axis; collectives are the
carry/boundary exchanges plus the sorts' compare-split ppermutes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.ops.exec import psort
from cl_ops_tpu.ops.exec.window import WINDOW_AGGS, _RANK_AGGS
from cl_ops_tpu.ops.sort import keys as keymod
from cl_ops_tpu.parallel.mesh import DATA_AXIS, iota_sharded, mesh_program
from cl_ops_tpu.parallel.scan import dist_scan, dist_segmented_scan
from cl_ops_tpu.parallel.sort import dist_sort_i32_cols


def _dist_change_flags(limbs, mesh: Mesh, axis: str):
    """Row-change flags of globally sorted limb columns, sharded.

    flags[i] = 1 iff global row i differs from row i-1 in any limb (row 0
    always flags). The chip boundary is corrected by a ppermute of each
    chip's last row to its successor.
    """
    fn = mesh_program(_local_change_flags, mesh, P(axis), P(axis),
                      n_chips=mesh.shape[axis], axis=axis)
    return fn(*limbs)


def _local_change_flags(*ls, n_chips, axis):
    ls = tuple(c.reshape(-1) for c in ls)
    n_l = ls[0].shape[0]
    me = jax.lax.axis_index(axis)
    new = jnp.zeros((n_l,), jnp.bool_)
    diff_first = jnp.zeros((), jnp.bool_)
    for c in ls:
        new = new | jnp.concatenate(
            [jnp.zeros((1,), jnp.bool_), c[1:] != c[:-1]])
        prev_last = jax.lax.ppermute(
            c[-1:], axis, perm=[(i, i + 1) for i in range(n_chips - 1)])
        diff_first = diff_first | (c[0] != prev_last[0])
    first = (me == 0) | diff_first
    idx0 = jax.lax.broadcasted_iota(jnp.int32, (n_l,), 0) == 0
    return jnp.where(idx0, first, new).astype(jnp.int32)


def _dist_roll(cols, mesh: Mesh, axis: str, shift: int):
    """Global one-row roll of sharded columns (together).

    shift=+1: out[i] = col[i-1] (global row 0 receives zeros — callers
    mask edges); shift=-1: out[i] = col[i+1] (last row zeros). The
    boundary row crosses chips via ppermute.
    """
    fn = mesh_program(_local_roll, mesh, P(axis), P(axis),
                      n_chips=mesh.shape[axis], axis=axis, shift=shift)
    return fn(*cols)


def _local_roll(*cs, n_chips, axis, shift):
    outs = []
    for c in cs:
        c = c.reshape(-1)
        if shift == 1:
            b = jax.lax.ppermute(
                c[-1:], axis, perm=[(i, i + 1) for i in range(n_chips - 1)])
            outs.append(jnp.concatenate([b, c[:-1]]))
        else:
            b = jax.lax.ppermute(
                c[:1], axis, perm=[(i + 1, i) for i in range(n_chips - 1)])
            outs.append(jnp.concatenate([c[1:], b]))
    return tuple(outs)


def dist_window_cols(keys, order, values, aggs, mesh: Mesh, *,
                     exclusive: bool = False, axis: str = DATA_AXIS,
                     sorted_output: bool = False):
    """Window columns over row-sharded inputs (see ops/exec/window.py).

    Args mirror window_cols; all 1-D inputs are row-sharded over
    mesh[axis] (or shardable host arrays). Returns per-row columns in
    input row order with the same sharding — or (columns, row_src) when
    sorted_output=True, where outputs come partition-grouped and
    row_src[i] is the input row index now at global position i.
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
    n = keys.shape[0]
    kl = keymod.to_limbs(keys)
    ol = keymod.to_limbs(order) if order is not None else ()
    pos = iota_sharded(n, mesh, axis)

    # Dedup measure columns by identity so repeated measures ride the
    # global sort once (same discipline as the single-chip operator).
    uniq = []
    for v in values:
        if v is not None and not any(v is u for u in uniq):
            uniq.append(v)
    enc, spec = psort.cols_to_i32(tuple(uniq)) if uniq else ((), ())

    cols = (*kl, *ol, pos, *enc)
    out = dist_sort_i32_cols(cols, mesh, axis=axis)
    skl = out[:len(kl)]
    sol = out[len(kl):len(kl) + len(ol)]
    row_src = out[len(kl) + len(ol)]
    suniq = psort.cols_from_i32(out[len(kl) + len(ol) + 1:], spec)

    def sorted_measure(v):
        for u, su in zip(uniq, suniq):
            if v is u:
                return su
        raise AssertionError("measure column lost in dedup")

    flags = _dist_change_flags(skl, mesh, axis)
    ones = jnp.ones_like(row_src)
    gidx = iota_sharded(n, mesh, axis)

    def seg(x, fl, **kw):
        return dist_segmented_scan(x, fl, mesh, axis=axis, **kw)

    results = []
    rownum = None
    tie = None
    seg_id = None
    for a, v in zip(aggs, values):
        if a in ("row_number", "count"):
            if rownum is None:
                rownum = seg(ones, flags, exclusive=False)
            res = rownum - 1 if (a == "count" and exclusive) else rownum
            results.append(res)
            continue
        if a in ("rank", "dense_rank"):
            if tie is None:
                tie = jnp.maximum(flags, _dist_change_flags(sol, mesh, axis))
            if a == "dense_rank":
                results.append(seg(tie, flags, exclusive=False))
            else:
                if rownum is None:
                    rownum = seg(ones, flags, exclusive=False)
                in_tie = seg(ones, tie, exclusive=False)
                results.append(rownum - in_tie + 1)
            continue
        sv = sorted_measure(v)
        if a in ("lag", "lead"):
            if seg_id is None:
                seg_id = dist_scan(flags, mesh, sum_dtype=jnp.int32,
                                   exclusive=False, axis=axis)
            shift = 1 if a == "lag" else -1
            shifted, rolled_seg = _dist_roll((sv, seg_id), mesh, axis,
                                             shift)
            same = rolled_seg == seg_id
            edge = (gidx >= 1) if a == "lag" else (gidx < n - 1)
            results.append(jnp.where(same & edge, shifted,
                                     jnp.zeros((), sv.dtype)))
            continue
        if a == "mean":
            s = seg(sv, flags, sum_dtype=jnp.float32
                    if sv.dtype.kind == "f" else None, exclusive=exclusive)
            if rownum is None:
                rownum = seg(ones, flags, exclusive=False)
            cnt = rownum - 1 if exclusive else rownum
            results.append(s.astype(jnp.float32) /
                           jnp.maximum(cnt, 1).astype(jnp.float32))
            continue
        op = {"sum": "add", "min": "min", "max": "max"}[a]
        results.append(seg(sv, flags, op=op, exclusive=exclusive))

    if sorted_output:
        return tuple(results), row_src

    # Batched restore: one global sort keyed by the unique source position
    # brings every output column home together.
    renc, rspec = psort.cols_to_i32(tuple(results))
    rout = dist_sort_i32_cols((row_src, *renc), mesh, axis=axis)
    return psort.cols_from_i32(rout[1:], rspec)


def dist_window_scan(keys, values, mesh: Mesh, order=None, *, agg="sum",
                     exclusive: bool = False, axis: str = DATA_AXIS,
                     sorted_output: bool = False):
    """Single-measure distributed window aggregate (see dist_window_cols)."""
    out = dist_window_cols(keys, order, (values,), (agg,), mesh,
                           exclusive=exclusive, axis=axis,
                           sorted_output=sorted_output)
    if sorted_output:
        return out[0][0], out[1]
    return out[0]
